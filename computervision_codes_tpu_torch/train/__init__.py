"""Training-side code of the port (so far: reading JAX checkpoints)."""
