"""Host-side data of the port: ImageNet constants (``transforms``), the
triplet bank, splits, labels, the cached-feature bus, temporal sequences
and synthetic trees. Plain numpy; each module is a copy of its namesake in
the JAX package."""
