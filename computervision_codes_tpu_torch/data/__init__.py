"""Host-side data constants of the port (see data/transforms.py)."""
