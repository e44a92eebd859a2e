"""Models of the port (eval forward of the deployed student)."""
