"""Device kernels (JAX/XLA) for color depth search."""
