"""Datasets of the port (numpy generators copied from the JAX package)."""
