"""Configuration (a copy of the JAX package's Config)."""
