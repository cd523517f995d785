"""Deterministic synthetic data, bit-equal to the JAX package's."""
