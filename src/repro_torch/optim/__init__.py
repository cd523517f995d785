"""Optimizers as functions on trees of tensors."""
