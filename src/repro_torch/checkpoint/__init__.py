"""Checkpoints of the port's state trees (``io``)."""
