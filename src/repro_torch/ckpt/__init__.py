"""Checkpoints of the port's training path."""
