"""Optimizers for the port's training path."""
