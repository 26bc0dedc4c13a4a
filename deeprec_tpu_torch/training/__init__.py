"""Trainer, metrics and full checkpoints."""
