"""Serving-subset trainer and full checkpoints."""
