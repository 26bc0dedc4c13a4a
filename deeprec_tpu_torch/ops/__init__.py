"""Lookup ops and the row-gather kernel wrapper."""
