"""Integer hashing."""
