"""Hash-embedding tables and combiners."""
