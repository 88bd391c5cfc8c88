"""Small numeric and geometry helpers."""
