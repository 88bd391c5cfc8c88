"""Trace attribution (profiler phase scopes)."""
