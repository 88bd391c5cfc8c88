"""Environments: the procedural forest and its query-mode resolution."""
