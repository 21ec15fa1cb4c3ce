"""Symbolic rewrite rules and the MLtoDNN and MLtoSQL lowering rules."""
