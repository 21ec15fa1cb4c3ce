"""Symbolic rewrite rules and the MLtoDNN lowering rule."""
