"""Hop operands and metrics."""
