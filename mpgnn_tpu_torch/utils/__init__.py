"""Checkpoints, profiling, small helpers and the first-call warmer."""
