"""Parameter checkpoints."""
