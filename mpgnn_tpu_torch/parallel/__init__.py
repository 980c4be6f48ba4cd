"""Multi-rank training and the search fan-out on torch.distributed."""
