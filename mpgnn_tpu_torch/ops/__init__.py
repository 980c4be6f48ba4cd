"""Aggregation ops and the CUDA kernels behind them."""
