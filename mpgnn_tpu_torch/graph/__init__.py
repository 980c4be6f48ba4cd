"""Heterogeneous graph storage, loaders and generators."""
