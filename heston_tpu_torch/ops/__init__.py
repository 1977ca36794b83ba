"""Grids, stencil weights and operator bands (PyTorch)."""
