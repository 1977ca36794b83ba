"""Pricing models (PyTorch)."""
