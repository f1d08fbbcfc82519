"""Geometry, sampling and depth-hypothesis primitives (plain PyTorch)."""
