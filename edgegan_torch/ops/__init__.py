"""Ops, NCHW, and the hand-written CUDA kernels (kernels.py)."""
