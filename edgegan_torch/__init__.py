"""edgegan_torch: the PyTorch + CUDA port of edgegan_tpu for NVIDIA Hopper.

The JAX package `edgegan_tpu` is the reference; this package imports
nothing of it (nor of JAX) and keeps its own copies of what it needs.
Its entry points run on `cuda` unless the caller asks for the CPU, where
every hand-written kernel takes its plain PyTorch version.
"""
