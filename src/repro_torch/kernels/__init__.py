"""Hand-written CUDA kernels for Hopper and their plain torch versions.

Kernels are built and loaded on first use (``kernels._build``), never at
import: the CPU tests import every module on a machine without ``nvcc``.
"""
