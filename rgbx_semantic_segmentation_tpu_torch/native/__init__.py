"""CUDA kernels of the port: nvcc build and ctypes loading (see build.py)."""
