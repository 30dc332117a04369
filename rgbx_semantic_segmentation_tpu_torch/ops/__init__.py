"""Tensor ops of the port: layers, resize, attention and the CUDA kernel."""
