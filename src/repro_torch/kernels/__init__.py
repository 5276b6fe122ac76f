"""Hopper CUDA kernels of the query path, their plain PyTorch twins and the
device dispatch between them (``ops``)."""
