"""EHL* on PyTorch and CUDA: the port of ``repro`` to an NVIDIA H100.

Host index building (``core``: geometry, visibility graph, hub labels, the
EHL grid and its EHL* compression) is float64 numpy; the online query runs
on torch tensors, with the Hopper kernels of ``kernels`` on the card and
their plain PyTorch twins on the CPU.  ``serving`` fronts it with engines
and a batching server.
"""
