"""The port's benchmark: one cell of ``BENCHMARK.json`` per run of ``run.py``.

Everything here is the yardstick: the scenes and traffic made from the
seed, the plain reference that decides ``correct``, the work counts and
peaks of the roofline shares, and the readers of the per-layer metrics.
The system under test is ``repro_torch``; nothing here imports ``jax``,
``jaxlib``, ``flax`` or ``repro``.
"""
