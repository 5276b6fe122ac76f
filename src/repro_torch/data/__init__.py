"""The token pipeline: synthetic streams and a memory-mapped corpus (the
port of ``repro.data``)."""
from .pipeline import CorpusReader, DataConfig, synthetic_batch  # noqa: F401
