"""AdamW and int8 error-feedback gradient compression (the port of
``repro.optim``)."""
from . import adamw, compression  # noqa: F401
