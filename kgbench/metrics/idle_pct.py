"""The device's idle share of the traced segment: 1 - the union of the
device operations' intervals over the traced window, in %. Reads
``<cell>_idle_pct``."""
from kgbench.metrics.readers import idle_pct as read  # noqa: F401
