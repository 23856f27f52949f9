"""Seconds a traced seed spends in KGWAS_P's calibration: the port's span
kgwas.tail.calibration (finalize_predictions: Storey-Tibshirani and the
scale factor)."""
from kgbench.metrics.spans import traced_s

SPANS = ("kgwas.tail.calibration",)


def read(record):
    return traced_s(record, SPANS)
