"""Seconds a traced seed spends in the blocks before the replays: the port's
spans kgwas.scan.eager (the first block, run eagerly) and
kgwas.scan.capture (the CUDA graph's capture)."""
from kgbench.metrics.spans import traced_s

SPANS = ("kgwas.scan.eager", "kgwas.scan.capture")


def read(record):
    return traced_s(record, SPANS)
