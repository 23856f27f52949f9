"""Seconds a traced seed spends in its epoch-end evaluations: the port's
span kgwas.train.eval (the full-graph forward, its copy to the host, the
val metrics, the best state's copy)."""
from kgbench.metrics.spans import traced_s

SPANS = ("kgwas.train.eval",)


def read(record):
    return traced_s(record, SPANS)
