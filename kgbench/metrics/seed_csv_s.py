"""Seconds a traced seed spends writing pred.csv: the port's span
kgwas.tail.write_table."""
from kgbench.metrics.spans import traced_s

SPANS = ("kgwas.tail.write_table",)


def read(record):
    return traced_s(record, SPANS)
