"""Seconds a traced seed spends counting loci of GWAS and of KGWAS: the
port's span kgwas.loci (scripts/loci.count_loci)."""
from kgbench.metrics.spans import traced_s

SPANS = ("kgwas.loci",)


def read(record):
    return traced_s(record, SPANS)
