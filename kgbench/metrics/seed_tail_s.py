"""Mean seconds a window seed spends in one part: train_seconds["tail"] plus
scripts/loci.count_loci of GWAS and KGWAS."""
from kgbench.metrics.readers import mean_span


def read(record):
    return mean_span(record, "tail")
