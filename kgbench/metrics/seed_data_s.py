"""Mean seconds a window seed spends in one part: the draw through
process_gwas_file and prepare_split (host clock)."""
from kgbench.metrics.readers import mean_span


def read(record):
    return mean_span(record, "data")
