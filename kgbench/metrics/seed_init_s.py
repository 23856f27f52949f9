"""Mean seconds a window seed spends in one part: KGWAS with initialize_model
and the benchmark's parameters, plus train_seconds["setup"]."""
from kgbench.metrics.readers import mean_span


def read(record):
    return mean_span(record, "init")
