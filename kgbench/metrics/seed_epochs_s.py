"""Mean seconds a window seed spends in one part: train_seconds["epochs"]: the
steps and the epoch-end forwards."""
from kgbench.metrics.readers import mean_span


def read(record):
    return mean_span(record, "epochs")
