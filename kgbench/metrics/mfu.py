"""The traced unit's model operations (counts.model_flops: a training
step's forward and backward, or a forward) over its traced time and the
card's float32 peak, in %. Reads ``<cell>_mfu``."""
from kgbench.metrics.readers import mfu_pct


def read(record):
    return mfu_pct(record, train=record.train)
