"""The merged GAT forward (ops/gat_layer.py -> merged_gat_fwd.cu) as one
operation: its least time at the published peaks (counts.gat_fwd over
every group the model runs) over its kernels' device time, per traced
unit, in %. Reads ``roofline.gat_fwd.<cell>``."""
from kgbench.metrics import counts
from kgbench.metrics.readers import roofline_pct

KERNELS = ("merged_gat_fwd_kernel", "merged_gat_combine_kernel")


def read(record):
    return roofline_pct(record, KERNELS, counts.gat_fwd)
