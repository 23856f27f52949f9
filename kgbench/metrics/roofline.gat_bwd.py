"""The merged GAT backward as one operation (merged_gat_bwd.cu, then
ops/segment.py -> csc_segment_sum.cu): its least time at the published
peaks (counts.gat_bwd over every group the model runs) over its kernels'
device time, per traced step, in %. Reads ``roofline.gat_bwd.<cell>``."""
from kgbench.metrics import counts
from kgbench.metrics.readers import roofline_pct

KERNELS = ("merged_gat_bwd_kernel", "merged_gat_bwd_combine_kernel",
           "csc_items_kernel", "csc_combine_kernel", "group_sum_kernel",
           "slot_sum_kernel")


def read(record):
    return roofline_pct(record, KERNELS, counts.gat_bwd)
