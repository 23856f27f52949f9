"""Device ms a training step of the dense products' kernels (cuBLAS's,
matched by name)."""
from kgbench.metrics.readers import per_unit_s

KERNELS = ("gemm", "gemv", "splitkreduce")


def read(record):
    if per_unit_s(record) is None:
        return None
    return 1e3 * record.trace.seconds_of(KERNELS) / record.trace.units
