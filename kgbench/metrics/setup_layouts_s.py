"""Set-up seconds in the graph's compile and layouts: the port's spans
kgwas.data.compile (compile_graph), kgwas.layouts.merged
(build_merged_layouts) and kgwas.layouts.device (the upload, the device
layouts and their schedules). Reads ``setup_layouts_s.<cell>``."""
from kgbench.metrics.spans import table_s

SPANS = ("kgwas.data.compile", "kgwas.layouts.merged", "kgwas.layouts.device")


def read(record):
    return table_s(lambda n: n in SPANS)
