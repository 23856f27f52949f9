"""What the readers of the port's spans share (kgwas_tpu_torch's
``engine/profiling.span``): their seconds per traced unit among the trace's
host annotations, and their seconds in this process from the port's span
table (``span_totals()``), which the set-up readers read once the cell's
driver has returned. Each gives None where no span of the names ran, or
where the port has no span table."""
from __future__ import annotations


def traced_s(record, names):
    """Seconds per traced unit that the trace's host annotations of these
    names cover."""
    tr = record.trace
    if tr is None or not tr.units:
        return None
    found = [b - a for n, a, b in tr.host if n in names]
    return sum(found) / tr.units if found else None


def table_s(keep):
    """Seconds that the spans whose name keep(name) accepts took in this
    process."""
    try:
        from kgwas_tpu_torch.engine.profiling import span_totals
    except ImportError:
        return None
    found = [t.total_s for n, t in span_totals().items() if keep(n)]
    return sum(found) if found else None
