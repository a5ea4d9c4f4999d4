"""entry.host_waits: host waits a pricing inside the ``entry`` span, at any
depth: synchronises of a stream, the device or an event, and copies to or
from pageable memory; the median over the program-span phase's profiled
pricings (``perfbench/spans.py``)."""

import statistics

from perfbench import spans


def read(ctx: dict):
    prog = spans.program(ctx)
    if not prog or not prog["trace"] or "entry" not in prog["trace"]["names"]:
        return None
    return float(statistics.median(prog["trace"]["entry_waits"]))
