"""analytics.self_ms: the analytics layer's self time a pricing, in ms: the
time of its ``analytics`` spans less that of other layers' spans inside
them; the median over the program-span phase's pricings without the
profiler (``perfbench/spans.py``)."""

import statistics

from perfbench import spans


def read(ctx: dict):
    prog = spans.program(ctx)
    vals = [p["analytics"] for p in prog["self_s"] if "analytics" in p] if prog else []
    return 1e3 * statistics.median(vals) if vals else None
