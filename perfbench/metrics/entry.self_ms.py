"""entry.self_ms: the entry's self time a pricing, in ms: the time of its
``entry`` span (``entry.frame`` inside it included) less that of the
``pathgen`` and ``induction`` spans inside it; the median over the
program-span phase's untraced-by-the-profiler pricings (``perfbench/spans.py``)."""

import statistics

from perfbench import spans


def read(ctx: dict):
    prog = spans.program(ctx)
    vals = [p["entry"] for p in prog["self_s"] if "entry" in p] if prog else []
    return 1e3 * statistics.median(vals) if vals else None
