"""analytics.host_waits: host waits a pricing whose innermost program span
is ``analytics`` (or a span of that layer): synchronises of a stream, the
device or an event, and copies to or from pageable memory, over the
program-span phase's profiled pricings (``perfbench/spans.py``). Nothing to
read where the program has no ``analytics`` span."""

from perfbench import spans


def read(ctx: dict):
    prog = spans.program(ctx)
    t = prog and prog["trace"]
    if not t or "analytics" not in t["names"] or not t["entry_waits"]:
        return None
    waits = sum(n for name, n in t["waits"].items() if name.split(".")[0] == "analytics")
    return waits / len(t["entry_waits"])
