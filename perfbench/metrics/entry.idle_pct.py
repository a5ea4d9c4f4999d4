"""entry.idle_pct: the share of the program-span phase's profiled window in
which the card is idle while the innermost program span is ``entry`` or
``entry.frame`` (the entry's own host work), in % (``perfbench/spans.py``)."""

from perfbench import spans


def read(ctx: dict):
    prog = spans.program(ctx)
    t = prog and prog["trace"]
    if not t or not t["window_s"] or "entry" not in t["names"]:
        return None
    idle = t["idle_s"].get("entry", 0.0) + t["idle_s"].get("entry.frame", 0.0)
    return 100.0 * idle / t["window_s"]
