"""pathgen.idle_pct: the share of the program-span phase's profiled window
in which the card is idle while the innermost program span is ``pathgen``
or ``pathgen.tables`` (a new seed's host-side direction tables), in %
(``perfbench/spans.py`` (a)). Nothing to read where the program opens no
``pathgen.tables`` span."""

from perfbench import spans


def read(ctx: dict):
    prog = spans.program(ctx)
    t = prog and prog["trace"]
    if not t or not t["window_s"] or "pathgen.tables" not in t["names"]:
        return None
    idle = t["idle_s"].get("pathgen", 0.0) + t["idle_s"].get("pathgen.tables", 0.0)
    return 100.0 * idle / t["window_s"]
