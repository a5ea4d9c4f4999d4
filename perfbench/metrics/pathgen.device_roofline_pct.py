"""pathgen.device_roofline_pct: the pathgen's least time by its counted work
(``work/<route>.py``) over the device time a pricing of the operations
launched under the ``pathgen`` span (median over the program-span phase's
profiled pricings, ``perfbench/spans.py``), in %."""

from perfbench import spans


def read(ctx: dict):
    return spans.device_roofline_pct(ctx, "pathgen")
