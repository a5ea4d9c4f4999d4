"""analytics.device_roofline_pct: the analytics layer's least time by its
counted work (``work/<route>.py``: the paths read once) over the device time
a pricing of the operations launched under the ``analytics`` span (median
over the program-span phase's profiled pricings, ``perfbench/spans.py``),
in %."""

from perfbench import spans


def read(ctx: dict):
    return spans.device_roofline_pct(ctx, "analytics")
