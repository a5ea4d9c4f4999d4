"""induction.device_roofline_pct: the induction's least time by its counted
work (``work/<route>.py``) over the device time a pricing of the operations
launched under the ``induction`` span, ``induction.prepare`` included
(median over the program-span phase's profiled pricings,
``perfbench/spans.py``), in %."""

from perfbench import spans


def read(ctx: dict):
    return spans.device_roofline_pct(ctx, "induction")
