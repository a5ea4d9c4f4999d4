"""pathgen.roofline_pct: the pathgen's least time by its counted work (the
path array written once, or its operations) over the pathgen span, in %."""

from perfbench.roofline import share_pct


def read(ctx: dict):
    return share_pct(ctx, "pathgen")
