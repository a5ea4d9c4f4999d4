"""induction.roofline_pct: the induction's least time by its counted work
(the paths read once and its outputs written once, or its operations) over
its time, in %: the median span of the public function that runs it, or,
where the program has none (``REST`` of the route), the entry's median wall
less the other layers' median spans."""

from perfbench.roofline import share_pct


def read(ctx: dict):
    return share_pct(ctx, "induction")
