"""The numbers that decide ``correct``, each a gap between what the timed
path returned and the plain reference of the same pricing.

- ``price_gap``: |price - reference price| in units of the reference's
  standard error;
- ``stderr_gap``: |stderr - reference stderr| over the reference stderr.

A value that is not finite reads as an infinite gap.
"""

from __future__ import annotations

import math


def _gap(a: float, b: float, scale: float) -> float:
    if not (math.isfinite(a) and math.isfinite(b)) or not scale > 0:
        return math.inf
    return abs(a - b) / scale


def price_gaps(prog: dict, ref: dict) -> dict:
    return {"price_gap": _gap(prog["price"], ref["price"], ref["stderr"]),
            "stderr_gap": _gap(prog["stderr"], ref["stderr"], ref["stderr"])}


def judge(readings: list, limits: dict):
    """``(correct, numbers)``: each number is the largest reading over the
    compared pricings, beside its limit; correct when every one is within."""
    numbers = {}
    for name, limit in limits.items():
        vals = [r[name] for r in readings if name in r]
        value = max(vals) if vals else math.inf
        numbers[name] = {"value": value, "limit": limit}
    correct = bool(readings) and all(v["value"] <= v["limit"] for v in numbers.values())
    return correct, numbers
