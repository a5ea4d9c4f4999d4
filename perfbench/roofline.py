"""A layer's share of its roofline: the least time the card could take for
its work (the larger of its bytes over the memory rate and its operations
over the peak rates of their types), over the time the layer took."""

from __future__ import annotations

import functools
import json
from pathlib import Path


@functools.cache
def peaks() -> dict:
    """The card's published peaks (``peaks.json``)."""
    return json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def bound_s(work: dict, rates: dict | None = None) -> float:
    """Least seconds for ``work`` at ``rates`` (the card's peaks by default)."""
    rates = rates or peaks()
    t_bytes = work.get("bytes", 0) / rates["hbm_bytes_per_s"]
    t_ops = (work.get("f32", 0) / rates["f32_ops_per_s"]
             + work.get("f64", 0) / rates["f64_ops_per_s"])
    return max(t_bytes, t_ops)


def share_pct(ctx: dict, layer: str):
    """The layer's roofline share in percent, or None where the cell has no
    such layer or no positive span for it."""
    work, span = ctx["work"].get(layer), ctx["spans"].get(layer)
    if work is None or span is None or not span > 0:
        return None
    return 100.0 * bound_s(work) / span
