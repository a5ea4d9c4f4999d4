"""A short ``torch.profiler`` window over whole pricings, read from its trace.

Each pricing runs inside a ``perfbench.pricing`` annotation and ends with
its values on the host, so every device operation it launched has ended
inside it. From the trace: the window (first annotation's start to the last
one's end), the seconds in which a kernel, copy or fill ran (the union of
their intervals), the device operations of each pricing (matched to the
pricing by their launch), the operations that took most time, and the idle
gaps named by the innermost host operation running under each gap.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST = ("cpu_op", "cuda_runtime", "cuda_driver")
MARK = "perfbench.pricing"


def profile(price, seeds, cuda: bool):
    """Run ``price(seed)`` for each seed under the profiler; returns
    ``(outputs, summary)`` (see :func:`summarize`)."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    outs = []
    with torch.profiler.profile(activities=acts) as prof:
        for s in seeds:
            with record_function(MARK):
                outs.append(price(s))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return outs, summarize(events)


def _span(e):
    return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _top(totals: dict, n: int = 10):
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def _under(starts, spans, t, reach: int = 2000):
    """The innermost host operation running at ``t``: of those that cover it,
    the one that started last (the operations of one thread nest)."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 1 - reach, -1), -1):
        (s0, s1), name = spans[j]
        if s1 >= t:
            return name
    return "host: outside any operation"


def summarize(events: list) -> dict:
    """``busy_s``, ``window_s``, ``ops_per_pricing`` (device operations of each
    pricing), ``device_ops`` and ``idle_gaps`` (name, seconds; at most 10)."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    mark_events = [e for e in xs if e.get("name") == MARK and e.get("cat") == "user_annotation"]
    marks = sorted(_span(e) for e in mark_events)
    if not marks:
        return {"busy_s": 0.0, "window_s": 0.0, "ops_per_pricing": [], "device_ops": [],
                "idle_gaps": []}
    w0, w1 = marks[0][0], marks[-1][1]
    main = {e.get("tid") for e in mark_events}
    host = [e for e in xs if e.get("cat") in _HOST]
    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in host
                 if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    counts = [0] * len(marks)
    starts = [m[0] for m in marks]
    totals, busy = {}, []
    for e in (e for e in xs if e.get("cat") in _DEVICE):
        a, b = _span(e)
        at = launch_ts.get(e.get("args", {}).get("correlation"), a)
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and at <= marks[i][1]:
            counts[i] += 1
        totals[e["name"]] = totals.get(e["name"], 0.0) + (b - a) * 1e-6
        a, b = max(a, w0), min(b, w1)
        if b > a:
            busy.append((a, b))
    merged = _merge(busy)
    gaps, prev = [], w0
    for a, b in merged + [[w1, w1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    host_spans = sorted((_span(e), e["name"]) for e in host if e.get("tid") in main)
    host_starts = [s[0][0] for s in host_spans]
    idle = {}
    for a, b in gaps:
        name = _under(host_starts, host_spans, 0.5 * (a + b))
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
    return {"busy_s": sum(b - a for a, b in merged) * 1e-6, "window_s": (w1 - w0) * 1e-6,
            "ops_per_pricing": counts, "device_ops": _top(totals), "idle_gaps": _top(idle)}
