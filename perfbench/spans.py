"""The program's own spans (``amcx_torch.tracing``) in a ``--trace 1`` run.

``run.py`` hands a metric reader the traced run's ``ctx`` alone, so the
first reader of a program-span metric runs this phase itself, after the
run's profiled window and span phase (both with the program's tracing off),
and leaves its results in ``ctx["program"]`` for the others:

(a) a profiled window of ``trace_pricings`` pricings through the cell's
    entry with tracing on, profiled again while the device operations a
    pricing differ (``run.TRACE_ATTEMPTS`` windows at most), read by
    :func:`attribute`;
(b) at least 50 pricings, and at least a quarter of ``--seconds``, with
    tracing on and no profiler; their spans give each layer's self time a
    pricing (:func:`self_times`).

The cell, the seed and the seconds are read from the harness's command line
(``--workload <cell> --seed <n> --seconds <s>``). Where the program has no
``amcx_torch.tracing``, the phase does not run and every program-span
metric reads nothing. The idle seconds by innermost program span go to
stderr.

    python3 -m perfbench.spans --workload <cell> --seed <n> [--seconds <s>]

prints, for one cell on the card, tracing's cost (pricings a second with
tracing on against off, in alternating blocks in one process), whether one
pricing's price and stderr are the same bits with tracing on and off, and the
phase's readings, as one JSON line.
"""

from __future__ import annotations

import argparse
import bisect
import itertools
import json
import os
import statistics
import sys
import tempfile
import time

from perfbench import trace
from perfbench.roofline import bound_s

OUTSIDE = "outside the program"
SEED_OFFSET = 2 ** 41  # seeds no other window of the run reaches
SELF_PRICINGS = 50
COST_BLOCKS = 6  # blocks a side of the cost measurement
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def _tracing():
    """The program's tracing module, or None where the program has none."""
    try:
        from amcx_torch import tracing
    except ImportError:
        return None
    return tracing


def _innermost(starts, notes, t, reach: int = 64):
    """The innermost program span open at ``t``: of those that cover it, the
    one that started last (the spans of one thread nest)."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 1 - reach, -1), -1):
        (a, b), name = notes[j]
        if b >= t:
            return name
    return OUTSIDE


def attribute(events: list, prefix: str) -> dict | None:
    """Reads a profiled window of whole pricings (``trace.MARK`` annotations)
    whose program spans are annotations named ``prefix + span``. Each device
    operation goes to the innermost program span open on the main thread
    when it was launched, each idle gap to the one open at its midpoint, each
    host wait to the one open when it was called. A host wait is a
    synchronise of a stream, the device or an event, or a ``cudaMemcpy*``
    whose device copy is to or from pageable memory.

    Returns ``window_s``; ``names`` (the program spans seen); ``device_s``
    (span -> seconds in each pricing);
    ``idle_s`` (span -> seconds); ``entry_waits`` (host waits inside an
    ``entry`` span, any depth, in each pricing); ``waits`` (span -> count);
    ``outside_ops`` (device operations of pricings launched outside the
    program, name -> count). None without a pricing."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    mark_events = [e for e in xs
                   if e.get("name") == trace.MARK and e.get("cat") == "user_annotation"]
    marks = sorted(trace._span(e) for e in mark_events)
    if not marks:
        return None
    main = {e.get("tid") for e in mark_events}
    w0, w1 = marks[0][0], marks[-1][1]
    mark_starts = [m[0] for m in marks]

    def pricing(t):
        i = bisect.bisect_right(mark_starts, t) - 1
        return i if i >= 0 and t <= marks[i][1] else None

    notes = sorted((trace._span(e), e["name"][len(prefix):]) for e in xs
                   if e.get("cat") == "user_annotation" and e.get("tid") in main
                   and e["name"].startswith(prefix))
    starts = [n[0][0] for n in notes]
    entries = [span for span, name in notes if name == "entry"]
    entry_starts = [a for a, _ in entries]

    def in_entry(t):
        i = bisect.bisect_right(entry_starts, t) - 1
        return i >= 0 and t <= entries[i][1]

    host = [e for e in xs if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in host
                 if "correlation" in e.get("args", {})}
    device = [e for e in xs if e.get("cat") in trace._DEVICE]
    pageable = {e["args"]["correlation"] for e in device
                if e.get("cat") == "gpu_memcpy" and "Pageable" in e.get("name", "")
                and "correlation" in e.get("args", {})}

    device_s, outside_ops, busy = {}, {}, []
    for e in device:
        a, b = trace._span(e)
        at = launch_ts.get(e.get("args", {}).get("correlation"), a)
        i = pricing(at)
        if i is not None:
            name = _innermost(starts, notes, at)
            device_s.setdefault(name, [0.0] * len(marks))[i] += (b - a) * 1e-6
            if name == OUTSIDE:
                outside_ops[e["name"]] = outside_ops.get(e["name"], 0) + 1
        a, b = max(a, w0), min(b, w1)
        if b > a:
            busy.append((a, b))
    idle_s, prev = {}, w0
    for a, b in trace._merge(busy) + [[w1, w1]]:
        if a > prev:
            name = _innermost(starts, notes, 0.5 * (a + prev))
            idle_s[name] = idle_s.get(name, 0.0) + (a - prev) * 1e-6
        prev = max(prev, b)

    entry_waits, waits = [0] * len(marks), {}
    for e in host:
        if e.get("tid") not in main:
            continue
        name = e.get("name", "")
        if not (name in SYNCS or (name.startswith("cudaMemcpy")
                                  and e.get("args", {}).get("correlation") in pageable)):
            continue
        t = float(e["ts"])
        i = pricing(t)
        if i is None:
            continue
        span = _innermost(starts, notes, t)
        waits[span] = waits.get(span, 0) + 1
        if in_entry(t):
            entry_waits[i] += 1
    return {"window_s": (w1 - w0) * 1e-6, "names": sorted({name for _, name in notes}),
            "device_s": device_s, "idle_s": idle_s, "entry_waits": entry_waits,
            "waits": waits, "outside_ops": outside_ops}


def self_times(spans) -> list:
    """Each pricing's self seconds by layer (a span name's first dotted part):
    a span's time less its children's, summed over the layer's spans, so a
    layer's self time is the time its spans cover less that of other layers'
    spans inside them. One dict per pricing, in the order the roots closed."""
    children = {}
    for s in spans:
        if s.parent is not None:
            children[s.parent] = children.get(s.parent, 0) + s.end_ns - s.start_ns
    by_pricing = {}
    for s in spans:
        own = s.end_ns - s.start_ns - children.get(s.id, 0)
        layers = by_pricing.setdefault(s.pricing, {})
        layer = s.name.split(".")[0]
        layers[layer] = layers.get(layer, 0.0) + own * 1e-9
    roots = [s.id for s in spans if s.parent is None]
    return [by_pricing[r] for r in roots]


def device_roofline_pct(ctx: dict, layer: str):
    """``layer``'s least time by its counted work (``ctx["work"]``) over the
    median device seconds a profiled pricing of the operations launched
    under its spans, in %; None without the work, the spans or their time."""
    work, prog = ctx.get("work", {}).get(layer), program(ctx)
    if work is None or not prog or not prog["trace"]:
        return None
    rows = [v for k, v in prog["trace"]["device_s"].items() if k.split(".")[0] == layer]
    per_pricing = [sum(col) for col in zip(*rows)]
    if not per_pricing or not statistics.median(per_pricing) > 0:
        return None
    return 100.0 * bound_s(work) / statistics.median(per_pricing)


def _profile(tracing, price, seeds, cuda: bool) -> list:
    """The profiler's events over ``price(seed)`` for each seed, each inside
    a ``trace.MARK`` annotation, with the program's tracing on. A lead-in
    pricing of the first seed, outside any mark, runs first: late in a long
    traced run the card's record of the first kernel a profiler session
    launches can be missing (seen on the H100), as in the warm-up steps of
    ``torch.profiler.schedule``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with tracing.recording(), profile(activities=acts) as prof:
        price(seeds[0])
        for s in seeds:
            with record_function(trace.MARK):
                price(s)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def measure(route, seed: int, seconds: float, trace_pricings: int, cuda: bool) -> dict | None:
    """Phases (a) and (b) on ``route``: ``trace`` (:func:`attribute` of (a)),
    ``self_s`` (:func:`self_times` of (b)), ``self_pricings`` and ``span_ms``
    (each span's median ms in (b)); None where the program has no tracing."""
    tracing = _tracing()
    if tracing is None:
        return None
    from perfbench.run import TRACE_ATTEMPTS

    tracing.drain()
    for attempt in range(TRACE_ATTEMPTS):
        seeds = [seed + attempt * trace_pricings + i for i in range(trace_pricings)]
        events = _profile(tracing, route.price, seeds, cuda)
        counts = trace.summarize(events)["ops_per_pricing"]
        if not cuda or len(set(counts)) == 1:
            break
        print(f"traced window {attempt}: device operations a pricing differ {counts}; "
              "profiling again", file=sys.stderr)
    else:
        raise RuntimeError("the profiler recorded a different number of device operations "
                           f"for equal pricings in {TRACE_ATTEMPTS} traced windows")
    read = attribute(events, tracing.PREFIX)
    tracing.drain()
    s, n = seeds[-1] + 1, 0
    dropped = tracing.dropped()
    end = time.perf_counter() + seconds / 4
    with tracing.recording():
        while n < SELF_PRICINGS or time.perf_counter() < end:
            route.price(s + n)
            n += 1
    if tracing.dropped() != dropped:
        raise RuntimeError("the program dropped spans past its cap")
    kept, durations = tracing.drain(), {}
    for sp in kept:
        durations.setdefault(sp.name, []).append(sp.end_ns - sp.start_ns)
    return {"trace": read, "self_s": self_times(kept), "self_pricings": n,
            "span_ms": {k: 1e-6 * statistics.median(v) for k, v in durations.items()}}


def _report(program: dict | None) -> None:
    if program is None or program["trace"] is None:
        return
    for name, s in sorted(program["trace"]["idle_s"].items(), key=lambda kv: -kv[1]):
        print(f"program idle {name} {s!r} s", file=sys.stderr)
    for name, n in sorted(program["trace"]["outside_ops"].items()):
        print(f"program outside {name} {n} ops", file=sys.stderr)


def _command_line() -> dict | None:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float, default=20.0)
    args, _ = ap.parse_known_args(sys.argv[1:])
    if args.workload is None or args.seed is None or _tracing() is None:
        return None
    import torch

    from perfbench import run

    cell = run.Cell(run.load_manifest(), args.workload)
    cuda = torch.cuda.is_available()
    route = cell.route.Route(cell.config, torch.device("cuda", 0) if cuda else "cpu")
    out = measure(route, args.seed + SEED_OFFSET, args.seconds,
                  int(cell.traffic["trace_pricings"]), cuda)
    _report(out)
    return out


def program(ctx: dict) -> dict | None:
    """The phase's results for a traced run's ``ctx`` (run once, kept in
    ``ctx["program"]``); None outside a traced run or without the program's
    tracing."""
    if "trace" not in ctx:
        return None
    if "program" not in ctx:
        ctx["program"] = _command_line()
    return ctx["program"]


def _rate(price, seeds, seconds: float) -> float:
    start, n = time.perf_counter(), 0
    while n < 3 or time.perf_counter() - start < seconds:
        price(next(seeds))
        n += 1
    return n / (time.perf_counter() - start)


def _span_us(tracing, n: int = 100_000) -> float:
    """Host microseconds of one empty two-deep span pair's sites, per site."""
    start = time.perf_counter()
    for _ in range(n):
        with tracing.span("entry", engine="mega"):
            with tracing.span("pathgen"):
                pass
    us = 1e6 * (time.perf_counter() - start) / (2 * n)
    tracing.drain()
    return us


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    import torch

    from perfbench import run

    tracing = _tracing()
    if tracing is None or not torch.cuda.is_available():
        print("no result: needs a CUDA card and amcx_torch.tracing", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    cell = run.Cell(run.load_manifest(), args.workload)
    route = cell.route.Route(cell.config, torch.device("cuda", 0))
    for i in range(int(cell.traffic["warmup_pricings"])):
        route.price(run.WARM_SEED_OFFSET + args.seed + i)
    off = route.price(args.seed)
    with tracing.recording():
        on = route.price(args.seed)
    tracing.drain()
    seeds = itertools.count(args.seed)
    rates = {"off": [], "on": []}
    block = args.seconds / (2 * COST_BLOCKS)
    for b in range(COST_BLOCKS):  # off, on, on, off, ...
        for side in (("off", "on") if b % 2 == 0 else ("on", "off")):
            if side == "on":
                with tracing.recording():
                    rates[side].append(_rate(route.price, seeds, block))
                tracing.drain()
            else:
                rates[side].append(_rate(route.price, seeds, block))
    span_us = {"off": _span_us(tracing)}
    with tracing.recording():
        span_us["on"] = _span_us(tracing)
    prog = measure(route, args.seed + SEED_OFFSET, args.seconds,
                   int(cell.traffic["trace_pricings"]), True)
    _report(prog)
    t = prog["trace"]
    out = {"workload": args.workload, "device": run._device(True, cell.chips, 0),
           "same_bits": off == on, "off": off, "on": on, "pricings_per_s": rates,
           "cost_pct": 100.0 * (1.0 - statistics.median(rates["on"])
                                / statistics.median(rates["off"])),
           "self_ms": {k: 1e3 * statistics.median(p[k] for p in prog["self_s"] if k in p)
                       for k in ("entry", "pathgen", "induction") if k in prog["self_s"][0]},
           "span_us": span_us, "span_ms": prog["span_ms"],
           "device_ms": {k: 1e3 * statistics.median(v) for k, v in t["device_s"].items()},
           "idle_s": t["idle_s"], "window_s": t["window_s"], "waits": t["waits"],
           "entry_waits": t["entry_waits"], "outside_ops": t["outside_ops"]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
