"""Run one cell of ``BENCHMARK.json`` once and print one JSON line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the kernels' load or build, the cell's warm-up pricings)
is timed from the process's start. With ``--trace 0`` a closed loop of one
caller prices seeds ``seed``, ``seed + 1``, ... through the cell's entry for
``--seconds`` and reports the cell's end-to-end metrics; with ``--trace 1``
a short profiled window of whole pricings, then a span phase of
``--seconds`` that prices each seed through the entry and again through each
layer's public function, give the per-layer metrics (medians over the
phase). Either way a
sample of the window's pricings, drawn from the seed, is priced again by the
plain reference after the window, and ``correct`` says whether every
compared number is within its limit (``perfbench/limits/<cell>.json``).

A cell's configuration (``configs/<config>.json``), traffic mix
(``traffic/<traffic>.json``), route adapter and work count
(``routes/<kind>_<engine>.py``, ``work/<kind>_<engine>.py``), limits and
per-layer metric readers (``metrics/<metric>.py``) are files found by the
names in ``BENCHMARK.json``.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """The process's start on the monotonic clock (from /proc; else now)."""
    now = time.monotonic()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


_T0 = _process_start()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import random  # noqa: E402
import re  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

from perfbench import check, trace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "amcx")
WARM_SEED_OFFSET = 2 ** 40  # warm-up pricings draw seeds no window reaches
TRACE_ATTEMPTS = 4


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _module_from_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


class Cell:
    """One entry of ``workloads`` and every file it names."""

    def __init__(self, manifest: dict, name: str, overrides: dict | None = None):
        entries = {w["name"]: w for w in manifest["workloads"]}
        if name not in entries:
            raise SystemExit(f"unknown workload {name!r}; cells: {sorted(entries)}")
        w = entries[name]
        self.name, self.chips = name, int(w["chips"])
        self.config = json.loads((HERE / "configs" / f"{w['config']}.json").read_text())
        self.config.update(overrides or {})
        self.traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
        route = f"{self.config['product']['kind']}_{self.traffic['engine']}"
        self.route = importlib.import_module(f"perfbench.routes.{route}")
        self.work = importlib.import_module(f"perfbench.work.{route}").work(self.config)
        self.limits = json.loads((HERE / "limits" / f"{name}.json").read_text())["limits"]
        self.end_to_end = [m for m in manifest["end_to_end"] if _applies(m, name, {m["name"]})]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in manifest["per_layer"] if _applies(m, name, reported)]

    def reader(self, metric: str):
        safe = re.sub(r"\W", "_", metric)
        return _module_from_file(HERE / "metrics" / f"{metric}.py",
                                 f"perfbench.metrics.{safe}").read


def percentile(values: list, q: float) -> float:
    """Linear-interpolation percentile ``q`` (0-100) of ``values``."""
    v = sorted(values)
    pos = q / 100.0 * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (pos - lo) * (v[hi] - v[lo])


def _forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _price(route, seed: int, failures: list):
    try:
        return route.price(seed)
    except Exception:  # a pricing that raises is counted and the loop goes on
        failures.append(seed)
        traceback.print_exc(file=sys.stderr)
        return None


def _window(route, seed: int, seconds: float, failures: list):
    """The closed loop: pricings of seeds ``seed``, ``seed + 1``, ... until
    ``seconds`` have passed; ``(outputs by seed, latencies, window seconds)``."""
    outputs, lat = {}, []
    start = time.perf_counter()
    end = start + seconds
    while True:
        a = time.perf_counter()
        outputs[seed + len(lat)] = _price(route, seed + len(lat), failures)
        b = time.perf_counter()
        lat.append(b - a)
        if b >= end:
            return outputs, lat, b - start


def _traced(cell: Cell, route, seed: int, seconds: float, cuda: bool, failures: list):
    """The profiled window, then the span phase; ``(outputs, ctx)``."""
    n = int(cell.traffic["trace_pricings"])
    for attempt in range(TRACE_ATTEMPTS):
        seeds = [seed + attempt * n + i for i in range(n)]
        outs, summary = trace.profile(route.price, seeds, cuda)
        if not cuda or len(set(summary["ops_per_pricing"])) == 1:
            break
        print(f"profiled window {attempt}: device operations a pricing differ "
              f"{summary['ops_per_pricing']}; profiling again", file=sys.stderr)
    else:
        raise RuntimeError("the profiler recorded a different number of device operations "
                           f"for equal pricings in {TRACE_ATTEMPTS} windows")
    outputs = dict(zip(seeds, outs))
    walls, spans = [], {}
    s = seeds[-1] + 1
    end = time.perf_counter() + seconds
    while len(walls) < 3 or time.perf_counter() < end:
        a = time.perf_counter()
        outputs[s] = _price(route, s, failures)
        walls.append(time.perf_counter() - a)
        for k, v in route.layers(s).items():
            spans.setdefault(k, []).append(v)
        s += 1
    spans = {k: statistics.median(v) for k, v in spans.items()}
    entry_s = statistics.median(walls)
    host_s = entry_s - sum(spans.values())
    if cell.route.REST:  # the layer no public function runs alone: the entry's remainder
        spans[cell.route.REST], host_s = host_s, None
    ctx = {"spans": spans, "entry_s": entry_s, "entry_host_s": host_s, "work": cell.work,
           "trace": summary, "span_pricings": len(walls)}
    return outputs, ctx


def _device(cuda: bool, chips: int, peak: int) -> dict:
    import torch

    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
           "memory_peak_bytes": peak}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20, check=True)
        dev["power_limit"] = smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        dev["power_limit"] = "not read"
    return dev


def _finite(x):
    """JSON has no infinity: a non-finite number is written as null."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device, t0: float):
    """One run of ``cell``; returns ``(result, check numbers)``. Raises where
    the run cannot report (a profile that drops events; a module of JAX or of
    the JAX package loaded by the time the result is ready)."""
    import torch

    device = torch.device(device)
    cuda = device.type == "cuda"
    route = cell.route.Route(cell.config, device)
    failures = []
    warm = WARM_SEED_OFFSET + seed
    for i in range(int(cell.traffic["warmup_pricings"])):
        route.price(warm + i)
    if traced:
        route.layers(warm)
        trace.profile(route.price, [warm], cuda)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.monotonic() - t0

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    if traced:
        outputs, ctx = _traced(cell, route, seed, seconds, cuda, failures)
    else:
        outputs, lat, window_s = _window(route, seed, seconds, failures)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    if traced:
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"pricings_per_s": len(lat) / window_s,
               "pricing_ms_p95": 1e3 * percentile(lat, 95.0),
               "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = _device(cuda, cell.chips, peak)

    # the reference runs once the window has closed and its peak is read
    done = sorted(s for s, out in outputs.items() if out is not None)
    k = min(int(cell.traffic["check_pricings"]), len(done))
    sample = sorted(random.Random(seed).sample(done, k))
    if cuda:
        torch.cuda.empty_cache()
    readings = [route.judge(s, outputs[s]) for s in sample]
    correct, numbers = check.judge(readings, cell.limits)
    result = {"correct": bool(correct and not failures), "attempted": len(outputs),
              "failed": len(failures), "metrics": metrics, "device": dev}
    if traced:
        tr = ctx["trace"]
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["check"] = numbers
    found = _forbidden_modules()  # last: whatever the run loaded, the reference included
    if found:
        raise RuntimeError(f"modules of JAX or of the JAX package are loaded: {found}")
    return result, numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(load_manifest(), args.workload)

    import torch

    torch.set_num_threads(1)  # one process, one compute thread: steadier host timings
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"no result: the cell needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        result, numbers = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                   torch.device("cuda", 0), _T0)
    except RuntimeError as err:
        print(f"no result: {err}", file=sys.stderr)
        return 3
    for name, n in numbers.items():
        print(f"check {name} {n['value']!r} limit {n['limit']!r}", file=sys.stderr)
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
