"""The program-span phase (``perfbench/spans.py``) and its five readers: the
attribution on a synthetic Chrome trace, self times by layer, nothing to
read on an empty ``ctx`` or without the program's tracing, and the phase
itself on the CPU at a small size."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
from perfbench import run, spans, trace  # noqa: E402
from perfbench.roofline import bound_s  # noqa: E402

sys.path.remove(str(ROOT))

NEW = ["entry.self_ms", "entry.host_waits", "entry.idle_pct", "pathgen.device_roofline_pct",
       "induction.device_roofline_pct"]
MAIN = 1


def _reader(metric: str):
    return run.Cell.reader(None, metric)  # a reader depends on nothing of the cell


def _x(cat, name, ts, dur, corr=None, tid=MAIN):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 0}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _pricing(t0: float, c0: int) -> list:
    """One pricing of 100 µs from ``t0``: the entry's frame (no device work),
    a pathgen kernel, the induction's prepare (a pageable copy, a
    synchronise, a device-to-device copy) and kernel, then the benchmark's
    own copy to the host and its synchronise."""
    note = "user_annotation"
    return [
        _x(note, trace.MARK, t0, 100),
        _x(note, "amcx.entry", t0 + 5, 85),
        _x(note, "amcx.entry.frame", t0 + 6, 14),
        _x("cpu_op", "aten::arange", t0 + 7, 3),
        _x(note, "amcx.pathgen", t0 + 21, 3),
        _x("cuda_runtime", "cudaLaunchKernel", t0 + 22, 1, c0),
        _x("kernel", "gbm_kernel", t0 + 25, 20, c0, tid=7),
        _x(note, "amcx.induction", t0 + 46, 42),
        _x(note, "amcx.induction.prepare", t0 + 47, 8),
        _x("cuda_runtime", "cudaMemcpyAsync", t0 + 48, 1, c0 + 1),
        _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", t0 + 48.5, 0.5, c0 + 1, tid=7),
        _x("cuda_runtime", "cudaStreamSynchronize", t0 + 50, 2),
        _x("cuda_runtime", "cudaMemcpyAsync", t0 + 53, 0.5, c0 + 2),
        _x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", t0 + 53, 1, c0 + 2, tid=7),
        _x("cuda_runtime", "cudaLaunchKernel", t0 + 56, 1, c0 + 3),
        _x("kernel", "mega_kernel", t0 + 57, 28, c0 + 3, tid=7),
        _x("cuda_runtime", "cudaMemcpyAsync", t0 + 92, 1, c0 + 4),
        _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", t0 + 93, 1, c0 + 4, tid=7),
        _x("cuda_runtime", "cudaStreamSynchronize", t0 + 95, 1),
    ]


EVENTS = _pricing(0.0, 10) + _pricing(100.0, 20)
WORK = {"pathgen": {"bytes": 1e6}, "induction": {"bytes": 2e6}}


def _ctx():
    return {"trace": trace.summarize(EVENTS), "work": WORK,
            "program": {"trace": spans.attribute(EVENTS, "amcx."), "self_s": [
                {"entry": 4e-5, "pathgen": 1e-5}, {"entry": 6e-5}, {"entry": 5e-5}]}}


def test_attribution_by_innermost_program_span():
    got = spans.attribute(EVENTS, "amcx.")
    us = 1e-6
    assert got["window_s"] == pytest.approx(200 * us)
    assert got["names"] == ["entry", "entry.frame", "induction", "induction.prepare", "pathgen"]
    dev = got["device_s"]
    assert dev["pathgen"] == pytest.approx([20 * us] * 2)  # a kernel launched under pathgen
    assert dev["induction"] == pytest.approx([28 * us] * 2)
    assert dev["induction.prepare"] == pytest.approx([1.5 * us] * 2)
    assert dev[spans.OUTSIDE] == pytest.approx([1 * us] * 2)  # the benchmark's to_host
    assert got["outside_ops"] == {"Memcpy DtoH (Device -> Pageable)": 2}
    # idle gaps by midpoint: before each pathgen kernel under entry.frame (the
    # second from the first pricing's copy on), after the induction's kernel
    # under entry, after the last copy outside
    idle = got["idle_s"]
    assert idle["entry.frame"] == pytest.approx(25 * us + 31 * us)
    assert idle["entry"] == pytest.approx(2 * 8 * us)
    assert idle["induction.prepare"] == pytest.approx(2 * 4 * us)
    assert idle["induction"] == pytest.approx(2 * (3.5 + 3) * us)
    assert idle[spans.OUTSIDE] == pytest.approx(6 * us)
    assert sum(idle.values()) == pytest.approx(200 * us - 2 * 50.5 * us)
    # the pageable copy and the synchronise under induction.prepare are the
    # entry's host waits; the device-to-device copy is none; to_host's are
    # outside the entry
    assert got["entry_waits"] == [2, 2]
    assert got["waits"] == {"induction.prepare": 4, spans.OUTSIDE: 4}


def test_summarize_reads_the_same_with_and_without_program_spans():
    bare = [e for e in EVENTS if not e["name"].startswith("amcx.")]
    assert trace.summarize(EVENTS) == trace.summarize(bare)


def test_self_times_leave_out_other_layers_inside():
    from amcx_torch.tracing import Span

    tree = [Span("entry.frame", 2, 1, 1, 10, 20, {}), Span("pathgen", 3, 1, 1, 20, 50, {}),
            Span("induction.prepare", 5, 4, 1, 55, 60, {}), Span("induction", 4, 1, 1, 50, 90, {}),
            Span("entry", 1, None, 1, 0, 100, {})]
    (got,) = spans.self_times(tree)
    assert got == pytest.approx({"entry": 30e-9, "pathgen": 30e-9, "induction": 40e-9})


def test_readers_on_the_synthetic_trace():
    ctx = _ctx()
    read = {m: _reader(m)(ctx) for m in NEW}
    assert read["entry.self_ms"] == pytest.approx(5e-2)
    assert read["entry.host_waits"] == 2.0
    assert read["entry.idle_pct"] == pytest.approx(100 * (56 + 16) / 200)
    assert read["pathgen.device_roofline_pct"] == pytest.approx(
        100 * bound_s(WORK["pathgen"]) / 20e-6)
    assert read["induction.device_roofline_pct"] == pytest.approx(
        100 * bound_s(WORK["induction"]) / 29.5e-6)


@pytest.mark.parametrize("metric", NEW)
def test_each_reader_reads_nothing_on_an_empty_ctx(metric):
    assert _reader(metric)({}) is None


@pytest.mark.parametrize("metric", NEW)
def test_each_reader_reads_nothing_without_the_programs_tracing(metric, monkeypatch):
    monkeypatch.setattr(spans, "_tracing", lambda: None)
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload", "put-1M.mega", "--seed", "3"])
    ctx = {"trace": trace.summarize(EVENTS), "work": WORK}
    assert _reader(metric)(ctx) is None


def test_the_phase_on_the_cpu_from_the_command_line(monkeypatch):
    cell_of = run.Cell

    def small(manifest, name):
        cell = cell_of(manifest, name, {"n_paths": 4096, "n_steps": 4})
        cell.traffic = dict(cell.traffic, trace_pricings=3)
        return cell

    read_self, read_idle = _reader("entry.self_ms"), _reader("entry.idle_pct")
    monkeypatch.setattr(run, "Cell", small)
    monkeypatch.setattr(spans, "SELF_PRICINGS", 5)
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload", "put-1M.fusedpath", "--seed",
                                      str(2 ** 31 + 5), "--seconds", "0.1", "--trace", "1"])
    ctx = {"trace": {}, "work": {}}
    prog = spans.program(ctx)
    assert ctx["program"] is prog and prog["self_pricings"] >= 5
    assert all(set(p) == {"entry", "induction"} for p in prog["self_s"])
    assert prog["trace"]["window_s"] > 0 and prog["trace"]["entry_waits"] == [0, 0, 0]
    assert read_self(ctx) > 0
    t = prog["trace"]  # no idle gap need fall under the entry: then it reads 0, not nothing
    assert read_idle(ctx) == 100.0 * t["idle_s"].get("entry", 0.0) / t["window_s"]
