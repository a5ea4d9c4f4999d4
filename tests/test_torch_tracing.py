"""`amcx_torch.tracing`: spans off and on, the span tree of each benchmark
entry, the same bits with tracing on and off, exceptions, the cap, threads,
and the spans as annotations in a CPU profiler's trace.

Everything runs on the CPU at small sizes (8,192 paths).
"""

import json
import sys
import threading

import pytest
import torch

import amcx_torch as at
from amcx_torch import tracing

PUT = (at.MarketParams(S0=100.0, r=0.01, sigma=0.2),
       at.ProductSpec(K=100.0, T=1.0, option_type="put", exercise="american"),
       at.RegressionSpec(basis="chebyshev", degree=4),
       at.SimConfig(n_paths=8192, n_steps=16, backend="philox"))

ENTRIES = {
    "put-mega": lambda: at.price_option(7, *PUT, engine="mega", device="cpu"),
    "put-fusedpath": lambda: at.price_option(7, *PUT, engine="fusedpath", device="cpu"),
    "maxcall-mega": lambda: at.price_max_call(7, [100.0] * 5, 100.0, 3.0, 0.05, 0.2, q=0.1,
                                              n_exercise_dates=9, n_paths=8192,
                                              engine="mega", device="cpu"),
}

# (span, its parent's name) of one pricing; the root's parent is None
TREES = {
    "put-mega": {("entry", None), ("entry.frame", "entry"), ("pathgen", "entry"),
                 ("induction", "entry"), ("induction.prepare", "induction")},
    "put-fusedpath": {("entry", None), ("induction", "entry"),
                      ("induction.prepare", "induction")},
    "maxcall-mega": {("entry", None), ("pathgen", "entry"), ("induction", "entry"),
                     ("induction.prepare", "induction")},
}
ROOT_ATTRS = {"put-mega": dict(engine="mega", n_paths=8192, n_steps=16),
              "put-fusedpath": dict(engine="fusedpath", n_paths=8192, n_steps=16),
              "maxcall-mega": dict(engine="mega", n_paths=8192, n_steps=9)}


@pytest.fixture(autouse=True)
def _empty_store():
    assert tracing.span("a") is tracing.span("b")  # off between tests
    tracing.drain()
    yield
    tracing.drain()


@pytest.fixture(scope="module")
def priced():
    """Each entry priced once with tracing off and once on: (off, on, spans)."""
    out = {}
    for name, price in ENTRIES.items():
        tracing.drain()
        off = price()
        with tracing.recording():
            on = price()
        out[name] = (off, on, tracing.drain())
    return out


def test_off_records_nothing_and_returns_the_shared_noop():
    assert tracing.span("entry") is tracing.span("pathgen", n_paths=1)
    with tracing.span("entry") as s:
        assert s is None
    ENTRIES["put-fusedpath"]()
    assert tracing.drain() == []
    tracing.enable()
    try:
        assert tracing.span("entry") is not tracing.span("entry")
    finally:
        tracing.disable()
    assert tracing.span("entry") is tracing.span("pathgen")


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_one_pricing_gives_the_layer_span_tree(priced, entry):
    spans = priced[entry][2]
    by_id = {s.id: s for s in spans}
    edges = {(s.name, None if s.parent is None else by_id[s.parent].name) for s in spans}
    assert edges == TREES[entry] and len(spans) == len(TREES[entry])
    (root,) = [s for s in spans if s.parent is None]
    assert {s.pricing for s in spans} == {root.id}
    assert root.attrs == ROOT_ATTRS[entry]
    for s in spans:  # a child lies inside its parent
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_tracing_leaves_price_and_stderr_bits(priced, entry):
    off, on, _ = priced[entry]
    for a, b in ((off.price, on.price), (off.stderr, on.stderr)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("where", ["nested spans", "the entry"])
def test_an_exception_closes_the_spans_it_passes(where):
    with tracing.recording():
        if where == "nested spans":
            with pytest.raises(KeyError):
                with tracing.span("entry"):
                    with tracing.span("induction"):
                        raise KeyError("x")
            expect = {"induction": "KeyError", "entry": "KeyError"}
        else:
            with pytest.raises(ValueError):
                at.price_option(7, *PUT, engine="no-such-engine", device="cpu")
            expect = {"entry": "ValueError"}
        with tracing.span("after"):
            pass
    spans = tracing.drain()
    assert {s.name: s.attrs.get("error") for s in spans[:-1]} == expect
    after = spans[-1]
    assert after.name == "after" and after.parent is None and after.pricing == after.id


def test_the_cap_counts_dropped_spans(monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 3)
    before = tracing.dropped()
    with tracing.recording():
        for i in range(5):
            with tracing.span("entry", i=i):
                pass
    assert [s.attrs["i"] for s in tracing.drain()] == [0, 1, 2]
    assert tracing.dropped() - before == 2


def test_concurrent_callers_keep_their_own_trees():
    n_threads, n_pricings = 16, 200
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for _ in range(n_pricings):
                with tracing.span("entry", caller=k):
                    with tracing.span("pathgen", caller=k):
                        pass

        with tracing.recording():
            threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    spans = tracing.drain()
    assert len(spans) == 2 * n_threads * n_pricings
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        if s.name == "pathgen":
            root = by_id[s.parent]
            assert root.name == "entry" and root.parent is None
            assert s.pricing == root.id and root.attrs["caller"] == s.attrs["caller"]


def test_spans_are_profiler_annotations_around_their_ops(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    sim = at.SimConfig(n_paths=4096, n_steps=8)
    with tracing.recording(), profile(activities=[ProfilerActivity.CPU]) as prof:
        at.simulate_gbm(3, PUT[0], 1.0, sim, device="cpu")
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
              if e.get("ph") == "X"]
    (note,) = [e for e in events
               if e.get("cat") == "user_annotation" and e["name"] == tracing.PREFIX + "pathgen"]
    a0, a1 = note["ts"], note["ts"] + note["dur"]
    ops = [e for e in events if e.get("cat") == "cpu_op" and e["name"].startswith("aten::")]
    assert ops and all(a0 <= e["ts"] and e["ts"] + e["dur"] <= a1 for e in ops)
    assert [s.name for s in tracing.drain()] == ["pathgen"]
