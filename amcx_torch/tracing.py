"""Spans of a pricing: where its host time goes, layer by layer.

Tracing is off by default and is turned on for the process by
:func:`enable` / :func:`disable` or inside ``with recording():``. Off,
:func:`span` returns one shared no-op context manager: no clock read, no
allocation, no torch call. On, each span records its name, its start and
end (``time.perf_counter_ns``), its own id, its parent's id, the *pricing
id* (the id of its root span, shared by every span of one pricing) and its
attributes. The open span is kept in a ``contextvars.ContextVar``, so
threads and tasks that price at once never mix their trees. An exception
closes every span it passes through; the span's ``error`` attribute names
the exception's type. Spans are kept in memory until :func:`drain`; past
``CAP`` kept spans a closing span is dropped and counted (:func:`dropped`).

While a ``torch.profiler`` records, each span also opens a
``record_function`` annotation named ``PREFIX + name``, so the spans sit in
the profiler's trace, on its clock, around the operations and kernels they
launch. Outside a profiler no annotation is made.

The spans of the pricing entries, at the layer boundaries of ``PERF.md``:

========================  ==================================================
``entry`` (root)          ``price_option``, ``price_max_call``: the whole
                          call; attributes ``engine``, ``n_paths``,
                          ``n_steps``
``entry.frame``           ``price_option(engine="mega")``: the lookup of
                          the closed-form frame's kernel rows
                          (``closed_form_rows``; built on a new market or
                          grid only)
``pathgen``               ``simulate_gbm``, ``simulate_gbm_multi``
``pathgen.tables``        the Sobol backends' direction tables of a new
                          seed (`ops.sobol_pallas._device_tables`: on the
                          card the seed's PCG64 state on the host and one
                          launch of the table kernel, which replays the
                          scramble and writes both tables); a cached seed
                          opens none
``induction``             the induction entries the two entries call
                          (kernels 2, 6 and 7, the fused and the reference
                          engines), price and stderr included
``induction.prepare``     the induction's inputs before its launch (in
                          the mega put the argument checks; in
                          ``lsmc_price_megakernel`` also ``mega_stats``;
                          the max-call's ``prepare``; fusedpath's cached
                          rows and settings)
``analytics``             ``exposures_from_coeffs`` (in ``price_option``
                          with ``engine="mega"`` and ``surface_stats``):
                          the exposure kernel and the ``CCRExposures``
========================  ==================================================

A layer is a name's first dotted part; its self time is the time its spans
cover less the time covered by spans of other layers inside them.
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time
from contextlib import contextmanager
from typing import NamedTuple, Optional

import torch

__all__ = ["CAP", "PREFIX", "Span", "disable", "drain", "dropped", "enable", "recording",
           "span"]

PREFIX = "amcx."
CAP = 100_000


class Span(NamedTuple):
    """One closed span; times in ``time.perf_counter_ns`` nanoseconds."""

    name: str
    id: int
    parent: Optional[int]
    pricing: int
    start_ns: int
    end_ns: int
    attrs: dict


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_on = False
_open = contextvars.ContextVar("amcx_torch.tracing.open", default=None)  # (id, pricing id)
_lock = threading.Lock()
_ids = itertools.count(1)
_kept: list = []
_dropped = 0


class _Open:
    __slots__ = ("name", "attrs", "id", "parent", "pricing", "token", "note", "start")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        outer = _open.get()
        with _lock:
            self.id = next(_ids)
        self.parent, self.pricing = (None, self.id) if outer is None else outer
        self.token = _open.set((self.id, self.pricing))
        self.note = None
        if torch.autograd._profiler_enabled():
            from torch.autograd.profiler import record_function

            self.note = record_function(PREFIX + self.name)
            self.note.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, kind, value, tb):
        end = time.perf_counter_ns()
        if self.note is not None:
            self.note.__exit__(kind, value, tb)
        _open.reset(self.token)
        if kind is not None:
            self.attrs["error"] = kind.__name__
        _keep(Span(self.name, self.id, self.parent, self.pricing, self.start, end, self.attrs))
        return False


def _keep(s: Span) -> None:
    global _dropped
    with _lock:
        if len(_kept) < CAP:
            _kept.append(s)
        else:
            _dropped += 1


def span(name: str, **attrs):
    """A context manager that records ``name`` while tracing is on, else the
    shared no-op."""
    if not _on:
        return _OFF
    return _Open(name, attrs)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


@contextmanager
def recording():
    """Tracing on inside the block; as it was before, after it."""
    global _on
    was, _on = _on, True
    try:
        yield
    finally:
        _on = was


def drain() -> list:
    """The kept spans in the order they closed; the store is left empty."""
    with _lock:
        out = _kept[:]
        _kept.clear()
    return out


def dropped() -> int:
    """Spans dropped past ``CAP`` since the process started."""
    return _dropped
