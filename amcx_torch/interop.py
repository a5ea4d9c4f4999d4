"""Carry amcx state across to the port.

amcx has no weights: its state is configuration dataclasses, time-major
path arrays, per-step standardization rows and coefficient exports. This
module maps amcx configurations to the port's by reading fields by name
(duck-typed: it never imports jax or amcx) and turns numpy arrays into
tensors on a device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .types import MarketParams, ProductSpec, RegressionSpec, SimConfig

__all__ = ["config_from_jax", "tensor_from_numpy"]

_CLASSES = {cls.__name__: cls for cls in (MarketParams, ProductSpec, RegressionSpec, SimConfig)}
_BACKENDS = {"xla": "torch", "pallas": "philox"}


def _plain(value):
    """A field value as a Python scalar: 0-d arrays of any framework
    convert through ``float``; strings, bools, ints and None pass."""
    if value is None or isinstance(value, (str, bool, int, float)):
        return value
    shape = getattr(value, "shape", None)
    if shape == () or shape == (1,):
        return float(np.asarray(value).reshape(()))
    raise NotImplementedError(
        f"array-valued field {value!r}: per-step curves are not ported yet (ROADMAP A9)")


def config_from_jax(obj):
    """The port's counterpart of an amcx ``MarketParams``, ``ProductSpec``,
    ``RegressionSpec`` or ``SimConfig`` (matched by class name, fields read
    by name; the ``"xla"``/``"pallas"`` backends map to
    ``"torch"``/``"philox"``)."""
    cls = _CLASSES.get(type(obj).__name__)
    if cls is None or not dataclasses.is_dataclass(obj):
        raise TypeError(f"no amcx_torch counterpart for {type(obj).__name__}")
    kwargs = {f.name: _plain(getattr(obj, f.name)) for f in dataclasses.fields(cls)}
    if cls is SimConfig:
        kwargs["backend"] = _BACKENDS[kwargs["backend"]]
    return cls(**kwargs)


def tensor_from_numpy(arr, device="cuda") -> torch.Tensor:
    """A contiguous tensor copy of ``arr`` (paths, ``mean_t``/``inv_std_t``
    rows, ``(n_steps+1, k)`` coefficient arrays) on ``device`` (the card
    unless the caller asks for ``"cpu"``), dtype kept."""
    return torch.from_numpy(np.array(arr, order="C", copy=True)).to(device)
