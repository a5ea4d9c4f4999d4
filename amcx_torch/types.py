"""Configuration dataclasses for the PyTorch port of the amcx engine.

Same fields, defaults and validation as `amcx.types`; plain frozen
dataclasses (PyTorch runs eagerly, so there is no pytree registration and
no static/dynamic split). ``SimConfig.backend`` names the port's path
simulators: ``"torch"`` (``torch.randn`` driven by a ``torch.Generator``,
the counterpart of amcx's ``"xla"``), ``"philox"`` (the counter-based
Philox4x32-10 pathgen of `amcx_torch.ops.gbm`, the counterpart of amcx's
``"pallas"``), and ``"sobol"`` / ``"sobol-bridge"`` (scrambled-Sobol points
through `amcx_torch.ops.sobol_pallas`, one dimension a step or in
Brownian-bridge order: amcx's ``price --qmc [--brownian-bridge]``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = [
    "MarketParams",
    "ProductSpec",
    "RegressionSpec",
    "SimConfig",
    "OptionType",
    "ExerciseType",
]

BACKENDS = ("torch", "philox", "sobol", "sobol-bridge")
SOBOL_BACKENDS = ("sobol", "sobol-bridge")
SOBOL_LANES = 512  # paths per column of the Sobol kernel's tables: the low 9 bits of a path
# the dense bridge matrix the Sobol kernel's plain version sums (and its f64
# host builder) stays small: 4 MB of f32 at the cap
BRIDGE_MAX_STEPS = 1024


def check_sobol_grid(n_steps: int, n_paths: int, bridge: bool, who: str) -> None:
    """Raise where the Sobol pathgen cannot draw the grid: ``n_paths`` a
    multiple of :data:`SOBOL_LANES` in [512, 2^30] (the period of scipy's
    30-bit points) and, in bridge order, at most :data:`BRIDGE_MAX_STEPS`
    steps. ``who`` begins the message."""
    if n_steps < 1:
        raise ValueError(f"{who} takes n_steps >= 1, got {n_steps}")
    if n_paths % SOBOL_LANES or not SOBOL_LANES <= n_paths <= 2 ** 30:
        raise ValueError(f"{who} takes n_paths a multiple of {SOBOL_LANES} in "
                         f"[{SOBOL_LANES}, 2^30], got {n_paths}")
    if bridge and n_steps > BRIDGE_MAX_STEPS:
        raise ValueError(f"{who} takes at most {BRIDGE_MAX_STEPS} steps in bridge order, "
                         f"got {n_steps}")

OptionType = str  # "put" | "call"
ExerciseType = str  # "european" | "american"


def _norm(s: str) -> str:
    return s.strip().lower()


@dataclasses.dataclass(frozen=True)
class MarketParams:
    """Black-Scholes market: spot, rate, vol, continuous dividend yield."""

    S0: float
    r: float
    sigma: float
    q: float = 0.0

    def astuple(self):
        return (self.S0, self.r, self.sigma, self.q)


@dataclasses.dataclass(frozen=True)
class ProductSpec:
    """Option product identity: strike, maturity, optional barrier level,
    put/call, European/American, and the knock variant of the barrier."""

    K: float
    T: float
    barrier: Optional[float] = None
    option_type: str = "put"
    exercise: str = "european"
    barrier_type: str = "down-in"

    def __post_init__(self):
        object.__setattr__(self, "option_type", _norm(self.option_type))
        object.__setattr__(self, "exercise", _norm(self.exercise))
        object.__setattr__(self, "barrier_type", _norm(self.barrier_type))
        if self.option_type not in ("put", "call"):
            raise ValueError(f"option_type must be 'put' or 'call', got {self.option_type!r}")
        if self.exercise not in ("european", "american"):
            raise ValueError(f"exercise must be 'european' or 'american', got {self.exercise!r}")
        if self.barrier_type not in ("down-in", "up-in", "down-out", "up-out"):
            raise ValueError(
                f"barrier_type must be one of down-in/up-in/down-out/up-out, "
                f"got {self.barrier_type!r}"
            )

    @property
    def is_american(self) -> bool:
        return self.exercise == "american"

    @property
    def has_barrier(self) -> bool:
        return self.barrier is not None


@dataclasses.dataclass(frozen=True)
class RegressionSpec:
    """Continuation-value regression configuration.

    ``regress_on``: ``"auto"`` (resolved per product by
    `amcx_torch.engine.resolve_regression_spec`), ``"all"`` (fit on every
    path) or ``"itm"`` (weight the fit by the in-the-money indicator).
    ``internal_standardize`` builds the design matrix on a standardized
    regressor (same polynomial span, f32 conditioning). ``rcond`` is the
    relative eigenvalue cutoff of the pseudo-inverse solve.
    """

    basis: str = "chebyshev"
    degree: int = 4
    scaling: bool = False
    scaling_factor: float = 2.0
    regress_on: str = "auto"
    internal_standardize: bool = True
    rcond: float = 1e-6

    def __post_init__(self):
        object.__setattr__(self, "basis", _norm(self.basis))
        object.__setattr__(self, "regress_on", _norm(self.regress_on))
        if self.regress_on not in ("auto", "all", "itm"):
            raise ValueError(
                f"regress_on must be 'auto', 'all' or 'itm', got {self.regress_on!r}")
        if self.degree < 0:
            raise ValueError("degree must be >= 0")

    @property
    def n_basis(self) -> int:
        return self.degree + 1


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Path simulation configuration.

    ``antithetic`` pairs path i with path i + n_paths/2 (negated normals).
    ``backend``: ``"torch"`` (``torch.randn``), ``"philox"`` (the
    counter-based CUDA pathgen kernel; its plain version on the CPU), or
    ``"sobol"`` / ``"sobol-bridge"`` (the scrambled-Sobol kernel in
    increment or Brownian-bridge order, a new scramble per seed; float32,
    no antithetic mirror, ``n_paths`` a multiple of 512 up to 2³⁰, and in
    bridge order at most ``BRIDGE_MAX_STEPS`` steps).
    """

    n_paths: int = 100_000
    n_steps: int = 50
    dtype: str = "float32"
    antithetic: bool = False
    backend: str = "torch"  # "torch" | "philox" | "sobol" | "sobol-bridge"

    def __post_init__(self):
        if self.n_paths < 1 or self.n_steps < 1:
            raise ValueError(
                f"n_paths and n_steps must be >= 1, got {self.n_paths}, {self.n_steps}"
            )
        if self.antithetic and self.n_paths % 2 != 0:
            raise ValueError("antithetic sampling requires an even n_paths")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {', '.join(map(repr, BACKENDS))}, "
                             f"got {self.backend!r}")
        if self.backend in SOBOL_BACKENDS:
            self._check_sobol()

    def _check_sobol(self):
        who = f"backend {self.backend!r}"
        if self.dtype != "float32":
            raise ValueError(f"{who} emits float32 paths, got {self.dtype!r}")
        if self.antithetic:
            raise ValueError(f"{who}: scrambled-Sobol points have no antithetic mirror; "
                             "use antithetic=False")
        check_sobol_grid(self.n_steps, self.n_paths, self.backend == "sobol-bridge", who)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)
