"""amcx_torch: the PyTorch/CUDA port of amcx (American Monte Carlo, LSMC).

Plain functions on tensors with an explicit ``device`` and explicit
randomness (an integer ``seed``, or a ``torch.Generator`` for the
``torch.randn`` simulator). The kernels of `amcx_torch.ops` are written by
hand for Hopper; importing this package neither initialises CUDA nor
builds them.
"""

from .basis import BASIS_FAMILIES, design_matrix
from .engine import (
    LSMCResult,
    backward_induction,
    lsmc_option_pricing,
    price_option,
    resolve_regression_spec,
)
from .interop import config_from_jax, tensor_from_numpy
from .oracle import bs_price, crr_price, norm_cdf
from .paths import brownian_normals, gbm_standardization, simulate_gbm, to_path_major
from .payoff import (
    barrier_gate,
    barrier_knocked,
    exercise_allow_row,
    intrinsic_value,
    payoff_fn_for,
)
from .regress import (
    fit_continuation,
    fit_continuation_with_coeffs,
    pinv_solve,
    regression_fitted_values,
    weighted_standardize,
)
from .types import MarketParams, ProductSpec, RegressionSpec, SimConfig

__all__ = [
    "BASIS_FAMILIES",
    "LSMCResult",
    "MarketParams",
    "ProductSpec",
    "RegressionSpec",
    "SimConfig",
    "backward_induction",
    "barrier_gate",
    "barrier_knocked",
    "brownian_normals",
    "bs_price",
    "config_from_jax",
    "crr_price",
    "design_matrix",
    "exercise_allow_row",
    "fit_continuation",
    "fit_continuation_with_coeffs",
    "gbm_standardization",
    "intrinsic_value",
    "lsmc_option_pricing",
    "norm_cdf",
    "payoff_fn_for",
    "pinv_solve",
    "price_option",
    "regression_fitted_values",
    "resolve_regression_spec",
    "simulate_gbm",
    "tensor_from_numpy",
    "to_path_major",
    "weighted_standardize",
]
