"""amcx_torch: the PyTorch/CUDA port of amcx (American Monte Carlo, LSMC).

Plain functions on tensors with an explicit ``device`` (the card,
``"cuda"``, unless the caller asks for ``"cpu"``) and explicit randomness
(an integer ``seed``, or a ``torch.Generator`` for the ``torch.randn``
simulator). The kernels of `amcx_torch.ops` are written by
hand for Hopper; importing this package neither initialises CUDA nor
builds them.
"""

from .basis import BASIS_FAMILIES, design_matrix, multi_asset_design_matrix, n_multi_terms
from .book import BookResult, book_ccr_exposures, book_greeks, price_mixed_book, price_strike_grid
from .engine import (
    LSMCResult,
    backward_induction,
    lsmc_option_pricing,
    price_option,
    resolve_regression_spec,
)
from .engine_pallas import (
    backward_induction_fused,
    lsmc_option_pricing_fused,
    precompute_standardization,
)
from .exposures import (
    CCRExposures,
    bilateral_cva,
    compute_ccr_exposures,
    cva_from_epe,
    exposures_from_coeffs,
)
from .greeks import fast_greeks, fused_price_diff, gamma_fd, price_and_greeks
from .interop import config_from_jax, tensor_from_numpy
from .models.maxcall import (
    backward_induction_fused_maxcall,
    max_call_greeks,
    maxcall_standardization,
    price_max_call,
    reprice_max_call_with_coeffs,
)
from .oracle import (
    barrier_price,
    bs_greeks,
    bs_price,
    crr_barrier_price,
    crr_down_in_price,
    crr_price,
    discrete_barrier_shift,
    down_in_price,
    norm_cdf,
)
from .paths import (brownian_normals, gbm_standardization, simulate_gbm, simulate_gbm_multi,
                    to_path_major)
from .ops.lsmc_fusedpath import lsmc_price_fusedpath
from .ops.lsmc_swing import lsmc_price_swing
from .ops.sobol_pallas import simulate_gbm_qmc_device, sobol_gbm_paths
from .policy import OOSResult, price_out_of_sample, reprice_with_coeffs
from .payoff import (
    barrier_gate,
    barrier_knocked,
    exercise_allow_row,
    intrinsic_value,
    max_call_payoff,
    payoff_fn_for,
)
from .regress import (
    fit_continuation,
    fit_continuation_with_coeffs,
    pinv_solve,
    regression_fitted_values,
    weighted_standardize,
)
from .qmc import brownian_bridge_matrix, simulate_gbm_multi_qmc, simulate_gbm_qmc, sobol_normals
from .swing import (SwingContractResult, crr_swing_price, price_swing_contract,
                    price_swing_option, price_swing_option_curves)
from .types import MarketParams, ProductSpec, RegressionSpec, SimConfig

__all__ = [
    "BASIS_FAMILIES",
    "BookResult",
    "CCRExposures",
    "LSMCResult",
    "MarketParams",
    "OOSResult",
    "ProductSpec",
    "RegressionSpec",
    "SimConfig",
    "SwingContractResult",
    "backward_induction",
    "backward_induction_fused",
    "backward_induction_fused_maxcall",
    "barrier_gate",
    "barrier_knocked",
    "barrier_price",
    "bilateral_cva",
    "book_ccr_exposures",
    "book_greeks",
    "brownian_bridge_matrix",
    "brownian_normals",
    "bs_greeks",
    "bs_price",
    "compute_ccr_exposures",
    "config_from_jax",
    "crr_barrier_price",
    "crr_down_in_price",
    "crr_price",
    "crr_swing_price",
    "cva_from_epe",
    "design_matrix",
    "discrete_barrier_shift",
    "down_in_price",
    "exercise_allow_row",
    "exposures_from_coeffs",
    "fast_greeks",
    "fit_continuation",
    "fit_continuation_with_coeffs",
    "fused_price_diff",
    "gamma_fd",
    "gbm_standardization",
    "intrinsic_value",
    "lsmc_option_pricing",
    "lsmc_option_pricing_fused",
    "lsmc_price_fusedpath",
    "lsmc_price_swing",
    "max_call_greeks",
    "max_call_payoff",
    "maxcall_standardization",
    "multi_asset_design_matrix",
    "n_multi_terms",
    "norm_cdf",
    "payoff_fn_for",
    "pinv_solve",
    "precompute_standardization",
    "price_and_greeks",
    "price_max_call",
    "price_mixed_book",
    "price_option",
    "price_out_of_sample",
    "price_strike_grid",
    "price_swing_contract",
    "price_swing_option",
    "price_swing_option_curves",
    "regression_fitted_values",
    "reprice_max_call_with_coeffs",
    "reprice_with_coeffs",
    "resolve_regression_spec",
    "simulate_gbm",
    "simulate_gbm_multi",
    "simulate_gbm_multi_qmc",
    "simulate_gbm_qmc",
    "simulate_gbm_qmc_device",
    "sobol_gbm_paths",
    "sobol_normals",
    "tensor_from_numpy",
    "to_path_major",
    "weighted_standardize",
]
