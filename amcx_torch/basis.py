"""Polynomial regression bases, evaluated by their three-term recurrences.

Port of `amcx.basis` (single-asset families). Every family is generated by
its recurrence, producing the ``(..., degree+1)`` design matrix in one pass:

- ``power`` (alias ``monomial``):  ``P_i(x) = x**i``
- ``chebyshev``: ``T_0=1, T_1=x, T_{n+1} = 2x T_n - T_{n-1}``
- ``legendre``:  ``P_0=1, P_1=x, (n+1) P_{n+1} = (2n+1)x P_n - n P_{n-1}``
- ``laguerre``:  ``L_0=1, L_1=1-x, (n+1) L_{n+1} = (2n+1-x) L_n - n L_{n-1}``
- ``hermite``:   (physicists') ``H_0=1, H_1=2x, H_{n+1} = 2x H_n - 2n H_{n-1}``

The recurrences keep amcx's operation order, so both packages round alike.
The CUDA kernels (`amcx_torch/csrc/lsmc_common.cuh`) transcribe the same
formulas.

Multi-asset regressions (max-call and the other multi-state products) use
the cross-term basis of :func:`multi_asset_design_matrix`: products of the
per-asset univariate columns over the multi-indices of
:func:`_multi_index_set`, in amcx's column order (the multi-asset kernels
receive that table from here).
"""

from __future__ import annotations

import itertools

import torch

__all__ = ["BASIS_FAMILIES", "BASIS_IDS", "basis_cols", "design_matrix", "n_multi_terms",
           "multi_asset_cols", "multi_asset_design_matrix"]


def _rec_power(x, prev, prev2, n):
    return prev * x


def _rec_chebyshev(x, prev, prev2, n):
    return 2.0 * x * prev - prev2


def _divided(num, n):
    # by a 0-d tensor on num's device: torch's CUDA division by a Python
    # scalar multiplies by its rounded reciprocal, which differs from the
    # division (amcx's, the CPU's and the kernels') in ~1/3 of the values
    return num / torch.full((), n, dtype=num.dtype, device=num.device)


def _rec_legendre(x, prev, prev2, n):
    # n P_n = (2n-1) x P_{n-1} - (n-1) P_{n-2}
    return _divided((2.0 * n - 1.0) * x * prev - (n - 1.0) * prev2, n)


def _rec_laguerre(x, prev, prev2, n):
    # n L_n = (2n-1-x) L_{n-1} - (n-1) L_{n-2}
    return _divided((2.0 * n - 1.0 - x) * prev - (n - 1.0) * prev2, n)


def _rec_hermite(x, prev, prev2, n):
    # H_n = 2x H_{n-1} - 2(n-1) H_{n-2}
    return 2.0 * x * prev - 2.0 * (n - 1.0) * prev2


def _first_order(name, x):
    if name == "laguerre":
        return torch.ones_like(x) - x
    if name == "hermite":
        return 2.0 * x
    return x


BASIS_FAMILIES = {
    "power": _rec_power,
    "monomial": _rec_power,
    "chebyshev": _rec_chebyshev,
    "legendre": _rec_legendre,
    "laguerre": _rec_laguerre,
    "hermite": _rec_hermite,
}

# Family ids as the CUDA kernels number them (csrc/lsmc_mega.cu `Basis`).
BASIS_IDS = {
    "power": 0,
    "monomial": 0,
    "chebyshev": 1,
    "legendre": 2,
    "laguerre": 3,
    "hermite": 4,
}


def _family(basis: str):
    name = basis.strip().lower()
    if name not in BASIS_FAMILIES:
        raise ValueError(
            f"Unknown basis type {basis!r}. Use one of {sorted(set(BASIS_FAMILIES))}."
        )
    return name


def basis_cols(x: torch.Tensor, basis: str, degree: int) -> list:
    """Columns ``[P_0(x), ..., P_degree(x)]`` as a list of tensors shaped
    like ``x`` (the kernels' register-resident form of the design matrix)."""
    name = _family(basis)
    rec = BASIS_FAMILIES[name]
    cols = [torch.ones_like(x)]
    if degree >= 1:
        cols.append(_first_order(name, x))
    for n in range(2, degree + 1):
        cols.append(rec(x, cols[-1], cols[-2], float(n)))
    return cols


def design_matrix(x: torch.Tensor, basis: str, degree: int) -> torch.Tensor:
    """Vandermonde-style design matrix ``A[..., k] = P_k(x[...])``.

    Raises ``ValueError`` on an unknown family. Returns shape
    ``x.shape + (degree + 1,)``.
    """
    return torch.stack(basis_cols(x, basis, degree), dim=-1)


def n_multi_terms(n_assets: int, degree: int, mode: str = "total") -> int:
    """Number of columns of :func:`multi_asset_design_matrix`."""
    return len(_multi_index_set(n_assets, degree, mode))


def _multi_index_set(n_assets: int, degree: int, mode: str):
    """Sorted multi-indices: every ``alpha`` with total degree ≤ ``degree``
    (``"total"``), or the constant plus the per-asset univariate terms
    (``"separable"``)."""
    if mode == "total":
        idx = [alpha for alpha in itertools.product(range(degree + 1), repeat=n_assets)
               if sum(alpha) <= degree]
    elif mode == "separable":
        idx = [(0,) * n_assets]
        for a in range(n_assets):
            for d in range(1, degree + 1):
                alpha = [0] * n_assets
                alpha[a] = d
                idx.append(tuple(alpha))
    else:
        raise ValueError(f"Unknown multi-asset basis mode {mode!r}")
    return sorted(idx)


def multi_asset_cols(feats, basis: str, degree: int, mode: str = "total") -> list:
    """Cross-term columns from the list of per-asset regressors ``feats``
    (tensors of one shape): each column multiplies the asset columns with
    ``d > 0`` left to right, as amcx's ``_columns`` and the kernels do."""
    uni = [basis_cols(x, basis, degree) for x in feats]
    out = []
    for alpha in _multi_index_set(len(feats), degree, mode):
        term = None
        for a, d in enumerate(alpha):
            if d == 0:
                continue
            term = uni[a][d] if term is None else term * uni[a][d]
        out.append(torch.ones_like(feats[0]) if term is None else term)
    return out


def multi_asset_design_matrix(X: torch.Tensor, basis: str, degree: int,
                              mode: str = "total") -> torch.Tensor:
    """Cross-term design matrix ``(..., n_terms)`` of ``X`` ``(..., n_assets)``:
    columns ``prod_a P_{alpha_a}(X[..., a])`` over :func:`_multi_index_set`."""
    return torch.stack(multi_asset_cols(list(torch.unbind(X, dim=-1)), basis, degree, mode),
                       dim=-1)
