"""Product models of the port (`amcx.models`): the multi-asset Bermudan
max-call so far."""

from .maxcall import (
    backward_induction_fused_maxcall,
    max_call_fit,
    max_call_greeks,
    maxcall_standardization,
    price_max_call,
    reprice_max_call_with_coeffs,
)

__all__ = [
    "backward_induction_fused_maxcall",
    "max_call_fit",
    "max_call_greeks",
    "maxcall_standardization",
    "price_max_call",
    "reprice_max_call_with_coeffs",
]
