"""Pure, vectorized data-quality rule functions (the service layer of the
reference app, ported from ``sparkdq4ml_tpu/ops/rules.py``).

Null semantics use NaN as the null analogue and keep the reference's
asymmetry:

* ``minimum_price_rule`` has no null guard: a NaN price passes through.
* ``price_correlation_rule`` is null-safe: NaN in either input gives -1.
"""

from __future__ import annotations

import torch

from ..config import as_tensor, float_dtype

# Threshold constants from the reference services.
MIN_PRICE = 20.0             # MinimumPriceDataQualityService.java:5
CORRELATION_MAX_GUESTS = 14  # PriceCorrelationDataQualityService.java:6
CORRELATION_MAX_PRICE = 90.0  # PriceCorrelationDataQualityService.java:6
BAD_ROW_SENTINEL = -1.0


def minimum_price_rule(price):
    """price < 20 -> -1 else price; NaN is returned unchanged."""
    price = as_tensor(price, float_dtype())
    return torch.where(price < MIN_PRICE,
                       price.new_full((), BAD_ROW_SENTINEL), price)


def price_correlation_rule(price, guest):
    """guest < 14 and price > 90 -> -1 else price; NaN in either input
    -> -1 (the adapter's null guard)."""
    price = as_tensor(price, float_dtype())
    guest_f = as_tensor(guest, float_dtype())
    bad = (guest_f < CORRELATION_MAX_GUESTS) & (price > CORRELATION_MAX_PRICE)
    null = torch.isnan(price) | torch.isnan(guest_f)
    return torch.where(bad | null, price.new_full((), BAD_ROW_SENTINEL),
                       price)


def dq_rules_fused(price, guest):
    """One-pass fused DQ chain: ``(price_no_min, price_correct_correl,
    keep)``. Both inputs are cast to the float dtype first; the chain then
    runs in the ``dq_rules`` kernel on a CUDA tensor and in its plain
    version on a CPU tensor (``ops/kernels.py``)."""
    from . import kernels

    price = as_tensor(price, float_dtype())
    guest = as_tensor(guest, float_dtype())
    return kernels.dq_rules(price, guest)


def register_builtin_rules(registry=None) -> None:
    """Register both rules under the names the reference app uses."""
    from .udf import default_registry

    reg = registry if registry is not None else default_registry()
    reg.register("minimumPriceRule", minimum_price_rule, "double")
    reg.register("priceCorrelationRule", price_correlation_rule, "double")
