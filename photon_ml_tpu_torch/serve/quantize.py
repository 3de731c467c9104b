"""Quantized coefficient storage for the serving slabs (port of
photon_ml_tpu/serve/quantize.py; the same bytes on disk).

A ``store_dtype`` policy for the slab files:

  * ``f32``  — the default; scores stay bitwise the batch scoring
    driver's.
  * ``bf16`` — slabs stored as raw bf16 bit patterns (uint16 on disk, so
    numpy maps them with no custom dtype); dequantize is an exact widening
    (bf16 is the top 16 bits of f32). 50% of the f32 slab bytes.
  * ``int8`` — slabs stored as int8 with a per-slab-row absmax scale
    sidecar (``scales.npy``, f32 ``(E_pad,)``); dequantize is
    ``q.astype(f32) * scale[row]`` on the gathered elements. About 25% of
    the f32 slab bytes.

Quantized exports carry a pinned per-coefficient error budget derived from
the true slab (:func:`row_coeff_budget`); the realized error is computed
against the true slab at export time (:func:`slab_error_report`), and an
export whose realized error exceeds its budget fails: it never serves.
Per-score error then bounds as ``||values||_1 * coeff_err_budget`` per
random-effect coordinate (fixed-effect vectors stay f32).

Quantization error, per slab row with absmax ``m``:

  * bf16 round-to-nearest-even: ``|w_q - w| <= u * |w| <= u * m`` with
    unit roundoff ``u = 2^-8``.
  * int8 absmax: ``scale = m / 127``, ``q = round(w / scale)``, so
    ``|w_q - w| <= scale / 2 = m / 254`` plus a small f32 slack for the
    two f32 roundings (the scale, and the ``q * scale`` product).

bf16 rounding is done here on the f32 bit patterns with numpy (the JAX
package goes through ``ml_dtypes``, which the card's machine does not
have): round to nearest, ties to even, over normals and subnormals alike;
a NaN keeps its sign and becomes the quiet NaN ``0x7FC0``/``0xFFC0``, as
``ml_dtypes`` makes it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

#: the store_dtype policy values accepted everywhere a store is built
STORE_DTYPES = ("f32", "bf16", "int8")

#: bf16 unit roundoff (1 sign + 8 exp + 7 mantissa bits -> precision 8)
_BF16_U = 2.0 ** -8
#: int8 absmax rounding step is scale/2 = absmax/254; the extra term
#: covers the f32 roundings in the scale computation and the dequant product
_INT8_U = 0.5 / 127.0 + 2.0 ** -20


def f32_to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bit patterns (uint16), round to nearest even."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    bias = ((u >> np.uint32(16)) & np.uint32(1)) + np.uint32(0x7FFF)
    bits = ((u + bias) >> np.uint32(16)).astype(np.uint16)
    nan = np.isnan(x)
    if nan.any():
        sign = (u >> np.uint32(16)).astype(np.uint16) & np.uint16(0x8000)
        bits = np.where(nan, sign | np.uint16(0x7FC0), bits).astype(np.uint16)
    return bits


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (uint16) -> float32, exactly."""
    return (np.asarray(bits).astype(np.uint32) << np.uint32(16)).view(np.float32)


def validate_store_dtype(store_dtype: str) -> str:
    if store_dtype not in STORE_DTYPES:
        raise ValueError(
            f"store_dtype must be one of {STORE_DTYPES}, got {store_dtype!r}"
        )
    return store_dtype


def row_coeff_budget(store_dtype: str, absmax: np.ndarray) -> np.ndarray:
    """Per-slab-row bound on ``|w_quantized - w|`` given each row's absmax
    — the analytic budget a quantized export is pinned to."""
    validate_store_dtype(store_dtype)
    absmax = np.asarray(absmax, np.float64)
    if store_dtype == "f32":
        return np.zeros_like(absmax)
    if store_dtype == "bf16":
        # the 2^-133 floor covers rounding inside bf16's subnormal range
        # (spacing 2^-133), where the relative bound alone is too tight
        return absmax * _BF16_U + 2.0 ** -133
    return absmax * _INT8_U


def quantize_slab(
    slab: np.ndarray, store_dtype: str
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """True f32 slab -> (stored array, per-row scale sidecar or None).

    bf16 returns the raw bit patterns as uint16; int8 returns (int8 slab,
    (E_pad,) f32 scales). All-zero rows get scale 1.0 so the sidecar stays
    finite and strictly positive (the open-time gate rejects any other).
    """
    validate_store_dtype(store_dtype)
    slab = np.ascontiguousarray(slab, np.float32)
    if store_dtype == "f32":
        return slab, None
    if store_dtype == "bf16":
        return f32_to_bf16_bits(slab), None
    absmax = np.max(np.abs(slab), axis=1)
    scales = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(
        np.rint(slab / scales[:, None]), -127, 127
    ).astype(np.int8)
    return q, scales


def dequantize_slab(
    stored: np.ndarray, scales: Optional[np.ndarray], store_dtype: str
) -> np.ndarray:
    """Host-side dequantize to f32: the values the device gathers serve
    (export validation and host-side checks use it)."""
    validate_store_dtype(store_dtype)
    if store_dtype == "f32":
        return np.asarray(stored, np.float32)
    if store_dtype == "bf16":
        return bf16_bits_to_f32(stored)
    return stored.astype(np.float32) * np.asarray(scales, np.float32)[:, None]


def slab_error_report(
    true_slab: np.ndarray,
    stored: np.ndarray,
    scales: Optional[np.ndarray],
    store_dtype: str,
) -> Dict[str, float]:
    """Realized vs budgeted quantization error for one exported slab.

    Raises IOError when the realized error exceeds the pinned budget —
    the export fails; a slab over budget never serves.
    """
    true_slab = np.asarray(true_slab, np.float32)
    deq = dequantize_slab(stored, scales, store_dtype)
    realized = float(np.max(np.abs(deq.astype(np.float64) - true_slab)))
    budget = float(
        np.max(
            row_coeff_budget(
                store_dtype, np.max(np.abs(true_slab), axis=1)
            )
        )
        if true_slab.size
        else 0.0
    )
    # `not (realized <= budget)`: a NaN/inf realized error must fail the
    # gate, and every comparison against NaN is False
    if not (realized <= budget):
        if not np.all(np.isfinite(true_slab)):
            hint = (
                "the true slab carries non-finite coefficients (e.g. the "
                "optim.step NaN-corruption fault mode)"
            )
        elif not np.isfinite(realized):
            # an f32 coefficient past bf16's max finite overflows to inf in
            # the narrowing; a subnormal row absmax underflows the int8
            # scale to zero
            hint = (
                "the true slab is finite but does not survive the "
                f"{store_dtype} round trip (overflow past the dtype's "
                "max finite, or a subnormal row absmax underflowing the "
                "scale)"
            )
        else:
            hint = "the coefficients exceed this dtype's analytic budget"
        raise IOError(
            f"quantized slab exceeds its pinned error budget: realized "
            f"max |w_q - w| = {realized:.3e} > budget {budget:.3e} "
            f"({store_dtype}; {hint}); refusing the export — this slab "
            "must not serve"
        )
    return {
        "realized_max_abs_coeff_err": realized,
        "coeff_err_budget": budget,
    }
