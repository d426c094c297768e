"""Log scaling, normalization, thresholding.

Batched re-expression of the display-conditioning steps in the reference hot
loop (BscanFFT.cpp:1211-1255) and the helpers at BscanFFT.cpp:88-97, 173-178.
"""

from __future__ import annotations

from jax import lax
import jax.numpy as jnp

# The reference converts natural log to dB with the literal constant 2.303
# rather than ln(10) (BscanFFT.cpp:1235-1237: ``bscandb = 20.0*bscanlog/2.303``).
# Kept verbatim for numerical parity.
_REF_LN10 = 2.303


def to_db(x: jnp.ndarray, eps: float = 1e-5, compat: bool = True) -> jnp.ndarray:
    """dB conversion: ``20*ln(x + eps)/2.303``.

    reference: BscanFFT.cpp:1222 (``bscan += 1e-5``), 1235-1237.
    ``compat=False`` uses the exact ln(10).
    """
    denom = _REF_LN10 if compat else jnp.log(10.0)
    return 20.0 * jnp.log(x + eps) / denom


def normalize_minmax(x: jnp.ndarray, lo: float = 0.0, hi: float = 1.0,
                     axis=None) -> jnp.ndarray:
    """Min-max normalize to [lo, hi] (cv::normalize NORM_MINMAX semantics).

    reference: BscanFFT.cpp:1254.  With a constant input, OpenCV maps
    everything to ``lo``; matched here by guarding the zero range.
    """
    xmin = jnp.min(x, axis=axis, keepdims=axis is not None)
    xmax = jnp.max(x, axis=axis, keepdims=axis is not None)
    rng = xmax - xmin
    safe = jnp.where(rng == 0, 1.0, rng)
    return jnp.where(rng == 0, lo, (x - xmin) / safe * (hi - lo) + lo)


def minmax_pair(x: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Global (min, max) of ``x`` in ONE variadic reduction.

    ``jnp.min`` + ``jnp.max`` emit two separate reduce ops that XLA does
    not always fuse into one pass; on the B-scan display epilogue that is
    two of its small kernel launches.  min and max are
    associative and commutative, so the pair-reduce returns bit-identical
    values to the separate reductions in any order.
    """
    lo, hi = lax.reduce(
        (x, x),
        (jnp.asarray(jnp.inf, x.dtype), jnp.asarray(-jnp.inf, x.dtype)),
        lambda a, b: (jnp.minimum(a[0], b[0]), jnp.maximum(a[1], b[1])),
        tuple(range(x.ndim)))
    return lo, hi


def normalize_rows(x: jnp.ndarray, lo: float = 0.0, hi: float = 1.0) -> jnp.ndarray:
    """Per-row min-max normalize (reference: normalizerows, BscanFFT.cpp:88-97)."""
    return normalize_minmax(x, lo, hi, axis=-1)


def make_only_positive(x: jnp.ndarray) -> jnp.ndarray:
    """max(x, 0) (reference: makeonlypositive, BscanFFT.cpp:173-178)."""
    return jnp.maximum(x, 0.0)


def threshold_floor(x: jnp.ndarray, thresh: float) -> jnp.ndarray:
    """B-scan display floor: ``max(x, thresh)`` (reference: BscanFFT.cpp:1247)."""
    return jnp.maximum(x, thresh)


def clamp_pixel(x: jnp.ndarray, value: float, row: int = 5, col: int = 5) -> jnp.ndarray:
    """Set one pixel to a fixed dB value before normalization so that the
    display scale is absolute (reference 'q' key: BscanFFT.cpp:1248-1253 sets
    pixel (5,5) to 50 dB; spinjnt uses 30 dB at BscanFFTspinjnt.cpp:1886).

    Iota select rather than ``.at[].set`` — dynamic-update-slice breaks
    XLA's fusion of the surrounding display chain (same finding as
    mask_dc_rows; +16% end-to-end when the chain stays fused)."""
    r = jnp.arange(x.shape[-2])[:, None]
    c = jnp.arange(x.shape[-1])[None, :]
    return jnp.where((r == row) & (c == col), jnp.asarray(value, x.dtype), x)


def to_uint8(x01: jnp.ndarray) -> jnp.ndarray:
    """[0,1] float → uint8, matching ``convertTo(CV_8UC1, 255.0)``
    (saturating cast with rounding; reference: BscanFFT.cpp:1255)."""
    return jnp.clip(jnp.round(x01 * 255.0), 0, 255).astype(jnp.uint8)


def mask_dc_rows(bscan: jnp.ndarray, src_row: int = 4, upto: int = 2) -> jnp.ndarray:
    """Mask the DC rows of a (depth, lateral) B-scan for display by copying
    row ``src_row`` over rows [0, upto) (reference: BscanFFT.cpp:1239-1240
    copies row 4 over rows 0 and 1).

    Expressed as an iota select (not ``.at[].set``, which lowers to
    dynamic-update-slice and breaks XLA's elementwise fusion of the
    surrounding display chain)."""
    depth_idx = jnp.arange(bscan.shape[-2])[:, None]
    return jnp.where(depth_idx < upto,
                     bscan[..., src_row: src_row + 1, :], bscan)
