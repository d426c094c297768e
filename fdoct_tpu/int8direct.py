"""int8-direct display path: zero elementwise work on the big input.

The f32 hot path computes ``|((y - pi)/bg) @ M|`` (pipeline.ascan_mags_fused;
reference hot loop BscanFFT.cpp:1123-1190).  The naive int8 use
(pipeline._op_matmul_pair_int8) must dynamically quantize the *input* per
row — elementwise reductions over the big (H, W) frame.

This module removes ALL elementwise work on the input by folding the
calibration frames into the operator instead:

- the background ``bg`` (an averaged source-spectrum capture; physically
  near rank-1 because every lateral position sees the same source) is
  factored ``bg ~= u[r] * v[c]``; the spectral shape ``1/v`` folds into the
  operator columns and the per-row gain ``1/u`` scales the small output;
- the pi/J0 frame (and the dark frame in the BscanDark variant,
  BscanDark.cpp:1269 — both enter linearly) become a precomputed constant
  output correction ``(pi + dark) @ Mv``;
- camera counts are exact 8-bit integers, so the s8 input has NO
  quantization error; only the operator is quantized (symmetric per output
  column).  The host (or capture ring) delivers bias-shifted s8 counts
  ``raw ^ 0x80`` — a free transform on the memcpy path — and the +128 bias
  contributes the precomputed constant row ``128 * colsum(Mv)``.

Per group the device then runs exactly two s8 x s8 -> s32 matmuls straight
from device memory plus an O(rows x ndisp) epilogue.

Accuracy model: error = operator quantization (~= 1/127 per column,
partially averaged over the contraction) + the rank-1 background residual.
Characterized with a realistic non-rank-1 background and pinned by
tests/test_int8direct.py; display mode only — metrology uses stay on
'highest'.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp

from fdoct_tpu.calibration import Calibration
from fdoct_tpu.config import PipelineConfig


def rank1_factor(bg: np.ndarray, iters: int = 4) -> tuple[np.ndarray, np.ndarray, float]:
    """Best rank-1 factorization ``bg ~= u[:, None] * v[None, :]`` by
    alternating least squares (power iteration on bg bg^T).

    Returns (u, v, rel_residual) with ``v`` normalized to mean 1 so ``u``
    carries the physical per-row intensity scale.
    """
    b = np.asarray(bg, np.float64)
    v = b.mean(axis=0)
    v = np.where(v == 0.0, 1e-12, v)
    u = np.ones(b.shape[0])
    for _ in range(iters):
        u = (b @ v) / (v @ v)
        u = np.where(u == 0.0, 1e-12, u)
        v = (u @ b) / (u @ u)
        v = np.where(v == 0.0, 1e-12, v)
    scale = v.mean()
    if scale == 0.0:
        scale = 1.0
    v = v / scale
    u = u * scale
    resid = float(np.linalg.norm(b - np.outer(u, v)) / (np.linalg.norm(b) + 1e-300))
    return u, v, resid


def _quant_cols(A: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-output-column int8 quantization with column-sum error
    feedback.

    Camera counts are mostly DC (mean ~ bg scale, fringes a fraction); the
    DC row passes through colsum(Mv), so the *accumulated rounding error*
    of each column sum would leak mean_count x (colsum_q - colsum_exact)
    into every output — measured 1.4 dB on signal with plain rounding.
    Rather than correcting at runtime (a ones-column row-sum costs an
    unaligned D+1 matmul and breaks XLA's epilogue fusion — measured
    0.09 vs 0.07 ms/group), the quantizer redistributes +-1 units onto the
    entries with the largest same-signed rounding residual until each
    quantized column sum matches the exact one to within half a quantum.
    The DC leak is then <= mean_count x s/2 — below the AC quantization
    noise — with zero runtime cost.
    """
    s = np.abs(A).max(axis=0) / 127.0
    s = np.where(s == 0.0, 1.0, s)
    q = np.clip(np.rint(A / s), -127.0, 127.0)
    resid = A / s - q                       # in quantum units, |resid|<=~0.5
    delta = np.rint(A.sum(axis=0) / s - q.sum(axis=0)).astype(np.int64)
    for d in np.nonzero(delta)[0]:
        k = int(delta[d])
        sign = 1 if k > 0 else -1
        # entries whose residual most supports a +-1 nudge, clamp-safe
        order = np.argsort(-sign * resid[:, d])
        room = (q[order, d] * sign) < 127.0
        picks = order[room][: abs(k)]
        q[picks, d] += sign
    return q.astype(np.int8), s.astype(np.float32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Int8DirectPlan:
    """Precomputed tables for :func:`reconstruct_int8_direct`.

    Rebuilt whenever the background / pi / dark calibration frames change
    (rare: the 'b'/'p'/'o' key captures) — the per-frame path touches only
    the tables.
    """

    oph: int = dataclasses.field(metadata=dict(static=True))
    opw: int = dataclasses.field(metadata=dict(static=True))
    ndisp: int = dataclasses.field(metadata=dict(static=True))

    oq_re: Any = None        # (opw, ndisp) int8 — quantized diag(1/v) @ M
    #                          (colsum-matched; see _quant_cols' DC note)
    oq_im: Any = None        # (opw, ndisp) int8
    s_re: Any = None         # (ndisp,) f32 dequant scales
    s_im: Any = None
    row_gain_inv: Any = None  # (oph, 1) f32 — 1/u[r] (rank=1) / u1[r] (rank=2)
    const_re: Any = None     # (oph, ndisp) f32 — (128*colsum(Mv) - (pi+dark) @ Mv) / u[r]
    const_im: Any = None
    bg_rank1_resid: Any = None  # f32 scalar diagnostic (host-side; not traced)
    # rank-2 reciprocal fold (create(rank=2)): second quantized operator
    # pair for the top-2 SVD of 1/bg.  None for the production rank-1
    # plan — reconstruct adds the second s8 matmul pair only when present
    # (2x matmul cost).
    oq2_re: Any = None       # (opw, ndisp) int8 — quantized diag(v2) @ M
    oq2_im: Any = None
    s2_re: Any = None        # (ndisp,) f32
    s2_im: Any = None
    row_gain2: Any = None    # (oph, 1) f32 — u2[r]

    @classmethod
    def create(cls, calib: Calibration, cfg: PipelineConfig,
               background, pi_frame, dark_frame=None,
               rank: int = 1) -> "Int8DirectPlan":
        """Fold bg/pi/dark into quantized operator tables (host, float64).

        Requires the int8-direct preconditions — raise early otherwise so a
        mis-configured session fails loudly at plan-build time, not with a
        silently wrong display.

        ``rank=2`` folds the top-2 SVD of the RECIPROCAL background
        instead of the rank-1 bg factorization: two quantized operator
        pairs, 4 s8 matmuls per frame (2x matmul cost) — measured 6-10x
        lower fold residual on structured non-rank-1 backgrounds
        (two-component source spectra, row-dependent mixing), noise-floor-
        limited otherwise.
        """
        supported, why = int8_direct_supported(cfg)
        if not supported:
            raise ValueError(f"int8_direct unsupported for this config: {why}")
        if rank not in (1, 2):
            raise ValueError(f"rank must be 1 or 2, got {rank}")
        M_re = np.asarray(calib.op_re, np.float64)   # (opw, ndisp)
        M_im = np.asarray(calib.op_im, np.float64)
        bg = np.asarray(background, np.float64)
        pi = np.asarray(pi_frame, np.float64)
        if dark_frame is not None:
            pi = pi + np.asarray(dark_frame, np.float64)
        f32 = jnp.float32
        common = dict(oph=bg.shape[0], opw=M_re.shape[0],
                      ndisp=M_re.shape[1])

        if rank == 2:
            binv = 1.0 / np.where(bg == 0.0, 1e-12, bg)
            U, S, Vt = np.linalg.svd(binv, full_matrices=False)
            u1, v1 = U[:, 0] * S[0], Vt[0]
            u2, v2 = U[:, 1] * S[1], Vt[1]
            resid = float(np.linalg.norm(binv - np.outer(u1, v1)
                                         - np.outer(u2, v2))
                          / (np.linalg.norm(binv) + 1e-300))
            Mv1_re, Mv1_im = M_re * v1[:, None], M_im * v1[:, None]
            Mv2_re, Mv2_im = M_re * v2[:, None], M_im * v2[:, None]
            oq_re, s_re = _quant_cols(Mv1_re)
            oq_im, s_im = _quant_cols(Mv1_im)
            oq2_re, s2_re = _quant_cols(Mv2_re)
            oq2_im, s2_im = _quant_cols(Mv2_im)
            # the pi/dark correction is a HOST-side precompute — use the
            # exact reciprocal, no fold approximation needed; the +128 bias
            # passes through both folded operators' exact colsums
            bias_re = 128.0 * (np.outer(u1, Mv1_re.sum(axis=0))
                               + np.outer(u2, Mv2_re.sum(axis=0)))
            bias_im = 128.0 * (np.outer(u1, Mv1_im.sum(axis=0))
                               + np.outer(u2, Mv2_im.sum(axis=0)))
            const_re = bias_re - (pi * binv) @ M_re
            const_im = bias_im - (pi * binv) @ M_im
            return cls(
                **common,
                oq_re=jnp.asarray(oq_re), oq_im=jnp.asarray(oq_im),
                s_re=jnp.asarray(s_re, f32), s_im=jnp.asarray(s_im, f32),
                row_gain_inv=jnp.asarray(u1[:, None], f32),
                oq2_re=jnp.asarray(oq2_re), oq2_im=jnp.asarray(oq2_im),
                s2_re=jnp.asarray(s2_re, f32), s2_im=jnp.asarray(s2_im, f32),
                row_gain2=jnp.asarray(u2[:, None], f32),
                const_re=jnp.asarray(const_re, f32),
                const_im=jnp.asarray(const_im, f32),
                bg_rank1_resid=jnp.asarray(resid, f32),
            )

        u, v, resid = rank1_factor(bg)
        Mv_re = M_re / v[:, None]
        Mv_im = M_im / v[:, None]
        oq_re, s_re = _quant_cols(Mv_re)      # colsum-matched (DC-safe)
        oq_im, s_im = _quant_cols(Mv_im)
        uinv = (1.0 / u)[:, None]                    # (oph, 1)

        # constant output terms: the +128 s8 bias row (through the exact
        # colsum) and the pi/dark correction, scaled by the per-row gain
        const_re = (128.0 * Mv_re.sum(axis=0)[None, :] - pi @ Mv_re) * uinv
        const_im = (128.0 * Mv_im.sum(axis=0)[None, :] - pi @ Mv_im) * uinv
        return cls(
            **common,
            oq_re=jnp.asarray(oq_re), oq_im=jnp.asarray(oq_im),
            s_re=jnp.asarray(s_re, f32), s_im=jnp.asarray(s_im, f32),
            row_gain_inv=jnp.asarray(uinv, f32),
            const_re=jnp.asarray(const_re, f32),
            const_im=jnp.asarray(const_im, f32),
            bg_rank1_resid=jnp.asarray(resid, f32),
        )


def int8_direct_supported(cfg: PipelineConfig) -> tuple[bool, str]:
    """Whether the int8-direct path computes the same function as the f32
    pipeline for this config.  The folding requires the whole
    frame -> magnitudes map to be affine in the raw 8-bit counts."""
    if cfg.bpp > 8:
        return False, "input must be 8-bit camera counts (bpp <= 8)"
    if cfg.mediann > 0:
        return False, "median filter is nonlinear (mediann > 0)"
    if cfg.movavgn > 0:
        return False, "moving-average smoothing not folded (movavgn > 0)"
    if max(cfg.binvalue, cfg.binvaluex, cfg.binvaluey, 1) != 1:
        return False, "software binning not folded (binvalue[x/y] > 1)"
    if cfg.rowwisenormalize or not cfg.donotnormalize:
        return False, "input normalization is data-dependent (nonlinear)"
    return True, ""


def to_s8(raw_u8: np.ndarray) -> np.ndarray:
    """Host-side bias shift u8 -> s8 (raw - 128 == raw ^ 0x80 bit-exactly).

    This is the transform the capture ring applies on its memcpy path; the
    bytes on the host->device wire are unchanged (1 B/px).

    Rejects non-uint8 input loudly (matching the module's fail-at-plan-build
    philosophy): an unsafe cast would silently wrap 16-bit counts modulo
    256 and the display would be garbage with no diagnostic.
    """
    arr = np.asarray(raw_u8)
    if arr.dtype != np.uint8:
        raise TypeError(
            f"to_s8 expects exact uint8 camera counts, got {arr.dtype} "
            "(16-bit sources are unsupported by int8_direct — see "
            "int8_direct_supported)")
    return np.bitwise_xor(arr, 0x80).view(np.int8)


@jax.jit
def shift_u8_to_s8(raw_u8: jnp.ndarray) -> jnp.ndarray:
    """Device-side bias shift for frames already resident as u8."""
    return jax.lax.bitcast_convert_type(raw_u8 ^ jnp.uint8(0x80), jnp.int8)


@jax.jit
def reconstruct_int8_direct(frames_s8: jnp.ndarray,
                            plan: Int8DirectPlan) -> jnp.ndarray:
    """A-scan magnitudes from bias-shifted s8 frames: two s8 x s8 -> s32
    matmuls straight from device memory + an O(rows x ndisp) f32 epilogue.

    frames_s8: (..., oph, opw) int8 (raw counts - 128; see :func:`to_s8`).
    Returns (..., oph, ndisp) magnitudes matching
    ``pipeline.reconstruct(..., method="fused")`` to display accuracy.
    """
    acc_re = jnp.matmul(frames_s8, plan.oq_re,
                        preferred_element_type=jnp.int32)
    acc_im = jnp.matmul(frames_s8, plan.oq_im,
                        preferred_element_type=jnp.int32)
    re = (acc_re.astype(jnp.float32) * plan.s_re) * plan.row_gain_inv \
        + plan.const_re
    im = (acc_im.astype(jnp.float32) * plan.s_im) * plan.row_gain_inv \
        + plan.const_im
    if plan.oq2_re is not None:
        # rank-2 reciprocal fold: second s8 matmul pair (create(rank=2))
        acc2_re = jnp.matmul(frames_s8, plan.oq2_re,
                             preferred_element_type=jnp.int32)
        acc2_im = jnp.matmul(frames_s8, plan.oq2_im,
                             preferred_element_type=jnp.int32)
        re = re + (acc2_re.astype(jnp.float32) * plan.s2_re) * plan.row_gain2
        im = im + (acc2_im.astype(jnp.float32) * plan.s2_im) * plan.row_gain2
    return jnp.sqrt(re * re + im * im)
