"""The jit-compiled frame→B-scan reconstruction pipeline.

Functional re-expression of the reference hot loop (BscanFFT.cpp:946-1925):

    raw frame → [median] → bin → float → [moving average]      (preprocess)
    → (y - data_yp)/data_yb                                    (apodize_ratio)
    → per-row DC removal → ×window → [zero-pad ×mult]
    → λ→k resample → |IFFT|[:ndisp]                            (ascan_mags_*)
    → Σ over frames → transpose → ÷N → dB → display pipeline   (form_bscan)

Two device paths produce the A-scan magnitudes:

- ``method="gather"`` — step-by-step ops, bit-compatible with the reference
  loops; used for parity tests and as the fallback.
- ``method="fused"``  — one complex matmul against the precomputed linear
  operator (see calibration.py), the speed path.

Frames carry shape (..., oph, opw): rows are lateral A-scan positions,
columns are wavelength samples; output B-scans are (depth, lateral).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from fdoct_tpu.calibration import Calibration
from fdoct_tpu.config import PipelineConfig
from fdoct_tpu.ops import (
    bin_area, ifft_mag_rows, median_blur, normalize_minmax, normalize_rows,
    resample_klinear, smooth_moving_average, to_db, to_uint8, zeropad_rowwise,
    threshold_floor,
)
from fdoct_tpu.ops.scale import clamp_pixel


class BscanOutputs(NamedTuple):
    """Per-average-group outputs mirroring the reference display chain."""
    bscan: jnp.ndarray      # linear magnitudes, (depth=ndisp, lateral=oph)
    bscandb: jnp.ndarray    # dB, DC rows masked (BscanFFT.cpp:1235-1240)
    bscandisp: jnp.ndarray  # uint8 display image after threshold+normalize


# ---------------------------------------------------------------------------


def preprocess(raw: jnp.ndarray, cfg: PipelineConfig, dtype=None) -> jnp.ndarray:
    """Raw integer frame → binned float spectra (reference:
    BscanFFT.cpp:952-991: medianBlur, resize INTER_AREA, convertTo CV_64F,
    smoothmovavg)."""
    dtype = jnp.dtype(dtype or cfg.dtype)
    x = raw
    if cfg.mediann > 0:
        x = median_blur(x, cfg.mediann)
    bx = max(cfg.binvalue, cfg.binvaluex)
    by = max(cfg.binvalue, cfg.binvaluey)
    x = bin_area(x, bx, by)
    y = x.astype(dtype)
    if cfg.movavgn > 0:
        y = smooth_moving_average(y, cfg.movavgn)
    return y


def apodize_ratio(y: jnp.ndarray, background: jnp.ndarray,
                  pi_frame: jnp.ndarray, cfg: PipelineConfig,
                  ascan_axis: str | None = None) -> jnp.ndarray:
    """(y - data_yp) / data_yb with the optional input normalizations
    (reference: BscanFFT.cpp:1123-1132).

    The reference normalizes EACH frame by its own min/max (``normalize``
    of the loop-local ``data_y``; the simulator forces it on,
    BscanFFTsim.cpp:845) — so the min/max reduction runs over the frame
    axes only, never jointly across a batch: a batched ``y`` of frames
    with differing ranges gets per-frame scales identical to running the
    hot loop frame by frame.

    ``ascan_axis`` names the mesh axis sharding the frame ROWS when this
    runs inside ``shard_map`` (parallel.sharded): the per-frame min/max
    then completes with pmin/pmax scalar collectives so each frame sees
    its full-row range, not the shard-local one.
    """
    if cfg.rowwisenormalize:
        y = normalize_rows(y, 0.0, 1.0)
    if not cfg.donotnormalize:
        axes = (-2, -1) if y.ndim >= 2 else (-1,)
        if ascan_axis is None:
            y = normalize_minmax(y, 0.0, 1.0, axis=axes)
        else:
            lo = jax.lax.pmin(jnp.min(y, axis=axes, keepdims=True),
                              ascan_axis)
            hi = jax.lax.pmax(jnp.max(y, axis=axes, keepdims=True),
                              ascan_axis)
            rng = hi - lo
            safe = jnp.where(rng == 0, 1.0, rng)
            # cv::normalize NORM_MINMAX semantics like normalize_minmax:
            # constant frames map to the low bound
            y = jnp.where(rng == 0, 0.0, (y - lo) / safe)
    return (y - pi_frame) / background


def linearize(yr: jnp.ndarray, calib: Calibration) -> jnp.ndarray:
    """DC removal + window + zero-pad + λ→k resample (reference:
    BscanFFT.cpp:1135-1177), gather path."""
    y = yr - jnp.mean(yr, axis=-1, keepdims=True)
    y = y * calib.window
    y = zeropad_rowwise(y, calib.mult, calib.bandpassfilter)
    return resample_klinear(y, calib.nearest_idx, calib.frac, compat=calib.compat)


def ascan_mags_gather(yr: jnp.ndarray, calib: Calibration) -> jnp.ndarray:
    """Step-by-step A-scan magnitudes, truncated to the display depth
    (reference: BscanFFT.cpp:1181-1195).  Applies the dispersion phase
    explicitly when the calibration carries one (static flag)."""
    ylin = linearize(yr, calib)
    mag = ifft_mag_rows(ylin, calib.phase if calib.has_phase else None)
    return mag[..., : calib.ndisp]


def ascan_mags_fused(yr: jnp.ndarray, calib: Calibration,
                     precision: str = "default") -> jnp.ndarray:
    """A-scan magnitudes as one complex matmul pair ``|yr @ M|``.

    M composes DC-removal, window, zero-pad, resample, dispersion and the
    truncated unnormalized IDFT (calibration.Calibration.create).

    ``precision`` is the config's ``matmul_precision`` and means the same on
    every backend (``_op_matmul_pair``):

    - 'default': float32 operands at ``Precision.DEFAULT``.  The backend
      picks the matmul arithmetic: exact float32 on the CPU; on a GPU, XLA
      may run it on the tensor cores in TF32 (~1e-4 of the peak on an
      H100).
    - 'highest': exact float32 everywhere (metrology, Doppler phase).
    - 'bf16': explicit bfloat16 operands with float32 accumulation
      (``preferred_element_type``), which halves the operand bytes.
    - 'int8': the quantized operator with dynamically per-row-quantized
      inputs, a display mode (``_op_matmul_pair_int8``).

    Measured accuracy vs the f64 reference path (pinned by
    tests/test_precision.py::test_bf16_branch_display_equivalent): bf16
    operand rounding moves B-scan pixels within 30 dB of the peak by
    < 0.1 dB (display-invisible); only the noise floor ≥ 30 dB down moves
    ~1-2 dB, which any practical display threshold clamps.  Metrology uses
    should set 'highest'.
    """
    re, im = _op_matmul_pair(yr, calib, precision)
    return jnp.sqrt(re * re + im * im)


def _op_matmul_pair(yr: jnp.ndarray, calib: Calibration,
                    precision: str) -> tuple[jnp.ndarray, jnp.ndarray]:
    """The (re, im) operator matmuls with one precision policy for every
    consumer, so |ascan_complex(yr)| always matches ascan_mags_fused(yr)."""
    # "int8_direct" is honored only by callers that carry an
    # int8direct.Int8DirectPlan (Session, bench); through this generic
    # entry point — where the background is a traced per-call argument and
    # cannot be folded — it degrades to the int8 tables when present, else
    # the bf16 branch.
    if precision in ("int8", "int8_direct") and calib.op_re_q is not None:
        return _op_matmul_pair_int8(yr, calib)
    if precision in ("bf16", "int8", "int8_direct") and yr.dtype == jnp.float32:
        z = yr.astype(jnp.bfloat16)
        re = jnp.matmul(z, calib.op_re.astype(jnp.bfloat16),
                        preferred_element_type=jnp.float32)
        im = jnp.matmul(z, calib.op_im.astype(jnp.bfloat16),
                        preferred_element_type=jnp.float32)
        return re, im
    prec = (jax.lax.Precision.HIGHEST if precision == "highest"
            else jax.lax.Precision.DEFAULT)
    re = jnp.matmul(yr, calib.op_re, preferred_element_type=yr.dtype,
                    precision=prec)
    im = jnp.matmul(yr, calib.op_im, preferred_element_type=yr.dtype,
                    precision=prec)
    return re, im


def _op_matmul_pair_int8(yr: jnp.ndarray,
                         calib: Calibration) -> tuple[jnp.ndarray, jnp.ndarray]:
    """int8 display path: s8 x s8 -> s32 matmuls against the quantized
    operator.

    The input is quantized dynamically per A-scan row with a symmetric
    scale.  Because the operator M already contains the per-row DC-removal
    projector (I - 1.1^T/n) as its first factor (calibration.Calibration),
    ``yr @ M == (yr - mean(yr)) @ M`` exactly — so the row mean is
    subtracted BEFORE quantization, shrinking the dynamic range from
    DC~1 +- fringes to fringes alone and buying several effective bits.
    Accuracy is characterized and pinned by
    tests/test_precision.py::test_int8_branch_display_equivalent."""
    f32 = jnp.float32
    y0 = yr.astype(f32)
    y0 = y0 - jnp.mean(y0, axis=-1, keepdims=True)
    s_in = jnp.max(jnp.abs(y0), axis=-1, keepdims=True) / 127.0
    s_in = jnp.maximum(s_in, jnp.finfo(f32).tiny)
    q = jnp.round(y0 / s_in).astype(jnp.int8)
    acc_re = jnp.matmul(q, calib.op_re_q, preferred_element_type=jnp.int32)
    acc_im = jnp.matmul(q, calib.op_im_q, preferred_element_type=jnp.int32)
    re = acc_re.astype(f32) * (s_in * calib.op_scale_re)
    im = acc_im.astype(f32) * (s_in * calib.op_scale_im)
    if yr.dtype != f32:
        re, im = re.astype(yr.dtype), im.astype(yr.dtype)
    return re, im


def ascan_complex(yr: jnp.ndarray, calib: Calibration,
                  precision: str = "default") -> jnp.ndarray:
    """Complex A-scans (phase-resolved OCT / Doppler use): the fused
    operator's (re, im) pair before the magnitude.  No reference equivalent
    (the reference discards phase at BscanFFT.cpp:1190); exposed because
    the fused path computes it for free.  Shares ``_op_matmul_pair`` with
    ascan_mags_fused so the two paths agree bit-for-bit at any precision.

    Precision caveat: only MAGNITUDE accuracy is characterized for the
    quantized modes (tests/test_precision.py pins 'int8' display
    equivalence).  Under 'int8' the re/im channels carry independent
    per-column scales and input quantization noise, so the PHASE error is
    unbounded at low-SNR depths — phase-resolved consumers (Doppler,
    vibrometry phase) should use 'default'/'bf16'/'highest'; the shipped
    Doppler callers do."""
    re, im = _op_matmul_pair(yr, calib, precision)
    return jax.lax.complex(re, im)


def ascan_mags(yr: jnp.ndarray, calib: Calibration, method: str = "fused",
               precision: str = "default") -> jnp.ndarray:
    if method == "fused":
        return ascan_mags_fused(yr, calib, precision)
    if method == "fused_exact":
        return ascan_mags_fused(yr, calib, "highest")
    if method == "gather":
        return ascan_mags_gather(yr, calib)
    if method == "hilbert":
        # analytic-signal estimator (the wangOCTrec4.m alternative):
        # complex fringe from the Hilbert transform of the k-linear
        # spectrum, then |IFFT|
        from fdoct_tpu.ops.hilbert import hilbert_reconstruct
        return hilbert_reconstruct(linearize(yr, calib), calib.ndisp)
    raise ValueError(f"unknown method {method!r}")


# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("cfg", "method", "dtype"))
def reconstruct(raw_frames: jnp.ndarray, background: jnp.ndarray,
                pi_frame: jnp.ndarray, calib: Calibration,
                cfg: PipelineConfig, method: str = "fused",
                dtype=None) -> jnp.ndarray:
    """Full raw→magnitudes path for a batch of frames.

    raw_frames: (..., oph*bin, opw*bin) raw integers (or floats).
    Returns (..., oph, ndisp) A-scan magnitude stacks.
    """
    y = preprocess(raw_frames, cfg, dtype)
    yr = apodize_ratio(y, background, pi_frame, cfg)
    return ascan_mags(yr, calib, method, cfg.matmul_precision)


@partial(jax.jit, static_argnames=("cfg", "averages"))
def form_bscan(mag_sum: jnp.ndarray, cfg: PipelineConfig,
               averages: int = 1,
               bscanthreshold: float | jnp.ndarray | None = None,
               eps: float = 1e-5) -> BscanOutputs:
    """Accumulated magnitudes → displayed B-scan (reference:
    BscanFFT.cpp:1211-1255).

    mag_sum: (oph, ndisp) sum over ``averages`` frames (the reference's
    ``bscantransposed``).  Returns linear, dB and uint8-display images,
    all (depth, lateral).  ``eps`` is the log guard — 1e-5 in the live app
    (BscanFFT.cpp:1222), 1e-6 in the simulator (BscanFFTsim.cpp:949).
    """
    thresh = cfg.bscanthreshold if bscanthreshold is None else bscanthreshold
    # The chain runs UNTRANSPOSED (rows = lateral, cols = depth) so the
    # global min/max reduction fuses with the elementwise dB chain and the
    # transpose sinks into the final display kernel; with the one-pass
    # minmax_pair the epilogue is 2 fusions instead of ~5 launches.
    # Values are bit-identical to the transposed-first formulation: every
    # step is elementwise, min/max are order-invariant, and pixel (5,5) is
    # symmetric under transpose.
    bscan_u = mag_sum / averages + eps                # ÷N + log guard (1220-1222)
    db_u = to_db(bscan_u, eps=0.0, compat=cfg.compat)   # 20·ln/2.303 (1235-1237)
    depth = jnp.arange(db_u.shape[-1])[None, :]
    # mask_dc_rows, untransposed: depth cols 0,1 ← col 4 (1239-1240)
    db_u = jnp.where(depth < 2, db_u[..., 4:5], db_u)
    disp_u = threshold_floor(db_u, thresh)            # display floor (1247)
    if cfg.clampupper:
        disp_u = clamp_pixel(disp_u, cfg.clampupperdb)  # absolute-scale px (1252)
    from fdoct_tpu.ops.scale import minmax_pair
    lo, hi = minmax_pair(disp_u)                      # ONE pass, both scalars
    rng = hi - lo
    safe = jnp.where(rng == 0, 1.0, rng)              # NORM_MINMAX semantics (1254)
    disp = jnp.where(rng == 0, 0.0, (jnp.swapaxes(disp_u, -1, -2) - lo) / safe)
    return BscanOutputs(bscan=jnp.swapaxes(bscan_u, -1, -2),
                        bscandb=jnp.swapaxes(db_u, -1, -2),
                        bscandisp=to_uint8(disp))


@partial(jax.jit, static_argnames=("cfg", "method", "averages", "dtype"))
def reconstruct_bscan(raw_frames: jnp.ndarray, background: jnp.ndarray,
                      pi_frame: jnp.ndarray, calib: Calibration,
                      cfg: PipelineConfig, method: str = "fused",
                      averages: int | None = None, dtype=None) -> BscanOutputs:
    """Batch of raw frames → one averaged, displayed B-scan.

    The one-call equivalent of ``averages`` iterations of the reference hot
    loop followed by its display block.
    """
    mags = reconstruct(raw_frames, background, pi_frame, calib, cfg, method, dtype)
    n = averages if averages is not None else (
        raw_frames.shape[0] if raw_frames.ndim == 3 else 1)
    mag_sum = mags.sum(axis=0) if mags.ndim == 3 else mags
    return form_bscan(mag_sum, cfg, n)
