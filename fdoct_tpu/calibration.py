"""λ→k calibration precompute and the fused reconstruction operator.

Reference precompute (BscanFFT.cpp:615-698): build the non-uniform k grid
from the λ range, a uniform ``klinear`` target grid, then for every target
point the nearest-lower-k index (first-match linear search) and a fractional
offset.  Here the same quantities are computed vectorized on host in float64,
once, into an immutable :class:`Calibration` pytree.

The speed core: everything between the apodization ratio
``yr = (y - data_yp)/data_yb`` and the A-scan magnitudes — per-row DC
removal, windowing, spectral zero-pad, k-linear resampling, dispersion
phase, and the (display-truncated) unnormalized inverse DFT — is *linear*
in ``yr``.  :func:`Calibration.create` therefore composes it into one
complex matrix ``M`` (n_raw × numdisplaypoints) by pushing the identity
matrix through the exact compat-mode pipeline, so the per-frame hot path is
a single matmul pair ``|yr @ M|`` instead of the reference's scalar loops
(BscanFFT.cpp:1135-1190).  The gather-based path (pipeline.py) retains
step-by-step semantics for bit-parity testing.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp

from fdoct_tpu.config import PipelineConfig
from fdoct_tpu.ops import windows as _windows
from fdoct_tpu.ops.resample import resample_matrix

_PI = np.pi


# ---------------------------------------------------------------------------
# host-side float64 helpers (numpy mirrors of ops.fft used only to build M)
# ---------------------------------------------------------------------------

def _np_zeropad_rowwise(x: np.ndarray, mult: int, bandpassfilter: bool = False) -> np.ndarray:
    """float64 NumPy mirror of ops.fft.zeropad_rowwise (reference:
    BscanFFT.cpp:180-245 / BscanDark.cpp:169-254)."""
    if mult <= 1 and not bandpassfilter:
        return x
    n = x.shape[-1]
    spec = np.fft.fftshift(np.fft.fft(x, axis=-1) / n, axes=-1)
    if bandpassfilter:
        tenth = n // 10
        keep = np.zeros(n, bool)
        keep[n // 2 - tenth: n // 2 + tenth] = True
        keep[n // 2 - 3: n // 2 + 3] = False
        spec = np.where(keep, spec, 0.0)
    z = (n * mult - n) // 2
    if z:
        spec = np.pad(spec, [(0, 0)] * (x.ndim - 1) + [(z, z)])
    return np.fft.ifft(np.fft.ifftshift(spec, axes=-1), axis=-1).real * spec.shape[-1]


def reference_grids(cfg: PipelineConfig) -> dict[str, np.ndarray]:
    """Vectorized reference λ→k precompute (BscanFFT.cpp:615-698).

    Returns lambdas, k (both length opw*mult), klinear, nearest_idx, frac
    (length numfftpoints), diffk.
    """
    opw = cfg.opw
    mult = max(cfg.increasefftpointsmultiplier, 1)
    nfft = cfg.numfftpoints
    n_in = opw * mult

    deltalambda = (cfg.lambdamax - cfg.lambdamin) / opw  # BscanFFT.cpp:615
    i = np.arange(n_in, dtype=np.float64)
    lambdas = cfg.lambdamin + i * deltalambda / mult      # BscanFFT.cpp:638-643
    k = 2 * _PI / lambdas                                 # BscanFFT.cpp:644
    kmin = 2 * _PI / (cfg.lambdamax - deltalambda)        # BscanFFT.cpp:645
    kmax = 2 * _PI / cfg.lambdamin                        # BscanFFT.cpp:646
    deltak = (kmax - kmin) / nfft
    f = np.arange(nfft, dtype=np.float64)
    klinear = kmin + (f + 1) * deltak                     # BscanFFT.cpp:649-653

    # diffk[i] = k[i-1] - k[i] (decreasing series), diffk[0] = diffk[1]
    diffk = np.empty(n_in)
    diffk[1:] = k[:-1] - k[1:]
    diffk[0] = diffk[1]                                   # BscanFFT.cpp:663-671

    # nearest lower-k index: first i with k[i] < klinear[f]
    # (first-match linear search, BscanFFT.cpp:673-690).  k is strictly
    # decreasing, so this is the count of k[i] >= klinear[f]; unfound → 0.
    nearest = np.searchsorted(-k, -klinear, side="right")
    nearest = np.where(nearest >= n_in, 0, nearest).astype(np.int32)

    frac = (klinear - k[nearest]) / diffk[nearest]        # BscanFFT.cpp:692-698
    return dict(lambdas=lambdas, k=k, klinear=klinear, diffk=diffk,
                nearest_idx=nearest, frac=frac, deltak=deltak)


# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Calibration:
    """Immutable per-config reconstruction tables (device pytree).

    Array leaves ride along through jit; static metadata is hashable.
    """

    # static
    n_raw: int = dataclasses.field(metadata=dict(static=True))
    n_in: int = dataclasses.field(metadata=dict(static=True))
    nfft: int = dataclasses.field(metadata=dict(static=True))
    ndisp: int = dataclasses.field(metadata=dict(static=True))
    mult: int = dataclasses.field(metadata=dict(static=True))
    compat: bool = dataclasses.field(metadata=dict(static=True))
    bandpassfilter: bool = dataclasses.field(metadata=dict(static=True))
    has_phase: bool = dataclasses.field(metadata=dict(static=True))

    # arrays
    lambdas: Any
    k: Any
    klinear: Any
    nearest_idx: Any
    frac: Any
    window: Any          # (n_raw,) apodization window
    phase: Any           # (nfft,) dispersion phase φ(k); zeros if unused
    op_re: Any           # (n_raw, ndisp) fused operator, real part
    op_im: Any           # (n_raw, ndisp) fused operator, imag part
    # int8-quantized operator (per-column symmetric scales) for the
    # matmul_precision="int8" display path (the inputs are camera counts
    # anyway).  None when absent (e.g. hand-built Calibrations); pipeline
    # falls back to bf16 then.
    op_re_q: Any = None      # (n_raw, ndisp) int8
    op_im_q: Any = None      # (n_raw, ndisp) int8
    op_scale_re: Any = None  # (ndisp,) f32 per-column dequant scale
    op_scale_im: Any = None  # (ndisp,) f32

    @classmethod
    def create(cls, cfg: PipelineConfig, dtype: Any = None) -> "Calibration":
        """Build all tables on host in float64, then cast to ``dtype``
        (default: cfg.dtype) for device residence."""
        cfg.validate()
        dtype = jnp.dtype(dtype or cfg.dtype)
        g = reference_grids(cfg)
        opw = cfg.opw
        mult = max(cfg.increasefftpointsmultiplier, 1)
        nfft = cfg.numfftpoints
        ndisp = min(cfg.numdisplaypoints, nfft)
        n_in = opw * mult

        win = np.asarray(_windows.get_window(cfg.window, opw)).astype(np.float64)

        # dispersion phase on the uniform k grid (framework extension)
        if cfg.dispersion_a2 or cfg.dispersion_a3:
            kl = g["klinear"]
            kc = (kl[0] + kl[-1]) / 2
            half = (kl[-1] - kl[0]) / 2
            x = (kl - kc) / half
            phase = cfg.dispersion_a2 * x**2 + cfg.dispersion_a3 * x**3
        else:
            phase = np.zeros(nfft)

        # ---- fused operator: push identity through the linear chain ----
        # rows of E are unit impulses at each raw spectral sample
        E = np.eye(opw)
        # per-row DC removal then window (BscanFFT.cpp:1135-1143)
        X = (E - E.mean(axis=-1, keepdims=True)) * win
        # spectral zero-pad ×mult (+ optional band-pass, BscanDark)
        X = _np_zeropad_rowwise(X, mult, cfg.bandpassfilter)
        # k-linear resample as matrix
        R = resample_matrix(g["nearest_idx"], g["frac"], n_in, compat=cfg.compat)
        X = X @ R
        # dispersion ⊙ truncated unnormalized inverse DFT:
        # IDFT[k, d] = exp(+2πi·k·d/nfft)  (OpenCV dft(DFT_INVERSE) has no
        # 1/N; BscanFFT.cpp:1185), columns truncated to the displayed depths
        # (BscanFFT.cpp:1195 keeps colRange(0, numdisplaypoints)).
        kk = np.arange(nfft)[:, None]
        dd = np.arange(ndisp)[None, :]
        F = np.exp((2j * _PI / nfft) * (kk * dd))
        if phase.any():
            F = np.exp(1j * phase)[:, None] * F
        M = X.astype(complex) @ F  # (opw, ndisp)

        # int8 quantization of the operator, symmetric per output column
        # (the contracted axis stays full precision in the f32 accumulator;
        # per-ROW input scales are computed dynamically in the pipeline).
        # Built only when the config asks for the int8 path: the tables cost
        # ~2 x n_raw x ndisp device bytes per calibration and replicate to
        # every device in the sharded paths; pipeline._op_matmul_pair
        # falls back to bf16 when they are None.  (matmul_precision
        # "int8_direct" quantizes its own folded operator in
        # fdoct_tpu.int8direct and does not need these.)
        if cfg.matmul_precision == "int8":
            def _quant_cols(A: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
                s = np.abs(A).max(axis=0) / 127.0
                s = np.where(s == 0.0, 1.0, s)
                q = np.clip(np.rint(A / s), -127, 127).astype(np.int8)
                return q, s.astype(np.float32)

            q_re, s_re = _quant_cols(M.real)
            q_im, s_im = _quant_cols(M.imag)
        else:
            q_re = s_re = q_im = s_im = None

        as_dev = lambda a: jnp.asarray(a, dtype=dtype)
        return cls(
            n_raw=opw, n_in=n_in, nfft=nfft, ndisp=ndisp, mult=mult,
            compat=cfg.compat, bandpassfilter=cfg.bandpassfilter,
            has_phase=bool(phase.any()),
            lambdas=as_dev(g["lambdas"]),
            k=as_dev(g["k"]),
            klinear=as_dev(g["klinear"]),
            nearest_idx=jnp.asarray(g["nearest_idx"]),
            frac=as_dev(g["frac"]),
            window=as_dev(win),
            phase=as_dev(phase),
            op_re=as_dev(M.real),
            op_im=as_dev(M.imag),
            op_re_q=None if q_re is None else jnp.asarray(q_re),
            op_im_q=None if q_im is None else jnp.asarray(q_im),
            op_scale_re=None if s_re is None else jnp.asarray(s_re),
            op_scale_im=None if s_im is None else jnp.asarray(s_im),
        )
