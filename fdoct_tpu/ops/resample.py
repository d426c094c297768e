"""λ→k spectral resampling (linearization in wavenumber).

The reference precomputes, for each uniform-k output point q, the index of the
nearest lower non-uniform k sample (``nearestkindex``, first-match linear
search, BscanFFT.cpp:673-690) and a fractional offset (``fractionalk``,
BscanFFT.cpp:692-698), then per frame interpolates row-wise with scalar loops
(BscanFFT.cpp:1150-1177).  That per-frame loop is the dominant CPU cost of
the reference; here it is a precomputed gather (or one matmul — see
:func:`resample_matrix`) over the whole frame.

Two faithful semantics are provided:

- ``compat=True`` reproduces the reference *exactly*, including its two
  idiosyncrasies (BscanFFT.cpp:1169-1171):
  (a) ``fractionalk`` is indexed by ``nearestkindex[q]`` rather than ``q``
      (single-arg ``Mat::at`` on the 1×nfft Mat → flat index), and
  (b) the slope term is *added*: ``ylin[q] = y[near[q]] +
      frac[near[q]] * (y[near[q]] - y[near[q]-1])``.
  Output columns 0 and nfft-1 are left untouched by the reference
  (uninitialized memory); compat mode writes 0 there, which is what the
  reference's own commented-out initialization intended
  (BscanFFT.cpp:1174-1175).  When ``near[q] >= nfft`` the reference reads out
  of bounds; compat mode clamps the index (documented deviation).

- ``compat=False`` is the mathematically correct linear interpolation:
  ``ylin[q] = y[near[q]] + frac[q] * (y[near[q]-1] - y[near[q]])`` with
  ``frac[q] = (klin[q] - k[near[q]]) / (k[near[q]-1] - k[near[q]])``,
  all output columns valid.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def row_slopes(y: jnp.ndarray) -> jnp.ndarray:
    """Backward differences per row, first column copied from the second
    (reference: BscanFFT.cpp:1153-1161)."""
    d = jnp.diff(y, axis=-1)
    return jnp.concatenate([d[..., :1], d], axis=-1)


def resample_klinear(
    y: jnp.ndarray,
    nearest_idx: jnp.ndarray,
    frac: jnp.ndarray,
    compat: bool = True,
) -> jnp.ndarray:
    """Gather-based k-linearization of ``y`` (..., n_in) → (..., nfft).

    ``nearest_idx`` (int32, (nfft,)) and ``frac`` ((nfft,)) come from
    :class:`fdoct_tpu.calibration.Calibration`; in compat mode ``frac`` must
    be the reference's ``fractionalk`` table and is re-indexed by
    ``nearest_idx`` here, mirroring BscanFFT.cpp:1169-1171.
    """
    nfft = nearest_idx.shape[-1]
    slopes = row_slopes(y)
    yg = jnp.take(y, nearest_idx, axis=-1)
    sg = jnp.take(slopes, nearest_idx, axis=-1)
    if compat:
        fidx = jnp.clip(nearest_idx, 0, nfft - 1)
        f = jnp.take(frac, fidx, axis=-1)
        ylin = yg + f * sg
        # reference leaves columns 0 and nfft-1 unwritten (BscanFFT.cpp:1164:
        # loop runs q = 1 .. nfft-2); zero them as its commented-out init did.
        mask = (jnp.arange(nfft) > 0) & (jnp.arange(nfft) < nfft - 1)
        return jnp.where(mask, ylin, 0.0)
    return yg - frac * sg  # -frac*(y[i]-y[i-1]) == +frac*(y[i-1]-y[i])


def resample_matrix(
    nearest_idx: np.ndarray,
    frac: np.ndarray,
    n_in: int,
    compat: bool = True,
    dtype=np.float64,
) -> np.ndarray:
    """Materialize the k-linearization as a dense (n_in, nfft) operator R so
    that ``ylin = y @ R``.

    The resampling is linear in ``y``, so the gather/fma above is equivalent
    to a sparse two-entries-per-column matrix; densified it becomes a
    matmul operand and composes with the window/DC-removal/IFFT operators into the single
    fused reconstruction matmul (see calibration.fused_operator).  Built on
    host with NumPy at calibration time.
    """
    nfft = nearest_idx.shape[-1]
    R = np.zeros((n_in, nfft), dtype=dtype)
    cols = np.arange(nfft)
    idx = nearest_idx.astype(np.int64)
    if compat:
        f = frac[np.clip(idx, 0, nfft - 1)]
        valid = (cols > 0) & (cols < nfft - 1)
    else:
        f = -frac  # clean mode: ylin = y[i] - frac*(y[i]-y[i-1])
        valid = np.ones(nfft, bool)
    # ylin[q] = y[idx] + f*(y[idx] - y[idx-1]); slope at idx==0 uses y[1]-y[0]
    prev = np.where(idx >= 1, idx - 1, 0)
    nxt = np.where(idx >= 1, idx, 1)          # slope[0] == slope[1]
    np.add.at(R, (idx[valid], cols[valid]), 1.0)
    np.add.at(R, (nxt[valid], cols[valid]), f[valid])
    np.add.at(R, (prev[valid], cols[valid]), -f[valid])
    return R
