"""Spatial preprocessing filters.

Batched equivalents of the reference's OpenCV preprocessing: 2D median filter
(medianBlur, BscanFFT.cpp:952-956), software binning (resize INTER_AREA,
BscanFFT.cpp:958), weighted moving average smoothing (smoothmovavg,
BscanFFT.cpp:247-304), and the spinjnt output B-scan rebinning
(BscanFFTspinjnt.cpp:1856-1861).

All functions accept arbitrary leading batch dimensions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def smooth_moving_average(x: jnp.ndarray, n: int) -> jnp.ndarray:
    """2n+1-point weighted moving average along the last axis.

    x'(p) = ( x(p-n) + ... + 2*x(p) + ... + x(p+n) ) / (2*(n+1)),
    with the window truncated at the edges and the weight of the *centre*
    point increased by the number of truncated taps
    (reference: smoothmovavg, BscanFFT.cpp:247-304).

    Vectorized as: windowed zero-pad sum + (1 + #out-of-range-taps)·x(p),
    which is algebraically identical to the reference's scalar loop.
    """
    if n <= 0:
        return x
    L = x.shape[-1]
    # Sliding-window sum via padded cumulative sum: sum over [p-n, p+n] ∩ [0,L).
    pad = [(0, 0)] * (x.ndim - 1) + [(n + 1, n)]
    cs = jnp.cumsum(jnp.pad(x, pad), axis=-1)
    win_sum = (
        jax.lax.slice_in_dim(cs, 2 * n + 1, 2 * n + 1 + L, axis=-1)
        - jax.lax.slice_in_dim(cs, 0, L, axis=-1)
    )
    # Out-of-range tap count per position: the reference substitutes x(p)
    # for each truncated tap (BscanFFT.cpp:287).
    j = jnp.arange(L)
    oob = jnp.maximum(0, n - j) + jnp.maximum(0, j + n - (L - 1))
    oob = oob.astype(x.dtype)
    return (win_sum + (oob + 1.0) * x) / (2.0 * (n + 1))


def median_blur(img: jnp.ndarray, ksize: int) -> jnp.ndarray:
    """ksize×ksize 2D median filter with replicate borders over the last two
    axes (reference: medianBlur at BscanFFT.cpp:952-956, applied to the raw
    integer frame before binning).

    Implemented as a sort over the k² shifted planes — fully vectorized,
    VPU-friendly; k is 3/5/7 in practice.
    """
    if ksize <= 1:
        return img
    assert ksize % 2 == 1, "median aperture must be odd"
    r = ksize // 2
    pad = [(0, 0)] * (img.ndim - 2) + [(r, r), (r, r)]
    padded = jnp.pad(img, pad, mode="edge")
    h, w = img.shape[-2], img.shape[-1]
    planes = [
        jax.lax.slice_in_dim(
            jax.lax.slice_in_dim(padded, dy, dy + h, axis=-2), dx, dx + w, axis=-1
        )
        for dy in range(ksize)
        for dx in range(ksize)
    ]
    stacked = jnp.stack(planes, axis=0)
    med = jnp.sort(stacked, axis=0)[(ksize * ksize) // 2]
    return med


def bin_area(img: jnp.ndarray, bx: int, by: int | None = None) -> jnp.ndarray:
    """Integer-factor software binning = block averaging over the last two
    axes (reference: ``resize(m, opm, Size(), 1/binvalue, 1/binvalue,
    INTER_AREA)`` at BscanFFT.cpp:958 — for integer factors INTER_AREA is
    exactly the block mean).

    Integer inputs are rounded back to the input dtype, matching OpenCV's
    saturating integer resize (half-away-from-zero rounding).
    """
    by = bx if by is None else by
    if bx == 1 and by == 1:
        return img
    *lead, h, w = img.shape
    assert h % by == 0 and w % bx == 0, (
        f"frame {h}x{w} not divisible by bin {by}x{bx}"
    )
    blocks = img.reshape(*lead, h // by, by, w // bx, bx)
    if jnp.issubdtype(img.dtype, jnp.integer):
        mean = blocks.astype(jnp.float32).mean(axis=(-3, -1))
        return jnp.round(mean).astype(img.dtype)
    return blocks.mean(axis=(-3, -1))


def resize_area(img: jnp.ndarray, fx: int, fy: int) -> jnp.ndarray:
    """Alias of :func:`bin_area` with (fx, fy) downscale factors."""
    return bin_area(img, fx, fy)


import functools

import numpy as np


@functools.lru_cache(maxsize=64)
def _cv_cubic_matrix(n_in: int, n_out: int, a: float = -0.75) -> np.ndarray:
    """(n_out, n_in) interpolation matrix reproducing OpenCV INTER_CUBIC:
    Catmull-Rom-family cubic kernel with a = -0.75, half-pixel-centred
    source coordinates, clamped (replicate) borders.  Built once per shape;
    the resize then runs as two small matmuls."""
    scale = n_in / n_out
    d = np.arange(n_out)
    src = (d + 0.5) * scale - 0.5
    i0 = np.floor(src).astype(int)
    t = src - i0

    def kern(x):
        x = np.abs(x)
        return np.where(
            x <= 1, (a + 2) * x**3 - (a + 3) * x**2 + 1,
            np.where(x < 2, a * x**3 - 5 * a * x**2 + 8 * a * x - 4 * a, 0.0))

    W = np.zeros((n_out, n_in))
    for o in (-1, 0, 1, 2):
        idx = np.clip(i0 + o, 0, n_in - 1)
        np.add.at(W, (d, idx), kern(t - o))
    return W


def resize_bicubic(img: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """Bicubic resize over the last two axes, OpenCV INTER_CUBIC semantics
    (a = -0.75 kernel), implemented as separable interpolation matmuls.

    Used by the spinjnt output-B-scan rebinning path: down-resize INTER_AREA
    then up-resize INTER_CUBIC back to the display size
    (reference: BscanFFTspinjnt.cpp:1856-1861).
    """
    h, w = img.shape[-2], img.shape[-1]
    Wr = jnp.asarray(_cv_cubic_matrix(h, out_h), img.dtype)
    Wc = jnp.asarray(_cv_cubic_matrix(w, out_w), img.dtype)
    return jnp.einsum("oh,...hw,pw->...op", Wr, img, Wc)


def channel_select(frame: jnp.ndarray, channelnum: int) -> jnp.ndarray:
    """Webcam color-channel selection (reference: BscanFFTwebcam.cpp
    1015-1039): channelnum 0/1/2 picks the B/G/R plane of an OpenCV-order
    (h, w, 3) frame; 3 sums all channels scaled by 1/(255*3).

    Accepts RGB-order numpy/JAX arrays (the PIL convention used by our
    imageio): OpenCV channel c == RGB channel 2-c.
    """
    if frame.ndim == 2:
        return frame
    if channelnum == 3:
        return frame.astype(jnp.float32).sum(axis=-1) / (255.0 * 3.0)
    return frame[..., 2 - channelnum]


def bscan_rebin(bscan: jnp.ndarray, binx: int, biny: int,
                multiplyfactor: float = 1.0) -> jnp.ndarray:
    """spinjnt output B-scan binning: INTER_AREA downscale by (binx, biny),
    scale by ``multiplyfactor``, then bicubic upscale back to the original
    size (reference: BscanFFTspinjnt.cpp:1856-1861)."""
    if binx == 1 and biny == 1:
        return bscan
    h, w = bscan.shape[-2], bscan.shape[-1]
    down = bin_area(bscan, binx, biny)
    return resize_bicubic(down * multiplyfactor, h, w)
