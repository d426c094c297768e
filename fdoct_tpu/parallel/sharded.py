"""Sharded reconstruction steps (shard_map + explicit collectives).

Layouts:
- raw frame batches  (B, H, W):  P('data', 'ascan', None)
- calibration tables: replicated
- B-scan outputs     (ndisp, H): P(None, 'ascan') — depth local, lateral
  sharded; replicated over 'data' after the psum averaging.
- C-scan volumes     (F, ndisp, H): P('data', None, None) — frames stay
  sharded, full B-scans assembled per frame by the all_gather over
  'ascan' (fully replicated with ``gather_full``).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from fdoct_tpu.calibration import Calibration
from fdoct_tpu.config import PipelineConfig
from fdoct_tpu.ops import to_db
from fdoct_tpu.ops.filters import median_blur
from fdoct_tpu.ops.scale import (mask_dc_rows, minmax_pair, threshold_floor,
                                 to_uint8)
from fdoct_tpu.pipeline import apodize_ratio, ascan_mags, preprocess


def _preprocess_sharded(fr, cfg: PipelineConfig, n_ascan: int):
    """``pipeline.preprocess`` inside a shard body, with the median
    filter's cross-shard row dependency satisfied by a halo exchange.

    The k×k median (reference medianBlur, BscanFFT.cpp:952-956) reads
    k//2 rows past each row-block edge; with rows sharded over 'ascan'
    the shard-local filter would see replicated edges at every internal
    cut instead of the true neighbor rows.  Each
    shard therefore ppermutes its k//2 boundary rows to its neighbors,
    filters the extended block, and keeps the interior — bit-identical to
    the single-device filter.  The global top/bottom shards substitute
    replicated edge rows, exactly what BORDER_REPLICATE pads with.

    Requires local raw rows >= k//2 so one neighbor hop completes the
    halo (Session._mesh_ok gates on it).
    """
    k = cfg.mediann
    if k > 1 and n_ascan > 1:
        h = k // 2
        if fr.shape[-2] < h:
            raise ValueError(
                f"median halo needs >= {h} local rows per 'ascan' shard, "
                f"got {fr.shape[-2]} (mediann={k}, {n_ascan} shards) — use "
                f"fewer 'ascan' shards for this frame height")
        from_above = lax.ppermute(
            fr[..., -h:, :], "ascan", [(i, i + 1) for i in range(n_ascan - 1)])
        from_below = lax.ppermute(
            fr[..., :h, :], "ascan", [(i + 1, i) for i in range(n_ascan - 1)])
        idx = lax.axis_index("ascan")
        top = jnp.where(idx == 0,
                        jnp.broadcast_to(fr[..., :1, :], from_above.shape),
                        from_above)
        bot = jnp.where(idx == n_ascan - 1,
                        jnp.broadcast_to(fr[..., -1:, :], from_below.shape),
                        from_below)
        ext = jnp.concatenate([top, fr, bot], axis=-2)
        # the kept interior rows never touch median_blur's own pad rows
        fr = median_blur(ext, k)[..., h:-h, :]
        cfg = cfg.replace(mediann=0)
    return preprocess(fr, cfg)


def shard_frames(frames: jnp.ndarray, mesh: Mesh) -> jnp.ndarray:
    """Place a (B, H, W) frame batch with frames over 'data' and A-scan rows
    over 'ascan' (the host→device input seam; the moral successor of
    GetQHYCCDLiveFrame is a device_put with this sharding)."""
    return jax.device_put(frames, NamedSharding(mesh, P("data", "ascan", None)))


def _display_tail(local_mags_sum: jnp.ndarray, batch: int,
                  cfg: PipelineConfig, thresh=None,
                  eps: float = 1e-5) -> tuple[jnp.ndarray, jnp.ndarray,
                                              jnp.ndarray]:
    """The psum + display tail shared by the f32 and int8-direct B-scan
    step bodies — ONE implementation so the mesh paths (offline steps AND
    the session-facing steps below) and the single-device
    ``pipeline.form_bscan`` (whose semantics this mirrors,
    BscanFFT.cpp:1211-1255) cannot drift.

    Runs inside shard_map: psum over 'data' completes the group average
    (the local block is (h_loc, ndisp)); DC-row masking is local because
    depth is unsharded (ops.scale.mask_dc_rows); the display normalization
    reduces over 'ascan' with pmin/pmax scalars.

    ``thresh`` defaults to the config's static bscanthreshold; the session
    steps pass it as a traced replicated scalar so the '['/']' keys adjust
    it live without recompiling.  Returns (linear bscan, dB, disp01).
    """
    group = lax.psum(local_mags_sum, "data")
    bscan = group.T / batch + eps                 # (ndisp, h_loc)
    db = to_db(bscan, eps=0.0, compat=cfg.compat)
    db = mask_dc_rows(db)
    disp = threshold_floor(db, cfg.bscanthreshold if thresh is None
                           else thresh)
    if cfg.clampupper:
        # absolute-scale pixel (the 'q' display mode, BscanFFT.cpp:1248-53):
        # form_bscan clamps GLOBAL pixel (5,5); here columns are sharded
        # over 'ascan', so offset the column iota by the shard's global
        # start — exactly one shard owns the pixel, matching single-device
        col0 = lax.axis_index("ascan") * disp.shape[1]
        r = jnp.arange(disp.shape[0])[:, None]
        c = jnp.arange(disp.shape[1])[None, :] + col0
        disp = jnp.where((r == 5) & (c == 5),
                         jnp.asarray(cfg.clampupperdb, disp.dtype), disp)
    # one-pass local (min, max) like the single-device form_bscan
    # (ops.scale.minmax_pair), then the scalar collectives
    lmin, lmax = minmax_pair(disp)
    gmin = lax.pmin(lmin, "ascan")
    gmax = lax.pmax(lmax, "ascan")
    rng = jnp.where(gmax > gmin, gmax - gmin, 1.0)
    return bscan, db, (disp - gmin) / rng


def _assemble_volume(mags: jnp.ndarray, gather_full: bool) -> jnp.ndarray:
    """C-scan assembly shared by the f32 and int8 volume bodies: gather the
    'ascan'-sharded rows into complete B-scans, (f_loc, nd, H) per device;
    optionally replicate over 'data' too."""
    mags = lax.all_gather(mags, "ascan", axis=1, tiled=True)
    vol = jnp.swapaxes(mags, 1, 2)                 # (f_loc, nd, H)
    if gather_full:
        vol = lax.all_gather(vol, "data", axis=0, tiled=True)
    return vol


def _bscan_step_fn(fr, yb, yp, calib: Calibration, *, cfg: PipelineConfig,
                   method: str, batch: int, n_ascan: int = 1):
    """Per-shard body of :func:`sharded_bscan_step` (module-level so the
    scaling harness can lower/compile it standalone to measure collective
    traffic from the emitted HLO).  ``calib`` is a traced argument (its
    array leaves replicate over the mesh) so the jitted step is cacheable
    across calls."""
    y = _preprocess_sharded(fr, cfg, n_ascan)
    yr = apodize_ratio(y, yb, yp, cfg, ascan_axis="ascan")
    # cfg.matmul_precision threads through so the mesh path computes the
    # same numbers as the single-chip path (int8_direct folds per-device
    # plans elsewhere; here it degrades like pipeline._op_matmul_pair)
    mags = ascan_mags(yr, calib, method,
                      cfg.matmul_precision)       # (b_loc, h_loc, ndisp)
    return _display_tail(jnp.sum(mags, axis=0), batch, cfg)[1:]


@lru_cache(maxsize=None)
def _jitted_bscan_step(mesh: Mesh, cfg: PipelineConfig, method: str,
                       batch: int):
    fn = shard_map(
        partial(_bscan_step_fn, cfg=cfg, method=method, batch=batch,
                n_ascan=mesh.shape["ascan"]),
        mesh=mesh,
        in_specs=(P("data", "ascan", None), P("ascan", None),
                  P("ascan", None), P()),   # calib pytree: replicated
        out_specs=(P(None, "ascan"), P(None, "ascan")),
    )
    return jax.jit(fn)


def build_bscan_step(mesh: Mesh, calib: Calibration, cfg: PipelineConfig,
                     method: str, batch: int):
    """The jitted sharded B-scan step as a callable — shared by
    :func:`sharded_bscan_step`, the scaling harness (which lowers it to
    count collective bytes in the emitted HLO), and the traffic test, so
    all three see the identical compiled module.

    The underlying jit object is cached on (mesh, cfg, method, batch) with
    the calibration passed as a traced (replicated) argument — repeated
    calls reuse the compiled executable instead of re-tracing (a fresh
    ``jax.jit(shard_map(...))`` per call compiled EVERY step; measured
    seconds per call at the flagship shape)."""
    jfn = _jitted_bscan_step(mesh, cfg, method, batch)

    def step(frames, background, pi_frame):
        return jfn(frames, background, pi_frame, calib)

    step.lower = lambda fr, yb, yp: jfn.lower(fr, yb, yp, calib)
    return step


def sharded_bscan_step(frames: jnp.ndarray, background: jnp.ndarray,
                       pi_frame: jnp.ndarray, calib: Calibration,
                       cfg: PipelineConfig, mesh: Mesh,
                       method: str = "fused"):
    """One averaged B-scan from a sharded frame batch.

    ``frames`` (B, H, W) raw; every frame in the batch belongs to the same
    averaging group (B = averages).  Local magnitudes accumulate on-device,
    ``psum`` over 'data' completes the group average, and the display
    normalization does its global min/max over 'ascan' with pmin/pmax —
    total communication: one (H_loc × ndisp) psum + 2 scalars.

    Returns (bscan_db, bscan_disp01) with layout P(None, 'ascan'),
    jit-compiled over the mesh.
    """
    return build_bscan_step(mesh, calib, cfg, method,
                            frames.shape[0])(frames, background, pi_frame)


# ---------------------------------------------------------------------------
# int8-direct on the mesh: the same two-s8-matmul display path
# (fdoct_tpu.int8direct) sharded like the f32 step.  The quantized operator
# and dequant scales replicate (they are per-spectral-column); the per-ROW
# tables (1/u gain, pi/dark constant correction) shard over 'ascan' with
# the frame rows they correct.
# ---------------------------------------------------------------------------


def _int8_plan_specs(plan):
    """PartitionSpec pytree for an Int8DirectPlan: row-indexed leaves shard
    over 'ascan', spectral/operator leaves replicate.

    Fields that are ``None`` on the plan (e.g. the rank-2 operator pair on
    a rank-1 plan) must STAY None so the spec pytree has exactly the same
    leaf structure as the plan — a spec where the plan has no leaf would
    desynchronize the two flattenings.  Conversely a rank-2 plan
    (create(rank=2), the measured rank-2 experiment) gets specs
    for its second operator pair: operator/scales replicate, the per-row
    gain shards over 'ascan' with the rows it scales."""
    import dataclasses as _dc
    repl = dict(
        oq_re=P(), oq_im=P(), s_re=P(), s_im=P(),
        row_gain_inv=P("ascan", None),
        const_re=P("ascan", None), const_im=P("ascan", None),
        bg_rank1_resid=P(),
        oq2_re=P(), oq2_im=P(), s2_re=P(), s2_im=P(),
        row_gain2=P("ascan", None),
    )
    repl = {k: v for k, v in repl.items()
            if getattr(plan, k, None) is not None}
    return _dc.replace(plan, **repl)


def _bscan_step_int8_fn(fr, plan, *, cfg: PipelineConfig, batch: int):
    """Per-shard body of :func:`sharded_bscan_step_int8`: device-side u8→s8
    bias shift, two s8 matmuls against the folded plan, then the same
    psum/display tail as the f32 step."""
    from fdoct_tpu.int8direct import reconstruct_int8_direct, shift_u8_to_s8

    mags = reconstruct_int8_direct(shift_u8_to_s8(fr), plan)
    return _display_tail(jnp.sum(mags, axis=0), batch, cfg)[1:]


@lru_cache(maxsize=None)
def _jitted_bscan_step_int8(mesh: Mesh, cfg: PipelineConfig, batch: int,
                            plan_treedef, spec_leaves):
    """The jit object is cached on (mesh, cfg, batch, plan structure) so
    repeated calls reuse the compiled executable — the plan's ARRAY leaves
    are traced arguments (a rebuilt plan after a 'b' capture does not
    recompile)."""
    def body(fr, *plan_leaves):
        plan = jax.tree_util.tree_unflatten(plan_treedef, plan_leaves)
        return _bscan_step_int8_fn(fr, plan, cfg=cfg, batch=batch)

    return jax.jit(shard_map(
        body, mesh=mesh,
        in_specs=(P("data", "ascan", None), *spec_leaves),
        out_specs=(P(None, "ascan"), P(None, "ascan")),
    ))


def build_bscan_step_int8(mesh: Mesh, plan, cfg: PipelineConfig, batch: int):
    """Jitted sharded int8-direct B-scan step (the mesh counterpart of
    Session's int8_direct fast path)."""
    leaves, treedef = jax.tree_util.tree_flatten(plan)
    spec_leaves = tuple(jax.tree_util.tree_leaves(
        _int8_plan_specs(plan), is_leaf=lambda x: isinstance(x, P)))
    fn = _jitted_bscan_step_int8(mesh, cfg, batch, treedef, spec_leaves)

    def step(frames):
        return fn(frames, *leaves)

    step.lower = lambda fr: fn.lower(fr, *leaves)
    return step


def sharded_bscan_step_int8(frames: jnp.ndarray, plan,
                            cfg: PipelineConfig, mesh: Mesh):
    """One averaged B-scan from a sharded u8 frame batch on the int8-direct
    display path; layouts match :func:`sharded_bscan_step`."""
    return build_bscan_step_int8(mesh, plan, cfg,
                                 frames.shape[0])(frames)


@lru_cache(maxsize=None)
def _jitted_cscan_volume_int8(mesh: Mesh, gather_full: bool,
                              plan_treedef, spec_leaves):
    from fdoct_tpu.int8direct import reconstruct_int8_direct, shift_u8_to_s8

    def step(fr, *plan_leaves):
        plan = jax.tree_util.tree_unflatten(plan_treedef, plan_leaves)
        mags = reconstruct_int8_direct(shift_u8_to_s8(fr), plan)
        return _assemble_volume(mags, gather_full)

    out_spec = P(None, None, None) if gather_full else P("data", None, None)
    return jax.jit(shard_map(
        step, mesh=mesh,
        in_specs=(P("data", "ascan", None), *spec_leaves),
        out_specs=out_spec,
        check_vma=False,   # all_gather replicates; see _jitted_cscan_volume
    ))


def sharded_cscan_volume_int8(frames: jnp.ndarray, plan,
                              cfg: PipelineConfig, mesh: Mesh,
                              gather_full: bool = False):
    """Volumetric C-scan on the int8-direct display path: per-frame raw
    magnitudes like :func:`sharded_cscan_volume`, but each device's block
    reconstructs via the folded s8 operator (two int8 matmuls per
    frame).  ``cfg`` is accepted for interface symmetry (the plan already
    encodes the geometry)."""
    del cfg
    leaves, treedef = jax.tree_util.tree_flatten(plan)
    spec_leaves = tuple(jax.tree_util.tree_leaves(
        _int8_plan_specs(plan), is_leaf=lambda x: isinstance(x, P)))
    fn = _jitted_cscan_volume_int8(mesh, gather_full, treedef, spec_leaves)
    return fn(frames, *leaves)


# ---------------------------------------------------------------------------
# Session-facing mesh steps: the live data path on the mesh.
#
# These are what Session.process_group rides when constructed with a mesh —
# the architectural seat of the reference's acquisition loop
# (BscanFFT.cpp:946-1925, GetQHYCCDLiveFrame at :948) as sharded B-scan
# batches (SURVEY.md §2.5/§5).  They differ from the offline steps above in
# exactly two ways: the session's live bscanthreshold is a TRACED replicated
# scalar (the '['/']' keys adjust it without recompiling), and the outputs
# are the full BscanResult triple (linear, dB, uint8 display) with layout
# P(None, 'ascan') so the session can serve plugins/saves identically to the
# single-device fast path (tests/test_streaming.py pins the parity).
# ---------------------------------------------------------------------------


def _session_bscan_step_fn(fr, yb, yp, yd, thresh, calib: Calibration, *,
                           cfg: PipelineConfig, method: str, batch: int,
                           dark: bool, n_ascan: int = 1,
                           keep_frames: bool = False,
                           keep_binned: bool = False):
    y = _preprocess_sharded(fr, cfg, n_ascan)
    if dark:
        y = y - yd                                # BscanDark.cpp:1269
    yr = apodize_ratio(y, yb, yp, cfg, ascan_axis="ascan")
    mags = ascan_mags(yr, calib, method, cfg.matmul_precision)
    bscan, db, disp01 = _display_tail(jnp.sum(mags, axis=0), batch, cfg,
                                      thresh=thresh)
    out = [bscan, db, to_uint8(disp01)]
    # per-frame extras for the session's saveframes / saveinterferograms
    # ring buffers (BscanFFT.cpp:961-984) — the save flags stay on the
    # mesh fast path
    if keep_frames:
        out.append(mags)
    if keep_binned:
        out.append(y)
    return tuple(out)


@lru_cache(maxsize=None)
def _jitted_session_bscan_step(mesh: Mesh, cfg: PipelineConfig, method: str,
                               batch: int, dark: bool,
                               keep_frames: bool = False,
                               keep_binned: bool = False):
    n_extra = int(keep_frames) + int(keep_binned)
    fn = shard_map(
        partial(_session_bscan_step_fn, cfg=cfg, method=method, batch=batch,
                dark=dark, n_ascan=mesh.shape["ascan"],
                keep_frames=keep_frames, keep_binned=keep_binned),
        mesh=mesh,
        in_specs=(P("data", "ascan", None), P("ascan", None),
                  P("ascan", None), P("ascan", None), P(), P()),
        out_specs=(P(None, "ascan"),) * 3
        + (P("data", "ascan", None),) * n_extra,
    )
    return jax.jit(fn)


def build_session_bscan_step(mesh: Mesh, calib: Calibration,
                             cfg: PipelineConfig, method: str, batch: int,
                             dark: bool = False, keep_frames: bool = False,
                             keep_binned: bool = False):
    """Jitted sharded one-group session step: ``step(frames, yb, yp, yd,
    thresh) -> (bscan, bscandb, bscandisp_u8[, mags][, binned])``, cached
    like :func:`build_bscan_step` (the calibration is a traced replicated
    argument, so 'b'/'p' captures never recompile)."""
    jfn = _jitted_session_bscan_step(mesh, cfg, method, batch, dark,
                                     keep_frames, keep_binned)

    def step(frames, yb, yp, yd, thresh):
        return jfn(frames, yb, yp, yd, thresh, calib)

    # for the HLO collective-traffic accounting (scripts/bench_scaling.py,
    # tests/test_parallel.py) — the session step must move exactly the
    # same bytes as the offline step: one psum + two scalars
    step.lower = lambda fr, yb, yp, yd, th: jfn.lower(fr, yb, yp, yd, th,
                                                      calib)
    return step


@lru_cache(maxsize=None)
def _jitted_session_bscan_step_int8(mesh: Mesh, cfg: PipelineConfig,
                                    batch: int, plan_treedef, spec_leaves,
                                    keep_frames: bool = False):
    from fdoct_tpu.int8direct import reconstruct_int8_direct, shift_u8_to_s8

    def body(fr, thresh, *plan_leaves):
        plan = jax.tree_util.tree_unflatten(plan_treedef, plan_leaves)
        mags = reconstruct_int8_direct(shift_u8_to_s8(fr), plan)
        bscan, db, disp01 = _display_tail(jnp.sum(mags, axis=0), batch, cfg,
                                          thresh=thresh)
        out = (bscan, db, to_uint8(disp01))
        return out + ((mags,) if keep_frames else ())

    return jax.jit(shard_map(
        body, mesh=mesh,
        in_specs=(P("data", "ascan", None), P(), *spec_leaves),
        out_specs=(P(None, "ascan"),) * 3
        + ((P("data", "ascan", None),) if keep_frames else ()),
    ))


def build_session_bscan_step_int8(mesh: Mesh, plan, cfg: PipelineConfig,
                                  batch: int, keep_frames: bool = False):
    """int8-direct session step on the mesh: ``step(frames_u8, thresh) ->
    (bscan, bscandb, bscandisp_u8[, mags])``; plan array leaves are traced
    so a rebuilt plan after a 'b' capture reuses the compiled executable."""
    leaves, treedef = jax.tree_util.tree_flatten(plan)
    spec_leaves = tuple(jax.tree_util.tree_leaves(
        _int8_plan_specs(plan), is_leaf=lambda x: isinstance(x, P)))
    fn = _jitted_session_bscan_step_int8(mesh, cfg, batch, treedef,
                                         spec_leaves, keep_frames)

    def step(frames, thresh):
        return fn(frames, thresh, *leaves)

    return step


@lru_cache(maxsize=None)
def _jitted_cscan_volume(mesh: Mesh, cfg: PipelineConfig, method: str,
                         gather_full: bool):
    def step(fr, yb, yp, calib):
        y = _preprocess_sharded(fr, cfg, mesh.shape["ascan"])
        yr = apodize_ratio(y, yb, yp, cfg, ascan_axis="ascan")
        mags = ascan_mags(yr, calib, method,
                          cfg.matmul_precision)           # (f_loc, h_loc, nd)
        return _assemble_volume(mags, gather_full)

    out_spec = P(None, None, None) if gather_full else P("data", None, None)
    fn = shard_map(
        step, mesh=mesh,
        in_specs=(P("data", "ascan", None), P("ascan", None),
                  P("ascan", None), P()),   # calib pytree: replicated
        out_specs=out_spec,
        # all_gather makes the output replicated over the gathered axis; the
        # static varying-axes check cannot infer that, so disable it
        check_vma=False,
    )
    return jax.jit(fn)


def build_cscan_volume(mesh: Mesh, calib: Calibration, cfg: PipelineConfig,
                       method: str = "fused", gather_full: bool = False):
    """The jitted sharded C-scan volume assembly as a callable (shared by
    :func:`sharded_cscan_volume` and the scaling harness's HLO traffic
    accounting).  Cached like :func:`build_bscan_step`."""
    jfn = _jitted_cscan_volume(mesh, cfg, method, gather_full)

    def vol(frames, background, pi_frame):
        return jfn(frames, background, pi_frame, calib)

    vol.lower = lambda fr, yb, yp: jfn.lower(fr, yb, yp, calib)
    return vol


def sharded_cscan_volume(frames: jnp.ndarray, background: jnp.ndarray,
                         pi_frame: jnp.ndarray, calib: Calibration,
                         cfg: PipelineConfig, mesh: Mesh,
                         method: str = "fused",
                         gather_full: bool = False):
    """Volumetric C-scan: per-frame B-scans for a (F, H, W) volume.

    Frames shard over 'data', rows over 'ascan'.  Each device reconstructs
    its block locally; ``all_gather`` over 'ascan' assembles complete
    B-scans so the volume comes out P('data', None, None) — or fully
    replicated when ``gather_full`` (an extra all_gather over 'data').
    """
    return build_cscan_volume(mesh, calib, cfg, method, gather_full)(
        frames, background, pi_frame)
