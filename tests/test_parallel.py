"""Sharding tests on the virtual 8-device CPU mesh: sharded results must
bit-match the single-device pipeline."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fdoct_tpu.calibration import Calibration
from fdoct_tpu.config import PipelineConfig
from fdoct_tpu.parallel import (
    make_mesh, shard_frames, sharded_bscan_step, sharded_cscan_volume)
from fdoct_tpu.pipeline import form_bscan, reconstruct
from fdoct_tpu.sources.synthetic import SyntheticSource


@pytest.fixture(scope="module")
def cfg():
    return PipelineConfig(width=128, height=16, binvalue=1, averages=8,
                          numfftpoints=256, numdisplaypoints=64,
                          dtype="float64", compat=True)


@pytest.fixture(scope="module")
def setup(cfg, rng):
    src = SyntheticSource(height=cfg.height, width=cfg.width,
                          depths_um=(40.0, 70.0), noise=0.01, seed=7)
    it = iter(src.frames())
    frames = np.stack([next(it) for _ in range(8)])
    bg = np.maximum(src.background().astype(np.float64), 1.0)
    pi = np.zeros_like(bg)
    calib = Calibration.create(cfg)
    return frames, bg, pi, calib


def test_device_count():
    assert len(jax.devices()) == 8  # virtual CPU mesh from conftest


class TestMesh:
    def test_default_mesh(self):
        m = make_mesh()
        assert m.shape == {"data": 8, "ascan": 1}

    def test_2d_mesh(self):
        m = make_mesh(n_data=4, n_ascan=2)
        assert m.shape == {"data": 4, "ascan": 2}

    def test_bad_factorization(self):
        with pytest.raises(ValueError):
            make_mesh(n_data=3, n_ascan=2)


@pytest.mark.parametrize("ndata,nascan", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_bscan_matches_single_device(cfg, setup, ndata, nascan):
    frames, bg, pi, calib = setup
    mesh = make_mesh(ndata, nascan)
    sharded = shard_frames(jnp.asarray(frames), mesh)
    db_sh, disp_sh = sharded_bscan_step(
        sharded, jnp.asarray(bg), jnp.asarray(pi), calib, cfg, mesh)

    mags = reconstruct(jnp.asarray(frames), jnp.asarray(bg), jnp.asarray(pi),
                       calib, cfg, method="fused")
    ref = form_bscan(mags.sum(0), cfg, averages=8)
    assert np.allclose(np.asarray(db_sh), np.asarray(ref.bscandb), atol=1e-9)
    # disp compare against float normalize (pre-uint8)
    from fdoct_tpu.ops import normalize_minmax
    from fdoct_tpu.ops.scale import threshold_floor
    want = normalize_minmax(threshold_floor(ref.bscandb, cfg.bscanthreshold))
    assert np.allclose(np.asarray(disp_sh), np.asarray(want), atol=1e-9)


@pytest.mark.parametrize("ndata,nascan", [(8, 1), (4, 2), (2, 4)])
def test_sharded_clampupper_matches_single_device(cfg, setup, ndata, nascan):
    """The absolute-scale display mode (cfg.clampupper pins GLOBAL pixel
    (5,5) to clampupperdb before normalization, BscanFFT.cpp:1248-1253)
    must behave identically on the mesh: exactly ONE shard owns the pixel
    (the column iota is offset by the shard's global start), so the
    normalized display matches the single-device form_bscan chain.
    Regression: the sharded display tail used to omit the clamp entirely."""
    frames, bg, pi, calib = setup
    cfgc = cfg.replace(clampupper=True, clampupperdb=50.0)
    mesh = make_mesh(ndata, nascan)
    sharded = shard_frames(jnp.asarray(frames), mesh)
    db_sh, disp_sh = sharded_bscan_step(
        sharded, jnp.asarray(bg), jnp.asarray(pi), calib, cfgc, mesh)

    mags = reconstruct(jnp.asarray(frames), jnp.asarray(bg), jnp.asarray(pi),
                       calib, cfgc, method="fused")
    ref = form_bscan(mags.sum(0), cfgc, averages=8)
    from fdoct_tpu.ops import normalize_minmax
    from fdoct_tpu.ops.scale import clamp_pixel, threshold_floor
    want = normalize_minmax(clamp_pixel(
        threshold_floor(ref.bscandb, cfgc.bscanthreshold), cfgc.clampupperdb))
    assert np.allclose(np.asarray(disp_sh), np.asarray(want), atol=1e-9)
    # the clamp really landed: exactly one pixel pinned to the max
    assert np.asarray(disp_sh)[5, 5] == np.asarray(want)[5, 5]


@pytest.mark.parametrize("gather_full", [False, True])
def test_sharded_cscan_matches_single_device(cfg, setup, gather_full):
    frames, bg, pi, calib = setup
    mesh = make_mesh(4, 2)
    sharded = shard_frames(jnp.asarray(frames), mesh)
    vol = sharded_cscan_volume(sharded, jnp.asarray(bg), jnp.asarray(pi),
                               calib, cfg, mesh, gather_full=gather_full)
    mags = reconstruct(jnp.asarray(frames), jnp.asarray(bg), jnp.asarray(pi),
                       calib, cfg, method="fused")
    want = np.swapaxes(np.asarray(mags), 1, 2)  # (F, ndisp, H)
    assert vol.shape == want.shape
    assert np.allclose(np.asarray(vol), want, atol=1e-9)


def test_cscan_output_sharding(cfg, setup):
    frames, bg, pi, calib = setup
    mesh = make_mesh(4, 2)
    sharded = shard_frames(jnp.asarray(frames), mesh)
    vol = sharded_cscan_volume(sharded, jnp.asarray(bg), jnp.asarray(pi),
                               calib, cfg, mesh, gather_full=False)
    # volume stays sharded over frames ('data')
    spec = vol.sharding.spec
    assert spec[0] == "data"


class TestScalingHarness:
    """scripts/bench_scaling.py internals: the HLO collective-traffic
    parser and the module-level step fn it lowers."""

    def test_collective_bytes_parser(self):
        import sys
        from pathlib import Path
        sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
        from bench_scaling import collective_bytes

        hlo = """
  %ar = f32[256,512]{1,0} all-reduce(f32[256,512]{1,0} %x), replica_groups={}
  %s = f32[] all-reduce(f32[] %y), to_apply=%min
  %ag = f32[8,256,512]{2,1,0} all-gather(f32[8,128,512]{2,1,0} %z), dimensions={1}
  %other = f32[4]{0} add(f32[4]{0} %a, f32[4]{0} %b)
"""
        got = collective_bytes(hlo)
        assert got["all-reduce"] == 256 * 512 * 4 + 4
        assert got["all-gather"] == 8 * 256 * 512 * 4

    def test_collective_bytes_async_pair_counted_once(self):
        """-start results are operand-aliasing tuples (2x the real size);
        only the -done's plain result shape counts."""
        import sys
        from pathlib import Path
        sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
        from bench_scaling import collective_bytes

        hlo = """
  %st = (f32[256,512]{1,0}, f32[256,512]{1,0}) all-reduce-start(f32[256,512]{1,0} %x)
  %dn = f32[256,512]{1,0} all-reduce-done((f32[256,512]{1,0}, f32[256,512]{1,0}) %st)
"""
        got = collective_bytes(hlo)
        assert got["all-reduce"] == 256 * 512 * 4

    def test_measured_psum_traffic_matches_design(self, small_cfg):
        """The compiled sharded B-scan step moves exactly one
        (H_loc x ndisp) psum + 2 scalars over the mesh."""
        import sys
        from pathlib import Path

        import jax

        sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
        from bench_scaling import collective_bytes

        from fdoct_tpu.calibration import Calibration
        from fdoct_tpu.parallel import make_mesh, shard_frames
        from fdoct_tpu.parallel.sharded import build_bscan_step

        cfg = small_cfg
        calib = Calibration.create(cfg)
        mesh = make_mesh(2, 2, devices=jax.devices()[:4])
        rng = np.random.default_rng(0)
        frames = shard_frames(jnp.asarray(
            rng.integers(0, 255, (4, cfg.height, cfg.width)).astype(np.uint8)),
            mesh)
        bg = jnp.full((cfg.oph, cfg.opw), 128.0, cfg.dtype)
        pi = jnp.zeros_like(bg)
        fn = build_bscan_step(mesh, calib, cfg, "fused", 4)
        hlo = fn.lower(frames, bg, pi).compile().as_text()
        got = collective_bytes(hlo)
        h_loc = cfg.oph // 2
        itemsize = jnp.dtype(cfg.dtype).itemsize
        expect = h_loc * calib.ndisp * itemsize + 2 * itemsize
        assert got.get("all-reduce", 0) == expect, (got, expect)

    def test_session_step_traffic_matches_offline_step(self, small_cfg):
        """The r4 session-facing mesh step (traced threshold, three
        outputs) must move EXACTLY the same bytes as the offline step —
        the extra (linear, uint8) outputs are local transforms, and the
        traced threshold is replicated, so nothing new crosses the mesh."""
        import sys
        from pathlib import Path

        import jax

        sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
        from bench_scaling import collective_bytes

        from fdoct_tpu.calibration import Calibration
        from fdoct_tpu.parallel import make_mesh, shard_frames
        from fdoct_tpu.parallel.sharded import build_session_bscan_step

        cfg = small_cfg
        calib = Calibration.create(cfg)
        mesh = make_mesh(2, 2, devices=jax.devices()[:4])
        rng = np.random.default_rng(0)
        frames = shard_frames(jnp.asarray(
            rng.integers(0, 255, (4, cfg.height, cfg.width)).astype(np.uint8)),
            mesh)
        bg = jnp.full((cfg.oph, cfg.opw), 128.0, cfg.dtype)
        pi = jnp.zeros_like(bg)
        yd = jnp.zeros_like(bg)
        thresh = jnp.asarray(cfg.bscanthreshold, cfg.dtype)
        fn = build_session_bscan_step(mesh, calib, cfg, "fused", 4)
        hlo = fn.lower(frames, bg, pi, yd, thresh).compile().as_text()
        got = collective_bytes(hlo)
        h_loc = cfg.oph // 2
        itemsize = jnp.dtype(cfg.dtype).itemsize
        expect = h_loc * calib.ndisp * itemsize + 2 * itemsize
        assert got.get("all-reduce", 0) == expect, (got, expect)
        assert got.get("all-gather", 0) == 0, got


class TestShardedInt8Direct:
    """The int8-direct display path on the mesh must match its own
    single-device result (the quantized op replicates; the per-row gain
    and pi-correction tables shard over 'ascan' with their frame rows)."""

    @pytest.mark.parametrize("ndata,nascan", [(8, 1), (4, 2), (2, 4)])
    def test_matches_single_device(self, ndata, nascan):
        from fdoct_tpu.int8direct import (Int8DirectPlan,
                                          reconstruct_int8_direct, to_s8)
        from fdoct_tpu.ops import to_db
        from fdoct_tpu.ops.scale import threshold_floor
        from fdoct_tpu.parallel import sharded_bscan_step_int8
        from fdoct_tpu.ops.scale import mask_dc_rows

        cfg8 = PipelineConfig(width=128, height=16, binvalue=1, averages=8,
                              numfftpoints=256, numdisplaypoints=64,
                              dtype="float32", compat=True,
                              matmul_precision="int8_direct")
        src = SyntheticSource(height=16, width=128, depths_um=(40.0, 70.0),
                              noise=0.01, seed=7)
        it = iter(src.frames())
        frames = np.stack([next(it) for _ in range(8)]).astype(np.uint8)
        bg = np.maximum(src.background().astype(np.float64), 1.0)
        calib8 = Calibration.create(cfg8)
        plan = Int8DirectPlan.create(calib8, cfg8, bg, np.zeros_like(bg))

        # single-device reference with the same display tail
        mags = reconstruct_int8_direct(jnp.asarray(to_s8(frames)), plan)
        bscan = mags.sum(0).T / 8 + 1e-5
        ref_db = np.asarray(mask_dc_rows(
            to_db(bscan, eps=0.0, compat=True)))
        disp = np.asarray(threshold_floor(jnp.asarray(ref_db),
                                          cfg8.bscanthreshold))
        ref_disp = (disp - disp.min()) / max(disp.max() - disp.min(), 1e-30)

        mesh = make_mesh(ndata, nascan)
        sharded = shard_frames(jnp.asarray(frames), mesh)
        db_sh, disp_sh = sharded_bscan_step_int8(sharded, plan, cfg8, mesh)
        np.testing.assert_allclose(np.asarray(db_sh), np.asarray(ref_db),
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(np.asarray(disp_sh), ref_disp,
                                   rtol=0, atol=1e-5)

    def test_rank2_plan_on_the_mesh(self):
        """A rank-2 plan (create(rank=2), the measured experiment) must
        shard: its second operator pair replicates, row_gain2 shards over
        'ascan'.  Regression: _int8_plan_specs omitted the rank-2 fields,
        leaving real arrays in the spec pytree — every sharded int8
        builder crashed with unhashable-ArrayImpl on any rank-2 plan."""
        from fdoct_tpu.int8direct import (Int8DirectPlan,
                                          reconstruct_int8_direct, to_s8)
        from fdoct_tpu.parallel.sharded import build_session_bscan_step_int8
        from fdoct_tpu.pipeline import form_bscan

        cfg8 = PipelineConfig(width=128, height=16, binvalue=1, averages=8,
                              numfftpoints=256, numdisplaypoints=64,
                              dtype="float32", compat=True,
                              matmul_precision="int8_direct")
        calib8 = Calibration.create(cfg8)
        rng = np.random.default_rng(3)
        lam = np.linspace(0, 1, 128)
        bg = np.maximum(
            np.outer(1 + 0.05 * np.sin(np.linspace(0, 3, 16)),
                     np.exp(-(((lam - 0.45) / 0.15) ** 2)) * 180 + 12)
            + 0.25 * np.outer(np.linspace(0, 1, 16),
                              np.exp(-(((lam - 0.65) / 0.08) ** 2)) * 120),
            1.0)
        plan = Int8DirectPlan.create(calib8, cfg8, bg, np.zeros_like(bg),
                                     rank=2)
        assert plan.oq2_re is not None
        frames = rng.integers(0, 255, (8, 16, 128)).astype(np.uint8)
        mesh = make_mesh(4, 2)
        step = build_session_bscan_step_int8(mesh, plan, cfg8, 8)
        sharded = shard_frames(jnp.asarray(frames), mesh)
        thresh = jnp.asarray(cfg8.bscanthreshold, jnp.float32)
        bsc, db, disp = step(sharded, thresh)
        m = reconstruct_int8_direct(jnp.asarray(to_s8(frames)), plan)
        ref = form_bscan(m.sum(0), cfg8, averages=8)
        np.testing.assert_allclose(np.asarray(db), np.asarray(ref.bscandb),
                                   rtol=0, atol=1e-4)

    def test_jit_cache_reused_across_plan_rebuilds(self):
        """A recaptured background rebuilds the plan's arrays but must NOT
        recompile the sharded step (leaves are traced args)."""
        from fdoct_tpu.int8direct import Int8DirectPlan
        from fdoct_tpu.parallel.sharded import (_jitted_bscan_step_int8,
                                                build_bscan_step_int8)

        cfg8 = PipelineConfig(width=128, height=16, averages=8,
                              numfftpoints=256, numdisplaypoints=64,
                              dtype="float32", compat=True,
                              matmul_precision="int8_direct")
        calib8 = Calibration.create(cfg8)
        bg = np.full((16, 128), 100.0)
        mesh = make_mesh(4, 2)
        p1 = Int8DirectPlan.create(calib8, cfg8, bg, np.zeros_like(bg))
        build_bscan_step_int8(mesh, p1, cfg8, 8)
        mid = _jitted_bscan_step_int8.cache_info().currsize
        p2 = Int8DirectPlan.create(calib8, cfg8, bg * 1.1, np.zeros_like(bg))
        build_bscan_step_int8(mesh, p2, cfg8, 8)
        after = _jitted_bscan_step_int8.cache_info().currsize
        assert after == mid             # same jit object for both plans

    @pytest.mark.parametrize("gather_full", [False, True])
    def test_cscan_volume_matches_single_device(self, gather_full):
        from fdoct_tpu.int8direct import (Int8DirectPlan,
                                          reconstruct_int8_direct, to_s8)
        from fdoct_tpu.parallel import sharded_cscan_volume_int8

        cfg8 = PipelineConfig(width=128, height=16, binvalue=1, averages=8,
                              numfftpoints=256, numdisplaypoints=64,
                              dtype="float32", compat=True,
                              matmul_precision="int8_direct")
        src = SyntheticSource(height=16, width=128, depths_um=(40.0, 70.0),
                              noise=0.01, seed=7)
        it = iter(src.frames())
        frames = np.stack([next(it) for _ in range(8)]).astype(np.uint8)
        bg = np.maximum(src.background().astype(np.float64), 1.0)
        calib8 = Calibration.create(cfg8)
        plan = Int8DirectPlan.create(calib8, cfg8, bg, np.zeros_like(bg))

        ref = np.swapaxes(np.asarray(reconstruct_int8_direct(
            jnp.asarray(to_s8(frames)), plan)), 1, 2)     # (F, nd, H)

        mesh = make_mesh(4, 2)
        vol = sharded_cscan_volume_int8(
            shard_frames(jnp.asarray(frames), mesh), plan, cfg8, mesh,
            gather_full=gather_full)
        assert vol.shape == ref.shape
        np.testing.assert_allclose(np.asarray(vol), ref, rtol=0,
                                   atol=1e-4 * ref.max())


@pytest.mark.parametrize("ndata,nascan", [(4, 2), (2, 4), (1, 8)])
def test_sharded_per_frame_normalization(cfg, setup, ndata, nascan):
    """donotnormalize=False (a first-class ini field, build/BscanFFT.ini:55)
    normalizes EACH frame by its own min/max (BscanFFT.cpp:1123-1132).  On
    the mesh the min/max must complete over the 'ascan'-sharded rows with
    pmin/pmax — a shard-local or batch-joint reduction computes different
    B-scans (round-5 VERDICT item 1)."""
    frames, bg, pi, calib = setup
    ncfg = cfg.replace(donotnormalize=False)
    # give every frame a different range so any joint/shard-local min/max
    # is numerically distinguishable from the per-frame reference
    scaled = frames.astype(np.float64) * (
        1.0 + 0.5 * np.arange(len(frames))[:, None, None])
    mesh = make_mesh(ndata, nascan)
    sharded = shard_frames(jnp.asarray(scaled), mesh)
    db_sh, _ = sharded_bscan_step(
        sharded, jnp.asarray(bg), jnp.asarray(pi), calib, ncfg, mesh)

    # reference: the hot loop frame by frame (each frame 2-D → its own
    # min/max by construction)
    mags = sum(np.asarray(reconstruct(jnp.asarray(f), jnp.asarray(bg),
                                      jnp.asarray(pi), calib, ncfg,
                                      method="fused"))
               for f in scaled)
    ref = form_bscan(jnp.asarray(mags), ncfg, averages=len(frames))
    assert np.allclose(np.asarray(db_sh), np.asarray(ref.bscandb), atol=1e-9)


@pytest.mark.parametrize("nascan,k", [(2, 3), (4, 3), (2, 5), (4, 5), (2, 7)])
def test_sharded_median_halo(cfg, setup, nascan, k):
    """mediann>1 is a k×k 2-D filter (medianBlur, BscanFFT.cpp:952-956);
    with rows sharded over 'ascan' each internal cut needs the true k//2
    neighbor rows, exchanged by ppermute — shard-local replicate edges
    would differ from single-device around every cut (round-5 VERDICT
    item 2).  Bit-exact match required: median of integers is exact."""
    frames, bg, pi, calib = setup
    mcfg = cfg.replace(mediann=k)
    mesh = make_mesh(8 // nascan, nascan)
    sharded = shard_frames(jnp.asarray(frames), mesh)
    db_sh, _ = sharded_bscan_step(
        sharded, jnp.asarray(bg), jnp.asarray(pi), calib, mcfg, mesh)

    mags = reconstruct(jnp.asarray(frames), jnp.asarray(bg), jnp.asarray(pi),
                       calib, mcfg, method="fused")
    ref = form_bscan(mags.sum(0), mcfg, averages=len(frames))
    np.testing.assert_allclose(np.asarray(db_sh), np.asarray(ref.bscandb),
                               atol=1e-9)


def test_sharded_median_halo_too_thin_raises(cfg, setup):
    """Local blocks thinner than the halo cannot complete it in one
    neighbor hop; the step must fail loudly at trace time, never compute
    silently wrong edges (height=16 over 8 'ascan' shards = 2 rows < 3)."""
    frames, bg, pi, calib = setup
    mcfg = cfg.replace(mediann=7)
    mesh = make_mesh(1, 8)
    sharded = shard_frames(jnp.asarray(frames), mesh)
    with pytest.raises(ValueError, match="median halo"):
        sharded_bscan_step(sharded, jnp.asarray(bg), jnp.asarray(pi),
                           calib, mcfg, mesh)


def test_sharded_median_and_normalize_together(cfg, setup):
    """The two round-5 edge semantics compose: mediann=3 +
    donotnormalize=False on a 2-D mesh must match the per-frame chain."""
    frames, bg, pi, calib = setup
    ccfg = cfg.replace(mediann=3, donotnormalize=False)
    mesh = make_mesh(4, 2)
    sharded = shard_frames(jnp.asarray(frames), mesh)
    db_sh, _ = sharded_bscan_step(
        sharded, jnp.asarray(bg), jnp.asarray(pi), calib, ccfg, mesh)
    mags = sum(np.asarray(reconstruct(jnp.asarray(f), jnp.asarray(bg),
                                      jnp.asarray(pi), calib, ccfg,
                                      method="fused"))
               for f in frames)
    ref = form_bscan(jnp.asarray(mags), ccfg, averages=len(frames))
    assert np.allclose(np.asarray(db_sh), np.asarray(ref.bscandb), atol=1e-9)


def test_median_halo_collective_traffic(cfg, setup):
    """The mediann=3 mesh step's ONLY extra communication vs mediann=0 is
    the halo exchange: 2 ppermutes of h=1 boundary-row blocks, counted
    from the compiled HLO (the same accounting the scaling harness uses —
    the module transfers to real chips)."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
    from bench_scaling import collective_bytes

    from fdoct_tpu.parallel.sharded import build_bscan_step

    frames, bg, pi, calib = setup
    mesh = make_mesh(4, 2)
    shapes = jnp.asarray(frames), jnp.asarray(bg), jnp.asarray(pi)

    def hlo(mcfg):
        step = build_bscan_step(mesh, calib, mcfg, "fused", len(frames))
        return step.lower(*shapes).compile().as_text()

    base = collective_bytes(hlo(cfg))
    halo = collective_bytes(hlo(cfg.replace(mediann=3)))
    assert base.get("collective-permute", 0) == 0
    # per shard body: 2 ppermutes of (b_loc, h, W) raw rows; the counter
    # sums the per-shard program once.  b_loc = 8/4 = 2 frames, h = 1 row,
    # W = 128 cols of uint8 → 2 * (2*1*128) = 512 B
    b_loc = len(frames) // 4
    expect = 2 * b_loc * 1 * cfg.width * 1          # u8 frames
    assert halo.get("collective-permute", 0) == expect, halo
    # everything else unchanged: same psum + pmin/pmax scalars
    for op in ("all-reduce",):
        assert halo.get(op, 0) == base.get(op, 0)


def test_sharded_median_with_binning(cfg, setup):
    """mediann + software binning compose on the mesh: the median halo
    runs on RAW rows (preprocess order: median → bin, BscanFFT.cpp:952-958)
    and the row binning stays shard-aligned because oph % n_ascan == 0
    implies (H_loc % by) == 0.  Bit-match vs single-device."""
    frames, bg, pi, calib = setup
    # raw frames at 2x the binned geometry: H=32 raw rows → oph=16
    rng = np.random.default_rng(11)
    raw = rng.integers(0, 250, (8, 32, 256)).astype(np.uint8)
    bcfg = cfg.replace(width=256, height=32, binvalue=2, mediann=3)
    bcalib = Calibration.create(bcfg)
    bg2 = np.maximum(
        rng.integers(80, 180, (16, 128)).astype(np.float64), 1.0)
    pi2 = np.zeros_like(bg2)
    mesh = make_mesh(2, 4)       # 4 'ascan' shards × 8 raw rows each
    sharded = shard_frames(jnp.asarray(raw), mesh)
    db_sh, _ = sharded_bscan_step(
        sharded, jnp.asarray(bg2), jnp.asarray(pi2), bcalib, bcfg, mesh)
    mags = reconstruct(jnp.asarray(raw), jnp.asarray(bg2), jnp.asarray(pi2),
                       bcalib, bcfg, method="fused")
    ref = form_bscan(mags.sum(0), bcfg, averages=len(raw))
    np.testing.assert_allclose(np.asarray(db_sh), np.asarray(ref.bscandb),
                               atol=1e-9)


class TestInitializeMultihost:
    """initialize_multihost: a no-op for one process; otherwise the
    coordinator, process count and id reach jax.distributed (from the
    arguments or FDOCT_* variables), and a failed start says what a GPU
    cluster needs."""

    @pytest.fixture()
    def calls(self, monkeypatch):
        for k in ("FDOCT_COORDINATOR", "FDOCT_NUM_PROCESSES",
                  "FDOCT_PROCESS_ID"):
            monkeypatch.delenv(k, raising=False)
        seen = []
        monkeypatch.setattr(jax.distributed, "initialize",
                            lambda **kw: seen.append(kw))
        return seen

    def test_single_process_is_noop(self, calls):
        from fdoct_tpu.parallel import initialize_multihost
        assert initialize_multihost() is False
        assert calls == []

    def test_env_reaches_jax_distributed(self, calls, monkeypatch):
        from fdoct_tpu.parallel import initialize_multihost
        monkeypatch.setenv("FDOCT_COORDINATOR", "localhost:12345")
        monkeypatch.setenv("FDOCT_NUM_PROCESSES", "2")
        monkeypatch.setenv("FDOCT_PROCESS_ID", "1")
        assert initialize_multihost() is True
        assert calls == [dict(num_processes=2, process_id=1,
                              coordinator_address="localhost:12345")]

    def test_failure_names_what_is_missing(self, monkeypatch):
        from fdoct_tpu.parallel import initialize_multihost

        def refuse(**kw):
            raise ValueError("coordinator_address should be defined")

        monkeypatch.setattr(jax.distributed, "initialize", refuse)
        with pytest.raises(RuntimeError, match="FDOCT_COORDINATOR"):
            initialize_multihost(num_processes=2)
