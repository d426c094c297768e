"""int8-direct display path (fdoct_tpu.int8direct): correctness of the
background/pi folding, bias-shift exactness, config gating, and Session
integration.  Display-equivalence criteria follow tests/test_precision.py:
signal pixels (within 30 dB of peak) move < 0.15 dB; the noise floor is
bounded and clamped by any practical display threshold."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from fdoct_tpu.calibration import Calibration
from fdoct_tpu.config import PipelineConfig
from fdoct_tpu.int8direct import (Int8DirectPlan, int8_direct_supported,
                                  rank1_factor, reconstruct_int8_direct,
                                  shift_u8_to_s8, to_s8)
from fdoct_tpu.pipeline import form_bscan, reconstruct
from fdoct_tpu.sources.synthetic import SyntheticSource


@pytest.fixture(scope="module")
def data():
    cfg = PipelineConfig(width=256, height=32, averages=4,
                         numfftpoints=512, numdisplaypoints=160,
                         lambdamin=816e-9, lambdamax=884e-9,
                         dtype="float32", compat=True,
                         matmul_precision="int8_direct")
    src = SyntheticSource(height=32, width=256, depths_um=(40.0, 80.0),
                          reflectivities=(0.5, 0.3), noise=0.01, seed=9)
    it = iter(src.frames())
    frames = np.stack([next(it) for _ in range(4)]).astype(np.uint8)
    # non-rank-1 background: per-row gain + 0.3% multiplicative noise — the
    # realistic capture case (8-bit counts averaged over ~10 frames leave
    # ~0.3% residual noise; the reference averages `averagestoggle` frames,
    # BscanFFT.cpp:1000-1075).  The rank-1 residual of bg bounds the path's
    # accuracy — see test_residual_dominates_error for the degraded case.
    rng = np.random.default_rng(3)
    bg = np.maximum(src.background().astype(np.float64), 1.0)
    bg = bg * (1.0 + 0.04 * np.sin(np.linspace(0, 3, 32)))[:, None]
    bg = bg * (1.0 + 0.003 * rng.standard_normal(bg.shape))
    pi = rng.uniform(0.0, 8.0, bg.shape)
    return cfg, frames, bg, pi


class TestRank1Factor:
    def test_exact_rank1_recovered(self):
        u = np.linspace(1.0, 2.0, 16)
        v = np.linspace(0.5, 1.5, 64)
        uu, vv, resid = rank1_factor(np.outer(u, v))
        assert resid < 1e-12
        np.testing.assert_allclose(np.outer(uu, vv), np.outer(u, v),
                                   rtol=1e-10)
        # v normalized to mean 1
        assert abs(vv.mean() - 1.0) < 1e-12

    def test_residual_reported(self):
        rng = np.random.default_rng(0)
        b = np.outer(np.ones(8), np.ones(32)) + 0.1 * rng.standard_normal((8, 32))
        _, _, resid = rank1_factor(b)
        assert 0.0 < resid < 0.2


class TestBiasShift:
    def test_to_s8_exact(self):
        raw = np.arange(256, dtype=np.uint8).reshape(16, 16)
        s8 = to_s8(raw)
        assert s8.dtype == np.int8
        np.testing.assert_array_equal(s8.astype(np.int32),
                                      raw.astype(np.int32) - 128)

    def test_device_shift_matches_host(self):
        rng = np.random.default_rng(1)
        raw = rng.integers(0, 256, (8, 32), dtype=np.uint8)
        dev = np.asarray(shift_u8_to_s8(jnp.asarray(raw)))
        np.testing.assert_array_equal(dev, to_s8(raw))


class TestGating:
    def test_supported_flagship(self):
        ok, why = int8_direct_supported(PipelineConfig(
            width=256, height=32, matmul_precision="int8_direct"))
        assert ok, why

    @pytest.mark.parametrize("kw,frag", [
        (dict(bpp=16), "8-bit"),
        (dict(mediann=3), "median"),
        (dict(movavgn=2), "moving-average"),
        (dict(binvalue=2), "binning"),
        (dict(rowwisenormalize=True), "normalization"),
        (dict(donotnormalize=False), "normalization"),
    ])
    def test_unsupported_reasons(self, kw, frag):
        cfg = PipelineConfig(width=256, height=32, **kw)
        ok, why = int8_direct_supported(cfg)
        assert not ok and frag in why

    def test_plan_create_raises_on_unsupported(self):
        cfg = PipelineConfig(width=256, height=32, mediann=3)
        calib = Calibration.create(cfg)
        with pytest.raises(ValueError, match="median"):
            Int8DirectPlan.create(calib, cfg, np.ones((32, 256)),
                                  np.zeros((32, 256)))

    def test_validate_rejects_unknown_precision(self):
        with pytest.raises(ValueError, match="matmul_precision"):
            PipelineConfig(matmul_precision="int 8").validate()


class TestNumerics:
    def _db_pair(self, cfg, frames, bg, pi):
        cfg64 = cfg.replace(dtype="float64", matmul_precision="default")
        calib64 = Calibration.create(cfg64, dtype="float64")
        mags = reconstruct(jnp.asarray(frames), jnp.asarray(bg, jnp.float64),
                           jnp.asarray(pi, jnp.float64), calib64, cfg64,
                           method="gather")
        ref_db = np.asarray(form_bscan(mags.sum(0), cfg64, 4).bscandb)
        calib = Calibration.create(cfg)
        plan = Int8DirectPlan.create(calib, cfg, bg, pi)
        m8 = reconstruct_int8_direct(jnp.asarray(to_s8(frames)), plan)
        i8_db = np.asarray(form_bscan(m8.sum(0), cfg, 4).bscandb)
        return ref_db, i8_db

    def test_display_equivalent_clean_bg(self, data):
        """Quantization-only accuracy (clean rank-1-consistent background,
        pi=0): measured 0.033 dB on signal — tighter than the dynamic
        'int8' path's 0.085 dB because the s8 input is EXACT camera counts
        (no input quantization) and DC routes through the exact colsum
        (Int8DirectPlan.create)."""
        cfg, frames, bg, pi = data
        from fdoct_tpu.sources.synthetic import SyntheticSource
        src = SyntheticSource(height=32, width=256, depths_um=(40.0, 80.0),
                              reflectivities=(0.5, 0.3), noise=0.01, seed=9)
        bg_clean = np.maximum(src.background().astype(np.float64), 1.0)
        bg_clean = bg_clean * (1.0 + 0.04 * np.sin(np.linspace(0, 3, 32)))[:, None]
        ref_db, i8_db = self._db_pair(cfg, frames, bg_clean,
                                      np.zeros_like(bg_clean))
        d = np.abs(ref_db - i8_db)
        signal = ref_db > ref_db.max() - 30.0
        assert signal.sum() > 100
        assert d[signal].max() < 0.15, d[signal].max()
        assert d.max() < 8.0, d.max()

    def test_display_equivalent_vs_f64_gather(self, data):
        """Realistic capture (0.3% residual bg noise, nonzero pi): the
        operator-quantization noise floor sits ~50 dB below peak at this
        tiny fixture's W=256 (it scales ~1/sqrt(W)), so pixels at the
        -30 dB band edge move up to ~0.3 dB while near-peak pixels (what
        the eye reads) stay < 0.1 dB.  Any practical display threshold
        (every reference ini sets one) clamps the floor region."""
        cfg, frames, bg, pi = data
        ref_db, i8_db = self._db_pair(cfg, frames, bg, pi)
        d = np.abs(ref_db - i8_db)
        signal = ref_db > ref_db.max() - 30.0
        assert signal.sum() > 100
        assert d[signal].max() < 0.35, d[signal].max()
        # near-peak pixels (what the eye reads) stay display-invisible
        peak = ref_db > ref_db.max() - 10.0
        assert d[peak].max() < 0.10, d[peak].max()
        assert d.max() < 8.0, d.max()

    def test_residual_dominates_error(self, data):
        """The accuracy law: with a HEAVILY noisy background (1% per-pixel,
        full-rank) the error is set by the rank-1 residual — the f32 path
        faithfully divides by that noise realization and no folding can —
        while staying bounded.  The plan reports the residual so callers
        can gate (Session warns above 0.02)."""
        cfg, frames, bg, pi = data
        rng = np.random.default_rng(11)
        bg_noisy = bg * (1.0 + 0.01 * rng.standard_normal(bg.shape))
        cfg64 = cfg.replace(dtype="float64", matmul_precision="default")
        calib64 = Calibration.create(cfg64, dtype="float64")
        mags = reconstruct(jnp.asarray(frames),
                           jnp.asarray(bg_noisy, jnp.float64),
                           jnp.asarray(pi, jnp.float64), calib64, cfg64,
                           method="gather")
        ref_db = np.asarray(form_bscan(mags.sum(0), cfg64, 4).bscandb)
        calib = Calibration.create(cfg)
        plan = Int8DirectPlan.create(calib, cfg, bg_noisy, pi)
        assert float(plan.bg_rank1_resid) > 5e-3   # genuinely non-rank-1
        m8 = reconstruct_int8_direct(jnp.asarray(to_s8(frames)), plan)
        i8_db = np.asarray(form_bscan(m8.sum(0), cfg, 4).bscandb)
        d = np.abs(ref_db - i8_db)
        signal = ref_db > ref_db.max() - 30.0
        assert d[signal].max() < 3.0, d[signal].max()   # bounded, not equiv

    def test_rank2_fold_recovers_structured_backgrounds(self, data):
        """On a STRUCTURED
        non-rank-1 background (two-component source spectrum with
        row-dependent mixing — the case the rank-1 fold genuinely cannot
        represent, unlike full-rank noise), create(rank=2) folds the top-2
        SVD of the reciprocal and restores display-grade accuracy where
        rank-1 degrades to multiple dB."""
        cfg, frames, _, pi = data
        R, C = 32, 256
        lam = np.linspace(0, 1, C)
        spec1 = np.exp(-(((lam - 0.45) / 0.15) ** 2)) * 180.0 + 12.0
        spec2 = np.exp(-(((lam - 0.65) / 0.08) ** 2)) * 120.0
        g1 = 1.0 + 0.05 * np.sin(np.linspace(0, 3, R))
        g2 = np.linspace(0.0, 1.0, R)
        rng = np.random.default_rng(5)
        bg = np.maximum(
            (g1[:, None] * spec1[None, :] + 0.2 * g2[:, None] * spec2[None, :])
            * (1 + 0.003 * rng.standard_normal((R, C))), 1.0)

        cfg64 = cfg.replace(dtype="float64", matmul_precision="default")
        calib64 = Calibration.create(cfg64, dtype="float64")
        mags = reconstruct(jnp.asarray(frames), jnp.asarray(bg, jnp.float64),
                           jnp.asarray(pi, jnp.float64), calib64, cfg64,
                           method="gather")
        ref_db = np.asarray(form_bscan(mags.sum(0), cfg64, 4).bscandb)
        signal = ref_db > ref_db.max() - 30.0
        calib = Calibration.create(cfg)

        p1 = Int8DirectPlan.create(calib, cfg, bg, pi, rank=1)
        p2 = Int8DirectPlan.create(calib, cfg, bg, pi, rank=2)
        # the rank-2 reciprocal fold captures the structure: resid drops
        # to the noise floor (>=4x below rank-1 on this background)
        assert float(p2.bg_rank1_resid) < float(p1.bg_rank1_resid) / 4
        errs = {}
        for name, p in (("r1", p1), ("r2", p2)):
            m = reconstruct_int8_direct(jnp.asarray(to_s8(frames)), p)
            db = np.asarray(form_bscan(m.sum(0), cfg, 4).bscandb)
            errs[name] = np.abs(db - ref_db)[signal].max()
        # display-grade again: the 0.3% bg noise floor bounds rank-2 at
        # ~0.9 dB on this 32-row shape (0.4 dB pure-fold + quantization),
        # where rank-1 is 5+ dB
        assert errs["r2"] < 1.5, errs
        assert errs["r2"] < errs["r1"] / 3, errs  # and materially better

    def test_matches_f32_fused_magnitudes(self, data):
        """Magnitude-domain agreement with the f32 fused path (the exact
        function the folding re-expresses)."""
        cfg, frames, bg, pi = data
        calib = Calibration.create(cfg)
        ref = np.asarray(reconstruct(
            jnp.asarray(frames), jnp.asarray(bg, jnp.float32),
            jnp.asarray(pi, jnp.float32), calib, cfg, method="fused"))
        plan = Int8DirectPlan.create(calib, cfg, bg, pi)
        out = np.asarray(reconstruct_int8_direct(
            jnp.asarray(to_s8(frames)), plan))
        err = np.abs(out - ref).max() / (np.abs(ref).max() + 1e-12)
        assert err < 2e-2, err

    def test_dark_frame_folds(self, data):
        """BscanDark's y - data_yd (BscanDark.cpp:1269) enters the folding
        linearly: plan(dark=yd) must match the f32 chain with explicit
        subtraction."""
        cfg, frames, bg, pi = data
        rng = np.random.default_rng(7)
        yd = rng.uniform(0.0, 6.0, bg.shape)
        calib = Calibration.create(cfg)
        y = jnp.asarray(frames, jnp.float32) - jnp.asarray(yd, jnp.float32)
        yr = (y - jnp.asarray(pi, jnp.float32)) / jnp.asarray(bg, jnp.float32)
        from fdoct_tpu.pipeline import ascan_mags
        ref = np.asarray(ascan_mags(yr, calib, "fused", "default"))
        plan = Int8DirectPlan.create(calib, cfg, bg, pi, dark_frame=yd)
        out = np.asarray(reconstruct_int8_direct(
            jnp.asarray(to_s8(frames)), plan))
        err = np.abs(out - ref).max() / (np.abs(ref).max() + 1e-12)
        assert err < 2e-2, err

    def test_quant_tables_gated_on_precision(self):
        """Calibration only materializes the int8 operator tables when the
        config asks for matmul_precision='int8' (they cost device memory on
        every replica otherwise)."""
        cfg = PipelineConfig(width=256, height=32)
        assert Calibration.create(cfg).op_re_q is None
        cfg8 = cfg.replace(matmul_precision="int8")
        c8 = Calibration.create(cfg8)
        assert c8.op_re_q is not None and c8.op_scale_im is not None


class TestSessionIntegration:
    def _mk_session(self, cfg, bg, pi):
        from fdoct_tpu.session import Session
        s = Session(cfg, variant="base")
        s.data_yb = jnp.asarray(bg, jnp.float32)
        s.data_yp = jnp.asarray(pi, jnp.float32)
        return s

    def test_process_group_display_equivalent(self, data):
        cfg, frames, bg, pi = data
        batch = np.concatenate([frames, frames])      # 8 frames = 2 groups
        s32 = self._mk_session(cfg.replace(matmul_precision="default"),
                               bg, pi)
        s8 = self._mk_session(cfg, bg, pi)
        r32 = s32.process_group(batch)
        r8 = s8.process_group(batch)
        assert len(r32) == len(r8) == 2
        for a, b in zip(r32, r8):
            db32 = np.asarray(a.bscandb)
            db8 = np.asarray(b.bscandb)
            signal = db32 > db32.max() - 30.0
            d = np.abs(db32 - db8)
            assert signal.sum() > 100
            assert d[signal].max() < 0.35, d[signal].max()

    def test_per_frame_matches_group(self, data):
        """The per-frame process() path and the batched process_group()
        path must agree exactly under int8_direct (same plan, same jits)."""
        cfg, frames, bg, pi = data
        s1 = self._mk_session(cfg, bg, pi)
        s2 = self._mk_session(cfg, bg, pi)
        outs1 = [r for f in frames if (r := s1.process(f)) is not None]
        outs2 = s2.process_group(frames)
        assert len(outs1) == len(outs2) == 1
        np.testing.assert_array_equal(outs1[0].bscandisp, outs2[0].bscandisp)

    def test_plan_invalidated_on_capture(self, data):
        """Rebinding data_yb (a 'b' capture) must rebuild the plan."""
        cfg, frames, bg, pi = data
        s = self._mk_session(cfg, bg, pi)
        s.process(frames[0])
        p1 = s._i8plan
        assert p1 is not None
        s.data_yb = jnp.asarray(bg * 1.1, jnp.float32)
        s.process(frames[1])
        assert s._i8plan is not p1

    def test_webcam_color_rides_int8_direct(self, data):
        """Webcam color frames with a single-channel select (channelnum
        0/1/2, BscanFFTwebcam.cpp:1015-1039) ride int8-direct: the plane
        slice keeps exact u8 counts.  Pin (a) the batched path routes onto
        the int8 plan, (b) it equals the same session fed the pre-sliced
        gray frames bit-exactly, (c) channel sum (channelnum=3) falls back
        to the f32 chain."""
        cfg, frames, bg, pi = data
        cfgw = cfg.replace(channelnum=1)      # G plane = index 2-1
        rng = np.random.default_rng(5)
        color = rng.integers(0, 255, frames.shape + (3,)).astype(np.uint8)
        color[..., 1] = frames
        s_color = self._mk_session(cfgw, bg, pi)
        r_color = s_color.process_group(color)
        assert s_color._i8plan is not None    # routed onto int8-direct
        s_gray = self._mk_session(cfgw, bg, pi)
        r_gray = s_gray.process_group(frames)
        assert len(r_color) == len(r_gray) == 1
        np.testing.assert_array_equal(r_color[0].bscandisp,
                                      r_gray[0].bscandisp)
        # per-frame path agrees with the batched path on color input
        s_pf = self._mk_session(cfgw, bg, pi)
        outs = [r for f in color if (r := s_pf.process(f)) is not None]
        assert s_pf._i8plan is not None
        np.testing.assert_array_equal(outs[0].bscandisp,
                                      r_color[0].bscandisp)
        # channel sum rescales to float -> f32 chain, still correct
        s_sum = self._mk_session(cfg.replace(channelnum=3), bg, pi)
        r_sum = s_sum.process_group(color)
        assert s_sum._i8plan is None and len(r_sum) == 1

    def test_no_preprocess_dispatch_on_int8_path(self, data, monkeypatch):
        """The int8-direct design point is zero elementwise work on the big
        input: with no pending captures and no interferogram saves, the
        per-frame path must not dispatch preprocess() (the (H,W) u8→f32
        widen) at all."""
        import fdoct_tpu.session as sm
        cfg, frames, bg, pi = data
        calls = []
        orig = sm.preprocess
        monkeypatch.setattr(
            sm, "preprocess",
            lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
        s = self._mk_session(cfg, bg, pi)
        outs = [r for f in frames if (r := s.process(f)) is not None]
        assert len(outs) == 1 and not calls
        # ...but a pending 'b' capture still gets its preprocessed frame
        s.key("b")
        s.process(frames[0])
        assert calls

    def test_peak_variant_gated_off_int8(self, data):
        """The vibrometry (peak) variant is metrology —
        its plugin inverts sub-dB peak-hold differences through the
        Bessel-null curve (BscanFFTpeak.cpp:466-738), so int8-direct's
        display-grade quantization must never feed it.  The session stays
        on the f32 chain (mirroring the Doppler policy) and says so."""
        from fdoct_tpu.session import Session
        cfg, frames, bg, pi = data
        s = Session(cfg, variant="peak")
        s.data_yb = jnp.asarray(bg, jnp.float32)
        s.data_yp = jnp.asarray(pi, jnp.float32)
        assert not s._use_int8_direct(frames[0])
        for f in frames:
            s.process(f)
        assert s._i8plan is None          # the fast path never engaged
        assert any("display mode" in m for m in s.status)
        # the same config on a non-metrology variant DOES ride int8
        assert self._mk_session(cfg, bg, pi)._use_int8_direct(frames[0])

    @pytest.mark.parametrize("kind", ["structured", "noise"])
    def test_high_resid_falls_back_to_f32(self, data, kind):
        """The high-residual policy: above INT8_RESID_ACT the rank-1 fold is not
        display-grade, so the session refuses the plan and the frame path
        rides the exact f32 chain — for BOTH structured and
        noise-dominated deviations."""
        cfg, frames, bg, pi = data
        if kind == "structured":
            R, C = 32, 256
            lam = np.linspace(0, 1, C)
            spec1 = np.exp(-(((lam - 0.45) / 0.15) ** 2)) * 180.0 + 12.0
            spec2 = np.exp(-(((lam - 0.65) / 0.08) ** 2)) * 120.0
            g2 = np.linspace(0.0, 1.0, R)
            bad_bg = np.maximum(spec1[None, :]
                                + 0.25 * g2[:, None] * spec2[None, :], 1.0)
        else:
            rng = np.random.default_rng(17)
            bad_bg = np.maximum(
                bg * (1.0 + 0.05 * rng.standard_normal(bg.shape)), 1.0)
        s = self._mk_session(cfg, bad_bg, pi)
        assert not s._use_int8_direct(frames[0])
        assert s._int8_plan() is None
        assert any("falling back to the exact f32" in m for m in s.status)
        outs = [r for f in frames if (r := s.process(f)) is not None]
        assert len(outs) == 1                  # f32 chain still delivers

    def test_fallback_when_unsupported(self, data):
        """A config that defeats the folding (mediann) silently rides the
        normal f32 chain — int8_direct is an optimization, not a mode."""
        cfg, frames, bg, pi = data
        cfgm = cfg.replace(mediann=3)
        s = self._mk_session(cfgm, bg, pi)
        for f in frames:
            s.process(f)
        assert s._i8plan is None
