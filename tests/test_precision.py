"""Precision-policy tests: the float32 production path must be
display-equivalent to the float64 compat path."""

import numpy as np
import jax.numpy as jnp
import pytest

from fdoct_tpu.calibration import Calibration
from fdoct_tpu.config import PipelineConfig
from fdoct_tpu.pipeline import form_bscan, reconstruct
from fdoct_tpu.sources.synthetic import SyntheticSource


@pytest.fixture(scope="module")
def data():
    cfg64 = PipelineConfig(width=256, height=32, averages=4,
                           numfftpoints=512, numdisplaypoints=160,
                           lambdamin=816e-9, lambdamax=884e-9,
                           dtype="float64", compat=True)
    src = SyntheticSource(height=32, width=256, depths_um=(40.0, 80.0),
                          reflectivities=(0.5, 0.3), noise=0.01, seed=9)
    it = iter(src.frames())
    frames = np.stack([next(it) for _ in range(4)])
    bg = np.maximum(src.background().astype(np.float64), 1.0)
    return cfg64, frames, bg


def _display(cfg, frames, bg, dtype, method):
    cfgd = cfg.replace(dtype=dtype)
    calib = Calibration.create(cfgd, dtype=dtype)
    mags = reconstruct(jnp.asarray(frames), jnp.asarray(bg, dtype),
                       jnp.asarray(np.zeros_like(bg), dtype), calib, cfgd,
                       method=method)
    return np.asarray(form_bscan(mags.sum(0), cfgd, 4).bscandisp).astype(int)


class TestDisplayEquivalence:
    def test_f32_fused_vs_f64_gather(self, data):
        cfg, frames, bg = data
        ref = _display(cfg, frames, bg, "float64", "gather")
        fast = _display(cfg, frames, bg, "float32", "fused")
        diff = np.abs(ref - fast)
        # display-equivalent: at most 2 gray levels on at least 99% pixels
        assert np.mean(diff <= 2) > 0.99, float(np.mean(diff <= 2))
        assert diff.max() <= 8

    def test_f32_gather_vs_f64_gather(self, data):
        cfg, frames, bg = data
        ref = _display(cfg, frames, bg, "float64", "gather")
        fast = _display(cfg, frames, bg, "float32", "gather")
        diff = np.abs(ref - fast)
        assert np.mean(diff <= 2) > 0.99


class TestPolicy:
    """One precision policy, read from the config and the same on every
    backend: the lowered matmul pair's operand types and precision."""

    @pytest.mark.parametrize("precision,operand,prec", [
        ("default", "f32", "DEFAULT"),
        ("highest", "f32", "HIGHEST"),
        ("bf16", "bf16", "DEFAULT"),
    ])
    def test_matmul_operands(self, precision, operand, prec):
        import re

        import jax

        from fdoct_tpu.pipeline import ascan_mags_fused

        cfg = PipelineConfig(width=256, height=8, numfftpoints=512,
                             numdisplaypoints=64, dtype="float32")
        calib = Calibration.create(cfg, dtype="float32")
        yr = jnp.zeros((8, 256), jnp.float32)
        txt = jax.jit(lambda y: ascan_mags_fused(y, calib, precision)).lower(
            yr).as_text()
        dots = re.findall(r"stablehlo\.dot_general .*precision = "
                          r"\[(\w+), \w+\] : \(tensor<8x256x(\w+)>, "
                          r"tensor<256x64x(\w+)>\) -> tensor<8x64xf32>", txt)
        assert dots == [(prec, operand, operand)] * 2, txt


class TestMatmulPrecisionKnob:
    def test_fused_exact_method(self, data):
        """method='fused_exact' / matmul_precision='highest' forces exact
        f32 matmuls (identical to default on CPU; tighter than TF32 on a
        GPU)."""
        cfg, frames, bg = data
        a = _display(cfg, frames, bg, "float32", "fused")
        b = _display(cfg, frames, bg, "float32", "fused_exact")
        assert np.abs(a - b).max() <= 1

    def test_bf16_branch_display_equivalent(self, data):
        """matmul_precision='bf16' selects the explicit bf16-operand branch
        (f32 accumulation) on every backend — here on CPU
        (pipeline.ascan_mags_fused).

        Measured characterization (this test pins it): bf16 operand
        rounding perturbs only the NOISE FLOOR — the matmul's absolute
        error scales with the peak magnitude, so signal pixels (within
        30 dB of the B-scan peak) move < 0.1 dB (measured 0.023) while
        pixels ≥ 30 dB down can move ~1-2 dB.  Any practical display
        threshold (every reference ini sets one) clamps that region."""
        import jax.numpy as jnp

        from fdoct_tpu.pipeline import form_bscan

        cfg, frames, bg = data

        def bscan_db(cfgx, dtype, method):
            calib = Calibration.create(cfgx.replace(dtype=dtype), dtype=dtype)
            mags = reconstruct(jnp.asarray(frames), jnp.asarray(bg, dtype),
                               jnp.asarray(np.zeros_like(bg), dtype), calib,
                               cfgx.replace(dtype=dtype), method=method)
            return np.asarray(form_bscan(mags.sum(0), cfgx, 4).bscandb)

        ref_db = bscan_db(cfg, "float64", "gather")
        b16_db = bscan_db(cfg.replace(matmul_precision="bf16"),
                          "float32", "fused")
        d = np.abs(ref_db - b16_db)
        signal = ref_db > ref_db.max() - 30.0
        assert signal.sum() > 100          # the scene has real signal
        assert d[signal].max() < 0.1, d[signal].max()   # display-invisible
        assert d.max() < 4.0, d.max()      # noise floor bounded

    def test_int8_branch_display_equivalent(self, data):
        """matmul_precision='int8' (the s8 x s8 -> s32 display path)
        must stay display-equivalent on signal.  The key design point it
        pins: because M contains the DC-removal projector, the pipeline
        subtracts the row mean BEFORE quantization, so the int8 range
        covers fringes only — measured signal error 0.085 dB (< the 0.1 dB
        bf16 bound); the noise floor >= 30 dB down may move a few dB,
        clamped by any practical display threshold."""
        import jax.numpy as jnp

        cfg, frames, bg = data

        def bscan_db(cfgx, dtype, method):
            calib = Calibration.create(cfgx.replace(dtype=dtype), dtype=dtype)
            mags = reconstruct(jnp.asarray(frames), jnp.asarray(bg, dtype),
                               jnp.asarray(np.zeros_like(bg), dtype), calib,
                               cfgx.replace(dtype=dtype), method=method)
            return np.asarray(form_bscan(mags.sum(0), cfgx, 4).bscandb)

        ref_db = bscan_db(cfg, "float64", "gather")
        i8_db = bscan_db(cfg.replace(matmul_precision="int8"),
                         "float32", "fused")
        d = np.abs(ref_db - i8_db)
        signal = ref_db > ref_db.max() - 30.0
        assert signal.sum() > 100
        assert d[signal].max() < 0.15, d[signal].max()  # display-invisible
        assert d.max() < 8.0, d.max()                   # noise floor bounded

    def test_int8_without_tables_falls_back(self, data):
        """A Calibration without quantized tables (hand-built pytrees) must
        silently take the bf16 branch under precision='int8'."""
        import dataclasses
        import jax.numpy as jnp

        from fdoct_tpu.pipeline import ascan_mags_fused

        cfg, frames, bg = data
        cfg32 = cfg.replace(dtype="float32")
        calib = Calibration.create(cfg32, dtype="float32")
        bare = dataclasses.replace(calib, op_re_q=None, op_im_q=None,
                                   op_scale_re=None, op_scale_im=None)
        yr = jnp.asarray(frames[0], jnp.float32) / 255.0
        a = np.asarray(ascan_mags_fused(yr, bare, "int8"))
        b = np.asarray(ascan_mags_fused(yr, calib, "bf16"))
        np.testing.assert_allclose(a, b, rtol=1e-6)

    def test_bf16_complex_matches_magnitude(self, data):
        """|ascan_complex| must equal ascan_mags_fused at every precision —
        the two share _op_matmul_pair (phase-resolved consumers cross-check
        magnitudes against the complex path)."""
        import jax.numpy as jnp

        from fdoct_tpu.pipeline import (apodize_ratio, ascan_complex,
                                        ascan_mags_fused, preprocess)

        cfg, frames, bg = data
        cfg32 = cfg.replace(dtype="float32")
        calib = Calibration.create(cfg32, dtype="float32")
        # the int8 leg needs a calibration that CARRIES the quantized
        # tables (Calibration.create gates them on the config's precision;
        # without them 'int8' silently tests the bf16 branch instead)
        calib8 = Calibration.create(cfg32.replace(matmul_precision="int8"),
                                    dtype="float32")
        assert calib8.op_re_q is not None
        y = preprocess(jnp.asarray(frames[0]), cfg32)
        yr = apodize_ratio(y, jnp.asarray(bg, jnp.float32),
                           jnp.zeros_like(y), cfg32)
        for prec in ("default", "bf16", "highest", "int8"):
            c = calib8 if prec == "int8" else calib
            mags = np.asarray(ascan_mags_fused(yr, c, prec))
            cplx = np.asarray(jnp.abs(ascan_complex(yr, c, prec)))
            # same matmuls by construction; |z| may use hypot vs sqrt
            np.testing.assert_allclose(mags, cplx, rtol=1e-5,
                                       atol=1e-6 * mags.max())
