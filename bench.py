#!/usr/bin/env python
"""Benchmark: A-scans/s on one accelerator for 2048-px spectra (the
BASELINE.md primary metric), fused-operator path.

Measures steady-state device throughput of the full per-group pipeline —
uint8 raw frames → preprocess → background ratio → fused matmul-pair
reconstruction → group accumulation → displayed B-scan — on
device-resident frame batches generated on the device, so host→device
ingest is not part of the timed path.  Each sample is one jitted call over
``G`` groups timed to ``block_until_ready``; the value is the median of
``REPEATS`` samples after a compile-and-warm call.  Refuses to run without
a GPU: a CPU number is not a device metric.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "ascans/s", "vs_baseline": N, ...}

The headline "value" is the scan-chained (live-streaming) shape.  The
batched/offline shape and the int8_direct display mode are extra keys and
stderr info rows.

vs_baseline divides by the single-core C++ reimplementation of the
reference hot loop (native/cpu_baseline.cpp, -O3, same shapes); the
reference itself publishes no numbers (BASELINE.md).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
CACHE = ROOT / "native" / ".baseline_cache.json"

ROWS, COLS, NFFT, NDISP = 512, 2048, 2048, 512
BATCH = 8          # frames per group (averages)
G = 64             # groups per timed scan call
G_BATCHED = 16     # groups per timed flat (batched) call
REPEATS = 6


def cpp_baseline_ascans_per_sec() -> float:
    """Compile (if needed) and run the C++ single-core baseline; cache the
    result so bench runs are stable across invocations."""
    if CACHE.exists():
        try:
            return float(json.loads(CACHE.read_text())["ascans_per_sec"])
        except Exception:
            pass
    exe = ROOT / "native" / "cpu_baseline"
    src = ROOT / "native" / "cpu_baseline.cpp"
    try:
        if not exe.exists():
            subprocess.run(
                ["g++", "-O3", "-march=native", "-o", str(exe), str(src)],
                check=True, capture_output=True, timeout=120)
        out = subprocess.run(
            [str(exe), str(ROWS), str(COLS), str(NFFT), str(NDISP), "3"],
            check=True, capture_output=True, timeout=120, text=True)
        val = float(out.stdout.strip().split("=")[1])
        CACHE.write_text(json.dumps({"ascans_per_sec": val,
                                     "rows": ROWS, "cols": COLS}))
        return val
    except Exception as e:  # no toolchain on the bench host — use last known
        print(f"baseline compile/run failed: {e}", file=sys.stderr)
        return 15359.0  # measured on the dev machine (g++ -O3 -march=native)


def main() -> None:
    import functools

    import jax
    import jax.numpy as jnp

    from fdoct_tpu.calibration import Calibration
    from fdoct_tpu.config import PipelineConfig
    from fdoct_tpu.pipeline import form_bscan, reconstruct
    from fdoct_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: no GPU (found {dev.platform}); a CPU "
                         f"time is not a device metric")
    print(f"info: device {dev.platform} {dev.device_kind} x"
          f"{len(jax.devices())}", file=sys.stderr)

    cfg = PipelineConfig(
        width=COLS, height=ROWS, binvalue=1, averages=BATCH,
        numfftpoints=NFFT, numdisplaypoints=NDISP,
        lambdamin=816e-9, lambdamax=884e-9,
        dtype="float32", compat=True,
    )
    calib = Calibration.create(cfg)

    background = jax.device_put(jnp.full((ROWS, COLS), 128.0, jnp.float32), dev)
    pi_frame = jax.device_put(jnp.zeros((ROWS, COLS), jnp.float32), dev)

    def group_step(frames):
        mags = reconstruct(frames, background, pi_frame, calib, cfg,
                           method="fused")
        return form_bscan(mags.sum(axis=0), cfg, averages=BATCH).bscandisp

    @functools.partial(jax.jit, static_argnums=0)
    def gen_frames(g):
        key = jax.random.PRNGKey(0)
        return jax.random.randint(
            key, (g, BATCH, ROWS, COLS), 0, 255, jnp.int32).astype(jnp.uint8)

    # The scalar carry depends on every group's displayed B-scan, so
    # nothing is dead-code-eliminated.
    @jax.jit
    def scan_groups(all_frames):
        def step(c, fr):
            return c + group_step(fr).sum(), 0.0
        return jax.lax.scan(step, jnp.float32(0), all_frames)[0]

    @jax.jit
    def batched_groups(all_frames):
        # flat formulation: ONE matmul over every frame of every group,
        # then a vmapped display chain (the offline C-scan shape;
        # Session.process_group scans over groups instead)
        mags = reconstruct(all_frames, background, pi_frame, calib, cfg,
                           method="fused")          # (g, BATCH, ROWS, NDISP)
        msum = mags.sum(axis=1)
        disp = jax.vmap(
            lambda m: form_bscan(m, cfg, averages=BATCH).bscandisp)(msum)
        return disp.sum()

    def per_group(name, fn, g):
        """Median seconds per group over REPEATS timed calls of ``fn`` on
        ``g`` device-resident groups, and the samples' relative spread."""
        frames = gen_frames(g)
        frames.block_until_ready()
        fn(frames).block_until_ready()           # compile + warm
        samples = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            fn(frames).block_until_ready()
            samples.append(time.perf_counter() - t0)
        med = float(np.median(samples))
        spread = (max(samples) - min(samples)) / med
        print(f"info: {name} per-group {med / g * 1e3:.4f} ms (median of "
              f"{REPEATS} calls of {g} groups; spread {spread * 100:.1f}%)",
              file=sys.stderr)
        return med / g, spread

    per_scan, spread = per_group("scan (HEADLINE)", scan_groups, G)
    per_batched, _ = per_group("batched", batched_groups, G_BATCHED)
    ascans = BATCH * ROWS / per_scan

    # ---- int8_direct display mode (reported alongside, never headline):
    # background/pi folded into the quantized operator, device-side u8->s8
    # bias shift, two s8 matmuls straight from device memory
    # (fdoct_tpu.int8direct; accuracy pinned in tests/test_int8direct.py)
    from fdoct_tpu.int8direct import (Int8DirectPlan, reconstruct_int8_direct,
                                      shift_u8_to_s8)
    rng = np.random.default_rng(1)
    lam = np.linspace(0, 1, COLS)
    spec = np.exp(-(((lam - 0.5) / 0.18) ** 2)) * 180.0 + 12.0
    gain = 1.0 + 0.05 * np.sin(np.linspace(0, 3, ROWS))
    bg8 = gain[:, None] * spec[None, :] * (
        1 + 0.003 * rng.standard_normal((ROWS, COLS)))
    cfg8 = cfg.replace(matmul_precision="int8_direct")
    plan = Int8DirectPlan.create(calib, cfg8, bg8, np.zeros((ROWS, COLS)))

    @jax.jit
    def int8_groups(all_frames):
        def step(c, fr):
            m = reconstruct_int8_direct(shift_u8_to_s8(fr), plan)
            disp = form_bscan(m.sum(axis=0), cfg, averages=BATCH).bscandisp
            return c + disp.sum(), 0.0
        return jax.lax.scan(step, jnp.float32(0), all_frames)[0]

    @jax.jit
    def int8_batched(all_frames):
        m = reconstruct_int8_direct(shift_u8_to_s8(all_frames), plan)
        msum = m.sum(axis=1)
        disp = jax.vmap(
            lambda s: form_bscan(s, cfg, averages=BATCH).bscandisp)(msum)
        return disp.sum()

    per_int8, _ = per_group("int8_direct", int8_groups, G)
    per_int8b, _ = per_group("int8_batched", int8_batched, G_BATCHED)

    base = cpp_baseline_ascans_per_sec()
    print(json.dumps({
        "metric": "ascans_per_sec_per_chip_2048px",
        "value": round(ascans, 1),
        "unit": "ascans/s",
        "vs_baseline": round(ascans / base, 2),
        "headline_spread": round(spread, 3),
        "batched_ascans_per_sec": round(BATCH * ROWS / per_batched, 1),
        "int8_direct_ascans_per_sec": round(BATCH * ROWS / per_int8, 1),
        "int8_batched_ascans_per_sec": round(BATCH * ROWS / per_int8b, 1),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
