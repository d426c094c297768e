#!/usr/bin/env python
"""Multi-chip scaling harness (BASELINE.md: ≥80% efficiency at N≥2).

Runs the sharded B-scan step and C-scan volume assembly over every device
count 1..N available (virtual CPU mesh here, real chips in deployment) at
the flagship shape, and reports:

- strong-scaling wall-clock + efficiency vs 1 device,
- per-step collective traffic, measured from the compiled HLO (every
  all-reduce / all-gather / collective-permute / reduce-scatter with its
  shape), not estimated,
- a JSON summary line for machine consumption.

One command either way:
  CPU (virtual 8-device mesh, correctness + traffic numbers; the default):
      python scripts/bench_scaling.py
  the host's real GPUs (real efficiency numbers):
      python scripts/bench_scaling.py --native

On the CPU backend wall-clock "efficiency" reflects host thread scheduling,
not the interconnect — the number that matters here is the collective bytes/step, which
is identical on real hardware (same HLO).  The harness prints which regime
it ran in.
"""
from __future__ import annotations

import json
import os
import re
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

_NATIVE = "--native" in sys.argv
if not _NATIVE:
    # default to the virtual CPU mesh; --native uses whatever real
    # devices the environment provides
    os.environ["JAX_PLATFORMS"] = "cpu"
    if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   " --xla_force_host_platform_device_count=8").strip()

import numpy as np

# flagship shape (BASELINE primary metric: 2048-px spectra)
ROWS, COLS, NFFT, NDISP, BATCH = 512, 2048, 2048, 512, 8
REPEATS = 5

_DTYPE_BYTES = {"f32": 4, "bf16": 2, "f64": 8, "u8": 1, "s32": 4, "u32": 4,
                "f16": 2, "s8": 1, "pred": 1, "c64": 8, "c128": 16}

_COLLECTIVES = ("all-reduce", "all-gather", "collective-permute",
                "reduce-scatter", "all-to-all")


def collective_bytes(hlo_text: str) -> dict[str, int]:
    """Sum output bytes of every collective op in a compiled HLO module.

    Parses lines like ``%x = f32[512,64]{1,0} all-reduce(...)`` (including
    tuple-shaped variants) and attributes the full output size to the op.
    Measured from what XLA actually emitted — the same module runs on real
    chips, so these numbers transfer even when the harness runs on CPU.
    """
    out: dict[str, int] = {}
    shape_re = re.compile(r"(\w+)\[([\d,]*)\]")
    for line in hlo_text.splitlines():
        m = re.search(r"=\s*(.+?)\s+(" + "|".join(_COLLECTIVES) + r")[\s(.-]",
                      line)
        if not m:
            continue
        shapes, op = m.group(1), m.group(2)
        # async pairs appear as -start/-done: the -start's result is a
        # tuple that aliases the operand (double the real size), so count
        # only the -done's plain result shape; sync ops count their result
        if f"{op}-start" in line:
            continue
        nbytes = 0
        for dt, dims in shape_re.findall(shapes):
            if dt not in _DTYPE_BYTES:
                continue
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            nbytes += n * _DTYPE_BYTES[dt]
        out[op] = out.get(op, 0) + nbytes
    return out


def main() -> None:
    import jax

    if not _NATIVE:
        # belt-and-braces: some environments override JAX_PLATFORMS after
        # the interpreter starts; the config route wins (conftest.py ditto)
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from fdoct_tpu.calibration import Calibration
    from fdoct_tpu.config import PipelineConfig
    from fdoct_tpu.parallel import (make_mesh, shard_frames,
                                    sharded_bscan_step, sharded_cscan_volume)

    devs = jax.devices()
    n_max = len(devs)
    platform = devs[0].platform
    print(f"platform={platform} devices={n_max} "
          f"(CPU run: efficiency ≈ host scheduling; collective bytes exact)",
          flush=True)

    cfg = PipelineConfig(
        width=COLS, height=ROWS, binvalue=1, averages=BATCH,
        numfftpoints=NFFT, numdisplaypoints=NDISP,
        lambdamin=816e-9, lambdamax=884e-9, dtype="float32", compat=True)
    calib = Calibration.create(cfg)
    rng = np.random.default_rng(0)
    frames_host = rng.integers(0, 255, (BATCH, ROWS, COLS)).astype(np.uint8)
    bg = jnp.full((ROWS, COLS), 128.0, jnp.float32)
    pi = jnp.zeros((ROWS, COLS), jnp.float32)

    counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_max]
    rows = []
    t1 = None
    for n in counts:
        n_ascan = 2 if n % 2 == 0 and n > 1 else 1
        n_data = n // n_ascan
        mesh = make_mesh(n_data, n_ascan, devices=devs[:n])
        frames = shard_frames(jnp.asarray(frames_host), mesh)

        def bstep(fr):
            return sharded_bscan_step(fr, bg, pi, calib, cfg, mesh)

        # warm + correctness anchor
        db, disp = bstep(frames)
        db.block_until_ready()
        best = float("inf")
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            db, disp = bstep(frames)
            db.block_until_ready()
            best = min(best, time.perf_counter() - t0)
        if t1 is None:
            t1 = best
        eff = t1 / (n * best)

        # collective traffic from the ACTUAL compiled sharded module
        from fdoct_tpu.parallel.sharded import build_bscan_step
        fn = build_bscan_step(mesh, calib, cfg, "fused", BATCH)
        hlo = fn.lower(frames, bg, pi).compile().as_text()
        coll = collective_bytes(hlo)
        total_coll = sum(coll.values())

        rows.append(dict(devices=n, mesh=f"{n_data}x{n_ascan}",
                         ms_per_step=round(best * 1e3, 3),
                         ascans_per_sec=round(BATCH * ROWS / best, 0),
                         efficiency=round(eff, 3),
                         collective_bytes=total_coll,
                         collectives={k: v for k, v in sorted(coll.items())}))
        print(f"n={n:2d} mesh={n_data}x{n_ascan}  {best*1e3:8.2f} ms/step  "
              f"eff={eff:5.1%}  collectives={total_coll/1e3:.1f} kB "
              f"{coll}", flush=True)

    # C-scan volume assembly at the largest mesh (+ its all_gather traffic)
    n = counts[-1]
    n_ascan = 2 if n % 2 == 0 and n > 1 else 1
    mesh = make_mesh(n // n_ascan, n_ascan, devices=devs[:n])
    frames = shard_frames(jnp.asarray(frames_host), mesh)
    from fdoct_tpu.parallel.sharded import build_cscan_volume
    cfn = build_cscan_volume(mesh, calib, cfg)
    vol = cfn(frames, bg, pi)
    vol.block_until_ready()
    t0 = time.perf_counter()
    vol = cfn(frames, bg, pi)
    vol.block_until_ready()
    t_cscan = time.perf_counter() - t0
    cscan_coll = collective_bytes(cfn.lower(frames, bg, pi).compile().as_text())
    print(f"cscan volume {tuple(vol.shape)} on {n} devices: "
          f"{t_cscan*1e3:.2f} ms  collectives={cscan_coll}", flush=True)

    print(json.dumps({"metric": "scaling", "platform": platform,
                      "flagship": [ROWS, COLS, NFFT, NDISP, BATCH],
                      "rows": rows,
                      "cscan_collectives": cscan_coll}))


if __name__ == "__main__":
    main()
