#!/usr/bin/env python
"""Host→device ingest benchmark (BASELINE.md streaming).

Measures, on whatever device is attached:

1. raw ``device_put`` bandwidth (MB/s) for flagship-shape uint8 frame
   batches — the transport number that bounds any live deployment,
2. ingest-inclusive reconstruction throughput through the double-buffered
   input pipeline (streaming.run_streaming: device_put batch N+1 while
   batch N computes) — A-scans/s including the host feed,
3. the BscanFFTspinjnt-style 500 fps triggered-capture emulation at the
   reference's FLIR shape (720×480 @ 8 bit): sustained fps through the
   same pipeline, vs the 500 fps target,
4. the bandwidth the 500 fps flagship workload would need, next to the
   measured link bandwidth of (1).

Prints one JSON line per metric.  Runs on the default platform (the GPU)
or, for a correctness drive, on the CPU (--cpu).  Reporting (1) next to (2)
separates transport from compute.
"""
from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

if "--cpu" in sys.argv:
    os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np

ROWS, COLS, NFFT, NDISP, BATCH = 512, 2048, 2048, 512, 8
FLIR_H, FLIR_W = 480, 720          # BscanFFTspinjnt.ini working shape


def main() -> None:
    import jax
    import jax.numpy as jnp

    if "--cpu" in sys.argv:
        jax.config.update("jax_platforms", "cpu")

    from fdoct_tpu.calibration import Calibration
    from fdoct_tpu.config import PipelineConfig
    from fdoct_tpu.pipeline import form_bscan, reconstruct
    from fdoct_tpu.streaming import run_streaming

    dev = jax.devices()[0]
    print(f"device: {dev} ({dev.platform})", file=sys.stderr, flush=True)

    # ---- 1. raw device_put bandwidth --------------------------------
    rng = np.random.default_rng(0)
    pool = rng.integers(0, 255, (4, BATCH, ROWS, COLS)).astype(np.uint8)

    def put_forced(arr):
        return jax.device_put(arr, dev).block_until_ready()

    put_forced(pool[0])          # warm
    nbytes = pool[0].nbytes
    best = float("inf")
    for i in range(8):
        t0 = time.perf_counter()
        put_forced(pool[i % 4])
        best = min(best, time.perf_counter() - t0)
    put_mbps = nbytes / best / 1e6
    print(json.dumps({"metric": "device_put_bandwidth",
                      "value": round(put_mbps, 1), "unit": "MB/s",
                      "batch_bytes": nbytes}), flush=True)

    # ---- 2. ingest-inclusive reconstruction -------------------------
    cfg = PipelineConfig(width=COLS, height=ROWS, binvalue=1, averages=BATCH,
                         numfftpoints=NFFT, numdisplaypoints=NDISP,
                         lambdamin=816e-9, lambdamax=884e-9,
                         dtype="float32", compat=True)
    calib = Calibration.create(cfg)
    bg = jax.device_put(jnp.full((ROWS, COLS), 128.0, jnp.float32), dev)
    pi = jax.device_put(jnp.zeros((ROWS, COLS), jnp.float32), dev)

    def step(frames):
        mags = reconstruct(frames, bg, pi, calib, cfg, method="fused")
        return form_bscan(mags.sum(0), cfg, averages=BATCH).bscandisp

    jstep = jax.jit(step)
    jstep(jax.device_put(pool[0], dev)).block_until_ready()   # compile

    def frame_source():
        i = 0
        while True:
            yield pool[i % 4, i % BATCH]
            i += 1

    n_batches = 12
    t0 = time.perf_counter()
    results, stats = run_streaming(frame_source(), jstep, batch=BATCH,
                                   n_batches=n_batches, device=dev)
    float(jnp.sum(results[-1]))       # force true completion of the tail
    dt = time.perf_counter() - t0
    ingest_ascans = len(results) * BATCH * ROWS / dt
    print(json.dumps({"metric": "ingest_inclusive_ascans_per_sec",
                      "value": round(ingest_ascans, 1), "unit": "ascans/s",
                      "batches": len(results),
                      "fps": round(len(results) * BATCH / dt, 1)}), flush=True)

    # ---- 3. 500 fps triggered-capture emulation (FLIR shape) --------
    cfg_f = PipelineConfig(width=FLIR_W, height=FLIR_H, binvalue=1,
                           averages=BATCH, numfftpoints=720,
                           numdisplaypoints=360, lambdamin=816e-9,
                           lambdamax=884e-9, dtype="float32", compat=True)
    # FLIR width 720 is not 128-aligned; the fused path handles any size
    calib_f = Calibration.create(cfg_f)
    bg_f = jax.device_put(jnp.full((FLIR_H, FLIR_W), 128.0, jnp.float32), dev)
    pi_f = jax.device_put(jnp.zeros((FLIR_H, FLIR_W), jnp.float32), dev)
    pool_f = rng.integers(0, 255, (32, FLIR_H, FLIR_W)).astype(np.uint8)

    def step_f(frames):
        mags = reconstruct(frames, bg_f, pi_f, calib_f, cfg_f, method="fused")
        return form_bscan(mags.sum(0), cfg_f, averages=BATCH).bscandisp

    jstep_f = jax.jit(step_f)
    jstep_f(jax.device_put(pool_f[:BATCH], dev)).block_until_ready()

    def source_f():
        i = 0
        while True:
            yield pool_f[i % 32]
            i += 1

    n_batches = 40
    t0 = time.perf_counter()
    results, stats = run_streaming(source_f(), jstep_f, batch=BATCH,
                                   n_batches=n_batches, device=dev)
    float(jnp.sum(results[-1]))       # force true completion of the tail
    dt = time.perf_counter() - t0
    fps = len(results) * BATCH / dt
    need_mbps_flir = 500 * FLIR_H * FLIR_W / 1e6
    print(json.dumps({"metric": "triggered_capture_emulation_fps",
                      "value": round(fps, 1), "unit": "frames/s",
                      "target": 500,
                      "shape": [FLIR_H, FLIR_W],
                      "bandwidth_needed_at_500fps_MBps": round(need_mbps_flir, 1),
                      "measured_link_MBps": round(put_mbps, 1),
                      "link_bound_fps": round(put_mbps * 1e6
                                              / (FLIR_H * FLIR_W), 1)}),
          flush=True)

    # ---- 4. flagship 500 fps bandwidth requirement ------------------
    need_mbps = 500 * ROWS * COLS / 1e6
    print(json.dumps({"metric": "flagship_500fps_bandwidth_needed",
                      "value": round(need_mbps, 1), "unit": "MB/s",
                      "note": "compare with the measured "
                              "device_put_bandwidth above"}),
          flush=True)

    # ---- 5. ring→device copy paths (zero-copy prototype) ------------
    # Before: RingReader.latest per frame (ring→scratch memcpy + fresh
    # ndarray copy) + np.stack batch assembly (third copy) + device_put.
    # After: RingReader.latest_into writes each frame straight into a slot
    # of ONE persistent batch buffer (single memcpy) that device_put ships.
    # Bytes on the wire are IDENTICAL (u8 both ways, 8.4 MB/batch at the
    # flagship shape) — the delta is host-side assembly time, which bounds
    # the local-PCIe deployment where the link is not the bottleneck.
    from fdoct_tpu.sources.camera import RingReader, RingWriter
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        ring_path = Path(td) / "bench.ring"
        wr = RingWriter(ring_path, COLS, ROWS, bpp=8, nslots=BATCH + 2)
        rd = RingReader(ring_path)
        src_frames = pool[0]                       # (BATCH, ROWS, COLS) u8
        batch_buf = np.empty((BATCH, ROWS, COLS), np.uint8)

        # push/read interleaved (latest* return the NEWEST unseen frame, so
        # the reader must keep up with the writer — as in the live loop)
        def path_before():
            frames = []
            for f in src_frames:
                wr.push(f)
                got = rd.latest(timeout_s=2.0)
                assert got is not None
                frames.append(got)
            return jax.device_put(np.stack(frames), dev)

        def path_after():
            for i, f in enumerate(src_frames):
                wr.push(f)
                ok = rd.latest_into(batch_buf[i], timeout_s=2.0)
                assert ok
            return jax.device_put(batch_buf, dev)

        stats = {}
        for name, fn in (("copying", path_before), ("zero_copy", path_after)):
            best = float("inf")
            for _ in range(6):
                t0 = time.perf_counter()
                x = fn()
                int(x[0, 0, 0])                    # force the transfer
                best = min(best, time.perf_counter() - t0)
            stats[name] = best
        rd.close()
        wr.close()
    print(json.dumps({
        "metric": "ring_to_device_batch_ms",
        "copying_path_ms": round(stats["copying"] * 1e3, 2),
        "zero_copy_path_ms": round(stats["zero_copy"] * 1e3, 2),
        "speedup": round(stats["copying"] / stats["zero_copy"], 2),
        "bytes_on_wire_per_batch": int(batch_buf.nbytes),
        "note": "u8 both ways; delta = host assembly copies "
                "(RingReader.latest_into)"}), flush=True)


if __name__ == "__main__":
    main()
