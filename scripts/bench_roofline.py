#!/usr/bin/env python
"""Raw roofline probes for the attached device: device-memory read
bandwidth, matmul throughput, and lax.scan per-step overhead.  Establishes the hardware
ceiling the pipeline numbers should be judged against."""
from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main() -> None:
    import jax
    import jax.numpy as jnp

    print(f"devices: {jax.devices()}", flush=True)
    dev = jax.devices()[0]
    rng = np.random.default_rng(0)

    def timeit(name, fn, *args, n=10):
        out = fn(*args)
        jax.tree_util.tree_map(lambda x: x.block_until_ready(), out)
        for _ in range(3):
            out = fn(*args)
            jax.tree_util.tree_map(lambda x: x.block_until_ready(), out)
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn(*args)
        jax.tree_util.tree_map(lambda x: x.block_until_ready(), out)
        dt = (time.perf_counter() - t0) / n
        print(f"[{name}] {dt*1e3:.3f} ms", flush=True)
        return dt

    # 1) device-memory read bandwidth: sum of a 256 MB f32 array
    big = jax.device_put(
        rng.standard_normal((8192, 8192)).astype(np.float32), dev)
    dt = timeit("sum_256MB_f32", jax.jit(lambda x: x.sum()), big)
    print(f"  -> memory read ~ {big.nbytes / dt / 1e9:.0f} GB/s", flush=True)

    # 1b) u8 read + widen bandwidth
    bigu8 = jax.device_put(
        rng.integers(0, 255, (16384, 8192)).astype(np.uint8), dev)
    dt = timeit("sum_128MB_u8_widen",
                jax.jit(lambda x: x.astype(jnp.float32).sum()), bigu8)
    print(f"  -> u8 widen+read ~ {bigu8.nbytes / dt / 1e9:.0f} GB/s", flush=True)

    # 2) matmul: 4096^3 f32 (default precision) and bf16
    a = jax.device_put(rng.standard_normal((4096, 4096)).astype(np.float32), dev)
    b = jax.device_put(rng.standard_normal((4096, 4096)).astype(np.float32), dev)
    flops = 2 * 4096**3
    dt = timeit("matmul_4096_f32", jax.jit(lambda x, y: x @ y), a, b)
    print(f"  -> f32(default prec) {flops/dt/1e12:.1f} TFLOP/s", flush=True)
    a16, b16 = a.astype(jnp.bfloat16), b.astype(jnp.bfloat16)
    dt = timeit("matmul_4096_bf16", jax.jit(
        lambda x, y: jnp.dot(x, y, preferred_element_type=jnp.float32)), a16, b16)
    print(f"  -> bf16 {flops/dt/1e12:.1f} TFLOP/s", flush=True)

    # 3) scan per-step overhead: 64-step scan over a tiny op
    tiny = jax.device_put(np.zeros((64, 8, 128), np.float32), dev)
    @jax.jit
    def scan_tiny(x):
        return jax.lax.scan(lambda c, fr: (c + fr.sum(), 0.0), 0.0, x)[0]
    dt = timeit("scan64_tiny", scan_tiny, tiny)
    print(f"  -> per scan step ~ {dt/64*1e6:.1f} us", flush=True)

    # 4) the flagship group shapes, all 8 groups in ONE matmul (no scan)
    ROWS, COLS, NDISP, BATCH, GROUPS = 512, 2048, 512, 8, 8
    raw = jax.device_put(
        rng.integers(0, 255, (GROUPS * BATCH * ROWS, COLS)).astype(np.uint8), dev)
    op_re = jax.device_put(rng.standard_normal((COLS, NDISP)).astype(np.float32), dev)
    op_im = jax.device_put(rng.standard_normal((COLS, NDISP)).astype(np.float32), dev)
    @jax.jit
    def all_at_once(fr):
        y = fr.astype(jnp.float32)
        re = y @ op_re
        im = y @ op_im
        mag = jnp.sqrt(re * re + im * im)
        return mag.reshape(GROUPS, BATCH, ROWS, NDISP).sum(axis=1)
    dt = timeit("all8groups_one_matmul", all_at_once, raw)
    print(f"  -> {dt/GROUPS*1e3:.3f} ms/group = "
          f"{BATCH*ROWS*GROUPS/dt/1e6:.2f} M ascans/s", flush=True)

    flops8 = 2 * 2 * GROUPS * BATCH * ROWS * COLS * NDISP
    print(f"  -> {flops8/dt/1e12:.1f} TFLOP/s in the group matmul", flush=True)


if __name__ == "__main__":
    main()
