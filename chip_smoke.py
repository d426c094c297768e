#!/usr/bin/env python
"""GPU smoke run of the OCT reconstruction main path.

    python chip_smoke.py                # one card: the phases below
    python chip_smoke.py --cards 4      # four cards: the mesh paths only
    python chip_smoke.py --dump-hlo DIR # also write the group step's HLO

One process drives the system through its normal entry points
(``fdoct_tpu.cli.main``), in order:

1. device    — the first JAX device must be a GPU (there is no CPU
               fallback); prints its kind, the device count, and
               ``nvidia-smi``'s name and power limit for every card.
2. native    — rebuilds the capture ring library and daemon from source.
3. main_path — ``fdoct live`` (batched; synthetic source, then the native
               ring) and ``fdoct sim`` at the flagship shape, then the
               group step's memory analysis, the route every dot took in
               its compiled HLO, and its steady per-group time.
4. numerics  — every ``--precision`` mode and the gather / hilbert methods
               on the flagship, QHY and FLIR configurations, each against
               the float64 path on the host CPU, within the bounds the CPU
               suite pins.
5. selftest  — ``fdoct selftest``.
6. gpu_tests — the tests marked ``gpu`` (tests/test_chip_smoke.py).

``--cards 4`` runs the device phase and then only ``mesh``:
``__graft_entry__.dryrun_multichip(4)`` and a 512-frame
``fdoct cscan --mesh 2x2``, each compared with the same work on card 0.

A failed phase raises, so the script exits non-zero and prints no result.
The last line of stdout is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

PHASES = {
    1: ("device", "native", "main_path", "numerics", "selftest", "gpu_tests"),
    4: ("device", "mesh"),
}

#: display-equivalence bounds against the float64 reference, per mode, as
#: the CPU suite pins them (None where it pins none): the f32 paths
#: (tests/test_precision.py test_f32_fused_vs_f64_gather and
#: test_f32_gather_vs_f64_gather for the u8 display, the dB bounds of
#: test_bf16_branch_display_equivalent), the bf16 operands (the latter
#: test), and the quantized display modes (test_int8_branch_display_
#: equivalent; tests/test_int8direct.py test_display_equivalent_clean_bg).
_F32 = {"u8_within2": 0.99, "u8_max": 8, "db_signal": 0.1, "db_floor": 4.0}
_BF16 = {"u8_within2": None, "u8_max": None, "db_signal": 0.1,
         "db_floor": 4.0}
_INT8 = {"u8_within2": None, "u8_max": None, "db_signal": 0.15,
         "db_floor": 8.0}
BOUNDS = {"default": _F32, "highest": _F32, "gather": _F32, "hilbert": _F32,
          "bf16": _BF16, "int8": _INT8, "int8_direct": _INT8}

#: (name, method, matmul_precision) of every mode a user can select
MODES = (
    ("default", "fused", "default"),
    ("highest", "fused", "highest"),
    ("bf16", "fused", "bf16"),
    ("int8", "fused", "int8"),
    ("int8_direct", "fused", "int8_direct"),
    ("gather", "gather", "default"),
    ("hilbert", "hilbert", "default"),
)


def parse_nvidia_smi(text: str) -> list[tuple[str, str]]:
    """``name,power.limit`` CSV rows (noheader) → [(name, limit)]."""
    rows = []
    for line in text.splitlines():
        if line.strip():
            name, _, limit = line.rpartition(",")
            rows.append((name.strip(), limit.strip()))
    return rows


def query_cards() -> list[tuple[str, str]]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    cards = parse_nvidia_smi(out)
    if not cards:
        raise RuntimeError("nvidia-smi listed no card")
    return cards


def phases_for(cards: int) -> tuple[str, ...]:
    if cards not in PHASES:
        raise ValueError(f"--cards must be one of {sorted(PHASES)}")
    return PHASES[cards]


def dot_routes(hlo_text: str) -> Counter:
    """How XLA implemented the matrix products of a compiled GPU module:
    library calls (cuBLAS / cuBLASLt / cuDNN custom calls), Triton GEMM
    fusions, and dots left to XLA's own emitters."""
    routes = Counter()
    for target in re.findall(r'custom_call_target="([^"]+)"', hlo_text):
        if "cublas$lt" in target:
            routes["cublasLt"] += 1
        elif "cublas" in target:
            routes["cublas"] += 1
        elif "cudnn" in target:
            routes[f"cudnn:{target}"] += 1
    routes["triton_gemm_fusion"] += len(
        re.findall(r'"kind":"__triton_gemm"', hlo_text))
    routes["dot_instruction"] += len(re.findall(r"\sdot\(", hlo_text))
    return +routes            # drop zero counts


_DTYPE_BYTES = {"f32": 4, "bf16": 2, "f16": 2, "s32": 4, "s8": 1, "u8": 1}


def library_dot_output_bytes(hlo_text: str) -> int:
    """Bytes the library-call dots (cuBLAS / cuBLASLt) write to device
    memory: their results cannot stay in registers for a consumer fusion,
    so each is written and read back once."""
    total = 0
    for m in re.finditer(r"= \((\w+)\[([\d,]+)\][^=]*custom-call\([^)]*\), "
                         r'custom_call_target="__cublas', hlo_text):
        total += _DTYPE_BYTES[m.group(1)] * int(np.prod(
            [int(d) for d in m.group(2).split(",")]))
    return total


# ---------------------------------------------------------------------------
# configurations (the flagship deployment shape and the reference's own
# instrument settings, BASELINE.md table)


def flagship_cfg():
    from fdoct_tpu.config import PipelineConfig
    return PipelineConfig(
        width=2048, height=512, binvalue=1, averages=8, numfftpoints=2048,
        numdisplaypoints=512, lambdamin=816e-9, lambdamax=884e-9,
        increasefftpointsmultiplier=1, dtype="float32", compat=True,
        dirdescr="smoke")


def qhy_cfg():
    """QHY live instrument (build/BscanFFT.ini)."""
    from fdoct_tpu.config import PipelineConfig
    return PipelineConfig(
        width=320, height=240, bpp=8, binvalue=2, averages=10,
        numfftpoints=2560, increasefftpointsmultiplier=4,
        numdisplaypoints=320, dtype="float32", compat=True)


def flir_cfg():
    """FLIR batch instrument (build/BscanFFTspinjnt.ini), 16-bit counts."""
    from fdoct_tpu.config import PipelineConfig
    return PipelineConfig(
        width=720, height=480, bpp=16, binvalue=1, averages=10,
        numfftpoints=2880, increasefftpointsmultiplier=4,
        numdisplaypoints=360, dtype="float32", compat=True)


# ---------------------------------------------------------------------------
# numerics


def synthetic_group(cfg, seed: int = 9):
    """``cfg.averages`` noisy synthetic frames at the config's raw shape
    and bit depth, plus the background at the binned shape (float64)."""
    from fdoct_tpu.sources.synthetic import SyntheticSource

    # the scene the CPU suite pins its bounds on (tests/test_precision.py)
    src = SyntheticSource(height=cfg.height, width=cfg.width,
                          depths_um=(40.0, 80.0), reflectivities=(0.5, 0.3),
                          noise=0.01, bpp=cfg.bpp, seed=seed)
    it = iter(src.frames())
    frames = np.stack([next(it) for _ in range(cfg.averages)])
    bx = max(cfg.binvalue, cfg.binvaluex, 1)
    by = max(cfg.binvalue, cfg.binvaluey, 1)
    bg = np.asarray(src.background(), np.float64)
    bg = bg.reshape(cfg.oph, by, cfg.opw, bx).mean(axis=(1, 3))
    return frames, np.maximum(bg, 1.0)


def reference_outputs(cfg, frames, bg, method: str = "gather"):
    """float64 B-scan outputs on the host CPU (x64 on for this call only)."""
    import jax
    import jax.numpy as jnp

    from fdoct_tpu.calibration import Calibration
    from fdoct_tpu.pipeline import form_bscan, reconstruct

    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu):
        cfg64 = cfg.replace(dtype="float64", matmul_precision="highest")
        calib = Calibration.create(cfg64, dtype="float64")
        bg64 = jnp.asarray(bg, jnp.float64)
        mags = reconstruct(jnp.asarray(frames), bg64, jnp.zeros_like(bg64),
                           calib, cfg64, method=method)
        out = form_bscan(mags.sum(0), cfg64, frames.shape[0])
        return {k: np.asarray(v) for k, v in out._asdict().items()}


def candidate_outputs(cfg, frames, bg, method: str, precision: str, device):
    """float32 B-scan outputs of one mode on ``device``."""
    import jax
    import jax.numpy as jnp

    from fdoct_tpu.calibration import Calibration
    from fdoct_tpu.pipeline import form_bscan, reconstruct

    cfgx = cfg.replace(dtype="float32", matmul_precision=precision)
    with jax.default_device(device):
        calib = Calibration.create(cfgx, dtype="float32")
        if precision == "int8_direct":
            from fdoct_tpu.int8direct import (Int8DirectPlan,
                                              reconstruct_int8_direct,
                                              shift_u8_to_s8)
            plan = Int8DirectPlan.create(calib, cfgx, bg, np.zeros_like(bg))
            mags = reconstruct_int8_direct(
                shift_u8_to_s8(jnp.asarray(frames)), plan)
        else:
            bg32 = jnp.asarray(bg, jnp.float32)
            mags = reconstruct(jnp.asarray(frames), bg32,
                               jnp.zeros_like(bg32), calib, cfgx,
                               method=method)
        out = form_bscan(mags.sum(0), cfgx, frames.shape[0])
        return {k: np.asarray(v) for k, v in out._asdict().items()}


def display_errors(ref: dict, got: dict) -> dict:
    du8 = np.abs(ref["bscandisp"].astype(int) - got["bscandisp"].astype(int))
    ddb = np.abs(ref["bscandb"].astype(np.float64) - got["bscandb"])
    signal = ref["bscandb"] > ref["bscandb"].max() - 30.0
    return {"u8_within2": float(np.mean(du8 <= 2)), "u8_max": int(du8.max()),
            "db_signal": float(ddb[signal].max()),
            "db_floor": float(ddb.max())}


def within(err: dict, bound: dict) -> bool:
    ok = err["db_signal"] < bound["db_signal"]
    ok &= err["db_floor"] < bound["db_floor"]
    if bound["u8_within2"] is not None:
        ok &= err["u8_within2"] > bound["u8_within2"]
        ok &= err["u8_max"] <= bound["u8_max"]
    return bool(ok)


def describe(err: dict, bound: dict) -> str:
    def b(key, op):
        return "not pinned" if bound[key] is None else f"{op}{bound[key]}"
    return (f"u8 within 2: {err['u8_within2']:.5f} ({b('u8_within2', '>')}),"
            f" u8 max {err['u8_max']} ({b('u8_max', '<=')}), dB signal "
            f"{err['db_signal']:.5f} ({b('db_signal', '<')}), dB floor "
            f"{err['db_floor']:.5f} ({b('db_floor', '<')})")


def mode_applies(cfg, precision: str) -> str:
    """'' when the mode applies to the config, else why not."""
    from fdoct_tpu.int8direct import int8_direct_supported

    if precision in ("int8", "int8_direct") and cfg.bpp > 8:
        return "quantized display modes take 8-bit counts only"
    if precision == "int8_direct":
        return int8_direct_supported(cfg)[1]
    return ""


def check_numerics(name: str, cfg, device, modes=MODES) -> list[str]:
    """Compare every applicable mode with the float64 reference; print one
    line per mode and return the names that broke their bound."""
    frames, bg = synthetic_group(cfg)
    refs = {}
    failed = []
    outs = {}
    for mode, method, precision in modes:
        why = mode_applies(cfg, precision)
        if why:
            print(f"numerics {name} {mode}: not applicable ({why})")
            continue
        ref_method = "hilbert" if method == "hilbert" else "gather"
        if ref_method not in refs:
            refs[ref_method] = reference_outputs(cfg, frames, bg, ref_method)
        got = candidate_outputs(cfg, frames, bg, method, precision, device)
        outs[mode] = got
        bound = BOUNDS[mode]
        err = display_errors(refs[ref_method], got)
        ok = within(err, bound)
        if not ok:
            failed.append(mode)
        print(f"numerics {name} {mode} vs f64 {ref_method}: "
              f"{'ok' if ok else 'FAIL'} {describe(err, bound)}")
    if "default" in outs and "highest" in outs:
        a, b = outs["default"]["bscan"], outs["highest"]["bscan"]
        rel = float(np.abs(a - b).max() / np.abs(b).max())
        print(f"numerics {name} default vs highest: max |diff|/peak "
              f"{rel:.3e} ({'below f32: TF32-class arithmetic' if rel > 1e-5 else 'f32-exact'})")
    return failed


# ---------------------------------------------------------------------------
# phases


@contextlib.contextmanager
def stdin_keys(keys: str):
    """Feed ``keys`` to a live session's stdin key reader, then EOF."""
    r, w = os.pipe()
    os.write(w, keys.encode())
    os.close(w)
    saved = sys.stdin
    sys.stdin = os.fdopen(r)
    try:
        yield
    finally:
        sys.stdin.close()
        sys.stdin = saved


def run_cli(argv: list[str]) -> None:
    from fdoct_tpu.cli import main as fdoct

    t0 = time.perf_counter()
    rc = fdoct(argv)
    print(f"fdoct {' '.join(argv)}: rc {rc} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if rc != 0:
        raise RuntimeError(f"fdoct {argv[0]} exited {rc}")


def run_dirs(outdir: Path) -> list[Path]:
    return sorted(p for p in outdir.iterdir() if p.is_dir())


def phase_device(state: dict) -> None:
    import importlib.util

    import jax

    devs = jax.devices()
    d0 = devs[0]
    if d0.platform != "gpu":
        raise RuntimeError(f"no GPU: the first JAX device is {d0} "
                           f"(platform {d0.platform})")
    need = state["cards"]
    if len(devs) < need:
        raise RuntimeError(f"need {need} GPUs, JAX sees {len(devs)}")
    print(f"jax {jax.__version__}: platform {d0.platform}, kind "
          f"{d0.device_kind}, count {len(devs)}")
    state["card_lines"] = [f"{n}, {p}" for n, p in query_cards()]
    for line in state["card_lines"]:
        print(line)
    print(f"Pillow present: {importlib.util.find_spec('PIL') is not None}")
    state["device"] = {"platform": d0.platform, "kind": d0.device_kind,
                       "count": len(devs)}


def phase_native(state: dict) -> None:
    # -B: binaries copied along with the tree may come from another host
    subprocess.run(["make", "-C", str(ROOT / "native"), "-B",
                    "libfdoct_ring.so", "capture_daemon"], check=True,
                   timeout=300)
    for name in ("libfdoct_ring.so", "capture_daemon"):
        if not (ROOT / "native" / name).exists():
            raise RuntimeError(f"native/{name} was not built")


def phase_main_path(state: dict) -> None:
    import jax
    import jax.numpy as jnp

    from fdoct_tpu.calibration import Calibration
    from fdoct_tpu.session import _session_group_pipeline

    cfg = flagship_cfg()
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        cfg_path = td / "flagship.json"
        cfg_path.write_text(cfg.to_json())
        for name, extra in (("synthetic", []),
                            ("ring", ["--camera", str(td / "smoke.ring"),
                                      "--camera-daemon", "synthetic"])):
            out = td / f"live_{name}"
            out.mkdir()
            with stdin_keys("s\n"):       # save the first group's B-scan
                run_cli(["live", "--config", str(cfg_path), "--batch", "8",
                         "--frames", "64", "--outdir", str(out)] + extra)
            (run,) = run_dirs(out)
            if not (run / "bscan001.png").exists():
                raise RuntimeError(f"live {name}: no bscan001.png in {run}")
            print(f"live {name}: {sorted(p.name for p in run.iterdir())}")
        out = td / "sim"
        out.mkdir()
        run_cli(["sim", "--config", str(cfg_path), "--frames", "2",
                 "--outdir", str(out)])
        (run,) = run_dirs(out)
        want = {"bscan001.png", "bscan002.png", "bscanc001.png",
                "bscanc002.png"}
        have = {p.name for p in run.iterdir()}
        if not want <= have:
            raise RuntimeError(f"sim: missing {sorted(want - have)} in {run}")
        print(f"sim: {sorted(have)}")

    # the live session's group step at the flagship shape
    frames, bg = synthetic_group(cfg)
    calib = Calibration.create(cfg)
    yb = jnp.asarray(bg, jnp.float32)
    zeros = jnp.zeros_like(yb)
    raw = jnp.asarray(frames)
    thr = jnp.asarray(cfg.bscanthreshold, jnp.float32)
    static = dict(cfg=cfg, groups=1, averages=cfg.averages, method="fused",
                  dark=False, eps=1e-5)
    compiled = _session_group_pipeline.lower(
        raw, yb, zeros, zeros, thr, calib, **static).compile()
    mem = compiled.memory_analysis()
    print("group step memory_analysis: " + ", ".join(
        f"{k} {getattr(mem, k)}" for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes",
            "generated_code_size_in_bytes")))
    hlo = compiled.as_text()
    print(f"group step dot routes: {dict(dot_routes(hlo))}; library-call "
          f"dot outputs through device memory: "
          f"{library_dot_output_bytes(hlo)} bytes per group")
    if state.get("dump_hlo"):
        dest = Path(state["dump_hlo"]) / "group_step.hlo.txt"
        dest.parent.mkdir(parents=True, exist_ok=True)
        dest.write_text(hlo)
        print(f"group step HLO written to {dest}")

    def step():
        return _session_group_pipeline(raw, yb, zeros, zeros, thr, calib,
                                       **static)
    jax.block_until_ready(step())
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        jax.block_until_ready(step())
        times.append(time.perf_counter() - t0)
    print(f"group step wall time (informational): median "
          f"{np.median(times) * 1e3:.4f} ms per {cfg.averages}x{cfg.oph}x"
          f"{cfg.opw} group, min "
          f"{min(times) * 1e3:.4f} ms, 20 calls, on "
          f"{'; '.join(state['card_lines'])}")


def phase_numerics(state: dict) -> None:
    import jax

    failed = []
    for name, cfg in (("flagship", flagship_cfg()), ("qhy", qhy_cfg()),
                      ("flir", flir_cfg())):
        failed += [f"{name}:{m}"
                   for m in check_numerics(name, cfg, jax.devices()[0])]
    if failed:
        raise RuntimeError(f"modes outside their bounds: {failed}")


def phase_selftest(state: dict) -> None:
    run_cli(["selftest"])


def phase_gpu_tests(state: dict) -> None:
    import pytest

    rc = pytest.main([str(ROOT / "tests" / "test_chip_smoke.py"), "-q",
                      "-m", "gpu", "-p", "no:cacheprovider"])
    if rc != 0:
        raise RuntimeError(f"gpu-marked tests exited {rc}")


def phase_mesh(state: dict) -> None:
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as graft
    from fdoct_tpu.calibration import Calibration
    from fdoct_tpu.parallel import (make_mesh, shard_frames,
                                    sharded_cscan_volume)
    from fdoct_tpu.pipeline import preprocess
    from fdoct_tpu.sources.synthetic import SyntheticSource

    t0 = time.perf_counter()
    graft.dryrun_multichip(4)
    print(f"dryrun_multichip(4): ok in {time.perf_counter() - t0:.1f} s")

    cfg = flagship_cfg()
    card0 = make_mesh(1, 1, devices=jax.devices()[:1])
    calib = Calibration.create(cfg)
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        cfg_path = td / "flagship.json"
        cfg_path.write_text(cfg.to_json())
        run_cli(["cscan", "--config", str(cfg_path), "--frames", "512",
                 "--mesh", "2x2", "--outdir", str(td)])
        (run,) = run_dirs(td)
        (npz,) = run.glob("*.npz")
        vol4 = np.load(npz)["cscan"]
    # the same volume on card 0: the CLI's synthetic source and background
    src = SyntheticSource(height=cfg.height, width=cfg.width,
                          lambda0=cfg.lambda0,
                          dlambda=cfg.lambdabw * 2.3548 / 4.0)
    it = iter(src.frames())
    raw = np.stack([next(it) for _ in range(512)])
    bg = jnp.maximum(preprocess(jnp.asarray(src.background()), cfg), 1.0)
    vol1 = np.asarray(sharded_cscan_volume(
        shard_frames(jnp.asarray(raw), card0), bg, jnp.zeros_like(bg),
        calib, cfg, card0))
    err = float(np.abs(vol4 - vol1).max() / np.abs(vol1).max())
    print(f"cscan 512 frames: --mesh 2x2 vs card 0, max |diff|/peak "
          f"{err:.3e} (bound 1e-3), shape {vol4.shape}")
    if vol4.shape != vol1.shape or not err < 1e-3:
        raise RuntimeError("cscan --mesh 2x2 differs from card 0")

    # and a volume whose frames and rows all differ, so a misplaced shard
    # cannot hide: 2x2 mesh vs card 0
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 255, (512, cfg.oph, cfg.opw)).astype(np.uint8)
    bg = jnp.full((cfg.oph, cfg.opw), 128.0, jnp.float32)
    mesh = make_mesh(2, 2)
    vols = [np.asarray(sharded_cscan_volume(
        shard_frames(jnp.asarray(raw), m), bg, jnp.zeros_like(bg), calib,
        cfg, m, gather_full=True)) for m in (mesh, card0)]
    err = float(np.abs(vols[0] - vols[1]).max() / np.abs(vols[1]).max())
    print(f"random 512-frame volume: 2x2 mesh vs card 0, max |diff|/peak "
          f"{err:.3e} (bound 1e-3)")
    if not err < 1e-3:
        raise RuntimeError("random volume on the 2x2 mesh differs from "
                           "card 0")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cards", type=int, default=1, choices=sorted(PHASES),
                   help="1 = the one-card main path (default); 4 = the "
                        "mesh paths on four cards")
    p.add_argument("--dump-hlo", metavar="DIR", default="",
                   help="write the group step's compiled HLO here")
    args = p.parse_args(argv)
    if not (ROOT / "fdoct_tpu").is_dir():
        print(f"chip_smoke: no fdoct_tpu package next to {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    # the float64 reference runs on the host CPU beside the GPU
    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    from fdoct_tpu.utils.compile_cache import enable_compile_cache
    print(f"compile cache: {enable_compile_cache()}")

    state = {"cards": args.cards, "dump_hlo": args.dump_hlo}
    for phase in phases_for(args.cards):
        t0 = time.perf_counter()
        print(f"== phase {phase}", flush=True)
        globals()[f"phase_{phase}"](state)
        print(f"== phase {phase}: ok in {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(json.dumps({"ok": True, "device": state["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
