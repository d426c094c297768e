"""End-to-end demo: every major subsystem in one script.

Run: python examples/demo.py [outdir]
Works on CPU or GPU; JAX_PLATFORMS=cpu selects the CPU.
"""

import sys
from pathlib import Path as _P
sys.path.insert(0, str(_P(__file__).resolve().parent.parent))  # run from a checkout
from pathlib import Path

import numpy as np
import jax.numpy as jnp

from fdoct_tpu.calibration import Calibration
from fdoct_tpu.config import PipelineConfig
from fdoct_tpu.pipeline import reconstruct_bscan
from fdoct_tpu.plugins import ROIPlugin, VibrometryPlugin
from fdoct_tpu.session import Session
from fdoct_tpu.sinks import RunWriter
from fdoct_tpu.sources.synthetic import SyntheticSource
from fdoct_tpu.viewer import Viewer


def main(outdir: str = "demo_out") -> None:
    out = Path(outdir)

    # 1. a config and its calibration (reference: BscanFFT.ini + the λ→k
    #    precompute)
    cfg = PipelineConfig(width=512, height=64, binvalue=1, averages=4,
                         numfftpoints=1024, numdisplaypoints=256,
                         lambdamin=816e-9, lambdamax=884e-9,
                         dtype="float32")
    calib = Calibration.create(cfg)
    print(f"calibration: {calib.n_raw} λ samples → {calib.ndisp} depths")

    # 2. synthetic physics source (the wangOCT model)
    src = SyntheticSource(height=cfg.height, width=cfg.width,
                          depths_um=(40.0, 90.0), reflectivities=(0.5, 0.3),
                          noise=0.01)

    # 3. one-shot batched reconstruction (the jit core)
    frames = jnp.asarray(np.stack([next(iter(src.frames()))
                                   for _ in range(cfg.averages)]))
    bg = jnp.asarray(np.maximum(src.background(), 1).astype(np.float32))
    pi = jnp.zeros_like(bg)
    result = reconstruct_bscan(frames, bg, pi, calib, cfg, method="fused")
    print(f"B-scan: {result.bscandb.shape}, peak {float(result.bscandb.max()):.1f} dB")

    # 4. interactive session + viewer (the keystroke state machine)
    sink = RunWriter(out, "demo")
    session = Session(cfg, sink=sink)
    session.plugins.append(ROIPlugin())
    viewer = Viewer(mode="files", outdir=out / "windows")
    session.key("b")                      # capture background
    it = iter(src.frames())
    for _ in range(cfg.averages):
        session.process(next(it))
    session.key("s")                      # save next group
    for _ in range(cfg.averages):
        raw = next(it)
        r = session.process(raw)
        viewer.show_session_frame(session, raw, r)
    session.close()
    print(f"session outputs in {sink.dir}, windows in {out / 'windows'}")

    # 5. sharded execution over whatever devices exist
    import jax
    if len(jax.devices()) > 1:
        from fdoct_tpu.parallel import make_mesh, shard_frames, sharded_bscan_step
        mesh = make_mesh()
        db, disp = sharded_bscan_step(shard_frames(frames, mesh), bg, pi,
                                      calib, cfg, mesh)
        print(f"sharded over {len(jax.devices())} devices: {db.shape}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "demo_out")
