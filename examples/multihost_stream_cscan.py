"""Multi-host streaming C-scan: two processes stream frames into their mesh
shards; all_gather assembles the full volume on every host.

The multi-host closing demo: the streaming ingest pipeline
(fdoct_tpu.streaming.run_streaming) and the jax.distributed machinery
(tests/test_multihost.py) tied together — each "host" produces ITS slice of
every frame batch, `jax.make_array_from_process_local_data` assembles the
global sharded array (the multi-host analog of the single-host
``device_put(host, NamedSharding(...))`` ingest seam), and the sharded
C-scan volume step's all_gather over 'ascan'/'data' rides the mesh.

This is the scaled shape of the reference's offline-tool hand-off
(BscanFFTspinj.cpp:2389-2412: fork/execv a reconstruction tool over a
captured directory) for the BASELINE.md >=2-host C-scan config: acquisition
streams in per host, reconstruction is mesh-parallel, every host ends
holding the complete volume.

Run (CPU emulation of 2 hosts — also what tests/test_multihost.py drives):

    python examples/multihost_stream_cscan.py --pid 0 --port 12345 &
    python examples/multihost_stream_cscan.py --pid 1 --port 12345

``--nprocs 4 --grid 2x2`` runs a FOUR-process 2x2 process grid instead:
frames shard over 'data' AND A-scan rows over 'ascan' across processes,
so both volume-assembly all_gathers cross the process boundary
(tests/test_multihost.py::test_four_process_streaming_cscan_2x2_grid).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pid", type=int, required=True, help="process id (0/1)")
    ap.add_argument("--port", required=True, help="coordinator port")
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--grid", default="",
                    help="process grid DxA (default: nprocs x 1); a 2x2 "
                         "grid shards frames over 'data' AND rows over "
                         "'ascan' across processes (stretch)")
    ap.add_argument("--batches", type=int, default=3,
                    help="streamed volume batches (global batch = 4 frames)")
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jax.distributed.initialize(coordinator_address=f"localhost:{args.port}",
                               num_processes=args.nprocs,
                               process_id=args.pid)
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fdoct_tpu.calibration import Calibration
    from fdoct_tpu.config import PipelineConfig
    from fdoct_tpu.parallel import make_mesh
    from fdoct_tpu.parallel.sharded import build_cscan_volume
    from fdoct_tpu.pipeline import reconstruct
    from fdoct_tpu.streaming import run_streaming

    cfg = PipelineConfig(width=64, height=8, binvalue=1, averages=4,
                         numfftpoints=128, numdisplaypoints=40,
                         dtype="float64", compat=True)
    calib = Calibration.create(cfg)
    bg = jnp.asarray(np.full((8, 64), 100.0))
    pi = jnp.zeros_like(bg)

    if args.grid:
        gd, ga = (int(x) for x in args.grid.lower().split("x"))
    else:
        gd, ga = args.nprocs, 1
    assert gd * ga == args.nprocs, (gd, ga, args.nprocs)
    # process p sits at grid position (p // ga, p % ga): it streams the
    # frame slice of its 'data' row and the A-scan row block of its
    # 'ascan' column — a 2-axis DCN-analog decomposition of acquisition
    pd, pa = args.pid // ga, args.pid % ga
    GLOBAL_BATCH = 4
    local_batch = GLOBAL_BATCH // gd
    H = 8
    h_loc = H // ga
    n_frames_global = args.batches * GLOBAL_BATCH

    # every host can regenerate the GLOBAL frame stream (seeded), so the
    # acquisition is emulated deterministically: host h streams the
    # [h*local : (h+1)*local) slice of each global batch
    rng = np.random.default_rng(2024)
    frames_global = rng.integers(0, 255, (n_frames_global, 8, 64)
                                 ).astype(np.uint8)

    def local_stream():
        for b in range(args.batches):
            batch = frames_global[b * GLOBAL_BATCH:(b + 1) * GLOBAL_BATCH]
            mine = batch[pd * local_batch:(pd + 1) * local_batch,
                         pa * h_loc:(pa + 1) * h_loc]
            yield from mine

    mesh = make_mesh(gd, ga)   # process grid: frames x A-scan rows
    sharding = NamedSharding(mesh, P("data", "ascan", None))
    vol_step = build_cscan_volume(mesh, calib, cfg, method="fused",
                                  gather_full=True)

    results, stats = run_streaming(
        local_stream(),
        lambda fr: vol_step(fr, bg, pi),
        batch=local_batch, n_batches=args.batches,
        # the multi-host ingest seam: this process contributes its
        # addressable shard of the global (GLOBAL_BATCH, H, W) array
        put=lambda host: jax.make_array_from_process_local_data(
            sharding, host),
    )
    assert len(results) == args.batches, (len(results), stats.frames_in)
    # gather_full=True replicates: every host holds every volume chunk
    volume = np.concatenate([np.asarray(r.addressable_data(0))
                             for r in results], axis=0)
    print(f"[host {args.pid}] C-scan volume {volume.shape} "
          f"({stats.frames_in} frames streamed)", file=sys.stderr)

    if args.pid == 0:
        mags = reconstruct(jnp.asarray(frames_global), bg, pi, calib, cfg,
                           method="fused")
        ref = np.swapaxes(np.asarray(mags), 1, 2)      # (F, ndisp, H)
        if volume.shape != ref.shape or not np.allclose(volume, ref,
                                                        atol=1e-9):
            print("STREAM_CSCAN_MISMATCH",
                  np.abs(volume - ref).max(), file=sys.stderr)
            return 1
        print("STREAM_CSCAN_OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
