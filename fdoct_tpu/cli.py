"""Command-line interface.

One executable with subcommands replaces the reference's 17 monolithic
binaries (SURVEY.md §2.1):

- ``fdoct sim``      — hardware-free replay (BscanFFTsim role): reconstruct
  saved interferogram PNGs, write B-scans + data dumps.
- ``fdoct live``     — streaming session on a source (synthetic generator or
  camera shim) with the keystroke state machine; keys via stdin.
- ``fdoct capture``  — triggered/free-running batch capture writing
  ``Trig%03d-%03d.png`` sets (BscanFFTspinj/spinjnt role).
- ``fdoct offline``  — the offline reconstruction tool the reference spawns
  by fork/execv with argv {dirname, manualaverages}
  (BscanFFTspinj.cpp:2389-2412); same protocol honoured.
- ``fdoct viewport`` — frame viewer/saver (ViewportSaver role).
- ``fdoct xml2m|xml2mm|xml2ms`` — FileStorage-XML → MATLAB converters
  (BscanFFTxml2m*.cpp roles).
- ``fdoct bench``    — the benchmark harness.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np


def _load_cfg(args) -> "PipelineConfig":
    from fdoct_tpu.config import PipelineConfig, read_ini

    if args.config and args.config.endswith(".ini"):
        cfg = read_ini(args.config, getattr(args, "variant", "base"))
    elif args.config:
        cfg = PipelineConfig.from_json(Path(args.config).read_text())
    else:
        cfg = PipelineConfig()
    # --precision overrides the config's matmul_precision (the reference
    # ini schemas are positional and cannot carry the field)
    if getattr(args, "precision", ""):
        cfg = cfg.replace(matmul_precision=args.precision)
        cfg.validate()
    return cfg


_open_sources: list = []   # sources needing close() (daemon-owning), see main()


#: default cap on continuous triggered-idle yields (single source of
#: truth for the argparse default, _idle_timeout fallback and _frame_iter)
IDLE_TIMEOUT_DEFAULT_S = 60.0


def _idle_timeout(args) -> float:
    """--idle-timeout resolution: <= 0 disables the cap (legitimate
    slow-trigger workflows where pulses arrive minutes apart)."""
    t = float(getattr(args, "idle_timeout", IDLE_TIMEOUT_DEFAULT_S))
    return float("inf") if t <= 0 else t


def _frame_iter(src, idle_timeout_s: float = IDLE_TIMEOUT_DEFAULT_S):
    """Blocking frame iterator for sequential/batch consumers.

    A triggered CameraSource yields ``None`` between pulses so the live
    loop can keep servicing the keys that fire them (camera.py frames());
    every other consumer (capture/viewport/fps/cscan/sweep/sim) just wants
    the next real frame, so the idle yields are skipped here — ``next()``
    blocks across pulse gaps instead of crashing on ``None.dtype``.

    The skip is capped: a consumer that never fires pulses (cscan /
    viewport / fps / sweep on a trigger-mode daemon, or a capture whose
    pulse's frame was overwritten) would otherwise block forever with no
    diagnostic, so ``idle_timeout_s`` of continuous idle yields raises a
    clear error instead.  The cmd_* consumers thread ``--idle-timeout``
    through (0 = wait forever, for operator-paced trigger workflows)."""
    import time as _time

    def gen():
        idle_since = None
        for f in src.frames():
            if f is None:
                now = _time.monotonic()
                if idle_since is None:
                    idle_since = now
                elif now - idle_since > idle_timeout_s:
                    raise TimeoutError(
                        f"triggered source produced no frame for "
                        f"{idle_timeout_s:.0f}s — this consumer does not "
                        f"fire trigger pulses; fire them (fdoct capture "
                        f"--trigger, or the t/k/| keys in fdoct live) or "
                        f"run the daemon free-running")
                continue
            idle_since = None
            yield f
    return gen()


def _parse_mesh(spec: str):
    """'DxA' → a ('data', 'ascan') device mesh, with a clean CLI error on
    malformed values (shared by `fdoct live --mesh` / `fdoct cscan --mesh`)."""
    from fdoct_tpu.parallel import make_mesh

    d, _, a = spec.lower().partition("x")
    try:
        n_data, n_ascan = int(d), (int(a) if a else 1)
        if n_data < 1 or n_ascan < 1:
            raise ValueError("axes must be >= 1")
    except ValueError as e:
        raise SystemExit(f"invalid --mesh {spec!r} "
                         f"(expected DxA, e.g. 4x2): {e}")
    # a well-formed spec that exceeds the machine is a capacity problem,
    # not a syntax one — report it without the misleading DxA prefix
    try:
        return make_mesh(n_data, n_ascan)
    except ValueError as e:
        raise SystemExit(f"--mesh {spec}: {e}")


def _make_source(args, cfg):
    from fdoct_tpu.sources import ReplaySource, SyntheticSource

    if getattr(args, "camera", None):
        # live hardware path: frames come from the native shared-memory ring
        # (the GetQHYCCDLiveFrame seat, BscanFFT.cpp:948); the daemon owns
        # the camera, this process owns the accelerator
        from fdoct_tpu.sources.camera import CameraSource
        spec = getattr(args, "camera_daemon", "synthetic")
        daemon_exe = "capture_daemon"
        if spec == "none":
            daemon_args = None
        elif spec == "synthetic":
            daemon_args = ["--synthetic"]
        elif spec.startswith("pgm:"):
            daemon_args = ["--pgm", spec[4:]]
        elif spec.startswith("v4l2:"):
            daemon_args = ["--v4l2", spec[5:]]
        elif spec == "qhy":
            daemon_args, daemon_exe = ["--qhy"], "capture_daemon_qhy"
        elif spec == "spinnaker":
            daemon_args, daemon_exe = ["--spinnaker"], "capture_daemon_spin"
        else:
            raise SystemExit(f"unknown --camera-daemon {spec!r}")
        trig = getattr(args, "trigger", "none")
        if daemon_args is not None:
            # acquisition geometry from the ini reaches the SDK init chain
            # (QHY SetQHYCCDResolution + CONTROL_USBTRAFFIC/SPEED,
            # BscanFFT.cpp:808-871; Spinnaker OffsetX/Y, Width/Height,
            # PixelFormat, AcquisitionFrameRate, BscanFFTspin.cpp:824-1015)
            daemon_args = daemon_args + [
                "--offsetx", str(cfg.offsetx), "--offsety", str(cfg.offsety),
                "--cambinx", str(cfg.cambinx), "--cambiny", str(cfg.cambiny),
                "--camspeed", str(cfg.camspeed),
                "--usbtraffic", str(cfg.usbtraffic),
                "--exposure", str(cfg.exposure_us), "--gain", str(cfg.gain)]
            if trig in ("sw", "hw"):
                daemon_args += ["--trigger", trig]
        src = CameraSource(args.camera, daemon_args=daemon_args,
                           width=cfg.width, height=cfg.height,
                           bpp=16 if cfg.bpp > 8 else 8,
                           fps=getattr(args, "camera_fps", 100.0),
                           daemon_exe=daemon_exe,
                           # triggered capture must collect EVERY pulse's
                           # frame (in-order reads); live view wants the
                           # newest (frame-skip).  triggered also relaxes
                           # the starvation watchdog: pulse gaps are idle,
                           # not a wedged daemon (CameraSource.frames)
                           sequential=trig in ("sw", "hw"),
                           triggered=trig in ("sw", "hw"),
                           initial_ctrl={"exposure": cfg.exposure_us,
                                         "gain": cfg.gain})
        _open_sources.append(src)
        return src
    if getattr(args, "image", None):
        base = Path(args.image).parent
        return ReplaySource(
            args.image,
            background_image=(args.background or
                              (base / "backg.png" if (base / "backg.png").exists() else None)),
            pi_image=(args.pi or
                      (base / "piimgi.png" if (base / "piimgi.png").exists() else None)),
        )
    # the wang λ grid spans λ0 ± 2σ_λ with σ_λ = FWHM/2.3548, so the
    # configured [λmin, λmax] range implies FWHM = range·2.3548/4
    return SyntheticSource(height=cfg.height, width=cfg.width,
                           lambda0=cfg.lambda0,
                           dlambda=cfg.lambdabw * 2.3548 / 4.0)


def _autosize(cfg, src):
    """Adapt the config to the source's actual frame size (the webcam
    variant auto-detects w/h from the first frame,
    BscanFFTwebcam.cpp:524-546)."""
    first = next(_frame_iter(src))
    h, w = first.shape[:2]
    if (cfg.height, cfg.width) == (h, w):
        return cfg
    cfg = cfg.replace(width=w, height=h)
    bx = max(cfg.binvalue, cfg.binvaluex, 1)
    by = max(cfg.binvalue, cfg.binvaluey, 1)
    if w % bx or h % by:
        cfg = cfg.replace(binvalue=1, binvaluex=1, binvaluey=1)
    return cfg


def cmd_sim(args) -> int:
    """Replay reconstruction (BscanFFTsim.cpp role)."""
    from fdoct_tpu.session import Session
    from fdoct_tpu.sinks import RunWriter

    cfg = _load_cfg(args).replace(donotnormalize=False)  # sim normalizes input
    if getattr(args, "strict_sim", False):
        cfg = cfg.replace(simcopyto=True)
    src = _make_source(args, cfg)
    if getattr(args, "image", None):
        cfg = _autosize(cfg, src)
    sink = RunWriter(args.outdir, cfg.dirdescr, fmt=args.format)
    s = Session(cfg, variant="sim", sink=sink, source=src, method=args.method)
    from fdoct_tpu.plugins import JMaskPlugin
    s.plugins.append(JMaskPlugin())      # the sim J-threshold mask path
    s.key("b")
    s.key("p")
    it = _frame_iter(src, _idle_timeout(args))

    if args.debug_dump:
        # first-iteration intermediate dump for the Octave cross-check flow
        # (BscanFFTsim.cpp:901-909 saves data_ylin + nearestkindex) — reuse
        # ``it``: a second iterator would consume (and lose) a real frame
        import jax.numpy as jnp
        from fdoct_tpu.pipeline import apodize_ratio, linearize, preprocess
        import itertools as _it
        first = next(it)
        it = _it.chain([first], it)      # put it back for the main loop
        y = preprocess(jnp.asarray(first), cfg)
        bgp = preprocess(jnp.asarray(src.background()), cfg)
        pip = preprocess(jnp.asarray(src.pi_frame()), cfg)
        yr = apodize_ratio(y, bgp.astype(y.dtype), pip.astype(y.dtype), cfg)
        ylin = linearize(yr, s.calib)
        sink.save_data("debugzpaddedlin", np.asarray(ylin))
        sink.save_data("nearestkindex", np.asarray(s.calib.nearest_idx)[None, :])

    shown = 0
    for _ in range(args.frames):
        s.key("s")
        r = None
        while r is None:
            r = s.process(next(it))
        shown += 1
    s.close()
    print(f"wrote {shown} B-scans to {sink.dir}")
    return 0


def cmd_live(args) -> int:
    """Streaming session with stdin keys (BscanFFT role, display-free)."""
    from fdoct_tpu.session import Session
    from fdoct_tpu.sinks import RunWriter

    if (getattr(args, "checkpoint_every", 0) or 0) > 0 \
            and not getattr(args, "checkpoint", None):
        # a user relying on periodic crash-safety must not silently get
        # no checkpoints: the period needs a path to write to
        raise SystemExit("--checkpoint-every N requires --checkpoint PATH")
    cfg = _load_cfg(args)
    src = _make_source(args, cfg)
    if getattr(args, "image", None):
        cfg = _autosize(cfg, src)
    sink = RunWriter(args.outdir, cfg.dirdescr, fmt=args.format)
    # ini-schema names map onto session behavior variants
    session_variant = {"base": "base", "webcam": "base", "dark": "dark",
                       "peak": "peak", "spinj": "spinj", "spinjnt": "spinj",
                       "viewport": "base", "viewportc": "base"}.get(
                           args.variant, "base")
    # live camera control loop: exposure/gain keys flow Session → this
    # callback → ring control block → daemon → device (the reference's
    # SetQHYCCDParam key seam, BscanFFT.cpp:1600-1624).  The config's
    # initial exposure/gain are seeded once, by CameraSource(initial_ctrl=)
    # in _make_source (BscanFFT.cpp:873-886) — not re-pushed here, so there
    # is exactly one seeding site to keep in sync.
    camera_cb = getattr(src, "set_param", None)
    mesh = None
    if getattr(args, "mesh", ""):
        # the live data path on the device mesh: Session.process_group
        # rides the sharded session steps (parallel.sharded), with each
        # batch device_put across the mesh in one transfer — the sharded
        # seat of the reference acquisition loop (BscanFFT.cpp:946-1925)
        mesh = _parse_mesh(args.mesh)
        print(f"live session on mesh {dict(mesh.shape)}", file=sys.stderr)
    if getattr(args, "resume", None):
        # resume: stored config wins; calibration tensors + knobs restored
        # (the reference's re-capturable ini+frames state, SURVEY.md §5)
        from fdoct_tpu.utils.checkpoint import load_session
        s = load_session(args.resume, variant=session_variant, sink=sink,
                         source=src, method=args.method, camera=camera_cb,
                         mesh=mesh)
        if camera_cb is not None:
            # restored knobs win over the config defaults pushed above
            camera_cb("exposure", s.exposure_us)
            camera_cb("gain", s.gain)
        print(f"resumed session from {args.resume}", file=sys.stderr)
    else:
        s = Session(cfg, variant=session_variant, sink=sink, source=src,
                    method=args.method, camera=camera_cb, mesh=mesh)
    viewer = None
    if args.viewer or args.viewer_mode == "http":
        from fdoct_tpu.viewer import Viewer
        viewer = Viewer(mode=args.viewer_mode, outdir=args.viewer or "viewer",
                        port=getattr(args, "viewer_port", 8089))
        if viewer.server is not None:
            print(f"live viewer at {viewer.server.url}", file=sys.stderr)
        # dashboard config panel (editiniadv analog): GET serves current
        # knobs, POSTed edits drain into Session.apply_config below
        viewer.set_config_provider(lambda: s.config_snapshot())
    import select

    batch = max(getattr(args, "batch", 1), 1)
    if getattr(src, "triggered", False):
        # a triggered camera CANNOT ride the batched streamer at all: the
        # batched loop services keys only between batches, so the 't'
        # pulse that produces the first frame could never be fired and
        # get_batch would time out.  Triggered live is always the
        # per-frame loop (which sees the None idle yields) — whether the
        # batch came from an explicit --batch or the --mesh default.
        if batch > 1 or mesh is not None:
            print("live: triggered camera keeps the per-frame loop (keys "
                  "fire the pulses); --batch/--mesh apply to free-running "
                  "sources only", file=sys.stderr)
        batch = 1
    elif mesh is not None and batch == 1:
        # the mesh rides the batched fast path (process_group); default to
        # one averaging group per sharded dispatch
        batch = max(cfg.averages, 1)
    streamer = None
    if batch > 1:
        # batched fast path: overlapped producer thread + one fused device
        # dispatch per batch (Session.process_group)
        from fdoct_tpu.streaming import FrameStreamer
        streamer = FrameStreamer(src.frames(), maxsize=4 * batch).start()
    else:
        # NOT _frame_iter: the live loop must see the None idle yields so
        # the keys that fire the next trigger pulses keep being serviced
        it = iter(src.frames())

    n = 0
    tracer = None
    if getattr(args, "trace", ""):
        # device-level profiling of the live loop (the reference's tracing
        # story is a 5 s fps counter, SURVEY.md §5; this gives real
        # per-kernel traces viewable in TensorBoard/xprof)
        from fdoct_tpu.utils.profiling import device_trace
        tracer = device_trace(args.trace)
        tracer.__enter__()
        print(f"profiler trace → {args.trace}", file=sys.stderr)

    # graceful shutdown: SIGTERM/SIGINT request a clean loop exit (like the
    # 'x' key) so the exit-time checkpoint/footer/close still run — a
    # production service stop must not lose the session state the
    # --checkpoint flag promised (the reference just dies; its resume
    # story is re-capturing calibration frames by hand).  The handler only
    # stores flags (no print: stderr may hold its buffer lock when the
    # signal lands mid-write — a reentrant print would crash the loop and
    # skip the very checkpoint it promises); the loop reports the signal.
    # A SECOND signal stops being graceful: handlers revert to default so
    # a stuck session (e.g. a stalled jit compile) stays interruptible.
    import signal as _signal

    sig_seen: list[int] = []
    old_handlers = {}

    def _graceful(signum, frame):
        if sig_seen:                      # second signal: force-exit path
            for sg, h in old_handlers.items():
                _signal.signal(sg, h)
            raise KeyboardInterrupt
        sig_seen.append(signum)
        s.done = True

    for sig in (_signal.SIGTERM, _signal.SIGINT):
        try:
            old_handlers[sig] = _signal.signal(sig, _graceful)
        except ValueError:        # not the main thread (in-process tests)
            pass

    ckpt_every = max(getattr(args, "checkpoint_every", 0) or 0, 0)
    groups_done = 0

    def _atomic_checkpoint() -> "Path":
        """Atomic write-aside + rename onto the checkpoint path (a signal
        or crash mid-save must never truncate the last good checkpoint)."""
        from fdoct_tpu.utils.checkpoint import npz_path, save_session
        tmp = Path(str(args.checkpoint) + ".tmp.npz")
        saved = save_session(s, tmp)
        dest = npz_path(args.checkpoint)
        Path(saved).replace(dest)
        return dest

    def _maybe_checkpoint(completed: int) -> None:
        """Periodic crash-safety checkpoint every N completed groups."""
        nonlocal groups_done
        groups_done += completed
        if (not args.checkpoint or not ckpt_every
                or groups_done < ckpt_every):
            return
        groups_done %= ckpt_every
        dest = _atomic_checkpoint()
        if args.verbose:
            print(f"periodic checkpoint → {dest}", file=sys.stderr)

    try:
        while not s.done and (args.frames == 0 or n < args.frames):
            if sys.stdin in select.select([sys.stdin], [], [], 0)[0]:
                for ch in sys.stdin.readline().rstrip("\n"):
                    s.key(ch)
            if viewer is not None:
                for ch in viewer.pop_keys():
                    s.key(ch)
                for roi in viewer.pop_rois():
                    s.set_roi(roi["x"], roi["y"], roi["w"], roi["h"])
                for upd in viewer.pop_config():
                    for msg in s.apply_config(upd):
                        print(f"config: {msg}", file=sys.stderr)
            if streamer is not None:
                want = batch if args.frames == 0 else min(batch,
                                                          args.frames - n)
                raws = streamer.get_batch(want)   # raises if the source died
                if raws is None:
                    break
                rs = s.process_group(raws)
                n += len(raws)
                _maybe_checkpoint(len(rs))
                raw, r = raws[-1], (rs[-1] if rs else None)
            else:
                raw = next(it)
                if raw is None:
                    # triggered source idling between pulses: loop back so
                    # the keys that fire the next pulses keep being read
                    continue
                r = s.process(raw)
                n += 1
                _maybe_checkpoint(1 if r is not None else 0)
            if viewer is not None:
                viewer.show_session_frame(s, raw, r)
            if r is not None and args.verbose:
                print(f"bscan group done (n={n}), peak "
                      f"{r.bscandb.max():.1f} dB", file=sys.stderr)
    finally:
        if sig_seen:
            print(f"signal {sig_seen[0]}: finishing up (checkpoint + "
                  f"close)", file=sys.stderr)
        if tracer is not None:
            tracer.__exit__(None, None, None)
        # join the producer before main() closes the source: a live
        # producer polling a just-munmapped ring would crash the process
        if streamer is not None:
            streamer.stop()
        # the exit-time checkpoint runs BEFORE the handlers are restored
        # (a signal during the save must not kill the write) and uses the
        # same atomic write-aside as the periodic path (an in-place
        # np.savez would truncate the last good periodic checkpoint).
        # It also runs on an EXCEPTION exit (a dead camera shouldn't lose
        # session state), so a save failure must not mask that error.
        if getattr(args, "checkpoint", None):
            try:
                dest = _atomic_checkpoint()
                print(f"session checkpoint saved to {dest}",
                      file=sys.stderr)
            except Exception as e:
                print(f"checkpoint save failed: {type(e).__name__}: {e}",
                      file=sys.stderr)
        for sig, handler in old_handlers.items():
            _signal.signal(sig, handler)
    s.close()
    if viewer is not None:
        viewer.close()
    print(f"processed {n} frames; outputs in {sink.dir}")
    return 0


def cmd_capture(args) -> int:
    """Batch capture to Trig/KTrig PNG sets (BscanFFTspinj 't'/'k'/'|' roles:
    AcquireImages/AcquireImagesAlt, BscanFFTspinj.cpp:258-450)."""
    from fdoct_tpu.sinks import RunWriter
    from fdoct_tpu.utils.imageio import write_png

    cfg = _load_cfg(args)
    src = _make_source(args, cfg)
    sink = RunWriter(args.outdir, cfg.dirdescr, fmt="m")
    it = _frame_iter(src, _idle_timeout(args))
    n = args.sets
    m = args.frames_per_set or cfg.manualaverages
    # with a trigger-mode daemon attached, fire one software pulse per
    # wanted frame (the Session._start_trig behaviour) — the daemon emits
    # exactly one frame per pulse, so an un-pulsed triggered capture would
    # otherwise block forever waiting on a silent ring.  Hardware-triggered
    # Spinnaker ignores software pulses (Line0 drives it); harmless there.
    trig_fn = getattr(src, "trigger", None)
    fire = callable(trig_fn) and getattr(src, "triggered", False)
    for si in range(n):
        if fire:
            trig_fn(m)
        for fi in range(m):
            frame = next(it)
            if frame.dtype == np.uint8 and args.bits16:
                frame = (frame.astype(np.uint16) << 8)
            write_png(sink.dir / f"Trig{si:03d}-{fi:03d}.png", frame)
        if args.alternate:  # '|' key: alternate signal/J0 sets
            pi = src.pi_frame()
            for fi in range(m):
                write_png(sink.dir / f"KTrig{si:03d}-{fi:03d}.png", pi)
    print(f"captured {n} sets of {m} frames in {sink.dir}")
    return 0


def offline_reconstruct(dirname, manualaverages: int, cfg,
                        method: str = "fused") -> int:
    """Reconstruct every Trig set of a captured directory into
    ``offline_bscan%03d.png`` (+ jet ``offline_bscanc``) next to it.
    Returns the number of sets (0 when the directory holds none).

    Shared by ``fdoct offline`` and the live session's 'y' hand-off, which
    runs it in-process (Session._spawn_offline_tool)."""
    from fdoct_tpu.calibration import Calibration
    from fdoct_tpu.pipeline import form_bscan, reconstruct
    from fdoct_tpu.sources import DirectorySource
    from fdoct_tpu.utils.colormap import apply_jet
    from fdoct_tpu.utils.imageio import read_png_gray, write_png

    import jax.numpy as jnp

    src = DirectorySource(dirname)
    sets = src.sets(False)
    if not sets:
        return 0
    first = next(_frame_iter(src))
    h, w = first.shape
    cfg = cfg.replace(width=w * max(cfg.binvalue, 1),
                      height=h * max(cfg.binvalue, 1))
    calib = Calibration.create(cfg)
    outdir = Path(dirname)
    bg = jnp.full((cfg.oph, cfg.opw), float(max(first.max(), 1)), jnp.float32)
    pi = jnp.zeros((cfg.oph, cfg.opw), jnp.float32)
    for si, paths in sorted(sets.items()):
        frames = np.stack([read_png_gray(p)
                           for p in paths[:manualaverages or None]])
        mags = reconstruct(jnp.asarray(frames), bg, pi, calib, cfg,
                           method=method)
        out = form_bscan(mags.sum(0), cfg, averages=frames.shape[0])
        write_png(outdir / f"offline_bscan{si:03d}.png", np.asarray(out.bscandisp))
        write_png(outdir / f"offline_bscanc{si:03d}.png",
                  apply_jet(np.asarray(out.bscandisp)))
    return len(sets)


def cmd_offline(args) -> int:
    """Offline reconstruction of a captured directory.

    argv protocol matches the tool the reference spawns: positional
    {dirname, manualaverages} (BscanFFTspinj.cpp:1139, 2389-2412).
    """
    n = offline_reconstruct(args.dirname, args.manualaverages,
                            _load_cfg(args), args.method)
    if not n:
        print(f"no Trig*.png sets in {args.dirname}", file=sys.stderr)
        return 1
    print(f"reconstructed {n} sets in {Path(args.dirname)}")
    return 0


def cmd_viewport(args) -> int:
    """Viewport saver: dump N raw frames as PNGs (ViewportSaver role; for
    color frames also applies the ViewportSaverc white balance and r/g/b
    single-channel display toggle)."""
    from fdoct_tpu.sinks import RunWriter

    cfg = _load_cfg(args)
    src = _make_source(args, cfg)
    sink = RunWriter(args.outdir, cfg.dirdescr, fmt="m")
    it = _frame_iter(src, _idle_timeout(args))
    for i in range(args.frames):
        frame = next(it)
        peak = 255.0 if frame.dtype == np.uint8 else 65535.0
        if frame.ndim == 3:
            # white balance (ViewportSaverc: WB R/G/B from ini) in RGB order
            wb = np.asarray([cfg.wb_red, cfg.wb_green, cfg.wb_blue])
            frame = np.clip(frame * wb, 0, peak).astype(frame.dtype)
            if args.channel in ("r", "g", "b"):
                frame = frame[..., "rgb".index(args.channel)]
        if cfg.vgamma != 1.0:
            frame = (np.clip((frame / peak) ** cfg.vgamma, 0, 1) * peak
                     ).astype(frame.dtype)
        sink.save_image(f"frame{i:03d}", frame)
    print(f"saved {args.frames} frames in {sink.dir}")
    return 0


def cmd_fps(args) -> int:
    """Source frame-rate measurement (the Displayspin/Displayspinmt role:
    fps over a measurement window, Displayspin.cpp:168-253)."""
    from fdoct_tpu.utils.profiling import FpsMeter

    cfg = _load_cfg(args)
    src = _make_source(args, cfg)
    meter = FpsMeter(window_s=args.window)
    it = _frame_iter(src, _idle_timeout(args))
    import time
    t_end = time.monotonic() + args.seconds
    while time.monotonic() < t_end:
        frame = next(it)
        reading = meter.tick()
        if reading is not None:
            print(f"fps = {reading:.1f}  max intensity = {int(frame.max())}")
    print(f"final fps = {meter.fps:.1f}")
    return 0


def _convert(args, mode: str) -> int:
    """FileStorage XML → .m converters (BscanFFTxml2m/mm/ms.cpp roles):
    'm' = one .m with all matrices, 'mm' = one .m per matrix,
    'ms' = one .m per matrix with a single variable each."""
    from fdoct_tpu.sinks.run_writer import matlab_matrix
    from fdoct_tpu.utils.cvxml import read_xml

    mats, scalars = read_xml(args.xmlfile)
    stem = Path(args.xmlfile).with_suffix("")
    if mode == "m":
        lines = [f"{k}={matlab_matrix(v)};" for k, v in mats.items()]
        lines += [f"{k}={v};" for k, v in scalars.items()]
        out = Path(f"{stem}_xml2m.m")
        out.write_text("\n".join(lines) + "\n")
        print(f"wrote {out}")
    else:
        for k, v in mats.items():
            out = Path(f"{stem}_{k}.m")
            var = k if mode == "ms" else "data"
            out.write_text(f"{var}={matlab_matrix(v)};\n")
        print(f"wrote {len(mats)} files next to {args.xmlfile}")
    return 0


def cmd_bench(args) -> int:
    import bench
    bench.main()
    return 0


def cmd_cscan(args) -> int:
    """Volumetric C-scan over the device mesh (BASELINE config-5 shape):
    optional dispersion sweep, sharded per-frame reconstruction with
    all_gather B-scan assembly, npz volume + per-frame PNGs out."""
    import jax
    import jax.numpy as jnp

    from fdoct_tpu.autofocus import autofocused_calibration, sweep_volume
    from fdoct_tpu.calibration import Calibration
    from fdoct_tpu.parallel import (
        initialize_multihost, make_mesh, shard_frames, sharded_cscan_volume)
    from fdoct_tpu.pipeline import preprocess
    from fdoct_tpu.sinks import RunWriter
    from fdoct_tpu.utils.colormap import apply_jet
    from fdoct_tpu.utils.imageio import write_png
    from fdoct_tpu.ops import normalize_minmax, to_db, to_uint8

    initialize_multihost()
    cfg = _load_cfg(args)
    src = _make_source(args, cfg)
    if getattr(args, "image", None):
        cfg = _autosize(cfg, src)
    calib = Calibration.create(cfg)
    it = _frame_iter(src, _idle_timeout(args))
    volume_raw = np.stack([next(it) for _ in range(args.frames)])
    bg = jnp.maximum(preprocess(jnp.asarray(src.background()), cfg), 1.0)
    pi = jnp.zeros_like(bg)

    if args.dispersion_sweep:
        grid = jnp.linspace(-8.0, 8.0, 33)
        _, best = sweep_volume(jnp.asarray(volume_raw[:1]), bg, pi,
                               calib, cfg, grid)
        print(f"dispersion sweep: a2 = {best:+.2f}")
        if best:
            calib = autofocused_calibration(cfg, best)

    if getattr(args, "mesh", ""):
        mesh = _parse_mesh(args.mesh)
    else:
        n_dev = len(jax.devices())
        n_ascan = 2 if n_dev % 2 == 0 and n_dev > 1 else 1
        mesh = make_mesh(n_dev // n_ascan, n_ascan)
    sharded = shard_frames(jnp.asarray(volume_raw), mesh)
    # int8-direct display volumes when the config asks and the folding
    # applies (fdoct_tpu.int8direct); dispersion-swept calibrations fold
    # the same way since the phase lives inside the operator
    from fdoct_tpu.int8direct import int8_direct_supported
    if (cfg.matmul_precision == "int8_direct" and args.method == "fused"
            and volume_raw.dtype == np.uint8
            and int8_direct_supported(cfg)[0]):
        from fdoct_tpu.int8direct import Int8DirectPlan
        from fdoct_tpu.parallel import sharded_cscan_volume_int8
        plan = Int8DirectPlan.create(calib, cfg, np.asarray(bg),
                                     np.zeros_like(np.asarray(bg)))
        print(f"int8-direct volume path (bg rank-1 residual "
              f"{float(plan.bg_rank1_resid):.2e})", file=sys.stderr)
        vol = sharded_cscan_volume_int8(sharded, plan, cfg, mesh)
    else:
        vol = sharded_cscan_volume(sharded, bg, pi, calib, cfg, mesh,
                                   method=args.method)
    vol_np = np.asarray(jax.device_get(vol))

    sink = RunWriter(args.outdir, cfg.dirdescr, fmt="npz")
    sink.save_data("cscan", vol_np)
    db = np.asarray(to_db(jnp.asarray(vol_np) + 1e-5, eps=0.0,
                          compat=cfg.compat))
    for i in range(0, vol_np.shape[0], max(1, vol_np.shape[0] // 8)):
        u8 = np.asarray(to_uint8(normalize_minmax(jnp.asarray(db[i]))))
        write_png(sink.dir / f"cscan_frame{i:03d}.png", apply_jet(u8))

    # volumetric views: en-face MIP + surface topography
    from fdoct_tpu.volume import enface_projection, surface_map
    enface = enface_projection(jnp.asarray(db), "max")
    u8 = np.asarray(to_uint8(normalize_minmax(enface)))
    write_png(sink.dir / "enface_mip.png", apply_jet(u8))
    surf = surface_map(jnp.asarray(vol_np))
    sink.save_data("surface", np.asarray(surf))
    u8 = np.asarray(to_uint8(normalize_minmax(jnp.asarray(surf).astype(jnp.float32))))
    write_png(sink.dir / "surface_map.png", u8)
    sink.close()
    print(f"C-scan {vol_np.shape} written to {sink.dir} "
          f"(+ enface_mip.png, surface_map.png)")
    return 0


def cmd_sweep(args) -> int:
    """Dispersion autofocus over a replay/synthetic source: sweep a2 on a
    frame, report the winner, optionally write the focused B-scan."""
    import jax.numpy as jnp

    from fdoct_tpu.autofocus import autofocused_calibration, sweep_volume
    from fdoct_tpu.calibration import Calibration
    from fdoct_tpu.pipeline import form_bscan, preprocess, reconstruct
    from fdoct_tpu.utils.colormap import apply_jet
    from fdoct_tpu.utils.imageio import write_png

    cfg = _load_cfg(args)
    src = _make_source(args, cfg)
    if getattr(args, "image", None):
        cfg = _autosize(cfg, src)
    calib = Calibration.create(cfg)
    raw = next(_frame_iter(src, _idle_timeout(args)))
    bg = preprocess(jnp.asarray(src.background()), cfg)
    bg = jnp.maximum(bg, 1.0)
    pi = jnp.zeros_like(bg)
    grid = jnp.linspace(args.a2_min, args.a2_max, args.steps)
    best_a3 = 0.0
    if args.joint:
        from fdoct_tpu.autofocus import sweep_volume_2d
        a3_grid = jnp.linspace(args.a3_min, args.a3_max, max(args.steps // 2, 3))
        scores, best, best_a3 = sweep_volume_2d(
            jnp.asarray(raw)[None], bg, pi, calib, cfg, grid, a3_grid)
        print(f"best a2 = {best:+.3f}, a3 = {best_a3:+.3f}")
    else:
        scores, best = sweep_volume(jnp.asarray(raw)[None], bg, pi, calib,
                                    cfg, grid)
        print(f"best a2 = {best:+.3f}  (scores "
              f"{float(scores.min()):.3e}..{float(scores.max()):.3e})")
    if args.out:
        calib2 = autofocused_calibration(cfg, best, best_a3)
        mags = reconstruct(jnp.asarray(raw), bg, pi, calib2, cfg, args.method)
        disp = form_bscan(mags, cfg, 1).bscandisp
        write_png(args.out, apply_jet(np.asarray(disp)))
        print(f"focused B-scan written to {args.out}")
    return 0


def cmd_selftest(args) -> int:
    """Deployment self-check: synthetic physics → both reconstruction paths
    → agreement + known-depth peak + sharded-vs-single parity on whatever
    devices exist.  Exit 0 = healthy."""
    import jax
    import jax.numpy as jnp

    from fdoct_tpu.calibration import Calibration
    from fdoct_tpu.config import PipelineConfig
    from fdoct_tpu.pipeline import reconstruct
    from fdoct_tpu.sources.synthetic import SyntheticSource

    cfg = PipelineConfig(width=256, height=16, averages=2, numfftpoints=512,
                         numdisplaypoints=160, dtype="float32")
    calib = Calibration.create(cfg)
    src = SyntheticSource(height=16, width=256, depths_um=(50.0,),
                          reflectivities=(0.5,))
    raw = jnp.asarray(np.stack([next(_frame_iter(src, _idle_timeout(args)))] * 2))
    bg = jnp.asarray(np.maximum(src.background(), 1).astype(np.float32))
    pi = jnp.zeros_like(bg)
    ok = True

    a = np.asarray(reconstruct(raw, bg, pi, calib, cfg, "gather"))
    b = np.asarray(reconstruct(raw, bg, pi, calib, cfg, "fused"))
    # matmul_precision "default" may run the fused matmul pair in TF32 on
    # a GPU (10-bit mantissa): ~2e-4 of the peak between the matmul and FFT
    # paths on an H100 (display-invisible), inside this 5e-3 bound; CPU f32
    # gives ~1e-7
    agree = np.allclose(a, b, rtol=5e-3, atol=5e-3 * a.max())
    print(f"[{'ok' if agree else 'FAIL'}] gather/fused agreement "
          f"(max rel {np.abs(a - b).max() / a.max():.2e})")
    ok &= agree

    kl = np.asarray(calib.klinear)
    expect = 50e-6 * (kl[-1] - kl[0]) / np.pi
    ascan = a[0, 0].copy()
    ascan[:5] = 0
    peak = int(np.argmax(ascan))
    hit = abs(peak - expect) <= 2
    print(f"[{'ok' if hit else 'FAIL'}] scatterer depth bin {peak} "
          f"(expect ~{expect:.1f})")
    ok &= hit

    n = len(jax.devices())
    n_data = 2 if n % 2 == 0 and n > 1 else 1
    n_ascan = n // n_data
    if n > 1 and raw.shape[0] % n_data == 0 and cfg.oph % n_ascan == 0:
        from fdoct_tpu.parallel import (make_mesh, shard_frames,
                                        sharded_bscan_step)
        mesh = make_mesh(n_data, n_ascan)
        db, _ = sharded_bscan_step(shard_frames(raw, mesh), bg, pi,
                                   calib, cfg, mesh)
        from fdoct_tpu.pipeline import form_bscan
        ref = form_bscan(jnp.asarray(b).sum(0), cfg, 2).bscandb
        par = np.allclose(np.asarray(db), np.asarray(ref), atol=1e-4)
        print(f"[{'ok' if par else 'FAIL'}] sharded parity over {n} devices")
        ok &= par
    else:
        print("[--] single device; sharded parity skipped")

    # native acquisition seam: ring + daemon + control loop (skipped when
    # no C++ toolchain / prebuilt binaries are available)
    import shutil as _shutil
    import tempfile

    from fdoct_tpu.sources.camera import _NATIVE_DIR
    have_native = ((_NATIVE_DIR / "capture_daemon").exists()
                   or _shutil.which("g++") is not None)
    if have_native:
        try:
            from fdoct_tpu.sources.camera import CameraSource
            with tempfile.TemporaryDirectory() as td:
                cam = CameraSource(Path(td) / "selftest.ring",
                                   daemon_args=["--synthetic"],
                                   width=64, height=16, fps=500.0)
                try:
                    it = iter(cam.frames())
                    bright = float(next(it).mean())
                    cam.set_param("exposure", 250.0)
                    acked = cam.reader.wait_ctrl_applied(5.0)
                    for _ in range(3):
                        dim_frame = next(it)
                    dim = float(dim_frame.mean())
                    ring_ok = acked and dim < bright * 0.5
                    print(f"[{'ok' if ring_ok else 'FAIL'}] camera ring + "
                          f"control loop (mean {bright:.1f} -> {dim:.1f})")
                    ok &= ring_ok
                finally:
                    cam.close()
        except Exception as e:
            print(f"[FAIL] camera ring: {type(e).__name__}: {e}")
            ok = False
    else:
        print("[--] no native toolchain; camera ring check skipped")

    print("selftest", "PASSED" if ok else "FAILED")
    return 0 if ok else 1


def cmd_configedit(args) -> int:
    """Edit fields of a positional ini in place (the role of the reference's
    Octave GUI editors build/editini.m / editiniadv.m, which poke specific
    line numbers; here fields are addressed by name)."""
    from fdoct_tpu.config import SCHEMAS, read_ini, write_ini

    # no validation here: configedit must be able to open a broken ini in
    # order to repair it (the reference's editini.m has no validation at all)
    cfg = read_ini(args.inifile, args.variant, validate=False)
    schema_names = {n for n, _ in SCHEMAS[args.variant]}
    for kv in args.set or []:
        key, _, val = kv.partition("=")
        if key not in schema_names:
            print(f"unknown field {key!r} for variant {args.variant}; "
                  f"have {sorted(schema_names)}", file=sys.stderr)
            return 1
        cur = getattr(cfg, key)
        typ = type(cur)
        cfg = cfg.replace(**{key: typ(int(val)) if typ is bool else typ(val)})
    if args.set:
        write_ini(cfg, args.inifile, args.variant)
        print(f"updated {args.inifile}")
    else:
        for name, _ in SCHEMAS[args.variant]:
            print(f"{name} = {getattr(cfg, name)}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fdoct", description=__doc__)
    # version surface for release artifacts (the reference ships versioned
    # binaries via Zenodo DOI, /root/reference/README.md:4-6)
    from fdoct_tpu import __version__
    p.add_argument("--version", action="version",
                   version=f"fdoct-tpu {__version__}")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, source=True):
        sp.add_argument("--config", help=".ini or .json config file")
        sp.add_argument("--variant", default="base",
                        help="ini schema variant (base/webcam/dark/peak/"
                             "spinj/spinjnt)")
        sp.add_argument("--outdir", default=".")
        sp.add_argument("--format", default="m", choices=["m", "xml", "npz"])
        sp.add_argument("--method", default="fused", choices=["fused", "gather"])
        sp.add_argument("--precision", default="",
                        choices=["", "default", "highest", "bf16", "int8",
                                 "int8_direct"],
                        help="matmul precision override: default = f32 "
                             "operands at the backend's default precision "
                             "(TF32 may be used on a GPU), highest = "
                             "f32-exact for metrology, bf16 = bf16 operands "
                             "with f32 accumulation, int8 / int8_direct = "
                             "quantized display modes; empty inherits the "
                             "config")
        if source:
            sp.add_argument("--image", help="interferogram PNG to replay")
            sp.add_argument("--background", help="background PNG")
            sp.add_argument("--pi", help="pi-shifted PNG")
            sp.add_argument("--camera", metavar="RING",
                            help="read frames from a native shared-memory "
                                 "ring (the camera shim; spawns the capture "
                                 "daemon unless --camera-daemon none)")
            sp.add_argument("--camera-daemon", default="synthetic",
                            help="daemon source: synthetic | pgm:DIR | "
                                 "v4l2:DEV | qhy | spinnaker | none (attach "
                                 "to an already-running daemon's ring)")
            sp.add_argument("--camera-fps", type=float, default=100.0)
            sp.add_argument("--trigger", default="none",
                            choices=["none", "sw", "hw"],
                            help="daemon trigger mode: sw = software pulses "
                                 "(t/k/| keys fire them), hw = hardware "
                                 "Line0 (Spinnaker; BscanFFTspinj)")
            sp.add_argument("--idle-timeout", type=float,
                            default=IDLE_TIMEOUT_DEFAULT_S, metavar="S",
                            help="error out after S seconds of a triggered "
                                 "source yielding no frames; <= 0 waits "
                                 "forever (operator-paced trigger "
                                 "workflows).  Applies to the sequential "
                                 "consumers (sim/capture/viewport/fps/"
                                 "cscan/sweep); `live` services the "
                                 "pulse-firing keys itself and ignores it")

    sp = sub.add_parser("sim", help="replay reconstruction")
    common(sp)
    sp.add_argument("--frames", type=int, default=1)
    sp.add_argument("--debug-dump", action="store_true",
                    help="save first-frame linearized spectrum + "
                         "nearestkindex (BscanFFTsim debug dump)")
    sp.add_argument("--strict-sim", action="store_true",
                    help="emulate the simulator's copyTo averaging slot "
                         "exactly (only the last frame of each group is "
                         "displayed; see config.simcopyto)")
    sp.set_defaults(fn=cmd_sim)

    sp = sub.add_parser("live", help="streaming session")
    common(sp)
    sp.add_argument("--frames", type=int, default=0, help="0 = until 'x' key")
    sp.add_argument("--batch", type=int, default=1,
                    help="frames per device dispatch (>1 = batched fast "
                         "path via Session.process_group; use a multiple "
                         "of the averaging count)")
    sp.add_argument("--mesh", default="", metavar="DxA",
                    help="run the live session over a jax device mesh, "
                         "e.g. 4x2 = 4-way frame (data) sharding x 2-way "
                         "A-scan sharding; implies the batched fast path "
                         "(one averaging group per sharded dispatch)")
    sp.add_argument("--verbose", action="store_true")
    sp.add_argument("--trace", metavar="LOGDIR", default="",
                    help="write a jax.profiler device trace of the live "
                         "loop here (open with TensorBoard/xprof)")
    sp.add_argument("--checkpoint", metavar="PATH",
                    help="save session state (config + calibration tensors "
                         "+ knobs) here on exit; SIGTERM/SIGINT also exit "
                         "cleanly through this save")
    sp.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                    help="with --checkpoint: also write it (atomically, "
                         "npz) every N completed B-scan groups, so a hard "
                         "crash loses at most N groups of session state")
    sp.add_argument("--resume", metavar="PATH",
                    help="restore session state from a checkpoint "
                         "(npz file or orbax dir) instead of starting cold")
    sp.add_argument("--viewer", default="",
                    help="render display windows into this directory")
    sp.add_argument("--viewer-mode", default="files",
                    choices=["files", "mpl", "http"])
    sp.add_argument("--viewer-port", type=int, default=8089,
                    help="http viewer port (0 = ephemeral)")
    sp.set_defaults(fn=cmd_live)

    sp = sub.add_parser("capture", help="batch capture Trig sets")
    common(sp)
    sp.add_argument("--sets", type=int, default=1)
    sp.add_argument("--frames-per-set", type=int, default=0)
    sp.add_argument("--alternate", action="store_true",
                    help="also write KTrig J0 sets ('|' trigger mode)")
    sp.add_argument("--bits16", action="store_true")
    sp.set_defaults(fn=cmd_capture)

    sp = sub.add_parser("offline", help="offline reconstruction of Trig dir")
    sp.add_argument("dirname")
    sp.add_argument("manualaverages", type=int, nargs="?", default=0)
    common(sp, source=False)
    sp.set_defaults(fn=cmd_offline)

    sp = sub.add_parser("viewport", help="save raw frames")
    common(sp)
    sp.add_argument("--frames", type=int, default=1)
    sp.add_argument("--channel", default="", choices=["", "r", "g", "b"],
                    help="single-channel display toggle (ViewportSaverc)")
    sp.set_defaults(fn=cmd_viewport)

    sp = sub.add_parser("fps", help="measure source frame rate")
    common(sp)
    sp.add_argument("--seconds", type=float, default=5.0)
    sp.add_argument("--window", type=float, default=1.0)
    sp.set_defaults(fn=cmd_fps)

    for mode in ("m", "mm", "ms"):
        sp = sub.add_parser(f"xml2{mode}", help=f"XML → .m ({mode})")
        sp.add_argument("xmlfile")
        sp.set_defaults(fn=lambda a, m=mode: _convert(a, m))

    sp = sub.add_parser("bench", help="run the benchmark")
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser("cscan", help="volumetric C-scan over the mesh")
    common(sp)
    sp.add_argument("--frames", type=int, default=32)
    sp.add_argument("--mesh", default="", metavar="DxA",
                    help="mesh shape override (default: all devices, "
                         "2-way A-scan sharding when even)")
    sp.add_argument("--dispersion-sweep", action="store_true")
    sp.set_defaults(fn=cmd_cscan)

    sp = sub.add_parser("sweep", help="dispersion autofocus sweep")
    common(sp)
    sp.add_argument("--a2-min", type=float, default=-8.0)
    sp.add_argument("--a2-max", type=float, default=8.0)
    sp.add_argument("--a3-min", type=float, default=-3.0)
    sp.add_argument("--a3-max", type=float, default=3.0)
    sp.add_argument("--joint", action="store_true",
                    help="joint (a2, a3) 2D sweep")
    sp.add_argument("--steps", type=int, default=33)
    sp.add_argument("--out", default="", help="write focused B-scan PNG here")
    sp.set_defaults(fn=cmd_sweep)

    sp = sub.add_parser("selftest", help="numerical self-check")
    sp.set_defaults(fn=cmd_selftest)

    sp = sub.add_parser("configedit", help="view/edit ini fields by name")
    sp.add_argument("inifile")
    sp.add_argument("--variant", default="base")
    sp.add_argument("--set", action="append", metavar="FIELD=VALUE")
    sp.set_defaults(fn=cmd_configedit)
    return p


def main(argv=None) -> int:
    from fdoct_tpu.utils.compile_cache import enable_compile_cache

    args = build_parser().parse_args(argv)
    enable_compile_cache()
    try:
        return args.fn(args)
    finally:
        # stop any spawned capture daemons (no orphans on exit or when
        # main() is called in-process)
        while _open_sources:
            _open_sources.pop().close()


if __name__ == "__main__":
    sys.exit(main())
