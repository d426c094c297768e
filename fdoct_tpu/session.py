"""Interactive session layer: the keystroke state machine as explicit state.

The reference's acquisition loop mixes compute with a single-key command
dispatch (``waitKey(3)`` switch, BscanFFT.cpp:1584-1917) and capture logic
scattered through the hot loop (background 'b' BscanFFT.cpp:1000-1075,
π/J0 'p' 1077-1099, J-lockin 'j'/'c' 1292-1304, save 's' 1307-1397, manual
averaging 1399-1477, double ring buffers 1482-1488; BscanDark adds dark /
reference-arm / sample-arm captures 'o'/'r'/'t', BscanDark.cpp:1005-1221).

Here all of that is a :class:`Session` object: device state lives in jax
arrays, control state in plain fields, and one :meth:`process` call per raw
frame performs exactly one reference loop iteration.  Keys arrive through
:meth:`key` with the reference's bindings (keyboardshortcuts.txt).
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Any, Callable

import numpy as np
import jax
import jax.numpy as jnp

from fdoct_tpu.calibration import Calibration
from fdoct_tpu.config import PipelineConfig
from fdoct_tpu.ops import (
    lowpass_rowwise, make_only_positive, normalize_minmax, normalize_rows,
    to_db, to_uint8, threshold_floor,
)
from fdoct_tpu.ops.filters import bscan_rebin
from fdoct_tpu.ops.scale import clamp_pixel
from fdoct_tpu.pipeline import ascan_mags, apodize_ratio, form_bscan, preprocess
from fdoct_tpu.sinks import RunWriter


@dataclasses.dataclass
class BscanResult:
    """Outputs of one completed averaging group (one displayed B-scan).

    ``bscandisp`` is always a host numpy array; ``bscan``/``bscandb`` may be
    device-resident jax arrays when produced by the batched fast path
    (Session.process_group) — call ``np.asarray`` on them for host-side
    mutation (reads work either way via ``__array__``).
    """
    bscan: np.ndarray             # linear, (ndisp, oph)
    bscandb: np.ndarray           # dB with DC rows masked
    bscandisp: np.ndarray         # uint8 display
    index: int                    # group counter
    sub_disp: np.ndarray | None = None      # J-lockin subtracted display
    manual_disp: np.ndarray | None = None   # manual-average display
    status: list[str] = dataclasses.field(default_factory=list)


class Session:
    """One live/replay reconstruction session.

    Parameters
    ----------
    cfg : pipeline configuration (immutable; runtime-adjustable quantities
        like exposure/threshold/averaging live on the session).
    variant : 'base' | 'sim' | 'dark' | 'peak' — enables the per-variant key
        handlers and processing (SURVEY.md §2.1).
    sink : optional RunWriter for 's'-key saves.
    camera : optional control callback ``camera(param: str, value)`` for
        exposure/gain changes (the QHY SetQHYCCDParam seam,
        BscanFFT.cpp:1600).
    source : optional FrameSource; when given, 'b'/'p' captures in sim
        variant pull the dedicated background/π images the way BscanFFTsim
        reads backg.png / piimgi.png (BscanFFTsim.cpp:806-825).
    """

    def __init__(self, cfg: PipelineConfig, variant: str = "base",
                 sink: RunWriter | None = None,
                 camera: Callable[[str, Any], None] | None = None,
                 source: Any = None, method: str = "fused",
                 calib: Calibration | None = None, mesh: Any = None):
        self.cfg = cfg
        self.variant = variant
        self.sink = sink
        self.camera = camera
        self.source = source
        self.method = method
        # device mesh for the live data path (SURVEY §2.5/§5): with a mesh,
        # process_group rides the sharded session steps
        # (parallel.sharded.build_session_bscan_step[_int8]) — the moral
        # successor of the reference acquisition loop
        # (BscanFFT.cpp:946-1925) running as sharded B-scan batches
        self.mesh = mesh
        self.calib = calib or Calibration.create(cfg)
        dt = jnp.dtype(cfg.dtype)
        oph, opw, ndisp = cfg.oph, cfg.opw, self.calib.ndisp

        # --- device state (the reference's Mats) ---
        self.data_yb = jnp.ones((oph, opw), dt)       # background S(k)
        self.data_yp = jnp.zeros((oph, opw), dt)      # π / J0 spectrum
        self.data_yd = jnp.zeros((oph, opw), dt)      # dark (BscanDark)
        self.data_yr = jnp.zeros((oph, opw), dt)      # reference arm
        self.data_ys = jnp.zeros((oph, opw), dt)      # sample arm
        self.accum = jnp.zeros((oph, ndisp), dt)      # bscantransposed
        self.baccum = jnp.zeros((oph, opw), dt)
        self.manualaccum = jnp.zeros((ndisp, oph), dt)
        self.jscansave: jnp.ndarray | None = None

        # --- control state (the reference's flags/counters) ---
        self.averages = cfg.averages
        self.averagestoggle = cfg.averages            # BscanFFT.cpp:481
        # the simulator display skips the threshold floor entirely
        # (BscanFFTsim.cpp:1131 block normalizes bscandisp directly, no
        # max(bscandisp, bscanthreshold)); -inf makes the floor a no-op
        # while '['/']' still adjust it if the user wants one
        self.bscanthreshold = (-np.inf if variant == "sim"
                               else cfg.bscanthreshold)
        self.exposure_us = cfg.exposure_us
        self.gain = cfg.gain
        self.ascanat = 20                             # BscanFFT.cpp:362
        self.vertposROI = 10
        self.widthROI = 10
        self.ROIreport = False
        self.jlockin = False
        self.done = False
        self.indextemp = 0
        self.indexi = 0                               # save counter
        self.manualindexi = 0
        self.baccumcount = 0
        self.manualaccumcount = 0
        self.zeroisactive = True                      # ring-buffer toggle
        self._pending: set[str] = set()
        self._dark_counts = {"dark": 0, "ref": 0, "sample": 0}
        self._dark_accum: dict[str, jnp.ndarray] = {}

        # double ring buffers (BscanFFT.cpp:569-583): per-frame B-scans and
        # raw interferograms for the save-after-the-fact story
        self._rings = {0: {"bscan": [], "raw": [], "binned": []},
                       1: {"bscan": [], "raw": [], "binned": []}}
        # int8-direct display path (cfg.matmul_precision="int8_direct"):
        # plan cache keyed on the identity of the calibration frames — any
        # 'b'/'p'/'o'/'r'/'t' capture rebinds data_yb/yp/yd and invalidates
        self._i8key: tuple | None = None
        self._i8plan = None
        self._said_once: set[str] = set()   # one-shot status messages
        self.plugins: list[Any] = []
        self.status: list[str] = []
        self._status_lock = threading.Lock()
        self._offline_threads: list[threading.Thread] = []   # 'y' hand-offs
        # 5-second fps + frame max-intensity meter (the reference's Status
        # rows, BscanFFT.cpp:1100-1119)
        from fdoct_tpu.utils.profiling import FpsMeter
        self.fpsmeter = FpsMeter(window_s=5.0)
        self.fps = 0.0
        self.max_intensity = 0
        if variant == "peak":
            # the vibrometry key set is integral to the peak variant
            from fdoct_tpu.plugins.vibrometry import VibrometryPlugin
            self.plugins.append(
                VibrometryPlugin(cfg.lambda0, cfg.peakholdnumframes))
        else:
            # the ROI analytics live in the flagship app itself
            # (printAvgROI/printMinMaxAscan, BscanFFT.cpp:99-171), toggled
            # by the 'e' key; attach them to every non-peak session
            from fdoct_tpu.plugins.roi import ROIPlugin
            self.plugins.append(ROIPlugin())

    @property
    def clampupper(self) -> bool:
        """Absolute-scale display mode (the 'q' key, BscanFFT.cpp:1248-53).
        Lives in cfg because form_bscan and the sharded display tail read
        ``cfg.clampupper`` — a separate session attribute made the toggle
        a silent no-op."""
        return self.cfg.clampupper

    @clampupper.setter
    def clampupper(self, value: bool) -> None:
        self.cfg = self.cfg.replace(clampupper=bool(value))

    # ------------------------------------------------------------------
    # key dispatch (reference: BscanFFT.cpp:1584-1917, keyboardshortcuts.txt)
    # ------------------------------------------------------------------

    _EXPOSURE_KEYS = {"+": 100, "=": 100, "-": -100, "_": -100,
                      "u": 1000, "d": -1000, "U": 10000, "D": -10000}

    def key(self, ch: str) -> None:
        """Apply one keypress.  Unknown keys are ignored (default: break)."""
        cfg = self.cfg
        if ch in ("\x1b", "x", "X"):
            self.done = True
        elif ch in self._EXPOSURE_KEYS:
            # Spinnaker has an 8 µs exposure floor (BscanFFTspinjnt '-' key
            # clamps camtime to 8); QHY clamps at 0 (BscanFFT.cpp:1623-1624)
            floor = 8 if self.variant == "spinj" else 0
            self.exposure_us = max(floor,
                                   self.exposure_us + self._EXPOSURE_KEYS[ch])
            if self.camera:
                self.camera("exposure", self.exposure_us)
            self._say(f"Exp time = {self.exposure_us} ")
        elif ch in ("s", "S", " "):
            self._pending.add("s")
        elif ch in ("b", "B"):
            self._pending.add("b")
        elif ch in ("p", "P"):
            self._pending.add("p")
        elif ch in ("j", "J"):
            self._pending.add("j")
        elif ch in ("c", "C"):
            self._pending.add("c")
        elif ch == "]":
            self.bscanthreshold += 1.0
            self._say(f"bscanthreshold = {self.bscanthreshold:f}")
        elif ch == "[":
            self.bscanthreshold -= 1.0
            self._say(f"bscanthreshold = {self.bscanthreshold:f}")
        elif ch == "(":
            if self.ascanat > 10:
                self.ascanat -= 10
            self._say(f"ascanat = {self.ascanat}")
        elif ch == "9":
            if self.ascanat > 0:
                self.ascanat -= 1
            self._say(f"ascanat = {self.ascanat}")
        elif ch == ")":
            if self.ascanat < cfg.oph - 11:
                self.ascanat += 10
            self._say(f"ascanat = {self.ascanat}")
        elif ch == "0":
            if self.ascanat < cfg.oph - 1:
                self.ascanat += 1
            self._say(f"ascanat = {self.ascanat}")
        elif ch == "W":
            if self.ascanat + self.widthROI < cfg.oph - 1:
                self.widthROI += 1
            self._say(f"ROI width = {self.widthROI}")
        elif ch == "w":
            if self.widthROI > 2:
                self.widthROI -= 1
            self._say(f"ROI width = {self.widthROI}")
        elif ch == "h":
            if self.vertposROI < self.calib.ndisp - 1:
                self.vertposROI += 1
            self._say(f"ROI vertical position = {self.vertposROI}")
        elif ch == "H":
            if self.vertposROI > 2:
                self.vertposROI -= 1
            self._say(f"ROI vertical position = {self.vertposROI}")
        elif ch in ("a", "A"):
            self.averagestoggle = (self.averages if self.averagestoggle == 1 else 1)
            self._say(f"Now averaging {self.averagestoggle} bscans.")
        elif ch in ("e", "E"):
            self.ROIreport = not self.ROIreport
        elif ch in ("q", "Q"):
            self.clampupper = not self.clampupper
        elif self.variant == "dark" and ch in ("o", "O"):
            self._pending.add("dark")            # BscanDark.cpp 'o' key
        elif self.variant == "dark" and ch in ("r", "R"):
            self._pending.add("ref")
        elif self.variant == "dark" and ch in ("t", "T"):
            self._pending.add("sample")
        elif self.variant == "spinj" and ch in ("t", "T"):
            self._start_trig("Trig")             # BscanFFTspinj.cpp:2338
        elif self.variant == "spinj" and ch in ("k", "K"):
            self._start_trig("KTrig")            # BscanFFTspinj.cpp:2332
        elif self.variant == "spinj" and ch in ("|", "\\"):
            self._start_trig("Alt")              # BscanFFTspinj.cpp:2345
        elif self.variant == "spinj" and ch in ("y", "Y"):
            self._spawn_offline_tool()           # BscanFFTspinj.cpp:2356-2412
        elif self.variant == "spinj" and ch in ("1", "!"):
            self.gain += 1                       # BscanFFTspinjnt.cpp:2188
            if self.camera:
                self.camera("gain", self.gain)
            self._say(f"Gain = {self.gain}")
        elif self.variant == "spinj" and ch in ("2", "@"):
            self.gain = max(0, self.gain - 1)
            if self.camera:
                self.camera("gain", self.gain)
            self._say(f"Gain = {self.gain}")
        elif self.variant == "spinj" and ch == "3":
            self.averagestoggle += 1             # BscanFFTspinj.cpp:2541
            self._say(f"Now averaging {self.averagestoggle} bscans.")
        elif self.variant == "spinj" and ch == "#":
            self.averagestoggle += 10
            self._say(f"Now averaging {self.averagestoggle} bscans.")
        elif self.variant == "spinj" and ch == "4":
            if self.averagestoggle > 1:
                self.averagestoggle -= 1
            self._say(f"Now averaging {self.averagestoggle} bscans.")
        elif self.variant == "spinj" and ch == "$":
            self.averagestoggle = (self.averagestoggle - 10
                                   if self.averagestoggle > 10 else 1)
            self._say(f"Now averaging {self.averagestoggle} bscans.")
        else:
            for plugin in self.plugins:
                if plugin.key(self, ch):
                    return

    # ------------------------------------------------------------------
    # live config editing (the editiniadv GUI analog over the dashboard:
    # GET/POST /config on viewer_server; reference build/editiniadv.m:47-80
    # edits ini line numbers and requires an app restart — here the
    # live-safe knobs apply at the next loop boundary)
    # ------------------------------------------------------------------

    #: knobs applying live, with parse functions
    _LIVE_CONFIG = {
        "bscanthreshold": float, "averages": int, "exposure_us": int,
        "gain": int, "clampupper": lambda v: bool(int(v)),
        "clampupperdb": float, "manualaverages": int,
    }

    def config_snapshot(self) -> dict:
        """Current knobs for GET /config: ``live`` fields apply through
        :meth:`apply_config`; ``static`` config needs a session restart."""
        import dataclasses as _dc
        live = {"bscanthreshold": self.bscanthreshold,
                "averages": self.averagestoggle,
                "exposure_us": self.exposure_us, "gain": self.gain,
                "clampupper": int(self.clampupper),
                "clampupperdb": self.cfg.clampupperdb,
                "manualaverages": self.cfg.manualaverages}
        static = {k: v for k, v in _dc.asdict(self.cfg).items()
                  if k not in live}
        return {"live": {k: (None if v in (np.inf, -np.inf) else v)
                         for k, v in live.items()},
                "static": static}

    def apply_config(self, updates: dict) -> list[str]:
        """Apply a POST /config update dict; returns one message per field
        (applied value, or why it was rejected / needs a restart)."""
        msgs = []
        for name, raw in updates.items():
            if name not in self._LIVE_CONFIG:
                msgs.append(f"{name}: restart required (not a live knob)")
                continue
            try:
                value = self._LIVE_CONFIG[name](raw)
            except (TypeError, ValueError):
                msgs.append(f"{name}: bad value {raw!r}")
                continue
            if name == "bscanthreshold":
                self.bscanthreshold = value
            elif name == "averages":
                if value < 1:
                    msgs.append("averages: must be >= 1")
                    continue
                # takes effect like the 'a' toggle: new group size, current
                # accumulation restarts (BscanFFT.cpp averagestoggle flow)
                self.averages = self.averagestoggle = value
                self.accum = jnp.zeros_like(self.accum)
                self.indextemp = 0
            elif name == "exposure_us":
                self.exposure_us = max(value, 0)
                if self.camera is not None:
                    self.camera("exposure", self.exposure_us)
            elif name == "gain":
                self.gain = max(value, 0)
                if self.camera is not None:
                    self.camera("gain", self.gain)
            elif name == "clampupper":
                self.clampupper = value
            elif name == "clampupperdb":
                self.cfg = self.cfg.replace(clampupperdb=value)
            elif name == "manualaverages":
                if value < 1:
                    msgs.append("manualaverages: must be >= 1")
                    continue
                self.cfg = self.cfg.replace(manualaverages=value)
            msgs.append(f"{name} = {value}")
            self._say(f"config: {name} = {value}")
        return msgs

    def _say(self, text: str) -> None:
        with self._status_lock:       # offline hand-off threads report too
            self.status.append(text)
            if len(self.status) > 100:
                del self.status[:50]

    def set_roi(self, x: int, y: int, w: int, h: int) -> None:
        """Apply a drag-selected rectangle (B-scan pixel coordinates:
        x = lateral A-scan position, y = depth row).

        The reference selects its vibrometry ROI with the mouse
        (BscanFFTpeak.cpp:112-181 onMouse); for the peak variant this
        routes to VibrometryPlugin.set_roi, otherwise it positions the
        ROI-analytics window (ascanat/vertposROI/widthROI — the quantities
        the (/9/0/)/w/W/h/H keys step, BscanFFT.cpp:1584+)."""
        # clamp to the B-scan image (depth = ndisp rows, lateral = oph
        # cols) — drags can arrive from any dashboard window, and an
        # out-of-range ROI would crash the vibrometry hold later
        ndisp, oph = self.calib.ndisp, self.cfg.oph
        x = max(0, min(int(x), oph - 1))
        y = max(0, min(int(y), ndisp - 1))
        w = max(1, min(int(w), oph - x))
        h = max(1, min(int(h), ndisp - y))
        for plugin in self.plugins:
            if hasattr(plugin, "set_roi"):
                plugin.set_roi(x, y, w, h)
                self._say(f"ROI = ({x}, {y}) {w}x{h}")
                return
        self.ascanat = min(x, self.cfg.oph - 2)
        self.widthROI = max(2, min(w, self.cfg.oph - 1 - self.ascanat))
        self.vertposROI = min(y, self.calib.ndisp - 1)
        self._say(f"ROI at ascan {self.ascanat}, depth {self.vertposROI}, "
                  f"width {self.widthROI}")

    # ------------------------------------------------------------------
    # spinj triggered batch capture + offline hand-off
    # ------------------------------------------------------------------

    def _start_trig(self, mode: str) -> None:
        """Begin a triggered batch capture: the next ``manualaverages`` raw
        frames are written as 16-bit Trig/KTrig PNGs ('Alt' alternates
        signal/J0 per frame — the '|' hardware-trigger mode,
        BscanFFTspinj.cpp:349-450)."""
        if self.sink is None:
            self._say("no sink; trig capture ignored")
            return
        n = max(self.cfg.manualaverages, 1)
        self._trig = {"mode": mode, "count": 0, "n": n,
                      "set": getattr(self, "_trig_set", 0)}
        # with a trigger-capable camera attached (daemon in --trigger mode),
        # fire one software pulse per frame so the capture drives the real
        # acquisition seam — ConfigureTrigger/GrabNextImageByTrigger on
        # Spinnaker (BscanFFTspinj.cpp:1695-1720) — instead of sampling
        # free-running frames.  A free-running daemon ignores the counter.
        trig_fn = getattr(self.source, "trigger", None)
        if callable(trig_fn):
            trig_fn(n * (2 if mode == "Alt" else 1))

    def _spawn_offline_tool(self) -> None:
        """Hand the capture directory to the offline reconstruction with
        argv {dirname, manualaverages} (BscanFFTspinj.cpp:2389-2412).

        A configured external tool (``offline_tool_path``) is fork/execv'd
        with that argv.  Otherwise this framework's own offline
        reconstruction (``fdoct offline``) runs on a worker thread of THIS
        process: a second JAX process would try to reserve the
        accelerator's memory again while the live session holds it."""
        dirname = str(self.sink.dir) if self.sink is not None else "."
        if self.cfg.offline_tool_path:
            import subprocess
            self._offline_proc = subprocess.Popen(
                [self.cfg.offline_tool_path, dirname,
                 str(self.cfg.manualaverages)])
            self._say(f"spawned offline tool for {dirname}")
            return

        def run():
            from fdoct_tpu.cli import offline_reconstruct
            # the same defaults the `fdoct offline DIR N` argv protocol gets
            try:
                n = offline_reconstruct(dirname, self.cfg.manualaverages,
                                        PipelineConfig())
            except Exception as e:  # worker boundary: the live loop goes on
                import traceback
                traceback.print_exc()
                self._say(f"offline reconstruction of {dirname} failed: "
                          f"{type(e).__name__}: {e}")
                return
            self._say(f"offline reconstruction of {dirname}: {n} sets")

        t = threading.Thread(target=run, name="fdoct-offline", daemon=True)
        self._offline_threads.append(t)
        t.start()
        self._say(f"offline reconstruction started for {dirname}")

    def _handle_trig(self, raw: np.ndarray) -> None:
        trig = getattr(self, "_trig", None)
        if not trig or self.sink is None:
            return
        frame = np.asarray(raw)
        if frame.dtype == np.uint8:
            frame = frame.astype(np.uint16) << 8   # Mono16 convert
        i = trig["count"]
        if trig["mode"] == "Alt":
            prefix = "Trig" if i % 2 == 0 else "KTrig"
            name = f"{prefix}{trig['set']:03d}-{i // 2:03d}"
        else:
            name = f"{trig['mode']}{trig['set']:03d}-{i:03d}"
        from fdoct_tpu.utils.imageio import write_png
        write_png(self.sink.dir / f"{name}.png", frame)
        trig["count"] += 1
        total = trig["n"] * (2 if trig["mode"] == "Alt" else 1)
        if trig["count"] >= total:
            self._trig_set = trig["set"] + 1
            self._say(f"{trig['mode']} capture {trig['set']:03d} done.")
            self._trig = None

    # ------------------------------------------------------------------
    # per-frame processing (one reference hot-loop iteration)
    # ------------------------------------------------------------------

    def _tick_fps(self, raw, n: int = 1) -> None:
        """fps + frame max-intensity Status rows, updated once per 5 s
        window (BscanFFT.cpp:1100-1119)."""
        reading = self.fpsmeter.tick(n)
        if reading is not None:
            self.fps = reading
            self.max_intensity = int(np.asarray(raw).max())
            self._say(f"fps = {reading:.0f}  Max Intensity = "
                      f"{self.max_intensity}")

    def _use_int8_direct(self, raw) -> bool:
        """Whether this frame can ride the int8-direct display path
        (cfg.matmul_precision="int8_direct"; fdoct_tpu.int8direct): the
        frame→magnitudes map must be affine in exact 8-bit counts."""
        if self.cfg.matmul_precision != "int8_direct" or self.method != "fused":
            return False
        if self.variant == "peak":
            # metrology gate (the Doppler policy, pipeline.ascan_complex
            # docstring): the vibrometry plugin inverts SUB-dB peak-hold
            # differences through the Bessel-null curve
            # (plugins/vibrometry.py; BscanFFTpeak.cpp:466-738), and
            # int8-direct's 0.03-0.3 dB display quantization would feed
            # straight into the displacement estimate.  int8direct.py:
            # "display mode only — metrology uses stay on 'highest'".
            if "int8_direct" not in self._said_once:
                self._said_once.add("int8_direct")
                self._say("int8_direct is a display mode; the peak/"
                          "vibrometry variant is metrology — staying on "
                          "the f32 chain (use --precision highest for "
                          "best displacement accuracy)")
            return False
        if getattr(raw, "dtype", None) != np.uint8 or raw.ndim != 2:
            return False
        if self.jlockin:
            return False  # subtraction path reuses the f32 chain untouched
        from fdoct_tpu.int8direct import int8_direct_supported
        if not int8_direct_supported(self.cfg)[0]:
            return False
        # the high-residual policy may refuse a plan (noise-dominated
        # background: no fold is display-grade) — f32 chain then
        return self._int8_plan() is not None

    #: rank-1 fold residual above which the display error is no longer
    #: display-grade: a STRUCTURED background at resid 0.023 produced 5-6 dB
    #: of worst-case display error — far beyond the 0.03-0.4 dB
    #: clean-capture band — so above this the session falls back to the
    #: exact f32 chain instead of warning and serving a degraded display.
    INT8_RESID_ACT = 0.02

    def _int8_plan(self):
        """Int8DirectPlan for the current calibration frames, rebuilt only
        when a capture rebinds data_yb / data_yp / data_yd.  The key holds
        STRONG references to the keyed arrays and compares ``is`` — a bare
        id() key would go stale when CPython reuses a freed array's address
        (a recaptured background could then silently keep the old plan).

        High-residual policy: above INT8_RESID_ACT the rank-1 fold is no
        longer display-grade (5-6 dB worst-case on structured
        backgrounds), so the session returns None and the frame path falls
        back to the f32 chain, which divides by the exact capture
        (BscanFFT.cpp:1123-1132).  The rank-2 escalation
        (``Int8DirectPlan.create(rank=2)``) restores display-grade
        accuracy at twice the s8 matmul work, so the session does not
        use it.
        """
        key = (self.data_yb, self.data_yp, self.data_yd)
        if (self._i8key is None
                or any(a is not b for a, b in zip(key, self._i8key))):
            from fdoct_tpu.int8direct import Int8DirectPlan
            dark = (np.asarray(self.data_yd)
                    if self.variant == "dark" else None)
            bg = np.asarray(self.data_yb)
            pi = np.asarray(self.data_yp)
            plan = Int8DirectPlan.create(self.calib, self.cfg, bg, pi, dark)
            resid = float(plan.bg_rank1_resid)
            if resid > self.INT8_RESID_ACT:
                plan = None
                self._say(f"int8_direct: background rank-1 residual "
                          f"{resid:.3f} is above {self.INT8_RESID_ACT} — "
                          f"not display-grade; falling back to the exact "
                          f"f32 chain (average more background frames)")
            self._i8plan = plan
            self._i8key = key
        return self._i8plan

    def process(self, raw: np.ndarray) -> BscanResult | None:
        cfg = self.cfg
        self._tick_fps(raw)
        raw = jnp.asarray(raw)
        if raw.ndim == 3:
            # webcam variant: color frame → channel select / sum
            # (BscanFFTwebcam.cpp:1015-1039)
            from fdoct_tpu.ops.filters import channel_select
            raw = channel_select(raw, cfg.channelnum)
        use_i8 = self._use_int8_direct(raw)
        # the int8-direct design point is ZERO elementwise work on the big
        # input (int8direct.py docstring); the preprocessed frame is only
        # needed by the f32 chain, pending key captures, and interferogram
        # saves — skip the per-frame (H,W) widen/cast dispatch otherwise
        y = (preprocess(raw, cfg)
             if (not use_i8 or self._pending or cfg.saveinterferograms)
             else None)

        # active ring fills during the current group; the inactive ring still
        # holds the previous group for after-the-fact saves (BscanFFT.cpp:961-984)
        ring = self._rings[0 if self.zeroisactive else 1]
        if cfg.saveinterferograms:
            ring["raw"].append(np.asarray(raw))
            ring["binned"].append(np.asarray(y))

        self._handle_trig(raw)
        self._handle_captures(raw, y)

        # apodize + A-scan magnitudes
        if use_i8:
            from fdoct_tpu.int8direct import (reconstruct_int8_direct,
                                              shift_u8_to_s8)
            mags = reconstruct_int8_direct(
                shift_u8_to_s8(jnp.asarray(raw)), self._int8_plan())
        else:
            yw = y - self.data_yd if self.variant == "dark" else y  # BscanDark.cpp:1269
            yr = apodize_ratio(yw, self.data_yb, self.data_yp, cfg)
            mags = ascan_mags(yr, self.calib, self.method,
                              cfg.matmul_precision)

        # accumulate (BscanFFT.cpp:1193-1209)
        if self.variant == "sim" and cfg.simcopyto:
            # strict simulator emulation (BscanFFTsim.cpp:935-947): copyTo
            # replaces the accumulator, and the if/else means the frame that
            # completes the group is dropped, so a group spans averages+1
            # frames of which only the last copied one is displayed
            if self.indextemp < self.averagestoggle:
                self.accum = mags
                if cfg.saveframes:
                    ring["bscan"].append(np.asarray(mags))
                self.indextemp += 1
                return None
            return self._finish_group()
        self.accum = self.accum + mags
        if cfg.saveframes:
            ring["bscan"].append(np.asarray(mags))
        self.indextemp += 1
        if self.indextemp < self.averagestoggle:
            return None
        return self._finish_group()

    # ------------------------------------------------------------------
    # batched fast path: the full-featured session
    # rides the same fused one-dispatch-per-batch pipeline as bench.py
    # ------------------------------------------------------------------

    def _say_once(self, key: str, text: str) -> None:
        """One-shot status message (the `_use_int8_direct` gate pattern):
        fast-path fallbacks must be diagnosable, not silent perf cliffs
        (ADVICE.md)."""
        if key not in self._said_once:
            self._said_once.add(key)
            self._say(text)

    def _per_frame_fallback(self, frames, why: str) -> list[BscanResult]:
        """The slow path, with its one-shot diagnosis.  Runs BEFORE any
        batched fps tick — process() ticks per frame itself."""
        self._say_once(
            f"slow:{why}",
            f"fast path disengaged ({why}) — per-frame dispatches"
            + ("; mesh unused" if self.mesh is not None else ""))
        return [r for f in frames if (r := self.process(f)) is not None]

    def _fast_path_blocker(self, n: int, avg: int) -> str | None:
        """Why this batch cannot ride the one-dispatch fast path, or None.

        saveframes / saveinterferograms / J-lockin ride the fast path
        too: their device math is batched and the
        ring-buffer / subtraction bookkeeping happens host-side per group.
        """
        cfg = self.cfg
        if self.indextemp != 0:
            return "mid-group entry"
        if self._pending:
            return "pending key capture"
        if getattr(self, "_trig", None) is not None:
            return "triggered batch capture in progress"
        if self.variant == "sim" and cfg.simcopyto:
            return "strict-sim copyTo accumulator"
        if cfg.manualaveraging:
            return "manual averaging"
        if cfg.bscanbinx > 1 or cfg.bscanbiny > 1:
            return "output B-scan rebinning"
        if avg < 1 or n % avg != 0:
            return f"batch of {n} not divisible by averages {avg}"
        return None

    def process_group(self, frames: np.ndarray) -> list[BscanResult]:
        """Process a batch of raw frames — ``len(frames)`` reference
        hot-loop iterations — in ONE device dispatch when the session is in
        its steady state, falling back to per-frame :meth:`process`
        whenever stateful semantics demand it (pending captures, triggered
        batch capture, manual averaging, strict-sim copyTo, mid-group
        entry).  saveframes / saveinterferograms ring fills and the
        J-lockin subtraction stay ON the fast path (their device math
        batches; BscanFFT.cpp:961-984, 1225-1232).

        Returns the completed B-scan results (one per ``averagestoggle``
        frames on the fast path).  Equivalent to calling :meth:`process`
        frame by frame; tests/test_session_group.py pins the parity.
        """
        cfg = self.cfg
        n = len(frames)
        avg = self.averagestoggle
        why = self._fast_path_blocker(n, avg)
        if why is not None:
            return self._per_frame_fallback(frames, why)

        # stay on HOST memory until the placement is decided: the mesh path
        # device_puts each group's slice with its sharding directly (one
        # host→device transfer), instead of committing the whole batch to
        # device 0 and resharding device→device.  Already-device-resident
        # input stays on device (np.asarray would force a D2H round-trip);
        # the mesh path reshards it D2D
        farr = frames if isinstance(frames, jax.Array) else np.asarray(frames)
        if (farr.ndim == 4 and farr.shape[-1] == 3
                and farr.dtype == np.uint8 and cfg.channelnum < 3
                and cfg.matmul_precision == "int8_direct"):
            # webcam single-channel select (BscanFFTwebcam.cpp:1015-1039) is
            # a pure plane slice — the selected plane stays EXACT u8 camera
            # counts, so color sources ride int8-direct too.  Channel sum
            # (channelnum=3) rescales to float and stays on the f32 chain.
            farr = farr[..., 2 - cfg.channelnum]
        if cfg.saveinterferograms and farr.ndim == 4:
            # the raw ring stores the post-channel-select frame (process());
            # reproducing that host-side for color sources isn't worth the
            # extra path — per-frame dispatches handle this corner
            return self._per_frame_fallback(frames,
                                            "color frames + saveinterferograms")
        self._tick_fps(frames[-1], n=n)
        groups = n // avg
        if self.mesh is not None and self._mesh_ok(farr, avg):
            return self._process_group_mesh(farr, groups, avg)
        farr = jnp.asarray(farr)
        thresh = jnp.asarray(self.bscanthreshold, self.data_yb.dtype)
        # the live app's log guard; strict-sim (1e-6) is excluded above
        if self._use_int8_direct(farr[0]):
            outs, fr_mags = _session_group_pipeline_int8(
                farr, self._int8_plan(), thresh, cfg, groups, avg, eps=1e-5,
                keep_frames=cfg.saveframes)
            binned = (_preprocess_batch(farr, cfg)
                      if cfg.saveinterferograms else None)
        else:
            outs, fr_mags, binned = _session_group_pipeline(
                farr, self.data_yb, self.data_yp, self.data_yd, thresh,
                self.calib, cfg, groups, avg, self.method,
                self.variant == "dark", eps=1e-5,
                keep_frames=cfg.saveframes,
                keep_binned=cfg.saveinterferograms)
        return self._emit_group_results(outs.bscan, outs.bscandb,
                                        np.asarray(outs.bscandisp),
                                        groups, avg, farr, fr_mags, binned)

    def _emit_group_results(self, bscan_stack, db_stack, disp_np,
                            groups: int, avg: int, farr,
                            fr_mags, binned) -> list[BscanResult]:
        """Per-group host bookkeeping shared by the batched and mesh fast
        paths: ring-buffer fills (saveframes / saveinterferograms,
        BscanFFT.cpp:961-984), the J-lockin subtraction display + saves
        (1257-1282), plugins, and the ring toggle (1482-1488) — state
        advances exactly as ``groups`` per-frame group completions would.

        Only the uint8 display transfers eagerly; the linear/dB stacks
        stay device-resident unless a plugin or caller touches them.
        """
        cfg = self.cfg
        sub_db_np = sub_disp_np = None
        if self.jlockin and self.jscansave is not None and self.variant != "sim":
            sub_db, sub_disp = _jlockin_batch(
                bscan_stack, jnp.asarray(self.jscansave),
                jnp.asarray(self.bscanthreshold, self.data_yb.dtype), cfg)
            sub_db_np, sub_disp_np = np.asarray(sub_db), np.asarray(sub_disp)
        mags_np = np.asarray(fr_mags) if fr_mags is not None else None
        binned_np = np.asarray(binned) if binned is not None else None
        raw_np = np.asarray(farr) if binned is not None else None
        results = []
        for g in range(groups):
            ring = self._rings[0 if self.zeroisactive else 1]
            sl = slice(g * avg, (g + 1) * avg)
            if binned_np is not None:
                ring["raw"].clear()
                ring["raw"].extend(raw_np[sl])
                ring["binned"].clear()
                ring["binned"].extend(binned_np[sl])
            if mags_np is not None:
                ring["bscan"].clear()
                ring["bscan"].extend(mags_np[sl])
            result = BscanResult(bscan=bscan_stack[g], bscandb=db_stack[g],
                                 bscandisp=disp_np[g], index=self.indexi)
            if sub_disp_np is not None:
                result.sub_disp = sub_disp_np[g]
                if self.sink is not None:
                    self.manualindexi += 1
                    mi = self.manualindexi
                    self.sink.save_data(f"bscansub{mi:03d}", sub_db_np[g])
                    self.sink.save_image(f"bscansub{mi:03d}", result.sub_disp)
                    self.sink.save_colormapped(f"bscansubc{mi:03d}",
                                               result.sub_disp)
            for plugin in self.plugins:
                plugin.on_bscan(self, result)
            # ring-buffer toggle per completed group (BscanFFT.cpp:1487);
            # the NEW active ring clears exactly as _finish_group does
            self.zeroisactive = not self.zeroisactive
            new_ring = self._rings[0 if self.zeroisactive else 1]
            new_ring["bscan"].clear()
            new_ring["raw"].clear()
            new_ring["binned"].clear()
            results.append(result)
        return results

    # ------------------------------------------------------------------
    # mesh fast path: the live data path on the device mesh (the last seat
    # of SURVEY §2.5/§5 — streaming ingest feeding sharded compute)
    # ------------------------------------------------------------------

    def _mesh_ok(self, farr, avg: int) -> bool:
        """Whether this batch can ride the sharded session steps: frames
        over 'data', rows over 'ascan' — the group and row counts must
        divide the mesh axes, the median halo must fit one neighbor hop,
        and color frames take the single-device path (channel handling is
        host-side there).  A mesh-configured session that falls back says
        why, once (ADVICE.md)."""
        cfg = self.cfg
        n_data = self.mesh.shape.get("data", 1)
        n_ascan = self.mesh.shape.get("ascan", 1)
        why = None
        if farr.ndim != 3:
            why = "color frames need host-side channel handling"
        elif avg % n_data != 0:
            why = f"averages {avg} not divisible by mesh 'data' axis {n_data}"
        elif cfg.oph % n_ascan != 0:
            why = f"oph {cfg.oph} not divisible by mesh 'ascan' axis {n_ascan}"
        elif cfg.mediann > 1 and (farr.shape[-2] // n_ascan
                                  < cfg.mediann // 2):
            why = (f"median halo needs >= {cfg.mediann // 2} raw rows per "
                   f"'ascan' shard, have {farr.shape[-2] // n_ascan}")
        if why is not None:
            self._say_once(f"mesh:{why}",
                           f"mesh unused — single-device fast path ({why})")
            return False
        return True

    def _process_group_mesh(self, farr, groups: int, avg: int) -> list:
        """One sharded device dispatch per averaging group: frames are
        device_put with P('data','ascan',None) (the mesh counterpart of
        the reference's GetQHYCCDLiveFrame ingest, BscanFFT.cpp:948) and
        reconstructed by the cached sharded session step.  Numerically
        identical to the single-device fast path
        (tests/test_streaming.py::TestMeshStreaming pins it); the
        saveframes / saveinterferograms / J-lockin bookkeeping rides along
        via _emit_group_results."""
        from jax.sharding import NamedSharding, PartitionSpec as P
        from fdoct_tpu.parallel.sharded import (
            build_session_bscan_step, build_session_bscan_step_int8)

        cfg = self.cfg
        sh = NamedSharding(self.mesh, P("data", "ascan", None))
        thresh = jnp.asarray(self.bscanthreshold, self.data_yb.dtype)
        use_i8 = self._use_int8_direct(farr[0])
        if use_i8:
            step = build_session_bscan_step_int8(
                self.mesh, self._int8_plan(), cfg, avg,
                keep_frames=cfg.saveframes)
        else:
            step = build_session_bscan_step(
                self.mesh, self.calib, cfg, self.method, avg,
                dark=self.variant == "dark", keep_frames=cfg.saveframes,
                keep_binned=cfg.saveinterferograms)
        results = []
        for g in range(groups):
            fr = jax.device_put(farr[g * avg:(g + 1) * avg], sh)
            binned = None
            if use_i8:
                bscan, db, disp, *extra = step(fr, thresh)
                fr_mags = extra[0] if cfg.saveframes else None
                if cfg.saveinterferograms:
                    binned = _preprocess_batch(fr, cfg)
            else:
                bscan, db, disp, *extra = step(fr, self.data_yb, self.data_yp,
                                               self.data_yd, thresh)
                fr_mags = extra[0] if cfg.saveframes else None
                if cfg.saveinterferograms:
                    binned = extra[-1]
            results.extend(self._emit_group_results(
                bscan[None], db[None], np.asarray(disp)[None], 1, avg,
                farr[g * avg:(g + 1) * avg], fr_mags, binned))
        return results

    # ------------------------------------------------------------------
    def _capture_background(self, y: jnp.ndarray) -> None:
        """'b' background accumulation (BscanFFT.cpp:1000-1075).

        With saveinterferograms on, the reference instead averages the
        formerly-active ring buffer's binned frames and saves the raw ones
        as rawframeb PNGs (BscanFFT.cpp:1003-1037)."""
        cfg = self.cfg
        if cfg.saveinterferograms:
            inactive = self._rings[1 if self.zeroisactive else 0]
            if len(inactive["binned"]) >= self.averagestoggle:
                if self.sink is not None:
                    for ii, raw in enumerate(inactive["raw"][: self.averagestoggle]):
                        self.sink.save_image(
                            f"rawframeb{self.indexi:03d}-{ii:03d}", raw)
                acc = jnp.sum(jnp.stack(
                    [jnp.asarray(b, y.dtype)
                     for b in inactive["binned"][: self.averagestoggle]]), axis=0)
                yb = acc
                if cfg.rowwisenormalize:
                    yb = normalize_rows(yb, 0.0001, 1.0)
                if not cfg.donotnormalize:
                    yb = normalize_minmax(yb, 0.0001, 1.0)
                else:
                    yb = yb / self.averagestoggle
                self.data_yb = yb
                self._pending.discard("b")
                self._say("S(k) saved.")
                if cfg.manualaveraging:
                    self.averagestoggle = 1
            return
        if self.baccumcount < self.averagestoggle:
            self.baccum = self.baccum + y
            self.baccumcount += 1
        if self.baccumcount >= self.averagestoggle:
            yb = self.baccum
            if cfg.rowwisenormalize:
                yb = normalize_rows(yb, 0.0001, 1.0)
            if not cfg.donotnormalize:
                yb = normalize_minmax(yb, 0.0001, 1.0)
            else:
                yb = yb / self.averagestoggle
            self.data_yb = yb
            self._pending.discard("b")
            self.baccumcount = 0
            self.baccum = jnp.zeros_like(self.baccum)
            self._say("S(k) saved.")
            if self.variant == "spinj" and self.sink is not None:
                # raw dump for the offline tool (BscanFFTspinjnt.cpp:1684)
                self.sink.save_bin("spectrum", np.asarray(self.data_yb))
            if cfg.manualaveraging:
                self.averagestoggle = 1              # BscanFFT.cpp:1070-1073

    def _handle_captures(self, raw, y) -> None:
        cfg = self.cfg
        if "b" in self._pending:
            if self.variant == "sim" and self.source is not None:
                # sim reads the dedicated background image (BscanFFTsim.cpp:806)
                bg = preprocess(jnp.asarray(self.source.background()), cfg)
                self.data_yb = bg.astype(self.data_yb.dtype)
                self._pending.discard("b")
                self._say("S(k) saved.")
            else:
                self._capture_background(y)
        if "p" in self._pending:
            if self.variant == "sim" and self.source is not None:
                pi = preprocess(jnp.asarray(self.source.pi_frame()), cfg)
                self.data_yp = pi.astype(self.data_yp.dtype)
            else:
                yp = y
                if cfg.rowwisenormalize:
                    yp = normalize_rows(yp, 0.0, 1.0)
                if not cfg.donotnormalize:
                    yp = normalize_minmax(yp, 0.0, 1.0)
                self.data_yp = yp
            self._pending.discard("p")
        for arm in ("dark", "ref", "sample"):
            if arm in self._pending:
                self._capture_arm(arm, y)

    def _capture_arm(self, arm: str, y: jnp.ndarray) -> None:
        """BscanDark 'o'/'r'/'t' averaged captures + background composition
        (BscanDark.cpp:1005-1221: each arm averaged over averagestoggle
        frames, optional low-pass; then data_yb = (data_yr - data_yd) +
        (data_ys - data_yd), BscanDark.cpp:996)."""
        acc = self._dark_accum.get(arm)
        self._dark_accum[arm] = y if acc is None else acc + y
        self._dark_counts[arm] += 1
        if self._dark_counts[arm] >= self.averagestoggle:
            avg = self._dark_accum[arm] / self.averagestoggle
            if self.cfg.lowpassfilter:
                avg = lowpass_rowwise(avg)
            setattr(self, {"dark": "data_yd", "ref": "data_yr",
                           "sample": "data_ys"}[arm], avg)
            self._pending.discard(arm)
            self._dark_counts[arm] = 0
            del self._dark_accum[arm]
            self._say(f"{arm} arm saved.")
            self.data_yb = (self.data_yr - self.data_yd) + (self.data_ys - self.data_yd)
            # guard against divide-by-zero before any capture
            self.data_yb = jnp.where(self.data_yb == 0, 1.0, self.data_yb)

    # ------------------------------------------------------------------
    def _finish_group(self) -> BscanResult:
        """Group-complete block (BscanFFT.cpp:1211-1488)."""
        cfg = self.cfg
        self.indextemp = 0
        mag_sum = self.accum
        if cfg.bscanbinx > 1 or cfg.bscanbiny > 1:
            # spinjnt output rebinning acts on the linear bscan; the scale
            # factor is derived, not configured (BscanFFTspinjnt.cpp:835:
            # multiplyfactor = bscanbinx*bscanbiny*binvaluex*binvaluey)
            mult = cfg.bscanbinx * cfg.bscanbiny * cfg.binvaluex * cfg.binvaluey
            bscan_lin = mag_sum.T / self.averagestoggle
            bscan_lin = bscan_rebin(bscan_lin, cfg.bscanbinx, cfg.bscanbiny, mult)
            mag_sum = bscan_lin.T * self.averagestoggle
        strict_sim = self.variant == "sim" and cfg.simcopyto
        out = form_bscan(mag_sum, cfg,
                         1 if strict_sim else self.averagestoggle,
                         bscanthreshold=self.bscanthreshold,
                         eps=1e-6 if strict_sim else 1e-5)
        bscan_np = np.asarray(out.bscan)
        result = BscanResult(
            bscan=bscan_np, bscandb=np.asarray(out.bscandb),
            bscandisp=np.asarray(out.bscandisp), index=self.indexi,
        )

        # J-lockin subtraction (BscanFFT.cpp:1225-1232, 1257-1282).
        # The sim variant does J-threshold *masking* instead (JMaskPlugin,
        # BscanFFTsim.cpp:959-975), not the dB subtraction.
        if self.jlockin and self.jscansave is not None and self.variant != "sim":
            # same jitted chain as the batched fast path (stack of one) —
            # one implementation, so the two paths cannot drift
            sub_db, sub_disp = _jlockin_batch(
                jnp.asarray(out.bscan)[None], jnp.asarray(self.jscansave),
                jnp.asarray(self.bscanthreshold, out.bscan.dtype), cfg)
            result.sub_disp = np.asarray(sub_disp[0])
            if self.sink is not None:
                self.manualindexi += 1
                self.sink.save_data(f"bscansub{self.manualindexi:03d}",
                                    np.asarray(sub_db[0]))
                self.sink.save_image(f"bscansub{self.manualindexi:03d}",
                                     result.sub_disp)
                self.sink.save_colormapped(f"bscansubc{self.manualindexi:03d}",
                                           result.sub_disp)

        # 'j' / 'c' handled at group boundary (BscanFFT.cpp:1292-1304)
        if "j" in self._pending:
            self.jscansave = out.bscan
            self.jlockin = True
            self._pending.discard("j")
        if "c" in self._pending:
            self.jlockin = False
            self._pending.discard("c")

        if "s" in self._pending:
            self._save_group(result)
            self._pending.discard("s")

        for plugin in self.plugins:
            plugin.on_bscan(self, result)

        # reset + toggle ring buffers (BscanFFT.cpp:1482-1488)
        self.accum = jnp.zeros_like(self.accum)
        self.zeroisactive = not self.zeroisactive
        new_ring = self._rings[0 if self.zeroisactive else 1]
        new_ring["bscan"].clear()
        new_ring["raw"].clear()
        new_ring["binned"].clear()
        return result

    # ------------------------------------------------------------------
    def _save_group(self, result: BscanResult) -> None:
        """'s' key: save displayed B-scan + per-frame/raw extras
        (BscanFFT.cpp:1307-1397) and manual averaging (1399-1477)."""
        cfg = self.cfg
        if self.sink is None:
            return
        self.indexi += 1
        i = self.indexi
        self.sink.save_data(f"bscan{i:03d}", result.bscandb)
        self.sink.save_image(f"bscan{i:03d}", result.bscandisp)
        self.sink.save_colormapped(f"bscanc{i:03d}", result.bscandisp)
        self._say(f"bscan{i:03d} saved.")
        result.index = i
        if self.variant == "spinj":
            # raw dumps for offline computing (BscanFFTspinjnt.cpp:1957-1971)
            self.sink.save_bin(f"bscandb{i:03d}", result.bscandb)

        if self.jlockin and self.jscansave is not None:
            self.sink.save_data(f"jscan{i:03d}", np.asarray(self.jscansave))
            if self.variant == "spinj":
                self.sink.save_bin(f"jscan{i:03d}", np.asarray(self.jscansave))

        inactive = self._rings[1 if self.zeroisactive else 0]
        if cfg.saveinterferograms:
            for ii, frame in enumerate(inactive["raw"]):
                self.sink.save_image(f"rawframe{i:03d}-{ii:03d}", frame)
        if cfg.saveframes:
            for ii, mags in enumerate(inactive["bscan"]):
                # per-frame bscans: transpose, +eps, dB, normalize, u8
                b = jnp.asarray(mags).T + 1e-6
                db = to_db(b, eps=0.0, compat=cfg.compat)
                u8 = to_uint8(normalize_minmax(db, 0.0, 1.0))
                self.sink.save_image(f"bscan{i:03d}-{ii:03d}", np.asarray(u8))

        if cfg.manualaveraging:
            if self.manualaccumcount < cfg.manualaverages:
                self.manualaccum = self.manualaccum + jnp.asarray(result.bscan)
                self.manualaccumcount += 1
            else:
                self.manualaccumcount = 0
                acc = self.manualaccum / cfg.manualaverages
                db = to_db(acc, eps=0.0, compat=cfg.compat)
                disp = threshold_floor(db, self.bscanthreshold)
                disp = normalize_minmax(disp, 0.0, 1.0)
                u8 = np.asarray(to_uint8(disp))
                result.manual_disp = u8
                self.manualindexi += 1
                mi = self.manualindexi
                self.sink.save_data(f"bscanman{mi:03d}", np.asarray(acc))
                self.sink.save_image(f"bscanman{mi:03d}", u8)
                self.sink.save_colormapped(f"bscanmanc{mi:03d}", u8)
                self.manualaccum = jnp.zeros_like(self.manualaccum)

    def close(self) -> None:
        for t in self._offline_threads:     # finish the 'y' hand-offs
            t.join()
        self._offline_threads.clear()
        if self.sink is not None:
            self.sink.parameter_footer(self.cfg, self.bscanthreshold)
            self.sink.close()


def _flatten_groups(stacked, groups, averages):
    """(groups, averages, ...) scan output → (groups·averages, ...) the
    ring-fill slicing expects, or None through."""
    if stacked is None:
        return None
    return stacked.reshape((groups * averages,) + stacked.shape[2:])


@functools.partial(jax.jit, static_argnames=(
    "cfg", "groups", "averages", "method", "dark", "eps",
    "keep_frames", "keep_binned"))
def _session_group_pipeline(raw, yb, yp, yd, threshold, calib, cfg,
                            groups, averages, method, dark, eps,
                            keep_frames=False, keep_binned=False):
    """One dispatch for ``groups`` whole averaging groups: a ``lax.scan``
    over groups, each iteration one preprocess → [dark subtract] →
    apodize ratio → fused A-scan magnitudes → accumulate → display chain.
    The batched form of the reference hot loop (BscanFFT.cpp:946-1255)
    the interactive Session rides in its steady state.

    Scan-over-groups, NOT one flat matmul over every frame: the flat form
    keeps a groups×-larger f32 working set live between its stages.

    ``keep_frames`` / ``keep_binned`` additionally return the per-frame
    magnitudes / preprocessed frames so the saveframes /
    saveinterferograms ring buffers (BscanFFT.cpp:961-984) fill without
    leaving the fast path.  Returns
    (outputs, mags-or-None, binned-or-None) with the extras flattened to
    (groups·averages, ...)."""
    from fdoct_tpu.pipeline import (apodize_ratio, ascan_mags, form_bscan,
                                    preprocess)

    if raw.ndim == 4:
        # webcam variant: color frames → channel select / sum
        from fdoct_tpu.ops.filters import channel_select
        raw = jax.vmap(lambda f: channel_select(f, cfg.channelnum))(raw)
    g = raw.reshape((groups, averages) + raw.shape[1:])

    def body(carry, fr):
        y = preprocess(fr, cfg)
        if dark:
            y = y - yd                  # BscanDark.cpp:1269
        yr = apodize_ratio(y, yb, yp, cfg)
        mags = ascan_mags(yr, calib, method, cfg.matmul_precision)
        outs = form_bscan(mags.sum(axis=0), cfg, averages,
                          bscanthreshold=threshold, eps=eps)
        return carry, (outs, mags if keep_frames else None,
                       y if keep_binned else None)

    _, (outs, mags, y) = jax.lax.scan(body, 0, g)
    return (outs, _flatten_groups(mags, groups, averages),
            _flatten_groups(y, groups, averages))


@functools.partial(jax.jit, static_argnames=(
    "cfg", "groups", "averages", "eps", "keep_frames"))
def _session_group_pipeline_int8(raw_u8, plan, threshold, cfg,
                                 groups, averages, eps, keep_frames=False):
    """int8-direct batched group pipeline: a ``lax.scan`` over groups of
    two s8 matmuls straight from the raw u8 frames (device-side bias
    shift) plus the display chain (scan-over-groups for the same reason
    as :func:`_session_group_pipeline`).  The background/pi/dark frames
    live folded inside ``plan`` (fdoct_tpu.int8direct.Int8DirectPlan).
    Returns (outputs, per-frame mags or
    None) — the binned frames are not on this path (int8-direct does zero
    elementwise work on the input; callers preprocess separately when
    saveinterferograms needs them)."""
    from fdoct_tpu.int8direct import reconstruct_int8_direct, shift_u8_to_s8
    from fdoct_tpu.pipeline import form_bscan

    g = raw_u8.reshape((groups, averages) + raw_u8.shape[1:])

    def body(carry, fr):
        mags = reconstruct_int8_direct(shift_u8_to_s8(fr), plan)
        outs = form_bscan(mags.sum(axis=0), cfg, averages,
                          bscanthreshold=threshold, eps=eps)
        return carry, (outs, mags if keep_frames else None)

    _, (outs, mags) = jax.lax.scan(body, 0, g)
    return outs, _flatten_groups(mags, groups, averages)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _preprocess_batch(raw, cfg):
    """Standalone batched preprocess (for the int8 fast path's
    saveinterferograms ring fills, where the display math never touches
    the preprocessed frames)."""
    from fdoct_tpu.pipeline import preprocess
    return preprocess(raw, cfg)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jlockin_batch(bscan_stack, jscansave, threshold, cfg):
    """Batched J-lockin subtraction display (BscanFFT.cpp:1257-1282): the
    per-group dB of max(bscan - jscansave, 0) + 1e-3, floored and
    normalized per group — pure device arithmetic, so it rides the
    batched/mesh fast paths."""
    jdiff = bscan_stack - jscansave[None]
    positive = make_only_positive(jdiff) + 0.001
    sub_db = to_db(positive, eps=0.0, compat=cfg.compat)
    disp = threshold_floor(sub_db, threshold)
    disp = normalize_minmax(disp, 0.0, 1.0, axis=(-2, -1))
    return sub_db, to_uint8(disp)
