"""Configuration system.

The reference configures every program through positional ``.ini`` files in
which field *order* is the schema: lines alternate a comment line and a value
line, with three leading comment lines, parsed by sequential stream extraction
(reference: BscanFFT.cpp:417-484, build/BscanFFT.ini:1-59).  Octave GUI
editors mutate specific line numbers (build/editini.m, build/editiniadv.m).

This module provides:

- :class:`PipelineConfig` — one immutable, typed config covering the union of
  every variant's fields (base, webcam, dark, peak, spinj/spinjnt, viewport),
  plus new-framework fields (dtype, compat mode, dispersion coefficients).
- ini-compatible readers/writers for each variant schema, so existing
  reference ``.ini`` files load unchanged.
- JSON round-tripping for the native config path.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Iterable


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Union of all reference variant parameters + framework extensions.

    Field semantics follow the reference ini schema
    (build/BscanFFT.ini, build/BscanDark.ini, build/BscanFFTspinjnt.ini).
    """

    # --- camera / acquisition geometry (reference: BscanFFT.cpp:417-447) ---
    gain: int = 12
    exposure_us: int = 1000
    bpp: int = 8
    width: int = 1280
    height: int = 960
    offsetx: int = 0
    offsety: int = 0
    camspeed: int = 2
    cambinx: int = 1
    cambiny: int = 1
    usbtraffic: int = 0

    # --- software preprocessing (reference: BscanFFT.cpp:446-476) ---
    binvalue: int = 1               # software binning factor (INTER_AREA resize)
    dirdescr: str = "fdoct"         # run-directory description suffix
    averages: int = 1               # frames accumulated per displayed B-scan
    numfftpoints: int = 1024        # k-linear grid length (IFFT size)
    saveframes: bool = False
    manualaveraging: bool = False
    manualaverages: int = 1
    saveinterferograms: bool = False
    movavgn: int = 0                # 2n+1-point weighted moving average; 0 = off
    numdisplaypoints: int = 512     # depth samples kept from each A-scan
    lambdamin: float = 816e-9       # spectrometer λ range (m)
    lambdamax: float = 884e-9
    mediann: int = 0                # 2D median filter aperture (odd); 0 = off
    increasefftpointsmultiplier: int = 1  # spectral zero-pad upsampling factor
    rowwisenormalize: bool = False
    donotnormalize: bool = True

    # --- display / thresholding state defaults (reference: BscanFFT.cpp:385) ---
    bscanthreshold: float = -30.0
    clampupper: bool = False
    clampupperdb: float = 50.0      # 50 dB in BscanFFT, 30 dB in spinjnt variants

    # --- webcam variant (reference: BscanFFTwebcam.cpp:507-508) ---
    channelnum: int = 1             # 0/1/2 = BGR channel; 3 = sum/(255*3)

    # --- dark variant (reference: BscanDark.cpp:484-486) ---
    bandpassfilter: bool = False    # band-pass blanking inside zero-pad
    lowpassfilter: bool = False     # FFT low-pass on captured dark/ref/sample

    # --- peak (vibrometry) variant (reference: BscanFFTpeak.cpp:1105-1106) ---
    peakholdnumframes: int = 50

    # --- spinjnt variant (reference: BscanFFTspinjnt.cpp:791-797, 829) ---
    binvaluex: int = 1
    binvaluey: int = 1
    bscanbinx: int = 1
    bscanbiny: int = 1
    offline_tool_path: str = ""

    # --- viewport variants ---
    vgamma: float = 1.0             # ViewportSaver float gamma
    wb_red: float = 1.0             # ViewportSaverc white balance
    wb_green: float = 1.0
    wb_blue: float = 1.0

    # --- framework extensions (no reference equivalent) ---
    dtype: str = "float32"          # compute dtype on device
    compat: bool = True             # bit-compatible reference semantics
    matmul_precision: str = "default"  # "default" (f32 operands at
    # Precision.DEFAULT: exact on CPU, may run as TF32 on a GPU) |
    # "highest" (f32-exact on every backend) | "bf16" (explicit bf16
    # operands, f32 accumulation) | "int8" (quantized display mode; see
    # pipeline._op_matmul_pair_int8)
    # | "int8_direct" (fastest display mode: background/pi folded into the
    # quantized operator, zero elementwise work on the input — honored by
    # Session and the bench paths that carry an int8direct.Int8DirectPlan;
    # generic reconstruct() calls fall back to bf16)
    window: str = "barthann"        # apodization window kind (ops.windows)
    simcopyto: bool = False         # strict-compat: emulate the simulator's
    # copyTo-instead-of-accumulate averaging slot (BscanFFTsim.cpp:940-941):
    # only the last frame of a group survives, the group-completing frame is
    # dropped (if/else vs the live app's two ifs, BscanFFT.cpp:1193-1211),
    # there is no ÷averages, and the log guard is 1e-6 (BscanFFTsim.cpp:949).
    # Off by default: accumulating like the live app is the intended behavior.
    dispersion_a2: float = 0.0      # dispersion compensation phase: a2*(k-k0)^2
    dispersion_a3: float = 0.0      # + a3*(k-k0)^3  [rad·(rad/m)^-n]

    # ------------------------------------------------------------------
    @property
    def opw(self) -> int:
        """Post-binning frame width (spectral samples per A-scan).

        reference: BscanFFT.cpp:545 (``opw = w / binvalue``).
        """
        return self.width // max(self.binvalue, self.binvaluex, 1)

    @property
    def oph(self) -> int:
        """Post-binning frame height (lateral A-scan count).

        reference: BscanFFT.cpp:546.
        """
        return self.height // max(self.binvalue, self.binvaluey, 1)

    @property
    def lambda0(self) -> float:
        """Centre wavelength (reference: BscanFFT.cpp:547)."""
        return (self.lambdamin + self.lambdamax) / 2

    @property
    def lambdabw(self) -> float:
        return self.lambdamax - self.lambdamin

    def replace(self, **kw: Any) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> "PipelineConfig":
        """Raise ValueError on inconsistent geometry/spectral settings (the
        reference silently misbehaves on these; e.g. non-divisible binning
        truncates, numdisplaypoints > nfft reads past the magnitude rows)."""
        errs = []
        bx = max(self.binvalue, self.binvaluex, 1)
        by = max(self.binvalue, self.binvaluey, 1)
        if self.width < bx or self.height < by:
            errs.append(f"frame {self.width}x{self.height} smaller than "
                        f"binning {bx}x{by} (or empty)")
        if self.width % bx or self.height % by:
            errs.append(f"frame {self.width}x{self.height} not divisible by "
                        f"binning {bx}x{by}")
        if not (0 < self.lambdamin < self.lambdamax):
            errs.append(f"bad λ range [{self.lambdamin}, {self.lambdamax}]")
        if self.numdisplaypoints > self.numfftpoints:
            errs.append(f"numdisplaypoints {self.numdisplaypoints} > "
                        f"numfftpoints {self.numfftpoints}")
        if self.numfftpoints < 2 or self.averages < 1:
            errs.append("numfftpoints must be >= 2 and averages >= 1")
        if self.increasefftpointsmultiplier < 1:
            errs.append("increasefftpointsmultiplier must be >= 1")
        if self.matmul_precision not in (
                "default", "highest", "bf16", "int8", "int8_direct"):
            errs.append(
                f"matmul_precision {self.matmul_precision!r} not one of "
                "default/highest/bf16/int8/int8_direct")
        if errs:
            raise ValueError("; ".join(errs))
        return self

    # ---------------------------- JSON ---------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "PipelineConfig":
        data = json.loads(text)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - known
        if unknown:
            raise ValueError(f"unknown config fields: {sorted(unknown)}")
        return cls(**data).validate()

    # ---------------------------- ini ----------------------------------
    @classmethod
    def from_ini(cls, path: str | Path, variant: str = "base") -> "PipelineConfig":
        return read_ini(path, variant=variant)

    def to_ini(self, path: str | Path, variant: str = "base") -> None:
        write_ini(self, path, variant=variant)


# ---------------------------------------------------------------------------
# ini schemas: ordered (field, type) pairs; order IS the wire format.
# Types: int, float (string field parsed with atof in the reference), str, bool.
# ---------------------------------------------------------------------------

def _bool(tok: str) -> bool:
    return bool(int(tok))


# Schema of the flagship BscanFFT.ini (reference: BscanFFT.cpp:417-484).
_BASE_FIELDS: list[tuple[str, Any]] = [
    ("gain", int),
    ("exposure_us", int),
    ("bpp", int),
    ("width", int),
    ("height", int),
    ("offsetx", int),
    ("offsety", int),
    ("camspeed", int),
    ("cambinx", int),
    ("cambiny", int),
    ("usbtraffic", int),
    ("binvalue", int),
    ("dirdescr", str),
    ("averages", int),
    ("numfftpoints", int),
    ("saveframes", _bool),
    ("manualaveraging", _bool),
    ("manualaverages", int),
    ("saveinterferograms", _bool),
    ("movavgn", int),
    ("numdisplaypoints", int),
    ("lambdamin", float),
    ("lambdamax", float),
    ("mediann", int),
    ("increasefftpointsmultiplier", int),
    ("rowwisenormalize", _bool),
    ("donotnormalize", _bool),
]

# Webcam drops offsets/camera fields it cannot control and adds channelnum
# (reference: BscanFFTwebcam.cpp:507-508).
_WEBCAM_FIELDS = [f for f in _BASE_FIELDS if f[0] not in ("offsetx", "offsety")] + [
    ("channelnum", int),
]

# Dark adds band-pass + low-pass flags (reference: BscanDark.cpp:484-486).
_DARK_FIELDS = [f for f in _BASE_FIELDS if f[0] not in ("offsetx", "offsety")] + [
    ("bandpassfilter", _bool),
    ("lowpassfilter", _bool),
]

# Peak adds peakholdnumframes (reference: BscanFFTpeak.cpp:1105-1106).
_PEAK_FIELDS = _BASE_FIELDS + [("peakholdnumframes", int)]

# spinjnt replaces binvalue IN PLACE with binvaluex/y + output B-scan
# binning, and appends the offline tool path at the end
# (reference: BscanFFTspinjnt.cpp:791-797, 829; build/BscanFFTspinjnt.ini).
_SPINJNT_FIELDS = []
for _f in _BASE_FIELDS:
    if _f[0] == "binvalue":
        _SPINJNT_FIELDS += [("binvaluex", int), ("binvaluey", int),
                            ("bscanbinx", int), ("bscanbiny", int)]
    else:
        _SPINJNT_FIELDS.append(_f)
_SPINJNT_FIELDS.append(("offline_tool_path", str))

# ViewportSaver adds a float gamma; ViewportSaverc adds white balance.
_VIEWPORT_FIELDS = _BASE_FIELDS + [("vgamma", float)]
_VIEWPORTC_FIELDS = _VIEWPORT_FIELDS + [
    ("wb_red", float),
    ("wb_green", float),
    ("wb_blue", float),
]

SCHEMAS: dict[str, list[tuple[str, Any]]] = {
    "base": _BASE_FIELDS,
    "webcam": _WEBCAM_FIELDS,
    "dark": _DARK_FIELDS,
    "peak": _PEAK_FIELDS,
    # BscanFFTspinj.ini shares the base field ordering exactly
    # (BscanFFTspinj.cpp:831-920); only the session behavior differs
    "spinj": _BASE_FIELDS,
    "spinjnt": _SPINJNT_FIELDS,
    "viewport": _VIEWPORT_FIELDS,
    "viewportc": _VIEWPORTC_FIELDS,
}


def _tokens(text: str) -> Iterable[str]:
    """Whitespace-delimited token stream, mirroring ``infile >> tok``."""
    return iter(text.split())


def read_ini(path: str | Path, variant: str = "base",
             validate: bool = True) -> PipelineConfig:
    """Parse a reference-format positional ini file.

    Format: three leading comment tokens, then alternating value / comment
    tokens (reference: BscanFFT.cpp:420-477 — ``infile >> tempstring`` x3,
    then ``infile >> value; infile >> tempstring;`` repeated).

    ``validate=False`` skips the consistency check — used by ``fdoct
    configedit`` so a broken ini can still be loaded and repaired.
    """
    schema = SCHEMAS[variant]
    toks = _tokens(Path(path).read_text())
    values: dict[str, Any] = {}
    try:
        for _ in range(3):
            next(toks)  # leading comment lines
        for i, (name, typ) in enumerate(schema):
            tok = next(toks)
            values[name] = typ(tok)
            if i != len(schema) - 1:
                next(toks)  # inter-field comment line
    except StopIteration as e:
        raise ValueError(
            f"ini file {path} too short for variant '{variant}' "
            f"(got {len(values)}/{len(schema)} fields)"
        ) from e
    # validate at the boundary so a geometry-inconsistent ini fails here
    # with a clear message instead of a late device-side shape error
    cfg = PipelineConfig(**values)
    return cfg.validate() if validate else cfg


def write_ini(cfg: PipelineConfig, path: str | Path, variant: str = "base") -> None:
    """Write a reference-compatible positional ini file."""
    schema = SCHEMAS[variant]
    lines = [f"#ini_file_for_fdoct_{variant}",
             "#Enter_each_parameter_in_the_line_below_the_comment.",
             f"#{schema[0][0]}"]
    for i, (name, typ) in enumerate(schema):
        val = getattr(cfg, name)
        if typ is _bool:
            lines.append(str(int(val)))
        elif typ is float:
            lines.append(repr(float(val)))
        elif typ is str:
            # the whitespace-token wire format cannot carry empty strings;
            # the reference uses "_" as its empty dirdescr (BscanFFT.cpp:398)
            lines.append(str(val) if str(val) else "_")
        else:
            lines.append(str(val))
        if i != len(schema) - 1:
            lines.append(f"#{schema[i + 1][0]}")
    Path(path).write_text("\n".join(lines) + "\n")
