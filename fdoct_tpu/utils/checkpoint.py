"""Checkpoint / resume of session calibration state.

The reference's "checkpoint" is its ini file plus re-capturable calibration
frames (background S(k), π/J0, dark/ref/sample), optionally dumped as raw
.ocv binaries for the offline tool (SURVEY.md §5).  Here the same state —
config + every captured calibration tensor + runtime knobs — round-trips
through one .npz archive, so a session can resume exactly where it stopped.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import jax.numpy as jnp

_TENSORS = ("data_yb", "data_yp", "data_yd", "data_yr", "data_ys")
#: cross-group state that may legitimately be absent (a session that never
#: armed J-lockin has no jscansave); written only when present, restored
#: only when stored — old checkpoints load unchanged
_OPT_TENSORS = ("jscansave", "manualaccum")
_SCALARS = ("averagestoggle", "bscanthreshold", "exposure_us",
            "gain", "ascanat", "vertposROI", "widthROI", "indexi",
            "manualindexi")
#: scalars added in round 5 — absent from older archives, restored only
#: when stored.  Core _SCALARS stay REQUIRED: a missing scalar_indexi in
#: a damaged archive must fail loudly, not silently resume with defaults
#: and overwrite the previous run's saves.
_OPT_SCALARS = ("averages", "jlockin", "manualaccumcount")


def _payload(session) -> dict:
    payload = {f"tensor_{k}": np.asarray(getattr(session, k)) for k in _TENSORS}
    for k in _OPT_TENSORS:
        v = getattr(session, k, None)
        if v is not None:
            payload[f"tensor_{k}"] = np.asarray(v)
    payload.update({f"scalar_{k}": np.asarray(getattr(session, k))
                    for k in _SCALARS + _OPT_SCALARS})
    payload["config_json"] = np.frombuffer(
        session.cfg.to_json().encode(), dtype=np.uint8)
    return payload


def npz_path(path: str | Path) -> Path:
    """The file np.savez actually writes for ``path`` (numpy appends .npz
    when the suffix is missing) — one place owns that rule so callers
    (e.g. the CLI's atomic periodic checkpoint) never re-encode it."""
    path = Path(path)
    return path if path.suffix == ".npz" else path.with_name(path.name
                                                             + ".npz")


def save_session(session, path: str | Path, backend: str = "npz") -> Path:
    """Write config + calibration tensors + runtime knobs to ``path``.

    backend='npz' (single compressed archive) or 'orbax' (directory
    checkpoint via orbax-checkpoint — JAX's checkpointing stack, useful
    when the session state should participate in a larger
    orbax-managed checkpoint layout).

    Returns the path actually WRITTEN (np.savez appends .npz when the
    suffix is missing — returning the input path made callers print and
    later --resume a file that does not exist).
    """
    path = Path(path)
    payload = _payload(session)
    if backend == "npz":
        path = npz_path(path)
        np.savez_compressed(path, **payload)
    elif backend == "orbax":
        import orbax.checkpoint as ocp

        ckptr = ocp.StandardCheckpointer()
        ckptr.save(path.resolve(), {k: v for k, v in payload.items()})
        ckptr.wait_until_finished()
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return path


def load_session(path: str | Path, session=None, backend: str = "npz",
                 **session_kwargs):
    """Rebuild (or update) a Session from a checkpoint.

    With ``session=None`` constructs a fresh Session from the stored config;
    otherwise restores tensors/knobs into the given session (its config must
    produce the same shapes).
    """
    from fdoct_tpu.config import PipelineConfig
    from fdoct_tpu.session import Session

    if backend == "orbax" or Path(path).is_dir():
        import orbax.checkpoint as ocp

        ckptr = ocp.StandardCheckpointer()
        data = ckptr.restore(Path(path).resolve())
    else:
        path = Path(path)
        if not path.exists() and npz_path(path).exists():
            path = npz_path(path)   # --checkpoint sess wrote sess.npz
        data = np.load(path)
    cfg = PipelineConfig.from_json(bytes(data["config_json"]).decode())
    if session is None:
        session = Session(cfg, **session_kwargs)
    keys = set(getattr(data, "files", data))
    for k in _TENSORS:
        setattr(session, k, jnp.asarray(data[f"tensor_{k}"]))
    for k in _OPT_TENSORS:
        if f"tensor_{k}" in keys:
            setattr(session, k, jnp.asarray(data[f"tensor_{k}"]))
    for k in _SCALARS:
        v = data[f"scalar_{k}"][()]   # REQUIRED — loud KeyError if absent
        setattr(session, k, type(getattr(session, k))(v))
    for k in _OPT_SCALARS:
        if f"scalar_{k}" not in keys:
            continue                  # pre-round-5 archive: keep default
        v = data[f"scalar_{k}"][()]
        setattr(session, k, type(getattr(session, k))(v))
    # checkpoints represent group-boundary state; a restore into a LIVE
    # session mid-group must restart the current accumulation (the same
    # semantics as a live 'averages' change, session.apply_config) — a
    # stale accum/indextemp against a restored averagestoggle would
    # mis-normalize the next displayed B-scan
    session.accum = jnp.zeros_like(session.accum)
    session.indextemp = 0
    return session
