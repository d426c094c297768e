"""Backend agnosticism: the production compute path runs on any JAX
backend — the CPU of the test suite and CI mesh, and the GPU (chip_smoke.py).
The reference is CUDA-free OpenCV C++; this framework keeps the hot path
pure XLA so the same code serves both.

Properties pinned here:

1. import hygiene — importing the package and running the production
   pipeline does not import `jax.experimental.pallas`.
2. the production jit functions lower on the generic backend with no
   backend-specific custom calls in the stable HLO.
3. no code branches on a backend's name, imports a backend-only Pallas
   module, or carries a platform override.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp

from fdoct_tpu.calibration import Calibration
from fdoct_tpu.config import PipelineConfig
from fdoct_tpu.pipeline import form_bscan, reconstruct

ROOT = Path(__file__).resolve().parent.parent


class TestImportHygiene:
    def test_production_paths_never_import_pallas(self):
        """A fresh interpreter that imports the package, builds a session,
        and processes a frame must finish with pallas absent from
        sys.modules (a top-level pallas import would break GPU hosts)."""
        prog = (
            "import sys\n"
            "sys.path.insert(0, %r)\n"
            "import os; os.environ['JAX_PLATFORMS'] = 'cpu'\n"
            "import jax\n"
            "import numpy as np, jax.numpy as jnp\n"
            "import fdoct_tpu\n"
            "from fdoct_tpu.config import PipelineConfig\n"
            "from fdoct_tpu.session import Session\n"
            "cfg = PipelineConfig(width=256, height=32, averages=2,\n"
            "                     numfftpoints=512, numdisplaypoints=128)\n"
            "s = Session(cfg, variant='base')\n"
            "s.data_yb = jnp.full((32, 256), 128.0)\n"
            "rng = np.random.default_rng(0)\n"
            "for _ in range(2):\n"
            "    s.process(rng.integers(0, 255, (32, 256)).astype(np.uint8))\n"
            "bad = [m for m in sys.modules if 'pallas' in m]\n"
            "assert not bad, f'pallas imported by production path: {bad}'\n"
            "print('clean')\n" % str(ROOT)
        )
        out = subprocess.run([sys.executable, "-c", prog],
                             capture_output=True, text=True, timeout=240)
        assert out.returncode == 0, out.stderr[-2000:]
        assert "clean" in out.stdout

    def test_no_backend_specific_code(self):
        """No backend-only Pallas import, no branch on the backend's name and
        no platform-override variable anywhere in the code, tests included
        (patterns assembled so this file does not match itself)."""
        patterns = ["jax.experimental.pallas" + ".tpu",
                    "pallas import " + "tpu",
                    "platform == " + '"tpu"', "platform == " + "'tpu'",
                    "default_backend" + "()", "FDOCT_" + "PLATFORM"]
        files = [p for d in ("fdoct_tpu", "tests", "scripts", "examples")
                 for p in (ROOT / d).rglob("*.py")]
        files += list(ROOT.glob("*.py")) + [ROOT / ".github" / "workflows"
                                             / "ci.yml"]
        hits = [f"{p.relative_to(ROOT)}: {pat}" for p in files
                for pat in patterns if pat in p.read_text()]
        assert not hits, hits


class TestGenericLowering:
    def test_fused_pipeline_lowers_without_tpu_custom_calls(self):
        cfg = PipelineConfig(width=256, height=32, averages=2,
                             numfftpoints=512, numdisplaypoints=128)
        calib = Calibration.create(cfg)
        bg = jnp.full((32, 256), 128.0, jnp.float32)
        pi = jnp.zeros((32, 256), jnp.float32)

        @jax.jit
        def step(frames):
            mags = reconstruct(frames, bg, pi, calib, cfg, method="fused")
            return form_bscan(mags.sum(0), cfg, averages=2).bscandisp

        frames = jnp.zeros((2, 32, 256), jnp.uint8)
        txt = step.lower(frames).as_text()
        for marker in ("custom_call", "mosaic"):
            assert marker not in txt, f"backend-specific op in HLO: {marker}"
        # and it actually executes on whatever backend the suite runs on
        # (bscandisp is (numdisplaypoints, height) — depth x lateral, the
        # reference's vertical B-scan orientation)
        out = np.asarray(step(frames))
        assert out.shape == (128, 32)
