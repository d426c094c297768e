"""chip_smoke.py: its host-side logic, its numerics check at a small size on
the CPU, and its refusal to report a result without a GPU.  The ``gpu``
test runs on the card (chip_smoke.py's gpu_tests phase) and skips here."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from fdoct_tpu.config import PipelineConfig

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def _run_script(script: Path, cwd: Path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


class TestNoResultWithoutGpu:
    def test_cpu_only_exits_nonzero(self):
        out = _run_script(ROOT / "chip_smoke.py", ROOT)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
        assert "no GPU" in out.stderr

    def test_script_alone_exits_nonzero(self, tmp_path):
        shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        out = _run_script(tmp_path / "chip_smoke.py", tmp_path)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("text,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n",
     [("NVIDIA H100 80GB HBM3", "700.00 W")]),
    ("NVIDIA H100 80GB HBM3, 700.00 W\nNVIDIA H100 80GB HBM3, 500.00 W\n\n",
     [("NVIDIA H100 80GB HBM3", "700.00 W"),
      ("NVIDIA H100 80GB HBM3", "500.00 W")]),
])
def test_parse_nvidia_smi(text, want):
    assert chip_smoke.parse_nvidia_smi(text) == want


class TestPhases:
    def test_four_cards_run_only_the_mesh_paths(self):
        assert chip_smoke.phases_for(4) == ("device", "mesh")

    def test_one_card_runs_the_main_path_without_the_mesh(self):
        phases = chip_smoke.phases_for(1)
        assert phases[0] == "device" and "mesh" not in phases
        assert {"native", "main_path", "numerics", "selftest"} <= set(phases)
        with pytest.raises(ValueError):
            chip_smoke.phases_for(2)


def test_dot_routes():
    hlo = "\n".join([
        '%a = f32[8,512]{1,0} custom-call(%x, %y), '
        'custom_call_target="__cublas$gemm"',
        '%b = f32[8,512]{1,0} custom-call(%x, %y), '
        'custom_call_target="__cublas$lt$matmul"',
        '%c = f32[8,512]{1,0} fusion(%x, %y), kind=kCustom, '
        'backend_config={"fusion_backend_config":{"kind":"__triton_gemm"}}',
        '%d = f32[8,512]{1,0} dot(%x, %y), lhs_contracting_dims={1}',
    ])
    assert dict(chip_smoke.dot_routes(hlo)) == {
        "cublas": 1, "cublasLt": 1, "triton_gemm_fusion": 1,
        "dot_instruction": 1}


def test_library_dot_output_bytes():
    hlo = ('%custom-call.0 = (f32[4096,512]{1,0}, s8[33554432]{0}) '
           'custom-call(%bitcast.61.0, %calib_op_im.1), '
           'custom_call_target="__cublas$gemm"\n'
           '%custom-call.1 = (f32[4096,512]{1,0}, s8[33554432]{0}) '
           'custom-call(%bitcast.61.0, %calib_op_re.1), '
           'custom_call_target="__cublas$gemm"\n')
    assert chip_smoke.library_dot_output_bytes(hlo) == 2 * 4096 * 512 * 4


#: the CPU suite's numerics fixture shape (tests/test_precision.py)
_SMALL = PipelineConfig(width=256, height=32, averages=4, numfftpoints=512,
                        numdisplaypoints=160, lambdamin=816e-9,
                        lambdamax=884e-9, dtype="float32", compat=True)


@pytest.mark.parametrize("mode", [m[0] for m in chip_smoke.MODES])
def test_mode_within_bounds_on_cpu(mode):
    """Each mode against the f64 reference, with chip_smoke's bounds, at
    the CPU suite's small shape (the same check runs on the card at the
    deployment widths)."""
    modes = [m for m in chip_smoke.MODES if m[0] == mode]
    assert chip_smoke.check_numerics("small", _SMALL, jax.devices()[0],
                                     modes) == []


@pytest.mark.gpu
def test_flagship_width_numerics_on_card(gpu_device):
    cfg = chip_smoke.flagship_cfg().replace(height=64)
    assert chip_smoke.check_numerics("flagship-64-rows", cfg,
                                     gpu_device) == []
