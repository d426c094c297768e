"""fdoct_tpu — an accelerator-native Fourier-domain OCT reconstruction framework.

A from-scratch re-design of the capabilities of hn-88/FDOCT (a suite of
C++/OpenCV programs for real-time spectral-domain OCT) as a single
JAX/XLA framework:

- ``fdoct_tpu.ops``          — the algorithmic kernel library (windows, spectral
  resampling, row-wise FFT ops, filters, dB scaling) that the reference
  copy-pastes into every executable (reference: BscanFFT.cpp:88-347).
- ``fdoct_tpu.calibration``  — the λ→k calibration precompute
  (reference: BscanFFT.cpp:615-698) plus the fused linear reconstruction
  operator that is this framework's speed path (one matmul pair).
- ``fdoct_tpu.pipeline``     — jit-compiled frame→B-scan reconstruction.
- ``fdoct_tpu.session``      — the interactive keystroke state machine
  (averaging, background/π/J0/dark/ref/sample captures, thresholds)
  re-expressed as explicit functional state transitions
  (reference: BscanFFT.cpp:946-1925).
- ``fdoct_tpu.plugins``      — per-variant analysis features (J0 lock-in,
  J-mask, dark-frame decomposition, peak-hold vibrometry, ROI reporting).
- ``fdoct_tpu.sources`` / ``fdoct_tpu.sinks`` — frame producers (synthetic
  physics generator, file replay, camera shim) and persistence (PNG, .m,
  .ocv, npz, run directories).
- ``fdoct_tpu.parallel``     — SPMD scale-out over a device mesh
  (data-parallel frames, sharded A-scan axis, psum averaging,
  all_gather C-scan assembly).
"""

__version__ = "0.1.0"

from fdoct_tpu.config import PipelineConfig  # noqa: F401
from fdoct_tpu.calibration import Calibration  # noqa: F401
