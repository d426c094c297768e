"""SPMD scale-out over a device mesh.

The reference is single-threaded C++ with no distributed anything
(SURVEY.md §2.5); its implicit parallelism — every A-scan row independent,
frames independent until averaged — becomes explicit sharding here:

- mesh axes ``('data', 'ascan')``: frames (data parallelism) × lateral
  A-scan positions (the "sequence" axis of a B-scan).  The k/depth axis is
  always device-local so each IFFT/matmul needs no communication.
- frame averaging reduces over 'data' with ``psum``
  (the reference's accumulate loop, BscanFFT.cpp:1193-1221).
- B-scan display normalization needs a global min/max over 'ascan'
  (``pmin``/``pmax``) — the only cross-A-scan communication in the pipeline.
- C-scan volumes stay sharded over frames; full B-scans are assembled with
  ``all_gather`` over 'ascan' riding ICI.
- multi-host runs initialize via jax.distributed (parallel.distributed).
"""

from fdoct_tpu.parallel.mesh import make_mesh  # noqa: F401
from fdoct_tpu.parallel.sharded import (  # noqa: F401
    build_session_bscan_step, build_session_bscan_step_int8,
    sharded_bscan_step, sharded_bscan_step_int8, sharded_cscan_volume,
    sharded_cscan_volume_int8, shard_frames,
)
from fdoct_tpu.parallel.distributed import initialize_multihost  # noqa: F401
