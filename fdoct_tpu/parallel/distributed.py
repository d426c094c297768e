"""Multi-host initialization.

The reference's only inter-process mechanism is fork/execv with the
filesystem as channel (BscanFFTspinj.cpp:2389-2412); the equivalent here is
jax.distributed: every host runs the same program, sees its local devices,
and the collectives in parallel.sharded span the global mesh.
"""

from __future__ import annotations

import os

import jax


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> bool:
    """Initialize jax.distributed when running multi-host.

    Arguments left as None are read from ``FDOCT_COORDINATOR``
    (``host:port``), ``FDOCT_NUM_PROCESSES`` and ``FDOCT_PROCESS_ID``.  A
    GPU cluster needs all three, unless it runs under a cluster manager
    that jax.distributed detects by itself (e.g. SLURM or Open MPI).
    Returns True when distributed mode was initialized, False for
    single-process runs (no-op, so the same entrypoints work at n=1).
    """
    env = os.environ
    if coordinator is None:
        coordinator = env.get("FDOCT_COORDINATOR") or None
    if num_processes is None:
        num_processes = int(env.get("FDOCT_NUM_PROCESSES", "1"))
    if process_id is None and env.get("FDOCT_PROCESS_ID"):
        process_id = int(env["FDOCT_PROCESS_ID"])
    if num_processes <= 1 and coordinator is None:
        return False
    kwargs = {"num_processes": num_processes}
    if coordinator is not None:
        kwargs["coordinator_address"] = coordinator
    if process_id is not None:
        kwargs["process_id"] = process_id
    try:
        jax.distributed.initialize(**kwargs)
    except (RuntimeError, ValueError) as e:
        raise RuntimeError(
            f"jax.distributed.initialize({kwargs}) failed: {e}. Outside a "
            "cluster manager jax.distributed detects, pass the coordinator "
            "address, process count and process id (or set "
            "FDOCT_COORDINATOR, FDOCT_NUM_PROCESSES and FDOCT_PROCESS_ID)"
        ) from e
    return True
