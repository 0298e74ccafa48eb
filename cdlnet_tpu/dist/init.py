"""Multi-process runtime initialization.

The reference is a single process on one GPU (train.py:15-16, job.sbatch).
Here one process drives every card of a host, so no init is needed there;
several processes (one per host, or one per card) call
jax.distributed.initialize with an explicit coordinator so jax.devices()
sees every card. Cards of one host are joined all to all, so the mesh
(dist/mesh.make_mesh) is flat and follows the algorithm alone.
"""

from __future__ import annotations

import os

import jax


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, local_device_ids=None):
    """Idempotent jax.distributed.initialize with env fallbacks
    (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID). No-op for
    single-process runs with no env config."""
    coordinator_address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    num_processes = num_processes or _int_env("NUM_PROCESSES")
    process_id = process_id if process_id is not None else _int_env("PROCESS_ID")
    if coordinator_address is None and num_processes is None:
        return False  # single-process
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    return True


def _int_env(name):
    v = os.environ.get(name)
    return int(v) if v is not None else None
