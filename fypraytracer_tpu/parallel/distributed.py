"""Multi-host initialization + collectives helpers.

The reference is strictly single-process/single-GPU (SURVEY.md §2.7);
this framework scales past one host: ``init_distributed`` wires
``jax.distributed`` (network rendezvous), and the mesh helpers place the
pixel data-parallel axis on the cards of one host (NVLink) before
spanning hosts, so ReSTIR halo exchange and gradient ``psum`` stay on the
fast intra-host links (SURVEY.md §5 "distributed communication backend"
row).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialize multi-host JAX.  No-ops gracefully single-process.

    Nothing detects a GPU cluster automatically: pass the coordinator
    address (``host:port``), process count and this process's id.
    """
    if num_processes is not None and num_processes <= 1:
        return
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except RuntimeError:
        # already initialized (idempotent use from notebooks/tests)
        pass


def pixel_mesh_hosts_outer(axis: str = "px") -> Mesh:
    """1D pixel mesh ordered so consecutive shards are intra-host first
    (NVLink-contiguous), hosts outermost (network)."""
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return Mesh(np.asarray(devs), (axis,))


def local_batch_slice(global_size: int) -> slice:
    """This process's contiguous slice of a globally sharded pixel axis."""
    n_proc = jax.process_count()
    pid = jax.process_index()
    per = global_size // n_proc
    return slice(pid * per, (pid + 1) * per if pid < n_proc - 1 else global_size)
