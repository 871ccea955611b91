"""Multi-host initialization & mesh construction.

The reference is a single JVM (SURVEY.md §2.2: no distributed backend);
this framework scales across hosts with jax.distributed: every host runs
the same program, streams its own slice of the read files, and joins
collectives within and across hosts.

Typical use:

    from metafast_jax.parallel import distributed as dist
    dist.initialize("localhost:1234", num_processes=2, process_id=0)
    mesh = dist.global_mesh()         # 1D kmer-shard mesh over all chips
    # ... sharded_count / sharded_connected_labels over `mesh`
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh

from .count import AXIS


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """jax.distributed.initialize.

    Pass the coordinator address, process count and this process's id:
    nothing on a plain GPU host tells JAX of a cluster.  Call once per
    process.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def global_mesh(axis: str = AXIS) -> Mesh:
    """1D mesh over every addressable chip in the job (all hosts)."""
    return Mesh(np.array(jax.devices()), (axis,))


def per_host_files(files: list, process_id: int | None = None,
                   num_processes: int | None = None) -> list:
    """Round-robin split of input files across hosts (data parallel over
    samples — the multi-host analog of kmer-counter-many's per-sample
    serial loop, src/tools/KmersCounterForManyFilesMain.java:80-108)."""
    pid = jax.process_index() if process_id is None else process_id
    n = jax.process_count() if num_processes is None else num_processes
    return [f for i, f in enumerate(files) if i % n == pid]
