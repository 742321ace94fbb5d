"""Multi-host bring-up (BASELINE.json tier 5: 50M-pt map across >= 2 hosts).

The reference has no multi-process story at all (SURVEY.md §5 "Distributed
communication backend: none"). Here the recipe is standard JAX multi-host
SPMD: jax.distributed.initialize on every host, one global Mesh over all
devices, hosts feed their local shard of the point set, and the collectives
in parallel.sharded (all_gather of fusion counts/halo shells, psum of ICP
normal equations) ride NVLink within a host and the network across hosts.

Single-host fallbacks keep every entry point usable in tests and on one
card; __graft_entry__.dryrun_multichip runs the multi-device program on
virtual devices.
"""
from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None):
    """jax.distributed bring-up. No-ops when single-process (the common
    local/test case); arguments default from the standard env vars
    (COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID) when present."""
    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    if coordinator is None:
        return False
    num_processes = num_processes or int(os.environ.get("NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else int(
        os.environ.get("PROCESS_ID", "0"))
    if num_processes <= 1:
        return False
    from ..utils.resilience import retry

    def init_once():
        # jax.distributed.initialize sets global client/service state BEFORE
        # client.connect(); a failed connect leaves that state behind and
        # every later call raises "should only be called once". Tear the
        # half-initialized state down before re-raising so the retry below
        # actually retries the connect, not a guaranteed RuntimeError.
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator,
                num_processes=num_processes,
                process_id=process_id,
            )
        except Exception:
            try:
                jax.distributed.shutdown()
            except Exception:
                pass
            raise

    # coordinator races at job start are the normal case (hosts come up in
    # any order) and network hiccups are transient: retry with backoff
    # instead of failing the whole multi-host job on the first connect
    retry(attempts=5, backoff=2.0, exceptions=(RuntimeError, OSError))(
        init_once
    )()
    return True


def global_mesh(axis: str = "blocks") -> Mesh:
    """Mesh over every device of every host (1-D block axis)."""
    return Mesh(np.array(jax.devices()), (axis,))


def host_local_slice(n_global: int):
    """The [start, stop) range of a length-n_global block axis owned by this
    process (uniform split; callers pad n_global to a multiple)."""
    p = jax.process_index()
    np_ = jax.process_count()
    per = n_global // np_
    return p * per, (p + 1) * per if p < np_ - 1 else n_global


def make_global_blocks(local_blocks, mesh: Mesh, axis: str = "blocks"):
    """Assemble a process-local block array into a global sharded array
    (jax.make_array_from_process_local_data)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    spec = P(axis, *([None] * (local_blocks.ndim - 1)))
    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, spec), np.asarray(local_blocks)
    )
