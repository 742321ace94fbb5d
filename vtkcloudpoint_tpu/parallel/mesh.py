"""Device mesh helpers.

Replaces the reference's in-process ThreadPool fan-out + poll barrier
(FrmMain.cs:1340-1399) with a jax.sharding.Mesh: blocks shard over the
``blocks`` axis (SURVEY.md §2 parallelism inventory). The mesh is 1-D: the
cards of one host are joined all to all (NVLink), so the layout follows the
algorithm alone.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis: str = "blocks") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    if len(devs) < n:
        # never silently degrade an explicitly-requested mesh size: a
        # 1-device "8-device" run would still pass, masquerading as a
        # multi-device validation
        raise RuntimeError(
            f"make_mesh({n}) but only {len(devs)} device(s) visible "
            f"(platform {devs[0].platform}); for a virtual CPU mesh set "
            "XLA_FLAGS=--xla_force_host_platform_device_count=N and "
            "jax.config.update('jax_platforms', 'cpu') before the first "
            "jax op"
        )
    return Mesh(np.array(devs[:n]), (axis,))


def shard_blocks(mesh: Mesh, arr, axis: str = "blocks"):
    """Shard leading (block) dimension over the mesh."""
    spec = P(axis) if arr.ndim == 1 else P(axis, *([None] * (arr.ndim - 1)))
    return jax.device_put(arr, NamedSharding(mesh, spec))


def replicated(mesh: Mesh, arr):
    return jax.device_put(arr, NamedSharding(mesh, P()))
