"""Scan-to-map ICP: register each scan against the accumulated world map.

The tier-4 pipeline's drift-resistant odometry (BASELINE.json config 4
"scan-to-map ICP"): instead of chaining scan-to-scan transforms (error
compounds), each new scan registers against a bounded voxel map of
everything seen so far. The map lives in a fixed-capacity table
(ops/voxel.py) so the whole sequential loop runs under lax.scan with static
shapes.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import ICPConfig
from ..ops import se3
from ..ops.voxel import voxel_downsample
from ..register.icp import icp
from .trajectory import Trajectory

# nn="auto": brute-force NN up to this many map points, the grid locator
# above (the crossover measured on the CPU; not yet measured on a GPU)
BRUTE_NN_MAX_MAP = 8192


class MapState(NamedTuple):
    points: jax.Array   # [M, 3] voxel map in world frame
    mask: jax.Array     # [M]


def scan_to_map(
    scans,
    scan_valid,
    cfg: ICPConfig = ICPConfig(),
    voxel_size: float = 0.2,
    map_capacity: int = 16384,
    nn: str = "auto",           # "auto" | "grid" | "brute"
    grid_cell_size: float = None,
    grid_cell_cap: int = 32,
    grid_fallback_cap: int = 2048,
):
    """Sequentially register scans against the accumulated voxel map.

    scans: [S, N, 3] in their own frames. Returns (Trajectory, final
    MapState, per-scan errors). Pose of scan 0 is identity; its points seed
    the map.

    nn="grid" (auto-selected above ``BRUTE_NN_MAX_MAP`` map points)
    switches the ICP
    correspondence from the O(N*M) brute scan to the grid-hash locator
    (register.nn_grid, VERDICT r1 item 2) -- the map grid rebuilds each step
    (the map changes), every query resolves exactly or falls back to brute
    force up to grid_fallback_cap. Default cell size: 4 * voxel_size.
    """
    s, n, _ = scans.shape
    dtype = scans.dtype
    if nn == "auto":
        nn = "grid" if map_capacity > BRUTE_NN_MAX_MAP else "brute"
    cell = float(grid_cell_size if grid_cell_size is not None
                 else 4.0 * voxel_size)

    map_pts, map_mask, _ = voxel_downsample(
        scans[0], scan_valid[0], voxel_size, map_capacity
    )

    def step(carry, inp):
        map_pts, map_mask, r_prev, t_prev = carry
        scan, sv = inp
        # init from the previous pose (smooth trajectories)
        if nn == "grid":
            from ..register.nn_grid import icp_grid

            res, _ovf = icp_grid(
                scan, sv, map_pts, map_mask, cfg, cell_size=cell,
                cell_cap=grid_cell_cap, fallback_cap=grid_fallback_cap,
                r0=r_prev, t0=t_prev)
        else:
            res = icp(scan, sv, map_pts, map_mask, cfg, r0=r_prev, t0=t_prev)
        world = se3.apply_rigid(res.r, res.t, scan)
        # merge into the map: re-voxelize map + new points together
        both = jnp.concatenate([map_pts, world])
        both_mask = jnp.concatenate([map_mask, sv])
        map_pts2, map_mask2, _ = voxel_downsample(
            both, both_mask, voxel_size, map_capacity
        )
        return (map_pts2, map_mask2, res.r, res.t), (res.r, res.t, res.error)

    init = (map_pts, map_mask, jnp.eye(3, dtype=dtype), jnp.zeros(3, dtype))
    (map_pts, map_mask, _, _), (rs, ts, errs) = jax.lax.scan(
        step, init, (scans[1:], scan_valid[1:])
    )
    r_all = jnp.concatenate([jnp.eye(3, dtype=dtype)[None], rs])
    t_all = jnp.concatenate([jnp.zeros((1, 3), dtype), ts])
    return Trajectory(r_all, t_all), MapState(map_pts, map_mask), errs
