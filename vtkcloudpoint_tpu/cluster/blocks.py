"""Spatial block partitioning for block-parallel DBSCAN.

Two modes:

1. ``assign_blocks_reference`` -- deterministic clean-grid version of the
   reference partitioner (FrmMain.cs:1214-1291): sort by L-inf distance from
   the min corner, first ``pts_in_cell`` points define the cell extents, then
   a rows x cols grid with left-exclusive/right-inclusive boundaries
   (Tools.getListByScale2, Tools.cs:510-513) and edge cells extended to the
   max bound.

   NOTE on parity scope: the reference's own blocked path is nondeterministic
   -- its seed block OVERLAPS later grid cells, the shared Point3D objects are
   clustered twice from concurrent ThreadPool workers with no locks
   (FrmMain.cs:1356-1361, 2782-2794), and boundary points with motor_x==x_min
   fall in no grid cell at all. We therefore define the deterministic
   semantics: every point belongs to exactly one grid cell (min-edge points
   clamp into cell 0), the seed block is used ONLY to derive cell extents,
   and ties in the L-inf sort break by point index (stable). The NumPy oracle
   implements the same spec; bit-compatibility is engine==oracle.

2. ``assign_blocks_balanced`` -- fast mode: Morton-order sort chunked
   into exactly-full blocks. Perfectly load-balanced (no overflow), spatially
   coherent, and shape-static.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

BIG = 1e30


def _extents(motor, valid):
    x = motor[:, 0]
    y = motor[:, 1]
    xmin = jnp.min(jnp.where(valid, x, BIG))
    ymin = jnp.min(jnp.where(valid, y, BIG))
    xmax = jnp.max(jnp.where(valid, x, -BIG))
    ymax = jnp.max(jnp.where(valid, y, -BIG))
    return xmin, ymin, xmax, ymax


@partial(jax.jit, static_argnames=("pts_in_cell",))
def assign_blocks_reference(motor, valid, pts_in_cell: int):
    """Grid-cell id per point, reference cell-extent derivation.

    Returns dict: block i32[N] (0 for invalid too -- mask separately),
    n_blocks i32[], rows, cols, cell_x, cell_y.
    """
    x = motor[:, 0]
    y = motor[:, 1]
    xmin, ymin, xmax, ymax = _extents(motor, valid)
    key = jnp.where(valid, jnp.maximum(x - xmin, y - ymin), BIG)
    order = jnp.argsort(key, stable=True)
    seed = order[:pts_in_cell]
    seed_valid = valid[seed]
    cell_x = jnp.max(jnp.where(seed_valid, x[seed] - xmin, -BIG))
    cell_y = jnp.max(jnp.where(seed_valid, y[seed] - ymin, -BIG))
    # degenerate guards: zero extent -> one row/col on that axis
    cell_x = jnp.where(cell_x > 0, cell_x, jnp.maximum(xmax - xmin, 1.0))
    cell_y = jnp.where(cell_y > 0, cell_y, jnp.maximum(ymax - ymin, 1.0))
    cols = (jnp.floor((xmax - xmin) / cell_x)).astype(jnp.int32) + 1
    rows = (jnp.floor((ymax - ymin) / cell_y)).astype(jnp.int32) + 1
    # (min + q*cell, min + (q+1)*cell] membership -> q = ceil(dx/cell) - 1,
    # min-edge points clamp into 0; last row/col extend to the max bound.
    col = jnp.ceil((x - xmin) / cell_x).astype(jnp.int32) - 1
    row = jnp.ceil((y - ymin) / cell_y).astype(jnp.int32) - 1
    col = jnp.clip(col, 0, cols - 1)
    row = jnp.clip(row, 0, rows - 1)
    block = jnp.where(valid, row * cols + col, 0).astype(jnp.int32)
    return {
        "block": block,
        "n_blocks": rows * cols,
        "rows": rows,
        "cols": cols,
        "cell_x": cell_x,
        "cell_y": cell_y,
        "origin": jnp.stack([xmin, ymin]),
    }


def _morton_key(qx, qy):
    """Interleave two 16-bit ints into a 32-bit Morton code."""

    def spread(v):
        v = v.astype(jnp.uint32)
        v = (v | (v << 8)) & jnp.uint32(0x00FF00FF)
        v = (v | (v << 4)) & jnp.uint32(0x0F0F0F0F)
        v = (v | (v << 2)) & jnp.uint32(0x33333333)
        v = (v | (v << 1)) & jnp.uint32(0x55555555)
        return v

    return spread(qx) | (spread(qy) << 1)


@partial(jax.jit, static_argnames=("block_capacity",))
def assign_blocks_balanced(motor, valid, block_capacity: int):
    """Morton-order equal-count blocks: block = rank // capacity.

    Every block except possibly the last is exactly full; invalid points sort
    to the tail. n_blocks = ceil(n_valid / capacity).
    """
    n = motor.shape[0]
    x = motor[:, 0]
    y = motor[:, 1]
    xmin, ymin, xmax, ymax = _extents(motor, valid)
    sx = jnp.clip((x - xmin) / jnp.maximum(xmax - xmin, 1e-30), 0.0, 1.0)
    sy = jnp.clip((y - ymin) / jnp.maximum(ymax - ymin, 1e-30), 0.0, 1.0)
    # clamp to 65534 so no valid code collides with the 0xFFFFFFFF
    # invalid sentinel (qx=qy=65535 would interleave into it)
    qx = jnp.minimum((sx * 65535.0).astype(jnp.int32), 65534)
    qy = jnp.minimum((sy * 65535.0).astype(jnp.int32), 65534)
    code = _morton_key(qx, qy)
    code = jnp.where(valid, code, jnp.uint32(0xFFFFFFFF))
    order = jnp.argsort(code, stable=True)
    rank = jnp.zeros(n, jnp.int32).at[order].set(jnp.arange(n, dtype=jnp.int32))
    block = jnp.where(valid, rank // block_capacity, 0).astype(jnp.int32)
    n_valid = jnp.sum(valid.astype(jnp.int32))
    n_blocks = (n_valid + block_capacity - 1) // block_capacity
    # ``order`` IS the bucket layout: slot (b, k) holds point order[b*cap+k].
    # gather_blocks_ordered consumes it directly, skipping a second argsort.
    return {"block": block, "n_blocks": n_blocks, "order": order}


@partial(jax.jit, static_argnames=("capacity", "max_blocks"))
def partition_gather_sorted(motor, valid, capacity: int, max_blocks: int,
                            coords=None):
    """assign_blocks_balanced + gather_blocks_ordered in ONE multi-operand
    sort: the Morton code carries (coords..., index) as sort payloads, so
    the blocked coordinate layout falls out of the sort with NO gather.

    The separate path costs an argsort plus a ~1M-row random gather;
    lax.sort moves the same rows as payload. Identical outputs to the two-step path
    (tested): (block_coords [B, cap, D], block_valid [B, cap],
    point_index [B, cap] i32 with -1 padding, overflow [1]).

    ``coords`` (default: motor) is the [N, D] coordinate payload to block
    -- pass the metric coords when they differ from the motor coords the
    Morton partition is computed on (e.g. 3D xyz under l2_xyz).
    """
    if coords is None:
        coords = motor
    n = motor.shape[0]
    x = motor[:, 0]
    y = motor[:, 1]
    d = coords.shape[1]
    xmin, ymin, xmax, ymax = _extents(motor, valid)
    sx = jnp.clip((x - xmin) / jnp.maximum(xmax - xmin, 1e-30), 0.0, 1.0)
    sy = jnp.clip((y - ymin) / jnp.maximum(ymax - ymin, 1e-30), 0.0, 1.0)
    qx = jnp.minimum((sx * 65535.0).astype(jnp.int32), 65534)
    qy = jnp.minimum((sy * 65535.0).astype(jnp.int32), 65534)
    code = _morton_key(qx, qy)
    code = jnp.where(valid, code, jnp.uint32(0xFFFFFFFF))
    idx = jnp.arange(n, dtype=jnp.int32)
    # two keys (code, index) = stable order without is_stable's 2.5x cost
    out = jax.lax.sort(
        (code, idx) + tuple(coords[:, k] for k in range(d)), num_keys=2)
    si = out[1]
    total = max_blocks * capacity
    n_valid = jnp.sum(valid.astype(jnp.int32))

    def fit(a, fill):
        if n >= total:
            return a[:total]
        return jnp.pad(a, (0, total - n), constant_values=fill)

    slot_valid = jnp.arange(total) < jnp.minimum(n_valid, total)
    pidx = jnp.where(slot_valid, fit(si, 0), -1).reshape(
        max_blocks, capacity)
    cols = [jnp.where(slot_valid, fit(out[2 + k], 0.0), 0.0)
            for k in range(d)]
    block_coords = jnp.stack(cols, axis=-1).reshape(
        max_blocks, capacity, d)
    overflow = jnp.maximum(n_valid - total, 0)[None]
    return block_coords, pidx >= 0, pidx, overflow


@partial(jax.jit, static_argnames=("max_blocks", "capacity"))
def gather_blocks_ordered(coords, order, valid, max_blocks: int,
                          capacity: int):
    """Bucket points using a precomputed sort order (balanced mode fast
    path): point_index[b, k] = order[b*cap + k], padded with -1 past the
    valid count. Equivalent to gather_blocks on assign_blocks_balanced
    output but with no second sort."""
    n = coords.shape[0]
    total = max_blocks * capacity
    o = order[:total] if n >= total else jnp.pad(order, (0, total - n),
                                                 constant_values=0)
    slot_valid = (jnp.arange(total) < jnp.sum(valid.astype(jnp.int32)))
    table = jnp.where(slot_valid, o.astype(jnp.int32), -1).reshape(
        max_blocks, capacity
    )
    safe = jnp.clip(table, 0, n - 1)
    block_coords = jnp.where(
        (table >= 0)[..., None], coords[safe], 0.0
    )
    overflow = jnp.maximum(
        jnp.sum(valid.astype(jnp.int32)) - total, 0
    )[None]
    return block_coords, table >= 0, table, overflow


@partial(jax.jit, static_argnames=("max_blocks", "capacity"))
def gather_blocks(coords, block, valid, max_blocks: int, capacity: int):
    """Bucket points into [max_blocks, capacity] padded coordinate blocks.

    Returns (block_coords [B, cap, D], block_valid [B, cap],
    point_index [B, cap] i32 with -1 padding, overflow [B]).
    """
    from ..ops.segment import bucket_by_cluster

    table, overflow = bucket_by_cluster(block, valid, max_blocks, capacity)
    safe = jnp.clip(table, 0, coords.shape[0] - 1)
    block_coords = coords[safe]
    block_valid = table >= 0
    block_coords = jnp.where(block_valid[..., None], block_coords, 0.0)
    return block_coords, block_valid, table, overflow
