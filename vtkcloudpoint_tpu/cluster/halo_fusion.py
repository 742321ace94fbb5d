"""Halo union-find: principled cross-block cluster merging.

The reference's only cross-boundary recovery is re-clustering leftover noise
(FrmMain.cs:1507-1520) plus an optional centroid-distance merge -- a cluster
split into two pieces that each independently survive the cull keeps TWO ids.
This module fixes that (the SURVEY.md §5 "principled version of the
re-cluster-the-leftovers trick"):

1. per block, collect core boundary points (within eps of the block's bbox)
   into fixed-capacity halo buffers;
2. over the gathered boundary set, any two CORE points from different
   clusters within eps imply their global ids denote one cluster;
3. a scatter-min union-find over the id table resolves the implied merges to
   a fixpoint, then ids densify to 1..K'.

The buffer builder and the union-find are split so the sharded path
(parallel.sharded) can all_gather per-device halo buffers between them --
the collective payload is the eps-shell, not the world.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..ops.metrics import pairwise


_IMAX = 2**31 - 1


def _safe_id(r):
    """Reserve INT_MAX as the invalid sentinel: remap a real hash landing
    exactly there to INT_MAX-1 (a collision -- false-positive-only, sound).
    Must be applied consistently to packed cells AND stencil queries."""
    return jnp.where(r == jnp.int32(_IMAX), jnp.int32(_IMAX - 1), r)


def pack_cells(raw1, raw2, use, cap: int):
    """Distinct (raw1, raw2) cell-hash pairs of the ``use`` points.

    The cross-device boundary filter exchanges each device's occupied-cell
    LIST instead of all-reducing [2^bits] occupancy tables: the collective
    payload becomes O(distinct cells) -- a few MB at 10M points -- where
    the table psum/pmin was 64+ MB per hash and tripped the XLA CPU
    rendezvous watchdog on oversubscribed validation hosts (and would
    waste interconnect bandwidth on real devices).

    Dedup is by the (raw1, raw2) PAIR: deduping on raw1 alone would let a
    raw1 collision between two distinct cells (expected ~100+ pairs at ~1M
    distinct cells/device) drop the second cell's raw2 from the foreign
    filter's t2 table, turning the Bloom-AND lookup into a silent false
    NEGATIVE -- a missed cross-device merge no overflow counter surfaces.
    Pair duplicates only consume ``cap``, which ``dropped`` accounts for.

    Returns (cells [cap, 2] i32, sel bool[cap], dropped i32) where dropped
    counts distinct pairs beyond ``cap`` -- a nonzero value means possible
    MISSED boundary points, so callers add it to the halo overflow.
    """
    n = raw1.shape[0]
    key = jnp.where(use, _safe_id(raw1), jnp.int32(_IMAX))
    # lexicographic (raw1, raw2): stable sort by the secondary key first,
    # then by the primary -- equal-key runs keep the secondary order
    o2 = jnp.argsort(raw2, stable=True)
    order0 = o2[jnp.argsort(key[o2], stable=True)]
    s1 = key[order0]
    s2 = raw2[order0]
    first = jnp.concatenate(
        [s1[:1] < _IMAX,
         ((s1[1:] != s1[:-1]) | (s2[1:] != s2[:-1])) & (s1[1:] < _IMAX)]
    )
    slot = jnp.where(first, jnp.arange(n, dtype=jnp.int32), n)
    order = jnp.argsort(slot)[:cap]
    sel = slot[order] < n
    cells = jnp.stack(
        [jnp.where(sel, s1[order], _IMAX), jnp.where(sel, s2[order], 0)],
        axis=-1,
    )
    dropped = jnp.sum(first, dtype=jnp.int32) - jnp.sum(sel, dtype=jnp.int32)
    return cells, sel, dropped


def foreign_cell_filter(raw1, raw2, deltas1, deltas2, cells, cells_sel,
                        bits: int):
    """bool[n]: some 3^D stencil cell of each point appears in the foreign
    cell list (two-hash AND lookup; false positives only)."""
    H = 1 << bits
    hm = jnp.int32(H - 1)
    idx1 = jnp.where(cells_sel, _safe_id(cells[..., 0]) & hm, H)
    idx2 = jnp.where(cells_sel, cells[..., 1] & hm, H)
    t1 = jnp.zeros(H, bool).at[idx1.reshape(-1)].set(True, mode="drop")
    t2 = jnp.zeros(H, bool).at[idx2.reshape(-1)].set(True, mode="drop")
    near = jnp.zeros(raw1.shape, bool)
    for d1, d2 in zip(deltas1, deltas2):
        q1 = _safe_id(raw1 + jnp.int32(d1)) & hm
        q2 = (raw2 + jnp.int32(d2)) & hm
        near = near | (t1[q1] & t2[q2])
    return near


def cell_hashes(coords, shell_eps: float, primes):
    """(raw i32[...], stencil deltas) for D-dim coords at shell_eps cells."""
    from itertools import product as _product

    from .grid import _PRIMES  # noqa: F401  (doc anchor)

    def _wrap32(v):
        return ((v + 2**31) % 2**32) - 2**31

    d = coords.shape[-1]
    cidx = jnp.floor(coords / shell_eps).astype(jnp.int32)
    raw = jnp.zeros(coords.shape[:-1], jnp.int32)
    for ax_ in range(d):
        raw = raw + cidx[..., ax_] * jnp.int32(primes[ax_])
    deltas = [
        _wrap32(sum(int(o[ax_]) * primes[ax_] for ax_ in range(d)))
        for o in _product((-1, 0, 1), repeat=d)
    ]
    return raw, deltas


def halo_buffers(block_coords, block_valid, block_labels, block_core,
                 eps: float, halo_cap: int, shell_eps: float = None,
                 block_id_offset: int | jax.Array = 0, axis: str = None,
                 cell_table_bits: int = 24):
    """Pack core boundary points into [B*halo_cap] buffers.

    Boundary test: a point is in the halo iff some cell of its 3^D stencil
    (GLOBAL ``shell_eps``-sized cells, hashed) contains a point from a
    DIFFERENT block -- detected through scatter-min/max block-id tables.
    This is partition-shape-agnostic. The earlier "within shell_eps of the
    own-block bounding box" criterion is sound ONLY when block bboxes are
    spatially disjoint (the reference's rows x cols grid); Morton
    equal-count blocks can span two distant regions, leaving truly adjacent
    points in the bbox INTERIOR -- cross-block merges were silently missed
    (caught by tests/test_engine.py::test_engine_cluster_sharded...).
    Hash collisions only ADD halo points (sound) -- but the table must
    stay sparsely loaded or false positives flood the downstream buffers:
    a 10M-point run occupies ~1M distinct eps-cells, and a 2^20 table at
    60% load marked HALF the cloud as boundary. 2^24 (64 MB i32) keeps
    load < 10% beyond 10^8 points; size cell_table_bits up with the map.
    ``shell_eps`` >= eps guarantees every cross-block eps-pair is captured
    (ParallelConfig.halo_width_eps scales it). Defaults to eps.

    ``block_id_offset`` makes block ids globally unique across devices and
    ``axis`` (when given) pmin/pmax-reduces the occupancy tables over the
    mesh, so per-device calls see every OTHER device's blocks too.

    Returns (hx [M, D], hlab i32[M], hvalid bool[M], halo_overflow i32[]).
    """
    if shell_eps is None:
        shell_eps = eps
    B, cap, d = block_coords.shape
    halo_cap = min(halo_cap, cap)
    big = jnp.asarray(1e30, block_coords.dtype)

    from .grid import _PRIMES, _PRIMES2

    H = 1 << cell_table_bits
    hmask = jnp.int32(H - 1)
    bid = (jnp.arange(B, dtype=jnp.int32)[:, None]
           + jnp.asarray(block_id_offset, jnp.int32))       # [B, 1]
    bid_full = jnp.broadcast_to(bid, (B, cap))
    occupied = block_valid
    imax = jnp.int32(_IMAX)

    raw1, deltas1 = cell_hashes(block_coords, shell_eps, _PRIMES)
    raw2, deltas2 = cell_hashes(block_coords, shell_eps, _PRIMES2)

    # LOCAL block-adjacency tables (two independent hashes AND-combined --
    # Bloom k=2, see grid._PRIMES2: per-lookup false positives drop from
    # table load to load^2). These never cross the mesh.
    def block_tables(raw):
        own_idx = raw & hmask
        bmin = jnp.full(H, imax, jnp.int32).at[own_idx.reshape(-1)].min(
            jnp.where(occupied, bid_full, imax).reshape(-1))
        bmax = jnp.full(H, -1, jnp.int32).at[own_idx.reshape(-1)].max(
            jnp.where(occupied, bid_full, -1).reshape(-1))
        return bmin, bmax

    bmin1, bmax1 = block_tables(raw1)
    bmin2, bmax2 = block_tables(raw2)
    near_other = jnp.zeros((B, cap), bool)
    for d1, d2 in zip(deltas1, deltas2):
        i1 = (raw1 + jnp.int32(d1)) & hmask
        i2 = (raw2 + jnp.int32(d2)) & hmask
        hit1 = (bmin1[i1] < bid) | (bmax1[i1] > bid)
        hit2 = (bmin2[i2] < bid) | (bmax2[i2] > bid)
        near_other = near_other | (hit1 & hit2)

    cell_dropped = jnp.int32(0)
    if axis is not None:
        # cross-DEVICE adjacency via gathered distinct-cell lists: the
        # collective payload is O(occupied cells), not O(table) -- all-
        # reducing the [2^bits] tables (4 x 64 MB) tripped the XLA CPU
        # rendezvous watchdog and would waste interconnect bandwidth
        dev = jax.lax.axis_index(axis)
        npts = B * cap
        list_cap = max(4096, npts // 4)
        cells, sel, cell_dropped = pack_cells(
            raw1.reshape(-1), raw2.reshape(-1), occupied.reshape(-1),
            list_cap)
        gcells = jax.lax.all_gather(cells, axis)        # [ndev, cap, 2]
        gsel = jax.lax.all_gather(sel, axis)
        # own-row mask via a gathered device marker (axis size stays
        # implicit in the gathered shape -- no static ndev needed here)
        gdev = jax.lax.all_gather(dev, axis)            # [ndev]
        other = gdev != dev
        cross = foreign_cell_filter(
            raw1.reshape(-1), raw2.reshape(-1), deltas1, deltas2,
            gcells.reshape(-1, 2), (gsel & other[:, None]).reshape(-1),
            cell_table_bits,
        ).reshape(B, cap)
        near_other = near_other | cross
    is_halo = block_valid & near_other & block_core & (block_labels > 0)

    slot_key = jnp.where(is_halo, jnp.arange(cap)[None, :], cap)
    order = jnp.argsort(slot_key, axis=1, stable=True)[:, :halo_cap]
    take = jnp.take_along_axis
    sel_valid = take(is_halo, order, axis=1)
    hx = jnp.where(
        sel_valid[..., None],
        take(block_coords, order[..., None], axis=1),
        big,
    ).reshape(B * halo_cap, d)
    hlab = jnp.where(
        sel_valid, take(block_labels, order, axis=1), 0
    ).reshape(B * halo_cap)
    hvalid = sel_valid.reshape(B * halo_cap)
    overflow = jnp.sum(
        jnp.maximum(jnp.sum(is_halo.astype(jnp.int32), axis=1) - halo_cap, 0)
    )
    # dropped distinct cells from the packed list could hide cross-device
    # boundary points -> exactness requires the counter to surface them
    return hx, hlab, hvalid, overflow + cell_dropped


def union_ids(hx, hlab, hvalid, n_used, eps: float, metric: str,
              max_ids: int):
    """Scatter-min union-find over cluster ids implied by halo adjacency.

    Returns dict(remap i32[max_ids], n_after, idmap)."""
    dist = pairwise(hx, hx, metric)
    adj = (
        (dist <= eps)
        & hvalid[:, None]
        & hvalid[None, :]
        & (hlab[:, None] != hlab[None, :])
    )
    idm0 = jnp.arange(max_ids, dtype=jnp.int32)
    lab_idx = jnp.clip(hlab, 0, max_ids - 1)

    def body(state):
        idm, _, it = state
        cur = idm[lab_idx]
        nbr_min = jnp.min(
            jnp.where(adj, cur[None, :], jnp.int32(max_ids)), axis=1
        )
        new_val = jnp.minimum(cur, nbr_min)
        idm_new = idm.at[lab_idx].min(
            jnp.where(hvalid, new_val, jnp.int32(max_ids))
        )
        idm_new = idm_new.at[0].set(0)
        idm_new = jnp.minimum(idm_new, idm_new[idm_new])  # path compression
        return idm_new, jnp.any(idm_new != idm), it + 1

    idm1, ch1, it1 = body((idm0, jnp.array(True), jnp.int32(0)))
    idm, _, _ = jax.lax.while_loop(
        lambda s: s[1] & (s[2] < 32), body, (idm1, ch1, it1)
    )

    ids = jnp.arange(max_ids)
    used = (ids >= 1) & (ids <= n_used)
    survivor = used & (idm == ids)
    new_id = jnp.cumsum(survivor.astype(jnp.int32))
    remap = jnp.where(used, new_id[idm], 0).astype(jnp.int32)
    remap = remap.at[0].set(0)
    return {
        "remap": remap,
        "n_after": jnp.sum(survivor.astype(jnp.int32)),
        "idmap": idm,
    }


def grid_union_ids(hx, hlab, hvalid, n_used, eps: float, metric: str,
                   max_ids: int, cell_cap: int = 64, idm_init=None,
                   max_rounds: int = 32):
    """union_ids with grid-hash adjacency instead of the [H, H] pairwise.

    Every halo point is core, so eps-connected components (dbscan_grid with
    min_pts=1: no noise, components = clusters) subsume pairwise adjacency:
    two ids are mergeable iff points carrying them share a component.  Per
    Jacobi round: component -> min CURRENT id (segment-min), id -> min over
    its points' components (scatter-min), path-compress; O(H x stencil)
    instead of O(H^2).  ``idm_init`` seeds the table (composition with an
    earlier union stage).  Returns dict(remap, n_after, idmap, overflow);
    overflow counts grid-cell truncation (exactness requires 0)."""
    from .grid import dbscan_grid

    inf = jnp.int32(max_ids)
    hn = hx.shape[0]
    use = hvalid & (hlab > 0)
    lab_idx = jnp.clip(hlab, 0, max_ids - 1)
    comp = dbscan_grid(hx, use, eps, 1, metric, cell_cap=cell_cap)
    clab = comp["label"]

    def body(state):
        idm, _, it = state
        cur = jnp.where(use, idm[lab_idx], inf)
        cmin = jnp.full(hn + 1, inf, jnp.int32).at[clab].min(cur)
        idm_new = idm.at[lab_idx].min(jnp.where(use, cmin[clab], inf))
        idm_new = jnp.minimum(idm_new, inf - 1)
        idm_new = idm_new.at[0].set(0)
        idm_new = jnp.minimum(idm_new, idm_new[idm_new])  # path compression
        return idm_new, jnp.any(idm_new != idm), it + 1

    idm0 = (jnp.arange(max_ids, dtype=jnp.int32)
            if idm_init is None else idm_init)
    st = body((idm0, jnp.array(True), jnp.int32(0)))
    idm, _, _ = jax.lax.while_loop(
        lambda s: s[1] & (s[2] < max_rounds), body, st
    )

    ids = jnp.arange(max_ids)
    used_ids = (ids >= 1) & (ids <= n_used)
    survivor = used_ids & (idm == ids)
    new_id = jnp.cumsum(survivor.astype(jnp.int32))
    remap = jnp.where(used_ids, new_id[idm], 0).astype(jnp.int32)
    remap = remap.at[0].set(0)
    return {
        "remap": remap,
        "n_after": jnp.sum(survivor.astype(jnp.int32)),
        "idmap": idm,
        "overflow": comp["overflow"],
    }


@partial(jax.jit, static_argnames=("eps", "metric", "halo_cap", "max_ids"))
def halo_merge_labels(
    block_coords,
    block_valid,
    block_labels,
    block_core,
    n_used,
    eps: float,
    metric: str = "l1_motor",
    halo_cap: int = 64,
    max_ids: int = 4096,
):
    """Single-device halo merge over [B, cap] blocks with GLOBAL ids.

    Returns dict(remap, n_after, halo_overflow, idmap); see union_ids."""
    hx, hlab, hvalid, overflow = halo_buffers(
        block_coords, block_valid, block_labels, block_core, eps, halo_cap
    )
    out = union_ids(hx, hlab, hvalid, n_used, eps, metric, max_ids)
    out["halo_overflow"] = overflow
    return out


def apply_halo_merge(labels, remap):
    """Apply the dense remap to a flat/per-block label array."""
    return remap[jnp.clip(labels, 0, remap.shape[0] - 1)]
