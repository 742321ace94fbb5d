"""Cross-block cluster fusion: global renumbering, small-cluster cull, noise
re-cluster, and centroid-distance merge.

Data-parallel equivalent of the reference merge pipeline:
- CompleteWork3 (FrmMain.cs:1432-1544): per-cell sort by local id, sequential
  global renumber, <=3-point cluster cull, then a second DBSCAN over all
  remaining noise seeded with the next free id to recover clusters split
  across block boundaries.
- MergeIDByDistance + refreshCensAndClusByDictionary (Tools.cs:580-621,
  521-572): DBSCAN over cluster centroids (L1 on X/Y, minPts=2); each
  centroid group collapses into its lowest-id member; survivors renumber
  densely by ascending old id.

Reference quirks reproduced under ``quirks=True`` (default, validated against
the sequential oracle):
- the cull run-length counter OVERCOUNTS the first run of a cell by one when
  the cell contains no noise points (idLast pre-init double-counts the first
  point, FrmMain.cs:1443,1462-1471): first run culled iff n+1 <= 3.
- the LAST run of each cell is never cull-checked (the check only fires on a
  transition to a different id inside the loop).
- the noise re-cluster id seed is clusterSum - delSum - 1 (FrmMain.cs:1509),
  so the FIRST recovered noise cluster collides with the last kept global id
  (off-by-one in the reference; clean mode seeds at K_kept instead).

Out-of-parity (documented): the reference's cull can corrupt/crash across
cell boundaries when the overcounted first run is culled (it rewinds one
point too many into the previous cell, FrmMain.cs:1485-1489), and its
within-cell sort is an unstable introsort; both make the reference itself
nondeterministic, so the spec here fixes stable ordering and per-cell
isolation.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .dbscan import dbscan_padded


def _block_label_counts(block_labels, block_valid, kmax: int):
    """[B, kmax] occurrence counts of local label c in block b: one flat
    scatter-add segment_sum, O(n). (A chunked compare+reduce over the id
    axis measured 2.5x slower on the H100 at the bench shape.)"""
    B = block_labels.shape[0]
    flat_seg = (
        jnp.arange(B, dtype=jnp.int32)[:, None] * kmax + block_labels
    ).reshape(-1)
    w = block_valid.reshape(-1).astype(jnp.int32)
    return jax.ops.segment_sum(
        w, flat_seg, num_segments=B * kmax).reshape(B, kmax)


def block_keep_rules(counts, min_cluster_size: int, quirks: bool):
    """CompleteWork3 cull rules from per-block label counts [B, kmax]
    (kmax = cap + 1; column 0 = noise run) -> keep [B, cap] bool.

    Every rule is PER-BLOCK-LOCAL (each row depends only on its own
    counts), which is what lets the sharded path evaluate it on a device's
    own count rows with no cross-device data (parallel.sharded only
    exchanges per-device kept-count scalars for the renumber offsets).
    Quirk semantics documented in the module docstring.
    """
    B, kmax = counts.shape
    present = counts[:, 1:] > 0  # [B, cap] run exists for local id c=1..cap
    n_run = counts[:, 1:]
    if quirks:
        has_noise = counts[:, 0] > 0
        # last existing run per block: local id == max present id
        max_id = jnp.max(
            jnp.where(present, jnp.arange(1, kmax)[None, :], 0), axis=1
        )
        is_last = jnp.arange(1, kmax)[None, :] == max_id[:, None]
        eff_len = jnp.where(
            (jnp.arange(1, kmax)[None, :] == 1) & ~has_noise[:, None],
            n_run + 1,
            n_run,
        )
        return present & (is_last | (eff_len > min_cluster_size))
    return present & (n_run > min_cluster_size)


def block_keep_renumber(counts, min_cluster_size: int, quirks: bool):
    """Cull + global-renumber from per-block label counts [B, kmax].

    Returns (keep [B, cap] bool, gid [B, cap] i32 -- the global id at each
    kept (block, local-id) slot, n_kept i32). ONE implementation shared by
    the single-device merge (merge_blocks) and the sharded path
    (parallel.sharded.sharded_blocked_dbscan applies block_keep_rules to
    its own rows + a scalar prefix offset -- identical by construction
    since the global renumber is a plain prefix sum in device-major block
    order) so the quirk rules cannot drift.
    """
    B, kmax = counts.shape
    keep = block_keep_rules(counts, min_cluster_size, quirks)
    # global ids in (block, local id) lex order
    gid = jnp.cumsum(keep.reshape(-1).astype(jnp.int32)).reshape(B, kmax - 1)
    n_kept = gid.reshape(-1)[-1]
    return keep, gid, n_kept


def apply_block_gid(block_labels, block_valid, keep, gid):
    """Point-level global ids [Bl, cap] from the keep/renumber tables, by
    one flat gather from the [Bl * kmax] table (a batched one-hot matmul
    measured 1.7x slower on the H100 at the bench shape).

    ``keep``/``gid`` rows must correspond to ``block_labels`` rows (the
    sharded path computes its device's rows locally + a prefix offset).
    Culled or noise points map to 0.
    """
    Bl, cap = block_labels.shape
    kmax = cap + 1
    keep_full = jnp.concatenate([jnp.zeros((Bl, 1), bool), keep], axis=1)
    gid_full = jnp.concatenate([jnp.zeros((Bl, 1), jnp.int32), gid], axis=1)
    b_idx = jnp.arange(Bl, dtype=jnp.int32)[:, None]
    flat_idx = (b_idx * kmax + block_labels).reshape(-1)
    point_keep = keep_full.reshape(-1)[flat_idx].reshape(Bl, cap)
    return jnp.where(
        block_valid & point_keep,
        gid_full.reshape(-1)[flat_idx].reshape(Bl, cap), 0
    )


def noise_pack_order(block_labels, noise_mask, capacity: int):
    """(order i32[capacity], sel bool[capacity]) packing the noise points
    in reference zeroList order: per cell ascending local id, then slot
    order (FrmMain.cs:1507-1510). The stable argsort preserves slot order
    within equal keys, so the key only needs (block, local id) -- keeps it
    int32-safe without x64. Shared by merge_blocks and the sharded
    path (each packs its own rows; device-major concatenation preserves
    the global order)."""
    B, cap = block_labels.shape
    kmax = cap + 1
    assert B * kmax < 2**31 - 1, "block count exceeds int32 order-key range"
    sentinel = jnp.int32(2**31 - 1)
    okey = jnp.arange(B, dtype=jnp.int32)[:, None] * kmax + block_labels
    okey = jnp.where(noise_mask, okey, sentinel).reshape(-1)
    # one multi-operand sort carries the slot index as payload (no
    # argsort-then-gather)
    idx = jnp.arange(okey.shape[0], dtype=jnp.int32)
    skey, order = jax.lax.sort((okey, idx), num_keys=1, is_stable=True)
    return order[:capacity], skey[:capacity] < sentinel


@partial(
    jax.jit,
    static_argnames=(
        "n_points",
        "min_cluster_size",
        "quirks",
        "noise_capacity",
        "eps",
        "min_pts",
        "metric",
        "noise_engine",
        "noise_cell_cap",
    ),
)
def merge_blocks(
    block_labels,
    block_valid,
    block_coords,
    point_index,
    n_points: int,
    eps: float,
    min_pts: int,
    metric: str = "l1_motor",
    min_cluster_size: int = 3,
    quirks: bool = True,
    noise_capacity: int = 4096,
    noise_engine: str = "auto",   # auto | dense | dense_chunked | grid
    noise_cell_cap: int = 32,
):
    """Fuse per-block local labels into global cluster ids.

    Args:
      block_labels: [B, cap] i32 local ids (1..k_b, 0 noise) from dbscan_blocks.
      block_valid:  [B, cap] bool.
      block_coords: [B, cap, D] metric coords (for the noise re-cluster).
      point_index:  [B, cap] i32 original point index (-1 pad) from
                    gather_blocks, to scatter global labels back.
      n_points:     static flat point-array size.

    Returns dict:
      label     i32[n_points] global ids (0 noise)
      n_kept    i32[] kept block clusters
      n_total   i32[] total clusters after noise re-cluster (reference
                dbb.clusterAmount semantics)
      noise_overflow i32[] noise points beyond capacity (left as noise)
    """
    B, cap = block_labels.shape
    kmax = cap + 1  # local ids are < cap+1

    counts = _block_label_counts(block_labels, block_valid, kmax)
    keep, gid, n_kept = block_keep_renumber(counts, min_cluster_size, quirks)
    point_gid = apply_block_gid(block_labels, block_valid, keep, gid)

    # ---- noise re-cluster (FrmMain.cs:1507-1520) ----
    noise_mask = block_valid & (point_gid == 0)
    order, sel_valid = noise_pack_order(block_labels, noise_mask,
                                        noise_capacity)
    coords_flat = block_coords.reshape(B * cap, -1)
    noise_coords = jnp.where(sel_valid[:, None], coords_flat[order], 0.0)

    cf_seed = (n_kept - 1) if quirks else n_kept
    if noise_engine == "auto":
        # engine by noise capacity T: the stored-adjacency dense engine up
        # to 8k (T^2 fits), above it the grid engine -- chunked dense
        # whenever the metric has no grid form (signed_sum_xy), so auto
        # never raises
        if noise_capacity <= 8192:
            noise_engine = "dense"
        else:
            from .grid import grid_metric

            gm = grid_metric(metric, block_coords.shape[-1])
            noise_engine = ("grid" if gm is not None
                            else "dense_chunked")
    if noise_engine == "grid":
        from .grid import dbscan_grid, grid_metric

        gmetric = grid_metric(metric, noise_coords.shape[-1])
        if gmetric is None:
            raise ValueError(
                f"metric {metric!r} has no grid form; use "
                "noise_engine='dense'")
        re = dbscan_grid(noise_coords, sel_valid, eps, min_pts, gmetric,
                         cf=cf_seed, cell_cap=noise_cell_cap)
    elif noise_engine == "dense_chunked":
        from .dbscan import dbscan_dense_chunked

        re = dbscan_dense_chunked(
            noise_coords, sel_valid, eps, min_pts, metric, cf=cf_seed
        )
    else:
        re = dbscan_padded(
            noise_coords, sel_valid, eps, min_pts, metric, cf=cf_seed
        )
    n_total = cf_seed + re["n_clusters"]

    # scatter re-cluster labels back into the block grid
    point_gid_flat = point_gid.reshape(-1)
    point_gid_flat = point_gid_flat.at[order].set(
        jnp.where(sel_valid, re["label"], point_gid_flat[order])
    )

    # scatter to original flat point order
    label = jnp.zeros(n_points, jnp.int32)
    pi = point_index.reshape(-1)
    # padding slots (-1) route out of range so mode="drop" discards them
    label = label.at[jnp.where(pi >= 0, pi, n_points)].set(
        point_gid_flat, mode="drop"
    )
    n_noise = jnp.sum(noise_mask.astype(jnp.int32))
    return {
        "label": label,
        "n_kept": n_kept,
        "n_total": n_total,
        "noise_overflow": jnp.maximum(n_noise - noise_capacity, 0)
        + (re["overflow"] if noise_engine == "grid" else 0),
    }


@partial(jax.jit, static_argnames=("merge_eps", "merge_min_pts"))
def merge_centroid_clusters(
    centers_xy,
    center_valid,
    merge_eps: float,
    merge_min_pts: int = 2,
):
    """Centroid-distance cluster fusion mapping.

    centers_xy: [K+1, 2] cluster centroid X/Y table indexed by cluster id
    (row 0 unused). Runs DBSCAN over the valid centroids with the reference's
    L1-on-(X,Y) metric (Tools.cs:586-592 copies X/Y into motor coords before
    calling DBImproved), eps=merge_eps, minPts=merge_min_pts.

    Returns dict:
      remap   i32[K+1] old id -> new dense id (0 stays 0)
      n_after i32[] cluster count after fusion
    """
    kp1 = centers_xy.shape[0]
    ids = jnp.arange(kp1, dtype=jnp.int32)
    valid = center_valid & (ids > 0)
    if kp1 > 8192:
        # the stored [K, K] adjacency is 17 GB at the tier-5 id-table
        # width (64k); the tile-recompute engine is bit-identical
        from .dbscan import dbscan_dense_chunked

        comp = dbscan_dense_chunked(centers_xy, valid, merge_eps,
                                    merge_min_pts, "l1_motor")
    else:
        comp = dbscan_padded(centers_xy, valid, merge_eps, merge_min_pts,
                             "l1_motor")
    glab = comp["label"]  # group label per centroid, 0 = unmerged
    # target old id per group: min member id (the group's first centroid,
    # Tools.cs:594-606); unmerged centroids target themselves
    group_min = jax.ops.segment_min(
        jnp.where(valid & (glab > 0), ids, kp1), glab, num_segments=kp1
    )
    target = jnp.where(valid & (glab > 0), group_min[glab], ids)
    survivor = valid & (target == ids)
    new_id = jnp.cumsum(survivor.astype(jnp.int32))  # dense 1..K' at survivors
    remap = jnp.where(valid, new_id[target], 0).astype(jnp.int32)
    remap = remap.at[0].set(0)
    return {"remap": remap, "n_after": jnp.sum(survivor.astype(jnp.int32))}
