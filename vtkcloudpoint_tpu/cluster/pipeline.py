"""End-to-end single-chip clustering pipeline.

The data-parallel equivalent of the reference's heavy compute job (call stack
SURVEY.md §3.2): partition -> per-block DBSCAN -> cross-block fusion ->
optional centroid merge -> centroids + circumcircles -> radius/aspect
rejection. Entirely on-device; the reference's ThreadPool fan-out + poll
barrier (FrmMain.cs:1340-1399) becomes one XLA program.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import EngineConfig
from ..ops.metrics import coords_for_metric
from ..ops.segment import cluster_stats, bucket_payload_by_cluster
from ..ops.geometry import cluster_shapes
from .blocks import (
    assign_blocks_reference, gather_blocks, partition_gather_sorted,
)
from .dbscan import dbscan_blocks_dispatch
from .fusion import merge_blocks, merge_centroid_clusters


class ClusterResult(NamedTuple):
    label: jax.Array          # i32[N] global cluster ids (0 noise)
    n_clusters: jax.Array     # i32[]
    count: jax.Array          # i32[K+1] per-cluster point counts
    center3d: jax.Array       # f[K+1,3]
    center2d: jax.Array       # f[K+1,2]
    radius3d: jax.Array       # f[K+1] circumradius over (X, Y)
    radius2d: jax.Array       # f[K+1] circumradius over motor coords
    aspect: jax.Array         # f[K+1] min-rect long/short side ratio
    block_overflow: jax.Array # i32[] points dropped by block capacity
    noise_overflow: jax.Array # i32[]


def cluster_scan(
    xyz,
    motor,
    valid,
    cfg: EngineConfig = EngineConfig(),
    *,
    mode: str = "reference",       # "reference" grid | "balanced" morton
    max_blocks: int = 256,
    quirks: bool = True,
    noise_capacity: int = 2048,
    max_clusters: int = 1024,
    cluster_capacity: int = 1024,
    max_hull: int = 64,
    centroid_merge: bool = False,
    halo_merge: bool = False,
    halo_cap: int = 64,
    backend: str = "auto",
):
    """Cluster one scan. Returns ClusterResult.

    halo_merge=True runs the principled cross-block union-find
    (cluster.halo_fusion) after the reference-style fusion, unifying
    clusters split across block boundaries -- a beyond-reference
    correctness upgrade (disable for bit-parity runs).

    All capacity knobs are static; overflow counters report any truncation.
    """
    n = xyz.shape[0]
    cc = cfg.cluster
    coords = coords_for_metric(xyz, motor, cc.metric)

    if mode == "reference":
        part = assign_blocks_reference(motor, valid, cc.pts_in_cell)
        block_coords, block_valid, point_index, overflow = gather_blocks(
            coords, part["block"], valid, max_blocks, cc.block_capacity
        )
    else:
        # one Morton-keyed multi-operand sort = partition + blocked layout
        # (no argsort + row gather; see blocks.partition_gather_sorted)
        block_coords, block_valid, point_index, overflow = (
            partition_gather_sorted(
                motor, valid, cc.block_capacity, max_blocks, coords=coords
            )
        )

    db = dbscan_blocks_dispatch(
        block_coords, block_valid, cc.eps, cc.min_pts, cc.metric,
        max_iters=cc.propagate_max_iters, backend=backend,
    )

    noise_capacity = min(noise_capacity, max_blocks * cc.block_capacity)
    fused = merge_blocks(
        db["label"], block_valid, block_coords, point_index, n,
        cc.eps, cc.min_pts, cc.metric,
        min_cluster_size=cc.min_cluster_size,
        quirks=quirks,
        noise_capacity=noise_capacity,
    )
    label = fused["label"]
    n_clusters = fused["n_total"]

    if halo_merge:
        from .halo_fusion import halo_merge_labels, apply_halo_merge

        safe_pi = jnp.clip(point_index, 0, n - 1)
        block_glabels = jnp.where(
            point_index >= 0, label[safe_pi], 0
        )
        hm = halo_merge_labels(
            block_coords, block_valid, block_glabels, db["core"],
            n_clusters, cc.eps, cc.metric,
            halo_cap=halo_cap, max_ids=max_clusters,
        )
        label = apply_halo_merge(label, hm["remap"])
        n_clusters = hm["n_after"]

    stats = cluster_stats(xyz, motor, label, valid, max_clusters)

    if centroid_merge:
        center_valid = stats["count"] > 0
        mg = merge_centroid_clusters(
            stats["center3d"][:, :2], center_valid,
            cc.merge_threshold, cc.merge_min_pts,
        )
        label = mg["remap"][jnp.clip(label, 0, max_clusters - 1)]
        n_clusters = mg["n_after"]
        stats = cluster_stats(xyz, motor, label, valid, max_clusters)

    # circumcircles: 3D (X, Y) and 2D motor variants (FrmMain.cs:1539-1540)
    # -- both coordinate systems ride one payload sort + one batched [2K]
    # shapes call (the index-table + per-cluster gather formulation costs
    # two ~N-element random-access ops; see
    # segment.bucket_payload_by_cluster)
    pay = (xyz[:, 0], xyz[:, 1], motor[:, 0], motor[:, 1])
    tabs, tval, runs, _ = bucket_payload_by_cluster(
        label, valid, pay, max_clusters, cluster_capacity)
    both = jnp.concatenate([tabs[..., 0:2], tabs[..., 2:4]], axis=0)
    bval = jnp.concatenate([tval, tval], axis=0)
    bcnt = jnp.concatenate([runs, runs], axis=0)
    sh = cluster_shapes(both, bval, bcnt, max_hull=max_hull,
                        min_points=cfg.filters.circle_min_points)

    return ClusterResult(
        label=label,
        n_clusters=n_clusters,
        count=stats["count"],
        center3d=stats["center3d"],
        center2d=stats["center2d"],
        radius3d=sh["radius"][:max_clusters],
        radius2d=sh["radius"][max_clusters:],
        aspect=sh["aspect"][:max_clusters],
        block_overflow=jnp.sum(overflow),
        noise_overflow=fused["noise_overflow"],
    )


def reject_clusters(result: ClusterResult, valid, radius_threshold: float,
                    aspect_threshold: float = 1e30):
    """Radius/aspect cluster rejection (FrmMain.cs:1905-1920, MCC.cs:24-80):
    clusters whose 3D circumradius exceeds the threshold (or min-rect aspect
    exceeds aspect_threshold) are removed wholesale -- their points drop out
    of the valid mask, ids are NOT renumbered (Tools.cs:70-74 just deletes).

    Returns (new_valid, rejected_mask [K+1])."""
    rejected = (result.radius3d > radius_threshold) | (
        result.aspect > aspect_threshold
    )
    rejected = rejected & (result.count > 0)
    point_rejected = rejected[jnp.clip(result.label, 0, rejected.shape[0] - 1)]
    return valid & ~point_rejected, rejected


def single_block_dbscan(xyz, motor, valid, cfg: EngineConfig = EngineConfig()):
    """Tier-1 path: whole scan as one block == plain reference DBSCAN
    (bit-compatible ids, no blocking effects)."""
    from .dbscan import dbscan_padded

    coords = coords_for_metric(xyz, motor, cfg.cluster.metric)
    return dbscan_padded(
        coords, valid, cfg.cluster.eps, cfg.cluster.min_pts, cfg.cluster.metric
    )
