"""Per-cluster segment reductions: counts, centroids (3D + motor 2D), weighted
centroids with duplicate multiplicity.

Data-parallel replacement for the reference's per-cluster list scans
(Tools.getClusterCenter / GetClusList, Tools.cs:118-195; weighted fixed-point
centroid getFixedPtsCentroid, Tools.cs:78-111): one segment_sum over the whole
point set instead of per-cluster Average() passes.

Cluster id convention matches the reference: label 0 = noise; clusters are
1..K. Segment tables are laid out with row c = cluster id c (row 0 collects
noise and is ignored by callers).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def indicator_segment_sum(values, seg, num_segments: int,
                          chunk: int = 8192, int32_tail: int = 0):
    """segment-sum as one-hot matmuls instead of a scatter-add.

    Exact: indicator entries are 0/1, products are the original f32
    values, accumulation is f32 (HIGHEST keeps the matmul out of reduced
    precision -- TF32 on a GPU).

    ``int32_tail``: the last that-many columns accumulate ACROSS chunks in
    int32 instead of f32. A count column accumulated in f32 saturates at
    2^24 (x+1 == x) -- real at 50M-point tier-5 clouds. Per-chunk partial
    sums are <= chunk << 2^24, hence exact in f32 before the cast.

    values: [N, D]; seg: i32[N] in [0, num_segments] -- ids ==
    num_segments are dropped (sentinel). Returns [num_segments, D] when
    int32_tail == 0, else ([num_segments, D - tail] f32,
    [num_segments, tail] i32).
    """
    n, d = values.shape
    chunk = min(chunk, max(n, 1))
    pad = (-n) % chunk
    vals = jnp.pad(values, ((0, pad), (0, 0)))
    sg = jnp.pad(seg, (0, pad), constant_values=num_segments)
    ids = jnp.arange(num_segments, dtype=sg.dtype)
    split = d - int32_tail

    def step(acc, args):
        lb, vl = args
        oh = (lb[None, :] == ids[:, None]).astype(values.dtype)
        out = jax.lax.dot(
            oh, vl, precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=values.dtype,
        )
        if int32_tail:
            acc_f, acc_i = acc
            return (acc_f + out[:, :split],
                    acc_i + out[:, split:].astype(jnp.int32)), None
        return acc + out, None

    if int32_tail:
        acc0 = (jnp.zeros((num_segments, split), values.dtype),
                jnp.zeros((num_segments, int32_tail), jnp.int32))
    else:
        acc0 = jnp.zeros((num_segments, d), values.dtype)
    out, _ = jax.lax.scan(
        step, acc0, (sg.reshape(-1, chunk), vals.reshape(-1, chunk, d))
    )
    return out


def cluster_counts(label, valid, num_segments: int):
    """Point count per cluster id. [num_segments] with row 0 = noise.

    Exact at any size: the count column accumulates in int32 across chunks
    (a pure-f32 accumulator silently pins at 2^24 = 16,777,216)."""
    w = valid.astype(jnp.float32)[:, None]
    seg = jnp.where(valid, label, num_segments)
    return indicator_segment_sum(w, seg, num_segments, int32_tail=1)[1][:, 0]


def cluster_means(values, label, valid, num_segments: int, weights=None):
    """Per-cluster mean of ``values`` [N, D] -> [num_segments, D].

    weights: optional i32/f32 [N] multiplicity (reference ptsCount,
    Tools.cs:92-101). Empty clusters return 0.
    """
    w = valid.astype(values.dtype)
    if weights is not None:
        w = w * weights.astype(values.dtype)
    seg = jnp.where(valid, label, num_segments)
    both = indicator_segment_sum(
        jnp.concatenate([values * w[:, None], w[:, None]], axis=1),
        seg, num_segments)
    sums, cnt = both[:, :-1], both[:, -1]
    return sums / jnp.maximum(cnt, 1)[:, None], cnt


@partial(jax.jit, static_argnames=("num_segments",))
def cluster_stats(xyz, motor, label, valid, num_segments: int, mult=None):
    """All reference centroid tables in one pass (ONE indicator matmul).

    Returns dict:
      count    i32[K+1]  points per cluster (row 0 = noise)
      center3d f[K+1,3]  mean xyz        (Tools.cs:189 centers)
      center2d f[K+1,2]  mean motor      (Tools.cs:190 centers2D)
    """
    dt = xyz.dtype
    w = valid.astype(dt)
    if mult is not None:
        w = w * mult.astype(dt)
    seg = jnp.where(valid, label, num_segments)
    cols = jnp.concatenate(
        [xyz * w[:, None], motor * w[:, None], w[:, None],
         valid.astype(dt)[:, None]], axis=1)           # [N, 7]
    # last column = the point count: int32-accumulated so it stays exact
    # past 2^24 points per cluster (tier-5 50M-point clouds)
    sums, cnt_i = indicator_segment_sum(cols, seg, num_segments,
                                        int32_tail=1)
    wcnt = sums[:, 5]
    inv = 1.0 / jnp.maximum(wcnt, 1)
    return {
        "count": cnt_i[:, 0],
        "weighted_count": wcnt,
        "center3d": sums[:, :3] * inv[:, None],
        "center2d": sums[:, 3:5] * inv[:, None],
    }


def bucket_payload_by_cluster(label, valid, payload, num_segments: int,
                              capacity: int):
    """Per-cluster padded PAYLOAD tables from one sort.

    A stable sort by cluster id carries the payload along; each point's
    (cluster, rank) slot is then written by one scatter. (Cutting each
    cluster's row as a window of the sorted payload instead measured 5%
    slower on the H100 at the bench shape.)

    label: i32[N]; valid: bool[N]; payload: f32[N, P] or a tuple of f32[N]
    columns (the tuple form never materializes an [N, P] array). Returns
    (tables [num_segments, capacity, P] -- zeros in empty slots --,
    slot_valid [num_segments, capacity], counts i32[num_segments],
    overflow i32[num_segments]). Slot order within each cluster is
    ascending point index, same contract as bucket_by_cluster.
    """
    cols = (tuple(payload[:, i] for i in range(payload.shape[1]))
            if not isinstance(payload, (tuple, list)) else tuple(payload))
    p = len(cols)
    n = label.shape[0]
    dtype = cols[0].dtype
    total = num_segments * capacity
    lab = jnp.where(valid, label, num_segments).astype(jnp.int32)
    sorted_ops = jax.lax.sort((lab,) + cols, num_keys=1, is_stable=True)
    sorted_lab = sorted_ops[0]
    first = jnp.searchsorted(sorted_lab, jnp.arange(num_segments + 1))
    run = (first[1:] - first[:-1]).astype(jnp.int32)
    idx = jnp.arange(n, dtype=jnp.int32)
    rank = idx - first[jnp.clip(sorted_lab, 0, num_segments)].astype(
        jnp.int32)
    in_cap = (rank < capacity) & (sorted_lab < num_segments)
    flat = jnp.where(
        in_cap,
        sorted_lab * capacity + jnp.clip(rank, 0, capacity - 1),
        total,
    )
    sorted_pay = jnp.stack(sorted_ops[1:], axis=-1)
    tables = (
        jnp.zeros((total, p), dtype)
        .at[flat].set(sorted_pay, mode="drop")
        .reshape(num_segments, capacity, p)
    )
    slot_valid = (jnp.arange(capacity)[None, :]
                  < jnp.minimum(run, capacity)[:, None])
    return tables, slot_valid, run, jnp.maximum(run - capacity, 0)


def bucket_by_cluster(label, valid, num_segments: int, capacity: int):
    """Build a per-cluster point-index table [num_segments, capacity].

    Used to hand per-cluster padded point sets to the geometry kernels
    (hull/MEC/min-rect). Entries are point indices; -1 = empty slot. Points
    beyond ``capacity`` per cluster are dropped and counted in ``overflow``
    (fixed-capacity discipline, SURVEY.md §7 hard part (e)).

    Slot order within each cluster is ascending point index (stable), which
    matches the reference's list order after its per-cell processing.
    """
    n = label.shape[0]
    lab = jnp.where(valid, label, num_segments)  # invalid -> out of range
    # stable sort by label; ranks within each label run
    order = jnp.argsort(lab, stable=True)
    sorted_lab = lab[order]
    idx = jnp.arange(n, dtype=jnp.int32)
    # start position of each label's run
    first_of_lab = jnp.searchsorted(sorted_lab, jnp.arange(num_segments + 1), side="left")
    rank = idx - first_of_lab[jnp.clip(sorted_lab, 0, num_segments)]
    in_cap = (rank < capacity) & (sorted_lab < num_segments)
    table = jnp.full((num_segments, capacity), -1, dtype=jnp.int32)
    flat = jnp.where(
        in_cap,
        jnp.clip(sorted_lab, 0, num_segments - 1) * capacity + jnp.clip(rank, 0, capacity - 1),
        num_segments * capacity,  # dropped
    )
    table = (
        table.reshape(-1)
        .at[flat]
        .set(order.astype(jnp.int32), mode="drop")
        .reshape(num_segments, capacity)
    )
    counts = cluster_counts(label, valid, num_segments)
    overflow = jnp.maximum(counts - capacity, 0)
    return table, overflow
