"""DBSCAN as data-parallel label propagation.

The reference clusters with a sequential BFS (DBImproved.cs:56-114). Here it
is reformulated as fixpoint label propagation + pointer jumping, which is
embarrassingly parallel and converges in O(log diameter) sweeps -- then a
deterministic renumbering pass reproduces the reference's exact ID assignment
(SURVEY.md §7 L3 hard part (a)).

Reference-ID-compatibility contract (derived from DBImproved.cs semantics,
validated against the sequential oracle in tests/test_dbscan.py):

1. A point is core iff its eps-neighborhood count (INCLUDING itself,
   DBImproved.cs:37-47) is >= minPts.
2. Core points within eps of each other are one cluster (BFS closure).
3. Cluster ids are assigned in scan order of each component's first core
   point, starting at cf+1 (DBImproved.cs:107: ``cf++`` at each new seed).
4. A non-core point within eps of cores from several clusters ends with the
   LARGEST such cluster id: expandCluster unconditionally overwrites
   clusterId for every touched neighbor (DBImproved.cs:87), and clusters
   expand in ascending id order, so the last writer has the max id.
5. Points in no core's neighborhood keep label 0 (noise).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..ops.metrics import pairwise


def _min_label_fixpoint(core_adj, core, max_iters: int):
    """Min-index label propagation with pointer jumping over the core graph.

    core_adj: [n, n] bool, symmetric, core-core eps-adjacency.
    Returns root[i] = min point index in i's core component (n for non-core).
    """
    n = core.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    inf = jnp.int32(n)
    lab0 = jnp.where(core, idx, inf)

    def body(state):
        lab, _, it = state
        # sweep: min over core neighbors' labels
        nbr = jnp.where(core_adj, lab[None, :], inf)
        new = jnp.minimum(lab, jnp.min(nbr, axis=1))
        # pointer jump: follow the label chain one hop (log-time shortcut)
        jumped = new[jnp.clip(new, 0, n - 1)]
        new = jnp.where(new < inf, jnp.minimum(new, jumped), inf)
        return new, jnp.any(new != lab), it + 1

    def cond(state):
        return state[1] & (state[2] < max_iters)

    # Seed the loop with one eager body step so the carry's varying-axis type
    # matches under shard_map (a literal True init is unvarying and rejected).
    lab1, changed1, it1 = body((lab0, None, jnp.int32(0)))
    lab, _, _ = jax.lax.while_loop(cond, body, (lab1, changed1, it1))
    return lab


def dbscan_padded(
    coords: jax.Array,
    valid: jax.Array,
    eps: float,
    min_pts: int,
    metric: str = "l1_motor",
    cf=0,
    max_iters: int = 64,
):
    """DBSCAN over one padded point block.

    Args:
      coords: [cap, D] metric coordinates (see ops.metrics.coords_for_metric).
      valid:  [cap] bool padding mask.
      cf:     starting cluster-id seed (reference DBImproved.cf,
              FrmMain.cs:1509 continued numbering).

    Returns dict with:
      label      i32[cap]  cluster ids (cf+1..cf+k), 0 noise/invalid
      n_clusters i32[]     number of clusters created
      core       bool[cap]
    """
    cap = coords.shape[0]
    dist = pairwise(coords, coords, metric)
    adj = (dist <= eps) & valid[None, :] & valid[:, None]
    counts = jnp.sum(adj, axis=1, dtype=jnp.int32)
    core = (counts >= min_pts) & valid

    core_adj = adj & core[None, :] & core[:, None]
    root = _min_label_fixpoint(core_adj, core, max_iters)

    idx = jnp.arange(cap, dtype=jnp.int32)
    is_root = core & (root == idx)
    # scan-order rank of each component root, 1-based
    rank = jnp.cumsum(is_root.astype(jnp.int32))
    core_id = jnp.where(core, cf + rank[jnp.clip(root, 0, cap - 1)], 0)

    # border points: max id over adjacent cores (rule 4)
    border_src = jnp.where(adj & core[None, :], core_id[None, :], 0)
    border_id = jnp.max(border_src, axis=1)

    label = jnp.where(core, core_id, jnp.where(valid, border_id, 0)).astype(jnp.int32)
    return {
        "label": label,
        "n_clusters": jnp.sum(is_root.astype(jnp.int32)),
        "core": core,
    }


def dbscan_dense_chunked(
    coords: jax.Array,
    valid: jax.Array,
    eps: float,
    min_pts: int,
    metric: str = "l1_motor",
    cf=0,
    chunk: int = 2048,
    max_iters: int = 64,
):
    """dbscan_padded semantics at sizes where the [n, n] adjacency cannot
    be stored (4 GB at n=32k): every pass recomputes pairwise distances in
    [chunk, n] row tiles instead of gathering through a grid.

    Every sweep is dense vector work with no gathers. Sweep count is
    O(log diameter) thanks to pointer jumping, so total work is
    ~(2 + log d) full distance passes. Bit-identical to dbscan_padded
    (same rules 1-5, same label convention); tested against it in
    tests/test_dbscan.py.
    """
    n = coords.shape[0]
    chunk = min(chunk, n)
    pad = (-n) % chunk
    pos = (jnp.arange(n + pad) % jnp.maximum(n, 1)).reshape(-1, chunk)
    inf = jnp.int32(n)
    idx = jnp.arange(n, dtype=jnp.int32)

    def row_reduce(fn):
        """Map fn(adj_rows [chunk, n], rows) over row chunks -> [n]."""

        def one(p_slice):
            d = pairwise(coords[p_slice], coords, metric)
            adj = (d <= eps) & valid[p_slice][:, None] & valid[None, :]
            return fn(adj, p_slice)

        return jax.lax.map(one, pos).reshape(-1)[:n]

    counts = row_reduce(
        lambda adj, p: jnp.sum(adj, axis=1, dtype=jnp.int32))
    core = (counts >= min_pts) & valid
    lab0 = jnp.where(core, idx, inf)

    def sweep(lab):
        nbr = row_reduce(lambda adj, p: jnp.min(
            jnp.where(adj & core[None, :], lab[None, :], inf), axis=1))
        new = jnp.where(core, jnp.minimum(lab, nbr), inf)
        jumped = new[jnp.clip(new, 0, n - 1)]
        return jnp.where(new < inf, jnp.minimum(new, jumped), inf)

    def body(state):
        lab, _, it = state
        new = sweep(lab)
        return new, jnp.any(new != lab), it + 1

    lab1 = sweep(lab0)
    lab, _, _ = jax.lax.while_loop(
        lambda s: s[1] & (s[2] < max_iters), body,
        (lab1, jnp.any(lab1 != lab0), jnp.int32(1)))

    is_root = core & (lab == idx)
    rank = jnp.cumsum(is_root.astype(jnp.int32))
    core_id = jnp.where(core, cf + rank[jnp.clip(lab, 0, n - 1)], 0)
    border = row_reduce(lambda adj, p: jnp.max(
        jnp.where(adj & core[None, :], core_id[None, :], 0), axis=1))
    label = jnp.where(core, core_id,
                      jnp.where(valid, border, 0)).astype(jnp.int32)
    return {
        "label": label,
        "n_clusters": jnp.sum(is_root.astype(jnp.int32)),
        "core": core,
    }


def dbscan_matlab_convention(data, min_pts: int, eps: float):
    """External-clusterer API shim: Data2Cluster.DoDbscan.dbscan replacement.

    The reference's MATLAB plugin (C21, FrmMain.cs:2796-2828, Tools.cs:636)
    takes [N, 2] rows with (minPts, eps) in THAT order and returns a label
    row vector with -1 = noise, ids 1..K. Metric is Euclidean (MATLAB
    dbscan default), unlike the L1-motor production path.
    """
    data = jnp.asarray(data)
    n = data.shape[0]
    out = dbscan_padded(data, jnp.ones(n, bool), eps, min_pts, "l2_xyz")
    lab = out["label"]
    return jnp.where(lab == 0, -1, lab), out["n_clusters"]


@partial(jax.jit, static_argnames=("eps", "min_pts", "metric", "max_iters", "chunk"))
def dbscan_blocks(
    coords: jax.Array,
    valid: jax.Array,
    eps: float,
    min_pts: int,
    metric: str = "l1_motor",
    max_iters: int = 64,
    chunk: int = 64,
):
    """Run DBSCAN independently over B padded blocks.

    Data-parallel analog of the reference's per-cell ThreadPool fan-out
    (FrmMain.cs:1340-1361, StartCode :2782-2794): each block clusters with
    local ids 1..k_b; the cross-block merge assigns global ids (fusion.py).

    coords: [B, cap, D]; valid: [B, cap]. Processed in chunks of ``chunk``
    blocks to bound the [chunk, cap, cap] adjacency working set.
    """

    def one(args):
        c, v = args
        out = dbscan_padded(c, v, eps, min_pts, metric, 0, max_iters)
        return out["label"], out["n_clusters"], out["core"]

    labels, counts, cores = jax.lax.map(one, (coords, valid), batch_size=chunk)
    return {"label": labels, "n_clusters": counts, "core": cores}


def resolve_backend(backend: str = "auto") -> str:
    """Per-block DBSCAN engine: "cuda" (the Hopper kernel) or "jnp".

    "auto" takes the platform policy's choice (the kernel on a GPU, the
    plain path on a CPU). An explicit "cuda" on a machine without a GPU
    raises: the kernel has no interpret mode and no silent fallback.
    """
    if backend == "auto":
        from ..policy import policy

        return policy().dbscan_blocks
    if backend not in ("cuda", "jnp"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "cuda" and jax.default_backend() != "gpu":
        raise RuntimeError("backend='cuda' needs a GPU; this process runs "
                           f"on {jax.default_backend()!r}")
    return backend


def dbscan_blocks_dispatch(
    coords,
    valid,
    eps: float,
    min_pts: int,
    metric: str = "l1_motor",
    max_iters: int = 64,
    chunk: int = 64,
    backend: str = "auto",
):
    """Backend-dispatched per-block DBSCAN, same contract as dbscan_blocks.

    The CUDA kernel (cluster.dbscan_cuda) serves float32 2-D blocks of
    capacity <= 1024 under l1_motor and signed_sum_xy and is bit-equal to
    the plain path there; "auto" sends any other block shape or metric
    (l2_xyz's distance goes through a matmul whose summation order the
    kernel cannot reproduce) to the plain path, an explicit "cuda" raises.
    The kernel runs every block to its fixpoint; ``max_iters`` and
    ``chunk`` bound the plain path only.
    """
    engine = resolve_backend(backend)
    if engine == "cuda":
        from .dbscan_cuda import dbscan_blocks_cuda, kernel_supports

        _, cap, nd = coords.shape
        if backend == "cuda" or kernel_supports(cap, nd, metric,
                                                coords.dtype):
            return dbscan_blocks_cuda(coords, valid, eps, min_pts, metric)
    return dbscan_blocks(coords, valid, eps, min_pts, metric, max_iters, chunk)
