"""Grid-hash DBSCAN: global clustering without block partitioning.

BASELINE.json tier-3 path (5M-pt scan, grid-hash neighbor kernels): instead
of the reference's block decomposition + fusion, bin points into eps-sized
cells and restrict every neighborhood scan to the 3^D surrounding cells --
the replacement for the VTK point locator (SURVEY.md "Native components"
item 3). Works for D=2 (motor coords, 9-cell stencil) and D=3 (xyz, 27-cell
stencil); the eps-cell stencil covers the eps-ball for both L1 and L2.

Design (static shapes throughout):
- cell ids are a MULTIPLICATIVE HASH of the integer cell coords (linear in
  the coords, so a stencil neighbor's id is own_id + a constant delta).
  Unlike a dense row-major id, the hash needs no int32 extent budget -- a
  50M-point 3D map at tiny eps has more cells than 2^31, which a dense id
  cannot address. Hash collisions are SAFE for exactness: a colliding far
  cell only adds candidates that the exact distance test rejects; the only
  cost is candidate-window occupancy, which the ``overflow`` counter already
  accounts (exact iff overflow == 0, same contract as before).
- points sort by cell hash; each point's 3^D neighbor cells resolve to start
  offsets with searchsorted; candidates are a fixed window of ``cell_cap``
  slots per neighbor cell, masked by cell-id equality. Points beyond
  cell_cap in an overfull cell still act as queries but stop being visible
  as candidates -- counted in ``overflow`` so callers can re-run with a
  bigger cap.
- core test, min-label propagation (original-index labels, so cluster ids
  keep the reference's scan-order semantics) with pointer jumping, then the
  same deterministic renumbering + max-id border rule as cluster.dbscan.
"""
from __future__ import annotations

from functools import partial
from itertools import product

import jax
import jax.numpy as jnp
import numpy as np

# odd multiplicative constants (Knuth/xxhash-style); int32 wraparound is
# two's-complement in XLA, and equal cell coords always hash equal, which is
# all correctness needs
_PRIMES = (-1640531535, -2048144789, -1028477387)  # 0x9E3779B1 etc. as i32
# independent second multiplier set for two-hash (Bloom-AND) membership
# tests: a cell only counts as occupied if BOTH hashed buckets are set, so
# the false-positive rate is the table load SQUARED (halo/skin boundary
# tests do 3^D lookups per point -- a single-hash table at 5% load turns
# into ~37% per-point false positives and floods the skin buffers)
_PRIMES2 = (-1898519407, -1376312589, -741103597)
# a NumPy scalar, not a jnp one: this module may first be imported while a
# jit is tracing, and a jnp value made then would be that trace's tracer
_MASK = np.int32(0x7FFFFFFE)  # keep ids in [0, 2^31-2]; INT_MAX = invalid


def _pair_dist(a, b, metric):
    if metric == "l1_motor":
        return jnp.sum(jnp.abs(a - b), axis=-1)
    if metric in ("l2_xy", "l2_xyz"):
        return jnp.sqrt(jnp.sum((a - b) ** 2, axis=-1))
    raise ValueError(f"grid mode does not support metric {metric!r}")


def grid_metric(metric: str, ndim: int):
    """The grid-engine metric name equivalent to ``metric`` on D-dim coords,
    or None when the metric has no grid form (signed_sum_xy is not a
    metric, so its eps-'ball' does not fit any stencil)."""
    if metric == "l1_motor":
        return "l1_motor"
    if metric == "l2_xyz":
        return "l2_xyz" if ndim == 3 else "l2_xy"
    if metric == "l2_xy":
        return "l2_xy"
    return None


@partial(
    jax.jit,
    static_argnames=("eps", "min_pts", "metric", "cell_cap", "max_iters"),
)
def dbscan_grid(
    coords,
    valid,
    eps: float,
    min_pts: int,
    metric: str = "l1_motor",
    cf=0,
    cell_cap: int = 32,
    max_iters: int = 64,
):
    """Grid-hash DBSCAN over one (large) point set.

    coords: [N, D] with D in (2, 3); valid: [N]. Returns dict(label,
    n_clusters, core, overflow) with the same id semantics as
    cluster.dbscan.dbscan_padded.
    """
    n, ndim = coords.shape
    if ndim not in (2, 3):
        raise ValueError(f"dbscan_grid supports D in (2, 3), got {ndim}")
    offsets = list(product((-1, 0, 1), repeat=ndim))     # 9 or 27, static
    self_idx = offsets.index((0,) * ndim)
    big = jnp.asarray(1e30, coords.dtype)
    lo = jnp.min(jnp.where(valid[:, None], coords, big), axis=0)
    c = jnp.floor((coords - lo[None, :]) / eps).astype(jnp.int32)

    # raw hash stays UNMASKED (int32 wraparound is linear), so a stencil
    # neighbor's id is (raw + static delta) & MASK == hash(c + offset);
    # masking before the add would break that identity (cleared carry bits)
    raw_h = jnp.zeros(n, jnp.int32)
    for ax in range(ndim):
        raw_h = raw_h + c[:, ax] * jnp.int32(_PRIMES[ax])
    def wrap32(v):  # two's-complement wrap of a Python int
        return ((v + 2**31) % 2**32) - 2**31

    deltas = [
        wrap32(sum(int(offsets[o][ax]) * _PRIMES[ax] for ax in range(ndim)))
        for o in range(len(offsets))
    ]
    own_h = raw_h & _MASK
    int_max = jnp.int32(2**31 - 1)
    cell = jnp.where(valid, own_h, int_max)

    order = jnp.argsort(cell, stable=True)          # sorted position -> orig
    sc = cell[order]                                # sorted cell ids
    pts_s = coords[order]
    valid_s = valid[order]

    # start offset of each point's 3^D neighbor cells
    nbr_cells = jnp.stack(
        [(raw_h + jnp.int32(d)) & _MASK for d in deltas], axis=1
    )[order]                                         # [N, 3^D] sorted order
    starts = jnp.searchsorted(sc, nbr_cells.reshape(-1)).reshape(
        n, len(offsets))

    k_idx = jnp.arange(cell_cap)
    my_orig = order

    def candidate_block(p_slice):
        """For sorted positions p in a chunk: candidate sorted indices
        [c, 3^D * cap] + validity mask."""
        st = starts[p_slice]                          # [c, 3^D]
        raw = st[:, :, None] + k_idx[None, None, :]   # [c, 3^D, cap]
        in_range = raw < n  # must mask BEFORE clamping: a clamped index
        cand = jnp.minimum(raw, n - 1)  # could alias the last point
        want = nbr_cells[p_slice][:, :, None]
        ok = (sc[cand] == want) & valid_s[cand] & in_range
        return cand.reshape(p_slice.shape[0], -1), ok.reshape(
            p_slice.shape[0], -1
        )

    chunk = 8192 if n > 8192 else n
    pad = (-n) % chunk
    pos = jnp.arange(n + pad) % jnp.maximum(n, 1)

    def counts_chunk(p_slice):
        cand, ok = candidate_block(p_slice)
        d = _pair_dist(pts_s[p_slice][:, None, :], pts_s[cand], metric)
        hit = ok & (d <= eps)
        return jnp.sum(hit, axis=1, dtype=jnp.int32)

    counts_s = jax.lax.map(
        counts_chunk, pos.reshape(-1, chunk)
    ).reshape(-1)[:n]
    core_s = (counts_s >= min_pts) & valid_s

    # overflow accounting: rank within own cell >= cap
    own_start = starts[:, self_idx]
    rank = jnp.arange(n) - own_start
    overflow = jnp.sum((rank >= cell_cap) & valid_s, dtype=jnp.int32)

    # ---- min-label propagation in ORIGINAL index space ----
    core_orig = jnp.zeros(n, bool).at[my_orig].set(core_s)
    idx = jnp.arange(n, dtype=jnp.int32)
    inf = jnp.int32(n)
    lab0 = jnp.where(core_orig, idx, inf)

    def sweep(lab):
        def chunk_min(p_slice):
            cand, ok = candidate_block(p_slice)
            d = _pair_dist(pts_s[p_slice][:, None, :], pts_s[cand], metric)
            adj = ok & (d <= eps) & core_s[cand]
            cand_lab = lab[my_orig[cand]]
            nl = jnp.min(jnp.where(adj, cand_lab, inf), axis=1)
            return nl

        nl_s = jax.lax.map(
            chunk_min, pos.reshape(-1, chunk)
        ).reshape(-1)[:n]
        nl = jnp.full(n, inf, jnp.int32).at[my_orig].set(nl_s)
        new = jnp.where(core_orig, jnp.minimum(lab, nl), inf)
        jumped = new[jnp.clip(new, 0, n - 1)]
        return jnp.where(new < inf, jnp.minimum(new, jumped), inf)

    def body(state):
        lab, _, it = state
        new = sweep(lab)
        return new, jnp.any(new != lab), it + 1

    def cond(state):
        return state[1] & (state[2] < max_iters)

    lab1 = sweep(lab0)
    lab, _, _ = jax.lax.while_loop(
        cond, body, (lab1, jnp.any(lab1 != lab0), jnp.int32(1))
    )

    # ---- renumber + border (same rules as dbscan_padded) ----
    is_root = core_orig & (lab == idx)
    rank_root = jnp.cumsum(is_root.astype(jnp.int32))
    core_id = jnp.where(core_orig, cf + rank_root[jnp.clip(lab, 0, n - 1)], 0)

    core_id_s = core_id[my_orig]

    def border_chunk(p_slice):
        cand, ok = candidate_block(p_slice)
        d = _pair_dist(pts_s[p_slice][:, None, :], pts_s[cand], metric)
        adj = ok & (d <= eps) & core_s[cand]
        return jnp.max(jnp.where(adj, core_id_s[cand], 0), axis=1)

    border_s = jax.lax.map(
        border_chunk, pos.reshape(-1, chunk)
    ).reshape(-1)[:n]
    border = jnp.zeros(n, jnp.int32).at[my_orig].set(border_s)

    label = jnp.where(
        core_orig, core_id, jnp.where(valid, border, 0)
    ).astype(jnp.int32)
    return {
        "label": label,
        "n_clusters": jnp.sum(is_root.astype(jnp.int32)),
        "core": core_orig,
        "overflow": overflow,
    }
