"""Grid-hash nearest-neighbor correspondence: the VTK point-locator
replacement for large ICP targets.

The reference's production ICP finds correspondences through a native VTK
point locator inside vtkIterativeClosestPointTransform
(vtk/include/vtk-5.0/vtkIterativeClosestPointTransform.h:49-183). The
brute-force tiled NN (register.icp.nn_correspond) is O(N*M) -- right for
centroid-sized targets, fatal for scan-to-map at 10^6-10^7 map points
(SURVEY.md §7 hard part (d)). This module bins the target once into
cell_size-sized cells; each query inspects its 27-cell stencil.

Exactness contract (tested vs brute force):
- if the best stencil candidate lies within cell_size AND no stencil cell
  overflowed cell_cap, it is provably the global NN (any point outside the
  stencil differs by > cell_size in some coordinate);
- all other queries are "unresolved" and fall back to exact brute force,
  up to ``fallback_cap`` of them per call (static shape). Overflow beyond
  that is counted and those queries keep their (possibly inexact) stencil
  result with resolved=False, so callers can drop them (trimmed ICP) or
  re-run with bigger caps.

Everything is static-shape and jit/scan-safe: the grid is a NamedTuple of
arrays, queries run in fixed chunks.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

_INT_MAX = 2**31 - 1

# 27-cell stencil offsets in (dx, dy, dz) cell units
_OFFS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
         for dz in (-1, 0, 1)]


class NNGrid(NamedTuple):
    pts: jax.Array        # [M, 3] target points sorted by cell id
    valid: jax.Array      # [M] sorted validity
    sc: jax.Array         # [M] i32 sorted cell ids (invalid -> INT_MAX)
    order: jax.Array      # [M] i32 sorted position -> original index
    origin: jax.Array     # [3] grid origin (min corner)
    dims: jax.Array       # [3] i32 cell counts per axis (interior)
    strides: jax.Array    # [2] i32 (stride_x, stride_y); stride_z == 1


def _cell_ids(pts, origin, dims, strides, cell_size):
    """i32 cell id per point; coordinates clamp to one ghost layer around the
    grid so out-of-range queries stay collision-free (ids unique on
    [-1, dims+1] per axis)."""
    c = jnp.floor((pts - origin[None, :]) / cell_size).astype(jnp.int32)
    c = jnp.clip(c, -1, dims[None, :] + 1)
    return ((c[:, 0] + 1) * strides[0]
            + (c[:, 1] + 1) * strides[1]
            + (c[:, 2] + 1))


def build_nn_grid(ref, ref_valid, cell_size: float) -> NNGrid:
    """Sort the target by eps-cell (one-time O(M log M) build)."""
    big = jnp.asarray(1e30, ref.dtype)
    lo = jnp.min(jnp.where(ref_valid[:, None], ref, big), axis=0)
    hi = jnp.max(jnp.where(ref_valid[:, None], ref, -big), axis=0)
    dims = jnp.floor((hi - lo) / cell_size).astype(jnp.int32) + 1
    dims = jnp.maximum(dims, 1)
    # strides over the padded (+3 per axis: 2 ghost layers + clamp slot) box;
    # int32 budget: (dx+3)(dy+3)(dz+3) must stay < 2^31
    sy = dims[2] + 3
    sx = (dims[1] + 3) * sy
    strides = jnp.stack([sx, sy])
    cell = _cell_ids(ref, lo, dims, strides, cell_size)
    cell = jnp.where(ref_valid, cell, _INT_MAX)
    order = jnp.argsort(cell, stable=True).astype(jnp.int32)
    return NNGrid(
        pts=ref[order],
        valid=ref_valid[order],
        sc=cell[order],
        order=order,
        origin=lo,
        dims=dims,
        strides=strides,
    )


def _brute_direct(query, ref, ref_valid, chunk: int):
    """Exact NN by direct differences, tiled over query chunks.

    Returns (idx i32[N], d2 f[N]). Used as the grid fallback; accurate to
    f32 rounding of the true distance (no expansion cancellation).

    The working set is capped at ~256 MB regardless of the requested
    chunk: the naive [chunk, M, 3] diff tensor is 12 GB at chunk=1024 and
    M=1M -- an allocation that exhausts device memory. The per-axis
    accumulation keeps peak memory at one [chunk, M] block.
    """
    n, d = query.shape
    m = ref.shape[0]
    chunk = max(8, min(chunk, max(8, (1 << 26) // max(m, 1))))
    pad = (-n) % chunk
    qp = jnp.pad(query, ((0, pad), (0, 0)))

    def one(q):
        d2 = jnp.zeros((q.shape[0], m), ref.dtype)
        for k in range(d):
            diff = q[:, k:k + 1] - ref[None, :, k]
            d2 = d2 + diff * diff
        d2 = jnp.where(ref_valid[None, :], d2, jnp.inf)
        idx = jnp.argmin(d2, axis=1)
        return (idx.astype(jnp.int32),
                jnp.take_along_axis(d2, idx[:, None], axis=1)[:, 0])

    idx, d2 = jax.lax.map(one, qp.reshape(-1, chunk, d))
    return idx.reshape(-1)[:n], d2.reshape(-1)[:n]


@partial(jax.jit, static_argnames=("cell_size", "cell_cap", "chunk"))
def _stencil_query(grid: NNGrid, query, cell_size: float, cell_cap: int,
                   chunk: int):
    """Best candidate within the 27-cell stencil per query.

    Returns (idx_orig i32[N], d2 f[N], resolved bool[N]): resolved means the
    result is provably the exact global NN.
    """
    n = query.shape[0]
    m = grid.pts.shape[0]
    qc = jnp.floor(
        (query - grid.origin[None, :]) / cell_size
    ).astype(jnp.int32)
    qc = jnp.clip(qc, -1, grid.dims[None, :] + 1)
    sx, sy = grid.strides[0], grid.strides[1]
    base = (qc[:, 0] + 1) * sx + (qc[:, 1] + 1) * sy + (qc[:, 2] + 1)
    offs = (jnp.asarray([o[0] for o in _OFFS], jnp.int32) * sx
            + jnp.asarray([o[1] for o in _OFFS], jnp.int32) * sy
            + jnp.asarray([o[2] for o in _OFFS], jnp.int32))
    want = base[:, None] + offs[None, :]                     # [N, 27]

    k_idx = jnp.arange(cell_cap, dtype=jnp.int32)
    pad = (-n) % chunk
    qpad = jnp.pad(query, ((0, pad), (0, 0)))
    wpad = jnp.pad(want, ((0, pad), (0, 0)))

    def one(args):
        q, w = args                                          # [c,3], [c,27]
        st = jnp.searchsorted(grid.sc, w.reshape(-1)).reshape(w.shape)
        en = jnp.searchsorted(grid.sc, w.reshape(-1) + 1).reshape(w.shape)
        overflow = jnp.any((en - st) > cell_cap, axis=1)     # [c]
        raw = st[:, :, None] + k_idx[None, None, :]          # [c, 27, cap]
        in_cell = raw < en[:, :, None]
        cand = jnp.minimum(raw, m - 1).reshape(q.shape[0], -1)
        ok = (in_cell.reshape(q.shape[0], -1)
              & grid.valid[cand])
        diff = q[:, None, :] - grid.pts[cand]
        d2 = jnp.sum(diff * diff, axis=-1)
        d2 = jnp.where(ok, d2, jnp.inf)
        best = jnp.argmin(d2, axis=1)
        bd2 = jnp.take_along_axis(d2, best[:, None], axis=1)[:, 0]
        bidx = jnp.take_along_axis(cand, best[:, None], axis=1)[:, 0]
        resolved = (bd2 <= cell_size * cell_size) & ~overflow
        return grid.order[bidx], bd2, resolved

    idx, d2, resolved = jax.lax.map(
        one, (qpad.reshape(-1, chunk, 3), wpad.reshape(-1, chunk, 27))
    )
    return (idx.reshape(-1)[:n], d2.reshape(-1)[:n],
            resolved.reshape(-1)[:n])


def nn_grid(grid: NNGrid, query, ref, ref_valid, cell_size: float,
            cell_cap: int = 16, fallback_cap: int = 1024,
            chunk: int = 4096, bf_chunk: int = 1024):
    """Exact NN against a pre-built grid, with brute-force fallback.

    ref/ref_valid are the ORIGINAL (unsorted) target arrays the grid was
    built from (for the fallback path and index space). Returns
    (idx i32[N], d2 f[N], resolved bool[N], n_unresolved_overflow i32[]).
    resolved[i] is True iff idx[i]/d2[i] is the exact global NN.
    """
    n = query.shape[0]
    idx, d2, resolved = _stencil_query(grid, query, cell_size, cell_cap,
                                       min(chunk, max(n, 1)))
    if fallback_cap <= 0:
        overflow = jnp.sum(~resolved, dtype=jnp.int32)
        return idx.astype(jnp.int32), d2, resolved, overflow

    # exact brute-force pass over up to fallback_cap unresolved queries.
    # Direct differences, not the |a|^2-2ab+|b|^2 expansion: the fallback
    # must be at least as accurate as the stencil path it backs up.
    fb = min(fallback_cap, n)
    sel = jnp.argsort(jnp.where(resolved, 1, 0), stable=True)[:fb]
    sel_unres = ~resolved[sel]
    qfb = query[sel]
    fidx, fd2 = _brute_direct(qfb, ref, ref_valid, min(bf_chunk, fb))
    idx = idx.at[sel].set(jnp.where(sel_unres, fidx, idx[sel]))
    d2 = d2.at[sel].set(jnp.where(sel_unres, fd2.astype(d2.dtype), d2[sel]))
    resolved = resolved.at[sel].set(True)
    overflow = jnp.sum(~resolved, dtype=jnp.int32)
    return idx.astype(jnp.int32), d2, resolved, overflow


@partial(jax.jit, static_argnames=("cfg", "cell_size", "cell_cap",
                                   "fallback_cap", "chunk"))
def icp_grid(
    source,
    source_valid,
    target,
    target_valid,
    cfg=None,
    cell_size: float = 1.0,
    cell_cap: int = 16,
    fallback_cap: int = 1024,
    chunk: int = 4096,
    r0=None,
    t0=None,
):
    """ICP with grid-hash correspondence: the large-target registration path
    (tier 3/4: scan-to-map at 10^6+ map points).

    Identical loop to register.icp.icp, but the target grid builds ONCE and
    every iteration queries it in O(N * 27 * cell_cap) instead of O(N * M).
    Unresolved-beyond-fallback queries drop out of the solve that iteration
    (weight 0 -- trimmed ICP); with fallback_cap >= #unresolved the
    transform equals brute-force ICP exactly.
    """
    from ..config import ICPConfig
    from ..ops import se3

    if cfg is None:
        cfg = ICPConfig()
    dtype = source.dtype
    grid = build_nn_grid(target, target_valid, cell_size)

    if r0 is None:
        r0 = jnp.eye(3, dtype=dtype)
    if t0 is None:
        if cfg.start_by_matching_centroids:
            w_src = source_valid.astype(dtype)
            w_tgt = target_valid.astype(dtype)
            mean_s = jnp.sum(source * w_src[:, None], 0) / jnp.maximum(
                jnp.sum(w_src), 1.0)
            mean_t = jnp.sum(target * w_tgt[:, None], 0) / jnp.maximum(
                jnp.sum(w_tgt), 1.0)
            t0 = mean_t - jnp.matmul(r0, mean_s,
                                     precision=jax.lax.Precision.HIGHEST)
        else:
            t0 = jnp.zeros(3, dtype)

    solve = se3.horn_solve if cfg.solver == "horn" else se3.kabsch_solve

    def body(state):
        r, t, prev_d, it, _, _ = state
        p = se3.apply_rigid(r, t, source)
        idx, d2, resolved, overflow = nn_grid(
            grid, p, target, target_valid, cell_size,
            cell_cap=cell_cap, fallback_cap=fallback_cap, chunk=chunk,
        )
        w = (source_valid & resolved).astype(dtype)
        y = target[idx]
        d = jnp.sum(jnp.where(w > 0, d2, 0.0))
        r1, t1 = solve(p, y, weights=w)
        r_new, t_new = se3.compose(r1, t1, r, t)
        converged = jnp.abs(d - prev_d) < cfg.tol
        return r_new, t_new, d, it + 1, converged, overflow

    def cond(state):
        return (~state[4]) & (state[3] < cfg.max_iterations)

    init = (r0, t0, jnp.inf, jnp.int32(0), jnp.array(False), jnp.int32(0))
    r, t, d, it, converged, overflow = jax.lax.while_loop(cond, body, init)
    from .icp import ICPResult

    return ICPResult(r=r, t=t, error=d, iterations=it,
                     converged=converged), overflow
