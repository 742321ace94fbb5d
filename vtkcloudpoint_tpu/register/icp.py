"""Iterative Closest Point registration.

Replaces both reference ICP paths with one engine:
- production native path: vtkIterativeClosestPointTransform with rigid-body
  landmark solve, StartByMatchingCentroidsOn, 100-iteration cap
  (FrmMain.cs:841-907)
- managed path: Horn quaternion loop with |d - pre_d| < e convergence on the
  summed squared correspondence distance (ICP.cs:18-181)

Design: correspondence search is a tiled brute-force NN (the cross term of
the distance expansion is one matmul at Precision.HIGHEST); the closed-form
SE(3) solve is Horn (eigh) or Kabsch (svd); the whole loop runs on-device
under jax.lax.while_loop, so no data crosses to the host per iteration
(only the loop predicate, on a GPU; the reference crosses the managed/
native boundary every call, FrmMain.cs:851-862).

Multi-start extension (BASELINE.json tier 3): vmap the loop over a bank of
initial rotations and keep the lowest final error -- addresses the README's
admitted checkerboard local-minimum failure mode.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import ICPConfig
from ..ops.metrics import pairwise_sqdist
from ..ops import se3


class ICPResult(NamedTuple):
    r: jax.Array         # [3,3] rotation
    t: jax.Array         # [3]   translation
    error: jax.Array     # final summed squared correspondence distance
    iterations: jax.Array
    converged: jax.Array


def nn_correspond(query, ref, ref_valid, chunk: int = 2048):
    """Nearest valid reference point for each query point.

    Returns (idx i32[N], sqdist f[N]); ties go to the lowest reference
    index (argmin's first minimum, the reference's sequential scan
    ICP.cs:235-245). Tiled over query chunks so the [N, M] distance matrix
    never materializes fully (SURVEY.md C18 FindClosestPointSet / the VTK
    point-locator role).
    """
    n = query.shape[0]
    bad = jnp.where(ref_valid, 0.0, jnp.inf)

    def one(q):
        d2 = pairwise_sqdist(q, ref) + bad[None, :]
        idx = jnp.argmin(d2, axis=1)
        return idx.astype(jnp.int32), jnp.take_along_axis(d2, idx[:, None], axis=1)[:, 0]

    if n <= chunk:
        return one(query)
    pad_n = (-n) % chunk
    qp = jnp.pad(query, ((0, pad_n), (0, 0)))
    idx, d2 = jax.lax.map(one, qp.reshape(-1, chunk, 3))
    return idx.reshape(-1)[:n], d2.reshape(-1)[:n]


@partial(jax.jit, static_argnames=("cfg", "chunk"))
def icp(
    source,
    source_valid,
    target,
    target_valid,
    cfg: ICPConfig = ICPConfig(),
    r0=None,
    t0=None,
    chunk: int = 2048,
):
    """Register source onto target: find (R, t) with target ~= R source + t.

    source/target: [N,3]/[M,3] padded; *_valid masks.
    """
    dtype = source.dtype
    w_src = source_valid.astype(dtype)
    n_src = jnp.maximum(jnp.sum(w_src), 1.0)

    if r0 is None:
        r0 = jnp.eye(3, dtype=dtype)
    if t0 is None:
        if cfg.start_by_matching_centroids:
            mean_s = jnp.sum(source * w_src[:, None], 0) / n_src
            w_tgt = target_valid.astype(dtype)
            mean_t = jnp.sum(target * w_tgt[:, None], 0) / jnp.maximum(
                jnp.sum(w_tgt), 1.0
            )
            t0 = mean_t - jnp.matmul(r0, mean_s, precision=jax.lax.Precision.HIGHEST)
        else:
            t0 = jnp.zeros(3, dtype=dtype)

    solve = se3.horn_solve if cfg.solver == "horn" else se3.kabsch_solve

    def body(state):
        r, t, prev_d, _, it, _ = state
        p = se3.apply_rigid(r, t, source)
        idx, _ = nn_correspond(p, target, target_valid, chunk)
        y = target[idx]
        # the error from each matched pair's own difference (as
        # parallel.sharded.sharded_icp does): the expansion nn_correspond
        # ranks by is off by ~|p|^2 ulp per pair, as large as the
        # residuals of a converged fit
        d2 = jnp.sum((p - y) ** 2, axis=1)
        d = jnp.sum(jnp.where(source_valid, d2, 0.0))
        r1, t1 = solve(p, y, weights=w_src)
        r_new, t_new = se3.compose(r1, t1, r, t)
        converged = jnp.abs(d - prev_d) < cfg.tol
        return r_new, t_new, d, d, it + 1, converged

    def cond(state):
        _, _, _, _, it, converged = state
        return (~converged) & (it < cfg.max_iterations)

    init = (r0, t0, jnp.inf, jnp.inf, jnp.int32(0), jnp.array(False))
    r, t, d, _, it, converged = jax.lax.while_loop(cond, body, init)
    return ICPResult(r=r, t=t, error=d, iterations=it, converged=converged)


@partial(jax.jit, static_argnames=("iters", "chunk"))
def ransac_init(
    source,
    source_valid,
    target,
    target_valid,
    inlier_threshold: float,
    iters: int = 64,
    key=None,
    chunk: int = 2048,
):
    """Congruent-pair RANSAC for a rigid 2D-dominant init (tier-3 extension;
    addresses the reference README's checkerboard local-minimum admission).

    Each hypothesis samples a source pair and a target pair, derives the
    z-rotation + translation mapping one onto the other, and scores by the
    number of source points whose NN lands within ``inlier_threshold``.
    Returns (r0, t0, best_inliers). Refine with icp(r0=..., t0=...).
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    n = source.shape[0]
    m = target.shape[0]
    dtype = source.dtype
    w_src = source_valid.astype(dtype)

    def hypothesis(k):
        ks, kt = jax.random.split(k)
        si = jax.random.choice(ks, n, (2,), p=w_src / jnp.sum(w_src))
        tj = jax.random.choice(
            kt, m, (2,),
            p=target_valid.astype(dtype) / jnp.sum(target_valid.astype(dtype)),
        )
        s1, s2 = source[si[0]], source[si[1]]
        t1, t2 = target[tj[0]], target[tj[1]]
        ang = jnp.arctan2(t2[1] - t1[1], t2[0] - t1[0]) - jnp.arctan2(
            s2[1] - s1[1], s2[0] - s1[0]
        )
        r = se3.rotz(ang).astype(dtype)
        t = t1 - jnp.matmul(r, s1, precision=jax.lax.Precision.HIGHEST)
        # length congruence gate: mismatched pair lengths score 0
        len_ok = jnp.abs(
            jnp.linalg.norm(s2 - s1) - jnp.linalg.norm(t2 - t1)
        ) < 2.0 * inlier_threshold
        moved = se3.apply_rigid(r, t, source)
        _, d2 = nn_correspond(moved, target, target_valid, chunk)
        inliers = jnp.sum(
            jnp.where(
                source_valid & (d2 < inlier_threshold**2), 1.0, 0.0
            )
        )
        return r, t, jnp.where(len_ok, inliers, 0.0)

    rs, ts, scores = jax.lax.map(hypothesis, jax.random.split(key, iters))
    best = jnp.argmax(scores)
    return rs[best], ts[best], scores[best]


@partial(jax.jit, static_argnames=("cfg", "chunk"))
def icp_ransac(
    source,
    source_valid,
    target,
    target_valid,
    cfg: ICPConfig = ICPConfig(),
    key=None,
    chunk: int = 2048,
):
    """RANSAC init + ICP refine (cfg.ransac_iters hypotheses)."""
    r0, t0, _ = ransac_init(
        source, source_valid, target, target_valid,
        cfg.ransac_inlier_threshold, max(int(cfg.ransac_iters), 1), key,
        chunk,
    )
    return icp(source, source_valid, target, target_valid, cfg,
               r0=r0, t0=t0, chunk=chunk)


@partial(jax.jit, static_argnames=("cfg", "chunk"))
def icp_multistart(
    source,
    source_valid,
    target,
    target_valid,
    cfg: ICPConfig = ICPConfig(),
    key=None,
    chunk: int = 2048,
):
    """Multi-start ICP: cfg.num_starts initial rotations (identity + uniform
    z-spins + random), keep the lowest-error run."""
    k = max(int(cfg.num_starts), 1)
    if k == 1:
        return icp(source, source_valid, target, target_valid, cfg,
                   chunk=chunk)
    dtype = source.dtype
    n_z = (k + 1) // 2
    thetas = jnp.arange(n_z, dtype=dtype) * (2.0 * jnp.pi / max(n_z, 1))
    rz = jax.vmap(se3.rotz)(thetas).astype(dtype)
    if key is None:
        key = jax.random.PRNGKey(0)
    rr = jax.vmap(se3.random_rotation)(jax.random.split(key, k - n_z)).astype(dtype)
    r0s = jnp.concatenate([rz, rr], axis=0)

    def run(r0):
        return icp(source, source_valid, target, target_valid, cfg,
                   r0=r0, chunk=chunk)

    results = jax.lax.map(run, r0s)
    best = jnp.argmin(results.error)
    return ICPResult(*(jax.tree.map(lambda a: a[best], tuple(results))))
