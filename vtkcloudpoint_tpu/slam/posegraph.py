"""Pose-graph optimization over scan poses (Gauss-Newton).

BASELINE.json tier-4 extension ("sequential 100-scan trajectory: scan-to-map
ICP + pose-graph optimization") -- no reference analog (the reference is
single-scan by design, SURVEY.md §6).

Poses are world-from-scan SE(3) (rotvec + translation). Edges carry measured
relative transforms (from ICP). The residual for edge (i, j):

    R_rel = R_i^T R_j,  t_rel = R_i^T (t_j - t_i)
    e_rot = log(R_meas^T R_rel),  e_t = t_rel - t_meas

plus a gauge prior pinning pose 0. Gauss-Newton with Levenberg damping; the
normal equations are dense (6S x 6S; S <= a few hundred scans) and solved
replicated. Jacobians come from jacfwd -- XLA unrolls the small per-edge
chains into vector code. The JtJ assembly is a plain matmul, which is the
piece that psum-reduces across hosts when residual blocks shard (tier 5).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import se3

_HI = jax.lax.Precision.HIGHEST


class PoseGraph(NamedTuple):
    edge_i: jax.Array    # i32[E]
    edge_j: jax.Array    # i32[E]
    r_meas: jax.Array    # f[E,3,3] measured R_ij
    t_meas: jax.Array    # f[E,3]
    weight: jax.Array    # f[E] information weight


def _residuals(rots, trans, graph: PoseGraph):
    """Edge residuals for absolute poses (rots [S,3,3], trans [S,3])."""

    def edge_res(i, j, rm, tm, w):
        mm = lambda a, b: jnp.matmul(a, b,
                                     precision=jax.lax.Precision.HIGHEST)
        ri = rots[i]
        rj = rots[j]
        r_rel = mm(ri.T, rj)
        t_rel = mm(ri.T, (trans[j] - trans[i]))
        e_rot = se3.so3_log(mm(rm.T, r_rel))
        e_t = t_rel - tm
        return jnp.sqrt(w) * jnp.concatenate([e_rot, e_t])

    return jax.vmap(edge_res)(
        graph.edge_i, graph.edge_j, graph.r_meas, graph.t_meas, graph.weight
    ).reshape(-1)


@partial(jax.jit, static_argnames=("iterations",))
def optimize_pose_graph(
    rot0,
    t0,
    graph: PoseGraph,
    iterations: int = 10,
    damping: float = 1e-6,
):
    """On-manifold Gauss-Newton pose-graph solve.

    Each iteration linearizes in LOCAL increments (R_i <- R_i exp(dw_i),
    t_i <- t_i + dt_i), so the rotation parametrization is always evaluated
    near zero -- no rotation-vector singularity at theta = pi, and the
    jacfwd jacobians stay finite. Pose 0 is gauge-fixed by a strong prior on
    its increment.

    Returns (R [S,3,3], t [S,3], final_cost).
    """
    s = rot0.shape[0]
    dtype = rot0.dtype

    def res_of_delta(dx, rots, trans):
        dw = dx[: 3 * s].reshape(s, 3)
        dt = dx[3 * s:].reshape(s, 3)
        r_new = jnp.einsum("sab,sbc->sac", rots, jax.vmap(se3.so3_exp)(dw),
                           precision=_HI)
        t_new = trans + dt
        res = _residuals(r_new, t_new, graph)
        anchor = dx[jnp.array([0, 1, 2, 3 * s, 3 * s + 1, 3 * s + 2])] * 1e3
        return jnp.concatenate([res, anchor])

    def gn_step(carry, _):
        rots, trans = carry
        zero = jnp.zeros(6 * s, dtype)
        r0 = res_of_delta(zero, rots, trans)
        jmat = jax.jacfwd(res_of_delta)(zero, rots, trans)
        h = (jnp.matmul(jmat.T, jmat, precision=_HI)
             + damping * jnp.eye(6 * s, dtype=dtype))
        dx = -jnp.linalg.solve(h, jnp.matmul(jmat.T, r0, precision=_HI))
        dw = dx[: 3 * s].reshape(s, 3)
        dt = dx[3 * s:].reshape(s, 3)
        rots = jnp.einsum("sab,sbc->sac", rots, jax.vmap(se3.so3_exp)(dw),
                          precision=_HI)
        trans = trans + dt
        return (rots, trans), jnp.sum(r0 * r0)

    (r_out, t_out), _ = jax.lax.scan(
        gn_step, (rot0, t0), None, length=iterations
    )
    final_cost = jnp.sum(_residuals(r_out, t_out, graph) ** 2)
    return r_out, t_out, final_cost


def absolute_trajectory_error(r_est, t_est, r_true, t_true):
    """ATE-trans RMSE after SE(3) alignment of the two trajectories
    (the BASELINE.json acceptance metric)."""
    r_align, t_align = se3.kabsch_solve(t_est, t_true)
    aligned = jnp.matmul(t_est, r_align.T, precision=_HI) + t_align
    return jnp.sqrt(jnp.mean(jnp.sum((aligned - t_true) ** 2, axis=-1)))
