"""Block-sparse distributed bundle adjustment / pose-graph Gauss-Newton.

The tier-5 solver (BASELINE.json north star: "pose-graph BA via
Schur-complement reduction over jax.lax collectives"). Replaces the dense
jacfwd in slam.posegraph.optimize_pose_graph with:

- per-edge 6x6 Jacobian blocks from LOCAL autodiff: each edge residual is a
  function of just its two poses' 12 increment dims, so jacfwd costs
  O(E * 6 * 12) instead of O(E * 6 * 6S) -- the block-sparse structure of
  JtJ is explicit, never materialized through a dense Jacobian;
- edge sharding over a device mesh: each device assembles the normal
  equations for its edge shard and ONE psum reduces (H, g); the 6S x 6S
  solve (S ~ 10^2 poses: tiny) is replicated -- the distributed-JtJ Schur
  recipe from SURVEY.md §2's parallelism table, last row;
- optional landmark (cluster-centroid) observations eliminated by Schur
  complement: H_ll is 3x3-block-diagonal, so the reduced camera system
  H_pp - H_pl H_ll^-1 H_lp assembles from psum'd moments and the landmark
  update back-substitutes locally.

Pose convention matches slam.posegraph: world-from-scan (R_s, t_s), edge
(i, j) measures i_from_j; local right perturbations R <- R exp(w),
t <- t + dt keep rotations away from the log singularity.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops import se3
from .posegraph import PoseGraph, _residuals

GAUGE_WEIGHT = 1e6  # prior stiffness pinning pose 0 (matches posegraph 1e3^2)


def _edge_residual_local(dxi, dxj, ri, ti, rj, tj, rm, tm, w):
    """Residual of one edge at local increments dxi/dxj in R^6 (w, t).

    All matmuls at HIGHEST precision: a reduced-precision default (TF32
    on a GPU, bf16 on some accelerators) puts ~1e-3 garbage into every
    residual through the rotation chains."""
    mm = lambda a, b: jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
    ri_new = mm(ri, se3.so3_exp(dxi[:3]))
    ti_new = ti + dxi[3:]
    rj_new = mm(rj, se3.so3_exp(dxj[:3]))
    tj_new = tj + dxj[3:]
    r_rel = mm(ri_new.T, rj_new)
    t_rel = mm(ri_new.T, (tj_new - ti_new))
    e_rot = se3.so3_log(mm(rm.T, r_rel))
    e_t = t_rel - tm
    return jnp.sqrt(w) * jnp.concatenate([e_rot, e_t])


def edge_blocks(rots, trans, graph: PoseGraph):
    """Per-edge residuals + 6x6 Jacobian blocks (local autodiff, vmapped).

    Returns (res [E,6], ji [E,6,6], jj [E,6,6]) with J evaluated at zero
    increments.
    """
    dtype = rots.dtype

    def one(i, j, rm, tm, w):
        ri, ti = rots[i], trans[i]
        rj, tj = rots[j], trans[j]
        zero = jnp.zeros(6, dtype)
        res = _edge_residual_local(zero, zero, ri, ti, rj, tj, rm, tm, w)
        ji = jax.jacfwd(_edge_residual_local, argnums=0)(
            zero, zero, ri, ti, rj, tj, rm, tm, w)
        jj = jax.jacfwd(_edge_residual_local, argnums=1)(
            zero, zero, ri, ti, rj, tj, rm, tm, w)
        return res, ji, jj

    return jax.vmap(one)(graph.edge_i, graph.edge_j, graph.r_meas,
                         graph.t_meas, graph.weight)


def assemble_normal_eqs(res, ji, jj, edge_i, edge_j, s: int):
    """Dense (H [6S,6S], g [6S]) from per-edge blocks via segment scatter.

    H = sum_e J_e^T J_e laid into (ii, jj, ij, ji) 6x6 blocks; the dense
    matrix is small (S ~ 10^2) -- the sparsity win is in never forming the
    [6E x 6S] Jacobian.
    """
    dtype = res.dtype
    hii = jnp.einsum("eab,eac->ebc", ji, ji, precision=jax.lax.Precision.HIGHEST)      # [E,6,6]
    hjj = jnp.einsum("eab,eac->ebc", jj, jj, precision=jax.lax.Precision.HIGHEST)
    hij = jnp.einsum("eab,eac->ebc", ji, jj, precision=jax.lax.Precision.HIGHEST)
    gi = jnp.einsum("eab,ea->eb", ji, res, precision=jax.lax.Precision.HIGHEST)
    gj = jnp.einsum("eab,ea->eb", jj, res, precision=jax.lax.Precision.HIGHEST)

    diag = (jax.ops.segment_sum(hii, edge_i, num_segments=s)
            + jax.ops.segment_sum(hjj, edge_j, num_segments=s))  # [S,6,6]
    g = (jax.ops.segment_sum(gi, edge_i, num_segments=s)
         + jax.ops.segment_sum(gj, edge_j, num_segments=s))      # [S,6]

    h = jnp.zeros((s, 6, s, 6), dtype)
    h = h.at[jnp.arange(s), :, jnp.arange(s), :].add(diag)
    h = h.at[edge_i, :, edge_j, :].add(hij)
    h = h.at[edge_j, :, edge_i, :].add(jnp.swapaxes(hij, 1, 2))
    return h.reshape(6 * s, 6 * s), g.reshape(6 * s)


def _apply_update(rots, trans, dx):
    s = rots.shape[0]
    dw = dx[: 6 * s].reshape(s, 6)[:, :3]
    dt = dx[: 6 * s].reshape(s, 6)[:, 3:]
    rots = jnp.einsum("sab,sbc->sac", rots, jax.vmap(se3.so3_exp)(dw), precision=jax.lax.Precision.HIGHEST)
    return rots, trans + dt


def _solve_spd(h, g):
    """f32-robust SPD solve: Jacobi equilibration + one iterative
    refinement step.

    The gauge prior (1e6) against O(1) edge rows gives H a condition
    number ~1e6 -- at f32's 1e-7 epsilon a raw solve loses most of its
    digits, and that once made the pose-graph stage WORSE than raw
    odometry. D^-1/2 H D^-1/2 drops the spread to the
    graph's intrinsic conditioning, and one refinement pass recovers the
    residual error. x64 CPU runs are unaffected (exact either way).
    """
    d = jnp.sqrt(jnp.maximum(jnp.diagonal(h), 1e-20))
    hs = h / (d[:, None] * d[None, :])
    gs = g / d
    x = jnp.linalg.solve(hs, gs)
    r = gs - hs @ x
    x = x + jnp.linalg.solve(hs, r)
    return x / d


@partial(jax.jit, static_argnames=("iterations",))
def optimize_pose_graph_sparse(
    rot0,
    t0,
    graph: PoseGraph,
    iterations: int = 10,
    damping: float = 1e-6,
):
    """Gauss-Newton with block-sparse assembly (single device).

    Same problem and minimum as posegraph.optimize_pose_graph; the Jacobian
    is computed per-edge instead of through one dense jacfwd.
    Returns (R [S,3,3], t [S,3], final_cost).
    """
    s = rot0.shape[0]
    dtype = rot0.dtype

    def gn_step(carry, _):
        rots, trans = carry
        res, ji, jj = edge_blocks(rots, trans, graph)
        h, g = assemble_normal_eqs(res, ji, jj, graph.edge_i, graph.edge_j, s)
        h = h.at[:6, :6].add(GAUGE_WEIGHT * jnp.eye(6, dtype=dtype))
        h = h + damping * jnp.eye(6 * s, dtype=dtype)
        dx = -_solve_spd(h, g)
        rots, trans = _apply_update(rots, trans, dx)
        return (rots, trans), jnp.sum(res * res)

    (r_out, t_out), _ = jax.lax.scan(gn_step, (rot0, t0), None,
                                     length=iterations)
    final_cost = jnp.sum(_residuals(r_out, t_out, graph) ** 2)
    return r_out, t_out, final_cost


def optimize_pose_graph_sharded(
    mesh: Mesh,
    rot0,
    t0,
    graph: PoseGraph,
    iterations: int = 10,
    damping: float = 1e-6,
    axis: str = "blocks",
):
    """Distributed pose-graph GN: edges shard over the mesh, one psum per
    iteration reduces the (H, g) normal equations, the 6S solve replicates.

    Edges are zero-weight-padded to a multiple of the mesh size (a w=0 edge
    contributes exactly nothing to H and g). Result equals the single-device
    solve up to psum summation order.
    """
    s = rot0.shape[0]
    dtype = rot0.dtype
    ndev = mesh.shape[axis]
    e = graph.edge_i.shape[0]
    pad = (-e) % ndev
    # pad with weight-0 edges (0,0) measuring identity: sqrt(0) kills the
    # residual AND the measurement stays in SO(3) so so3_log never sees
    # garbage (0 * NaN would poison the psum)
    eye_pad = jnp.tile(jnp.eye(3, dtype=dtype)[None], (pad, 1, 1))
    gp = PoseGraph(
        edge_i=jnp.pad(graph.edge_i, (0, pad)),
        edge_j=jnp.pad(graph.edge_j, (0, pad)),
        r_meas=jnp.concatenate([graph.r_meas, eye_pad]) if pad else
        graph.r_meas,
        t_meas=jnp.pad(graph.t_meas, ((0, pad), (0, 0))),
        weight=jnp.pad(graph.weight, (0, pad)),
    )

    def fn(ei, ej, rm, tm, w, rots, trans):
        def gn_step(carry, _):
            rots, trans = carry
            res, ji, jj = edge_blocks(
                rots, trans, PoseGraph(ei, ej, rm, tm, w))
            h_loc, g_loc = assemble_normal_eqs(res, ji, jj, ei, ej, s)
            cost_loc = jnp.sum(res * res)
            h = jax.lax.psum(h_loc, axis)
            g = jax.lax.psum(g_loc, axis)
            cost = jax.lax.psum(cost_loc, axis)
            h = h.at[:6, :6].add(GAUGE_WEIGHT * jnp.eye(6, dtype=dtype))
            h = h + damping * jnp.eye(6 * s, dtype=dtype)
            dx = -_solve_spd(h, g)
            rots, trans = _apply_update(rots, trans, dx)
            return (rots, trans), cost

        (r_out, t_out), costs = jax.lax.scan(gn_step, (rots, trans), None,
                                             length=iterations)
        return r_out, t_out, costs[-1:]

    r_out, t_out, cost = jax.jit(
        shard_map(
            fn,
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P(), P()),
            out_specs=(P(), P(), P()),
        )
    )(gp.edge_i, gp.edge_j, gp.r_meas, gp.t_meas, gp.weight, rot0, t0)
    return r_out, t_out, cost[0]


# ---------------------------------------------------------------------------
# Landmark (centroid) bundle adjustment with Schur elimination
# ---------------------------------------------------------------------------

class Observations(NamedTuple):
    """Landmark observations: scan ``pose`` sees world landmark ``lm`` at
    scan-frame coordinates ``z`` (e.g. a cluster centroid in scan coords)."""

    pose: jax.Array    # i32[O]
    lm: jax.Array      # i32[O]
    z: jax.Array       # f[O,3]
    weight: jax.Array  # f[O]


def _obs_blocks(rots, trans, lms, obs: Observations):
    """Residual + analytic Jacobians for landmark observations.

    r = R_s^T (m_l - t_s) - z  (scan frame), with right-perturbed pose:
      dr/dw = [R^T (m - t)]_x     dr/dt = -R^T     dr/dm = R^T
    """
    def one(p, l, z, w):
        r_s, t_s, m = rots[p], trans[p], lms[l]
        local = jnp.matmul(r_s.T, (m - t_s), precision=jax.lax.Precision.HIGHEST)
        res = jnp.sqrt(w) * (local - z)
        # right-perturbation: d/dw [exp(-w)^ R^T (m - t)] = [R^T(m-t)]_x
        jw = se3.so3_hat(local)
        jp = jnp.sqrt(w) * jnp.concatenate([jw, -r_s.T], axis=1)  # [3,6]
        jl = jnp.sqrt(w) * r_s.T                                  # [3,3]
        return res, jp, jl

    return jax.vmap(one)(obs.pose, obs.lm, obs.z, obs.weight)


def ba_schur_step(rots, trans, lms, obs: Observations, damping: float,
                  axis: Optional[str] = None):
    """One GN step over (poses, landmarks) with landmark Schur elimination.

    With ``axis`` set (inside shard_map), observations are device-local and
    the moment matrices psum-reduce; otherwise single-device. Returns
    (rots, trans, lms, cost).
    """
    s = rots.shape[0]
    nl = lms.shape[0]
    dtype = rots.dtype
    res, jp, jl = _obs_blocks(rots, trans, lms, obs)

    # pose system moments
    hpp_blk = jnp.einsum("oab,oac->obc", jp, jp, precision=jax.lax.Precision.HIGHEST)                # [O,6,6]
    gp_blk = jnp.einsum("oab,oa->ob", jp, res, precision=jax.lax.Precision.HIGHEST)
    hpp_d = jax.ops.segment_sum(hpp_blk, obs.pose, num_segments=s)
    gp = jax.ops.segment_sum(gp_blk, obs.pose, num_segments=s)

    # landmark system (3x3 block diagonal)
    hll_blk = jnp.einsum("oab,oac->obc", jl, jl, precision=jax.lax.Precision.HIGHEST)
    gl_blk = jnp.einsum("oab,oa->ob", jl, res, precision=jax.lax.Precision.HIGHEST)
    hll = jax.ops.segment_sum(hll_blk, obs.lm, num_segments=nl)  # [L,3,3]
    gl = jax.ops.segment_sum(gl_blk, obs.lm, num_segments=nl)    # [L,3]

    # cross term H_pl as [S,6,L,3] dense moments (S, L small at tier scale)
    key = obs.pose * nl + obs.lm
    hpl_blk = jnp.einsum("oab,oac->obc", jp, jl, precision=jax.lax.Precision.HIGHEST)                 # [O,6,3]
    hpl = jax.ops.segment_sum(
        hpl_blk, key, num_segments=s * nl
    ).reshape(s, nl, 6, 3)
    cost = jnp.sum(res * res)

    if axis is not None:
        hpp_d = jax.lax.psum(hpp_d, axis)
        gp = jax.lax.psum(gp, axis)
        hll = jax.lax.psum(hll, axis)
        gl = jax.lax.psum(gl, axis)
        hpl = jax.lax.psum(hpl, axis)
        cost = jax.lax.psum(cost, axis)

    hll = hll + damping * jnp.eye(3, dtype=dtype)[None]
    hll_inv = jnp.linalg.inv(hll)                                # [L,3,3]

    # reduced camera system: Hred dxp = -(gp - Hpl Hll^-1 gl)
    w_mat = jnp.einsum("slab,lbc->slac", hpl, hll_inv, precision=jax.lax.Precision.HIGHEST)           # [S,L,6,3]
    schur = jnp.einsum("slac,tlbc->satb", w_mat, hpl, precision=jax.lax.Precision.HIGHEST)            # [S,6,S,6]
    hred = -schur
    hred = hred.at[jnp.arange(s), :, jnp.arange(s), :].add(hpp_d)
    hred = hred.reshape(6 * s, 6 * s)
    hred = hred.at[:6, :6].add(GAUGE_WEIGHT * jnp.eye(6, dtype=dtype))
    hred = hred + damping * jnp.eye(6 * s, dtype=dtype)
    gred = (gp - jnp.einsum("slac,lc->sa", w_mat, gl, precision=jax.lax.Precision.HIGHEST)).reshape(6 * s)
    dxp = -_solve_spd(hred, gred)

    # landmark back-substitution: dxl = -Hll^-1 (gl + Hlp dxp)
    dxp6 = dxp.reshape(s, 6)
    hlp_dxp = jnp.einsum("slab,sa->lb", hpl, dxp6, precision=jax.lax.Precision.HIGHEST)               # [L,3]
    dxl = -jnp.einsum("lab,lb->la", hll_inv, gl + hlp_dxp,
                      precision=jax.lax.Precision.HIGHEST)

    rots, trans = _apply_update(rots, trans, dxp)
    lms = lms + dxl
    return rots, trans, lms, cost


@partial(jax.jit, static_argnames=("iterations",))
def bundle_adjust(rot0, t0, lms0, obs: Observations,
                  iterations: int = 10, damping: float = 1e-4):
    """Pose + landmark bundle adjustment (single device, Schur-eliminated).

    Returns (R [S,3,3], t [S,3], landmarks [L,3], final_cost)."""

    def step(carry, _):
        rots, trans, lms = carry
        rots, trans, lms, cost = ba_schur_step(rots, trans, lms, obs,
                                               damping)
        return (rots, trans, lms), cost

    (r_out, t_out, l_out), costs = jax.lax.scan(
        step, (rot0, t0, lms0), None, length=iterations)
    res, _, _ = _obs_blocks(r_out, t_out, l_out, obs)
    return r_out, t_out, l_out, jnp.sum(res * res)


def bundle_adjust_sharded(mesh: Mesh, rot0, t0, lms0, obs: Observations,
                          iterations: int = 10, damping: float = 1e-4,
                          axis: str = "blocks"):
    """Distributed BA: observations shard over the mesh; per-iteration the
    (H_pp, H_pl, H_ll, g) moments psum-reduce and both the reduced camera
    solve and the landmark back-substitution run replicated. Zero-weight
    padding observations (added here if O % ndev != 0) are exact no-ops."""
    ndev = mesh.shape[axis]
    o = obs.pose.shape[0]
    pad = (-o) % ndev
    op = Observations(
        pose=jnp.pad(obs.pose, (0, pad)),
        lm=jnp.pad(obs.lm, (0, pad)),
        z=jnp.pad(obs.z, ((0, pad), (0, 0))),
        weight=jnp.pad(obs.weight, (0, pad)),
    )

    def fn(pose, lm, z, w, rots, trans, lms):
        obs_loc = Observations(pose, lm, z, w)

        def step(carry, _):
            rots, trans, lms = carry
            rots, trans, lms, cost = ba_schur_step(
                rots, trans, lms, obs_loc, damping, axis=axis)
            return (rots, trans, lms), cost

        (r_out, t_out, l_out), costs = jax.lax.scan(
            step, (rots, trans, lms), None, length=iterations)
        return r_out, t_out, l_out, costs[-1:]

    r_out, t_out, l_out, cost = jax.jit(
        shard_map(
            fn,
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis), P(), P(), P()),
            out_specs=(P(), P(), P(), P()),
        )
    )(op.pose, op.lm, op.z, op.weight, rot0, t0, lms0)
    return r_out, t_out, l_out, cost[0]


def observations_from_scans(scans, scan_valid, traj_r, traj_t,
                            eps: float, min_pts: int,
                            max_clusters_per_scan: int = 32,
                            assoc_eps: float = None,
                            assoc_cell_cap: int = 64):
    """Build landmark ``Observations`` from per-scan cluster centroids
    (VERDICT r2 item 6: the BA solver gets a pipeline).

    The reference's registration targets ARE cluster centroids (survey
    markers, FrmMain.cs:841-907); the BA extension treats each physical
    marker as a landmark observed by every scan that clusters it:

    1. each scan clusters independently (DBSCAN l2_xyz, the per-scan analog
       of C7) and reduces to <= max_clusters_per_scan centroids in SCAN
       frame (the observation z);
    2. centroids transform into world by the current trajectory estimate
       and associate by eps-connectivity (dbscan_grid over the S*K centroid
       cloud with min_pts=1: connected components = landmarks) --
       association reuses the exact grid engine, so two scans' views of one
       marker land in one component whenever the trajectory is within
       assoc_eps (default 4*eps) of the truth;
    3. landmark initial positions are the component means.

    Returns (Observations, lms0 [L_cap, 3], n_landmarks) with
    L_cap = S * max_clusters_per_scan + 1; invalid slots carry weight 0
    (exact no-ops in the BA normal equations).
    """
    from ..cluster.dbscan import dbscan_padded
    from ..cluster.grid import dbscan_grid
    from ..ops.segment import cluster_stats

    s, n, _ = scans.shape
    k = max_clusters_per_scan
    dtype = scans.dtype
    if assoc_eps is None:
        assoc_eps = 4.0 * eps

    def one_scan(args):
        scan, sv = args
        db = dbscan_padded(scan, sv, eps, min_pts, "l2_xyz")
        st = cluster_stats(scan, scan[:, :2], db["label"], sv, k + 1)
        return st["center3d"], st["count"] > 0

    cents, cval = jax.lax.map(one_scan, (scans, scan_valid))  # [S,K+1,..]
    cents = cents[:, 1:, :]                  # drop noise row -> [S,K,3]
    cval = cval[:, 1:]
    world = jnp.einsum("sab,skb->ska", traj_r, cents, precision=jax.lax.Precision.HIGHEST) + traj_t[:, None, :]

    flat_w = world.reshape(s * k, 3)
    flat_z = cents.reshape(s * k, 3)
    flat_v = cval.reshape(s * k)
    comp = dbscan_grid(flat_w, flat_v, assoc_eps, 1, "l2_xyz",
                       cell_cap=assoc_cell_cap)
    lm = comp["label"]                       # 1..L, 0 invalid
    l_cap = s * k + 1
    cnt = jax.ops.segment_sum(flat_v.astype(dtype), lm,
                              num_segments=l_cap)
    lm_sum = jax.ops.segment_sum(
        jnp.where(flat_v[:, None], flat_w, 0.0), lm, num_segments=l_cap)
    lms0 = lm_sum / jnp.maximum(cnt, 1.0)[:, None]
    obs = Observations(
        pose=jnp.repeat(jnp.arange(s, dtype=jnp.int32), k),
        lm=lm,
        z=flat_z,
        weight=flat_v.astype(dtype),
    )
    return obs, lms0, comp["n_clusters"]
