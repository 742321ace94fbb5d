"""Multi-scan trajectory registration: sequential scan-to-scan ICP odometry,
loop-closure detection, and pose-graph assembly.

BASELINE.json tier-4 pipeline: each scan registers to its predecessor (ICP
odometry edge); scans whose odometry positions come close again get a
loop-closure ICP edge; the pose graph then relaxes drift globally
(slam/posegraph.py).
"""
from __future__ import annotations

import os
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ICPConfig
from ..ops import se3
from ..register.icp import icp
from .posegraph import PoseGraph, optimize_pose_graph


class Trajectory(NamedTuple):
    r: jax.Array   # [S,3,3] world-from-scan rotations
    t: jax.Array   # [S,3]


def odometry_chain(scans, scan_valid, cfg: ICPConfig = ICPConfig()):
    """Register each scan to its predecessor.

    scans: [S, N, 3] padded; scan_valid: [S, N].
    Returns (relative (r_rel [S-1,3,3], t_rel [S-1,3]) with
    scan_{s} ~= r_rel[s] scan_{s+1} + t_rel[s], world Trajectory).
    """
    s = scans.shape[0]

    def pair(prev_next):
        prev, pv, nxt, nv = prev_next
        res = icp(nxt, nv, prev, pv, cfg)
        return res.r, res.t

    r_rel, t_rel = jax.lax.map(
        pair, (scans[:-1], scan_valid[:-1], scans[1:], scan_valid[1:])
    )

    def compose(carry, rel):
        rw, tw = carry
        rr, tr = rel
        # world_from_next = world_from_prev o prev_from_next (se3.compose:
        # HIGHEST-precision matmuls -- a reduced-precision default compounds
        # across S)
        rn, tn = se3.compose(rw, tw, rr, tr)
        return (rn, tn), (rn, tn)

    dt = scans.dtype
    (_, _), (r_acc, t_acc) = jax.lax.scan(
        compose, (jnp.eye(3, dtype=dt), jnp.zeros(3, dt)), (r_rel, t_rel)
    )
    r_world = jnp.concatenate([jnp.eye(3, dtype=dt)[None], r_acc])
    t_world = jnp.concatenate([jnp.zeros((1, 3), dt), t_acc])
    return (r_rel, t_rel), Trajectory(r_world, t_world)


def detect_loop_closures(traj: Trajectory, radius: float, min_separation: int = 5):
    """Scan pairs whose odometry positions are within ``radius`` and at
    least ``min_separation`` apart in sequence. Returns (i, j) arrays.

    The pair test runs on-device as one [S, S] mask (the O(S^2) Python loop
    of round 1 was the only host-side hot spot in the tier-4 chain); only
    the final nonzero extraction crosses to the host, because downstream
    closure_edges needs concrete pair counts to size its lax.map."""
    li, lj, mask = loop_closure_mask(traj.t, radius, min_separation)
    m = np.asarray(mask)
    return np.asarray(li)[m].astype(np.int32), np.asarray(lj)[m].astype(np.int32)


@partial(jax.jit, static_argnames=("min_separation",))
def loop_closure_mask(positions, radius: float, min_separation: int = 5):
    """Device-side all-pairs closure test. positions: [S, 3].

    Returns (ii [P], jj [P], mask [P]) with P = S*(S-1)/2 upper-triangle
    pairs in (i, j) lexicographic order -- fixed shapes, jit/scan-safe."""
    s = positions.shape[0]
    d2 = jnp.sum(
        (positions[:, None, :] - positions[None, :, :]) ** 2, axis=-1
    )
    ii, jj = jnp.triu_indices(s, k=1)
    mask = (jj - ii >= min_separation) & (d2[ii, jj] < radius * radius)
    return ii.astype(jnp.int32), jj.astype(jnp.int32), mask


def closure_edges(scans, scan_valid, traj: Trajectory, li, lj,
                  cfg: ICPConfig = ICPConfig()):
    """ICP each loop-closure pair (j registered onto i), initialized from the
    current odometry estimate. Returns (r_meas [L,3,3], t_meas [L,3])."""
    if len(li) == 0:
        dt = scans.dtype
        return jnp.zeros((0, 3, 3), dt), jnp.zeros((0, 3), dt)

    def one(args):
        i, j = args
        # init: i_from_j = world_from_i^{-1} o world_from_j
        ri = traj.r[i]
        ti = traj.t[i]
        rj = traj.r[j]
        tj = traj.t[j]
        r0 = jnp.matmul(ri.T, rj, precision=jax.lax.Precision.HIGHEST)
        t0 = jnp.matmul(ri.T, (tj - ti),
                        precision=jax.lax.Precision.HIGHEST)
        res = icp(scans[j], scan_valid[j], scans[i], scan_valid[i], cfg,
                  r0=r0, t0=t0)
        return res.r, res.t

    return jax.lax.map(one, (jnp.asarray(li), jnp.asarray(lj)))


def build_pose_graph(r_rel, t_rel, li, lj, r_loop, t_loop,
                     odom_weight: float = 1.0, loop_weight: float = 1.0):
    """Assemble odometry + loop edges into a PoseGraph.

    Convention: edge (i, j) stores i_from_j measurements (scan_i frame), so
    edge residuals compare against X_i^{-1} X_j.
    """
    s1 = r_rel.shape[0]
    dt = r_rel.dtype
    ei = jnp.concatenate([jnp.arange(s1, dtype=jnp.int32), jnp.asarray(li, jnp.int32)])
    ej = jnp.concatenate([jnp.arange(1, s1 + 1, dtype=jnp.int32),
                          jnp.asarray(lj, jnp.int32)])
    rm = jnp.concatenate([r_rel, r_loop]) if r_loop.shape[0] else r_rel
    tm = jnp.concatenate([t_rel, t_loop]) if t_loop.shape[0] else t_rel
    w = jnp.concatenate([
        jnp.full((s1,), odom_weight, dt),
        jnp.full((r_loop.shape[0],), loop_weight, dt),
    ])
    return PoseGraph(edge_i=ei, edge_j=ej, r_meas=rm, t_meas=tm, weight=w)


def slam_pipeline(scans, scan_valid, icp_cfg: ICPConfig = ICPConfig(),
                  loop_radius: float = 5.0, gn_iterations: int = 10,
                  damping: float = 1e-6):
    """Full tier-4 pipeline: odometry -> loop closures -> pose-graph solve
    (block-sparse GN, slam.ba)."""
    from .ba import optimize_pose_graph_sparse

    (r_rel, t_rel), traj = odometry_chain(scans, scan_valid, icp_cfg)
    li, lj = detect_loop_closures(traj, loop_radius)
    r_loop, t_loop = closure_edges(scans, scan_valid, traj, li, lj, icp_cfg)
    graph = build_pose_graph(r_rel, t_rel, li, lj, r_loop, t_loop)
    r_opt, t_opt, cost = optimize_pose_graph_sparse(
        traj.r, traj.t, graph, iterations=gn_iterations, damping=damping
    )
    return Trajectory(r_opt, t_opt), traj, cost


def odometry_chain_checkpointed(scans, scan_valid, manager,
                                cfg: ICPConfig = ICPConfig(),
                                every: int = 10, max_chunks=None):
    """Resumable odometry: ICP pair edges computed ``every`` at a time, each
    chunk checkpointed through a utils.checkpoint.CheckpointManager.

    Per-pair ICP edges are independent, so the chunked run is bit-identical
    to odometry_chain. On restart the latest checkpoint restores and work
    continues from the first uncomputed pair. ``max_chunks`` bounds how many
    chunks this CALL computes (a kill/preemption stand-in for tests).

    Returns ((r_rel, t_rel), n_done) -- n_done == S-1 means complete.
    """
    s = scans.shape[0]
    n_pairs = s - 1
    dt = scans.dtype
    template = (jnp.zeros((n_pairs, 3, 3), dt), jnp.zeros((n_pairs, 3), dt),
                jnp.zeros((), jnp.int32))
    state, _ = manager.restore_latest(template)
    if state is None:
        r_rel = jnp.tile(jnp.eye(3, dtype=dt)[None], (n_pairs, 1, 1))
        t_rel = jnp.zeros((n_pairs, 3), dt)
        done = 0
    else:
        r_rel, t_rel, done = state
        r_rel, t_rel, done = jnp.asarray(r_rel), jnp.asarray(t_rel), int(done)

    def pair(prev_next):
        prev, pv, nxt, nv = prev_next
        res = icp(nxt, nv, prev, pv, cfg)
        return res.r, res.t

    from ..utils.resilience import Heartbeat

    hb = Heartbeat(os.path.join(manager.directory, "heartbeat"))
    chunks = 0
    while done < n_pairs:
        if max_chunks is not None and chunks >= max_chunks:
            break
        end = min(done + every, n_pairs)
        rr, tr = jax.lax.map(
            pair,
            (scans[done:end], scan_valid[done:end],
             scans[done + 1:end + 1], scan_valid[done + 1:end + 1]),
        )
        r_rel = r_rel.at[done:end].set(rr)
        t_rel = t_rel.at[done:end].set(tr)
        done = end
        manager.save(done, (r_rel, t_rel, jnp.asarray(done, jnp.int32)))
        hb.beat(f"odometry {done}/{n_pairs}")
        chunks += 1
    return (r_rel, t_rel), done


def slam_pipeline_checkpointed(scans, scan_valid, ckpt_dir: str,
                               icp_cfg: ICPConfig = ICPConfig(),
                               every: int = 10, loop_radius: float = 5.0,
                               gn_iterations: int = 10, damping: float = 1e-6,
                               max_chunks=None):
    """slam_pipeline with save/resume through ``ckpt_dir`` (VERDICT r1
    item 9): odometry checkpoints every ``every`` pairs; a killed run picks
    up from the last checkpoint and the final trajectory is bit-identical
    to the uninterrupted pipeline.

    Returns None while interrupted (max_chunks hit before completion);
    otherwise (Trajectory optimized, Trajectory odometry, cost)."""
    from ..utils.checkpoint import CheckpointManager
    from .ba import optimize_pose_graph_sparse

    manager = CheckpointManager(ckpt_dir)
    (r_rel, t_rel), done = odometry_chain_checkpointed(
        scans, scan_valid, manager, icp_cfg, every, max_chunks)
    if done < scans.shape[0] - 1:
        return None

    def compose(carry, rel):
        rw, tw = carry
        rr, tr = rel
        rn, tn = se3.compose(rw, tw, rr, tr)
        return (rn, tn), (rn, tn)

    dt = scans.dtype
    (_, _), (r_acc, t_acc) = jax.lax.scan(
        compose, (jnp.eye(3, dtype=dt), jnp.zeros(3, dt)), (r_rel, t_rel)
    )
    traj = Trajectory(
        jnp.concatenate([jnp.eye(3, dtype=dt)[None], r_acc]),
        jnp.concatenate([jnp.zeros((1, 3), dt), t_acc]),
    )
    li, lj = detect_loop_closures(traj, loop_radius)
    r_loop, t_loop = closure_edges(scans, scan_valid, traj, li, lj, icp_cfg)
    graph = build_pose_graph(r_rel, t_rel, li, lj, r_loop, t_loop)
    r_opt, t_opt, cost = optimize_pose_graph_sparse(
        traj.r, traj.t, graph, iterations=gn_iterations, damping=damping
    )
    return Trajectory(r_opt, t_opt), traj, cost


def slam_pipeline_ba(scans, scan_valid, icp_cfg: ICPConfig = ICPConfig(),
                     loop_radius: float = 5.0, gn_iterations: int = 10,
                     damping: float = 1e-6, landmark_eps: float = 0.5,
                     landmark_min_pts: int = 5,
                     max_clusters_per_scan: int = 32,
                     ba_iterations: int = 8, ba_damping: float = 1e-4,
                     mesh=None):
    """Tier-4/5 pipeline with landmark refinement (VERDICT r2 item 6):
    odometry -> loop closures -> pose-graph GN -> cluster-centroid BA.

    After the pose-graph solve, per-scan cluster centroids become landmark
    observations (slam.ba.observations_from_scans) and a Schur-eliminated
    bundle adjustment polishes poses + landmarks jointly. With ``mesh`` the
    BA observations shard over the mesh (bundle_adjust_sharded, one psum of
    the Schur moments per iteration).

    Returns (Trajectory ba, Trajectory posegraph, Trajectory odometry,
    dict(graph_cost, ba_cost, n_landmarks)).
    """
    from .ba import (bundle_adjust, bundle_adjust_sharded,
                     observations_from_scans)

    opt, odo, cost = slam_pipeline(scans, scan_valid, icp_cfg, loop_radius,
                                   gn_iterations, damping)
    obs, lms0, n_lm = observations_from_scans(
        scans, scan_valid, opt.r, opt.t, landmark_eps, landmark_min_pts,
        max_clusters_per_scan)
    if mesh is not None:
        r_ba, t_ba, _, ba_cost = bundle_adjust_sharded(
            mesh, opt.r, opt.t, lms0, obs, iterations=ba_iterations,
            damping=ba_damping)
    else:
        r_ba, t_ba, _, ba_cost = bundle_adjust(
            opt.r, opt.t, lms0, obs, iterations=ba_iterations,
            damping=ba_damping)
    stats = {"graph_cost": cost, "ba_cost": ba_cost,
             "n_landmarks": n_lm}
    return Trajectory(r_ba, t_ba), opt, odo, stats
