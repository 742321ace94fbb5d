"""Headline benchmark: one 500,000-point scan through the fused job, in
points/sec on one GPU.

The job is block-partitioned DBSCAN, cross-block fusion with the noise
re-cluster, cluster centroids, circumcircles in both coordinate systems
(3D and motor, FrmMain.cs:1539-1540) and centroid ICP to the targets
(BASELINE.md tier 2). It runs once per per-block DBSCAN engine -- the CUDA
kernel ("cuda") and the plain XLA path ("jnp") -- and the two must give
bit-equal labels, or the run fails. Prints stage lines on stderr and ONE
JSON line on stdout:

    {"metric": "dbscan_icp_points_per_sec_per_chip", "value": ...,
     "unit": "points/sec", "vs_baseline": ..., "device": {...}, ...}

Times are host walls around calls that end in block_until_ready: the
median of ``REPS`` calls after one warm-up call, whose time is reported as
compile time. ``value`` is the platform policy's engine (policy().
dbscan_blocks). vs_baseline divides by the sequential NumPy oracle's
throughput on a 20k-point slice of the same cloud, measured on this host
in the same run (the reference publishes no numbers).

Needs a GPU: exits non-zero on any other platform.
"""
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_POINTS = 500_000
# per-block DBSCAN work is O(N * cap); smaller caps multiply the
# cross-block split pieces fusion renumbers. BENCH_BLOCK_CAP measures
# other points.
BLOCK_CAP = int(os.environ.get("BENCH_BLOCK_CAP", 1024))
EPS = 0.004
MIN_PTS = 8
NOISE_CAP = 4096
N_TRUTH = 512
MAX_CLUSTERS = int(os.environ.get("BENCH_MAX_CLUSTERS", 1024))
CLUSTER_CAP = int(os.environ.get("BENCH_CLUSTER_CAP", 1024))
MAX_HULL = 32
REPS = 10


def synthetic_cloud(n, seed=0, noise_frac=0.006):
    """Dense blob field: ~n points, small noise fraction so the noise
    re-cluster fits its capacity (matches the reference's intended regime --
    most points belong to clusters).

    k=450 blobs so that n_total AFTER cross-block splits (~2.1x, the
    reference's own behavior without its optional merges) stays under
    MAX_CLUSTERS: a k=600 cloud produced 1136 ids against 1024-row tables,
    silently dropping ~112 clusters' stats/shape rows -- the run now
    FAILS when n_clusters > MAX_CLUSTERS.
    """
    rng = np.random.default_rng(seed)
    n_noise = int(n * noise_frac)
    n_clustered = n - n_noise
    k = 450
    centers = rng.uniform(0.02, 0.98, size=(k, 2))
    per = n_clustered // k
    pts = [centers[i] + 0.0008 * rng.standard_normal((per, 2)) for i in range(k)]
    pts.append(rng.uniform(0, 1, size=(n_clustered - per * k, 2)))
    pts.append(rng.uniform(0, 1, size=(n_noise, 2)))
    motor = np.concatenate(pts)[:n].astype(np.float32)
    xyz = np.concatenate([motor, np.ones((n, 1), np.float32)], axis=1)
    truth = np.concatenate([centers, np.ones((k, 1))], axis=1).astype(np.float32)
    truth = truth[:N_TRUTH]
    return motor, xyz, truth


def stage(msg, **kw):
    print(json.dumps(dict(stage=msg, **kw)), file=sys.stderr)


def job_args(n=N_POINTS, seed=0):
    import jax.numpy as jnp

    motor, xyz, truth = synthetic_cloud(n, seed)
    return (jnp.asarray(motor), jnp.asarray(xyz), jnp.ones(n, bool),
            jnp.asarray(truth), jnp.ones(len(truth), bool))


def make_step(backend, n=N_POINTS, block_cap=BLOCK_CAP,
              max_clusters=MAX_CLUSTERS, cluster_cap=CLUSTER_CAP):
    """The fused job as one jitted function of job_args(). The plain path
    solves all blocks in one vmapped chunk: on the H100 that beat chunks
    of 16 blocks by 2 ms at the bench shape (fewer sweep launches)."""
    import jax
    import jax.numpy as jnp
    from vtkcloudpoint_tpu.cluster.blocks import partition_gather_sorted
    from vtkcloudpoint_tpu.cluster.dbscan import dbscan_blocks_dispatch
    from vtkcloudpoint_tpu.cluster.fusion import merge_blocks
    from vtkcloudpoint_tpu.config import ICPConfig
    from vtkcloudpoint_tpu.ops.geometry import cluster_shapes
    from vtkcloudpoint_tpu.ops.segment import (
        bucket_payload_by_cluster, cluster_stats,
    )
    from vtkcloudpoint_tpu.register.icp import icp

    max_blocks = -(-n // block_cap)

    def step(motor, xyz, valid, truth, truth_valid):
        # one multi-operand sort = partition + blocked layout, no gather
        bc, bv, pidx, _ = partition_gather_sorted(
            motor, valid, block_cap, max_blocks)
        db = dbscan_blocks_dispatch(bc, bv, EPS, MIN_PTS, "l1_motor",
                                    chunk=max_blocks, backend=backend)
        fused = merge_blocks(db["label"], bv, bc, pidx, n, EPS, MIN_PTS,
                             "l1_motor", quirks=False,
                             noise_capacity=NOISE_CAP)
        label = fused["label"]
        stats = cluster_stats(xyz, motor, label, valid, max_clusters)
        # circumcircles x2 (3D + motor): both coordinate systems ride ONE
        # payload bucket and ONE batched [2K] shapes call
        pay = (xyz[:, 0], xyz[:, 1], motor[:, 0], motor[:, 1])
        tabs, tval, runs, _ = bucket_payload_by_cluster(
            label, valid, pay, max_clusters, cluster_cap)
        both = jnp.concatenate([tabs[..., 0:2], tabs[..., 2:4]], axis=0)
        bval = jnp.concatenate([tval, tval], axis=0)
        bcnt = jnp.concatenate([runs, runs], axis=0)
        sh = cluster_shapes(both, bval, bcnt, max_hull=MAX_HULL,
                            chunk_k=2 * max_clusters, tri_chunk=2480)
        res = icp(stats["center3d"], stats["count"] > 0, truth, truth_valid,
                  ICPConfig(max_iterations=50), chunk=1024)
        return (label, fused["n_total"], sh["radius"][:max_clusters],
                sh["radius"][max_clusters:],
                res.r, res.t, res.error, res.iterations)

    return jax.jit(step)


def wall(fn, *args, reps=REPS):
    """(compile_s, median_ms, min_ms, out): the first call's wall, then
    ``reps`` walls, each to block_until_ready."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return first, statistics.median(times), min(times), out


def stage_times(backend, args, n=N_POINTS):
    """Median wall of each stage as its own jit: the sum exceeds the fused
    wall (no cross-stage fusion), the ratios say where the time goes."""
    import jax
    import jax.numpy as jnp
    from vtkcloudpoint_tpu.cluster.blocks import partition_gather_sorted
    from vtkcloudpoint_tpu.cluster.dbscan import dbscan_blocks_dispatch
    from vtkcloudpoint_tpu.cluster.fusion import merge_blocks
    from vtkcloudpoint_tpu.config import ICPConfig
    from vtkcloudpoint_tpu.ops.geometry import cluster_shapes
    from vtkcloudpoint_tpu.ops.segment import (
        bucket_payload_by_cluster, cluster_stats,
    )
    from vtkcloudpoint_tpu.register.icp import icp

    motor, xyz, valid, truth, tv = args
    max_blocks = -(-n // BLOCK_CAP)
    s_part = jax.jit(lambda m, v: partition_gather_sorted(
        m, v, BLOCK_CAP, max_blocks))
    bc, bv, pidx, _ = s_part(motor, valid)
    s_db = jax.jit(lambda c, v: dbscan_blocks_dispatch(
        c, v, EPS, MIN_PTS, "l1_motor", chunk=max_blocks, backend=backend))
    db = s_db(bc, bv)
    s_fuse = jax.jit(lambda lab, v, c, p: merge_blocks(
        lab, v, c, p, n, EPS, MIN_PTS, "l1_motor", quirks=False,
        noise_capacity=NOISE_CAP))
    label = s_fuse(db["label"], bv, bc, pidx)["label"]
    s_stats = jax.jit(lambda x, m, lab, v: cluster_stats(
        x, m, lab, v, MAX_CLUSTERS))
    stats = s_stats(xyz, motor, label, valid)

    def bucket(lab, v, x, m):
        pay = (x[:, 0], x[:, 1], m[:, 0], m[:, 1])
        return bucket_payload_by_cluster(lab, v, pay, MAX_CLUSTERS,
                                         CLUSTER_CAP)

    s_bucket = jax.jit(bucket)
    tabs, tval, runs, _ = s_bucket(label, valid, xyz, motor)

    def shapes(tabs, tval, runs):
        both = jnp.concatenate([tabs[..., 0:2], tabs[..., 2:4]], axis=0)
        bval = jnp.concatenate([tval, tval], axis=0)
        bcnt = jnp.concatenate([runs, runs], axis=0)
        sh = cluster_shapes(both, bval, bcnt, max_hull=MAX_HULL,
                            chunk_k=2 * MAX_CLUSTERS, tri_chunk=2480)
        return sh["radius"]

    s_shapes = jax.jit(shapes)
    s_icp = jax.jit(lambda c, cv, t, v: icp(
        c, cv, t, v, ICPConfig(max_iterations=50), chunk=1024))
    cases = {
        "partition_gather": (s_part, motor, valid),
        "dbscan": (s_db, bc, bv),
        "fusion": (s_fuse, db["label"], bv, bc, pidx),
        "stats": (s_stats, xyz, motor, label, valid),
        "bucket": (s_bucket, label, valid, xyz, motor),
        "shapes_x2": (s_shapes, tabs, tval, runs),
        "icp": (s_icp, stats["center3d"], stats["count"] > 0, truth, tv),
    }
    return {name: round(wall(f, *a)[1], 3) for name, (f, *a) in
            cases.items()}


def oracle_points_per_sec(n_small=20_000):
    """Sequential reference-semantics oracle throughput on this host."""
    from vtkcloudpoint_tpu.oracle.pipeline_oracle import blocked_dbscan_oracle

    motor, _, _ = synthetic_cloud(n_small)
    t0 = time.perf_counter()
    blocked_dbscan_oracle(motor.astype(np.float64), EPS, MIN_PTS,
                          pts_in_cell=BLOCK_CAP)
    return n_small / (time.perf_counter() - t0)


def main():
    from vtkcloudpoint_tpu.policy import policy
    from vtkcloudpoint_tpu.utils.compile_cache import configure_compile_cache
    from vtkcloudpoint_tpu.utils.device import card_lines, require_gpu

    device = require_gpu()
    configure_compile_cache()
    card = card_lines()
    stage("device", card=card, **device)
    args = job_args()
    results, outs = {}, {}
    for backend in ("cuda", "jnp"):
        if os.environ.get("BENCH_STAGES", "1") == "1":
            stage("per_stage_ms", backend=backend, card=card,
                  **stage_times(backend, args))
        compile_s, med, best, out = wall(make_step(backend), *args)
        outs[backend] = out
        results[backend] = dict(
            wall_ms=round(med, 3), wall_min_ms=round(best, 3),
            compile_s=round(compile_s, 2),
            pts_per_sec=round(N_POINTS / (med * 1e-3), 1),
            n_clusters=int(out[1]), icp_error=float(out[6]),
            icp_iterations=int(out[7]))
        stage("full_job", backend=backend, card=card, **results[backend])
    if not np.array_equal(np.asarray(outs["cuda"][0]),
                          np.asarray(outs["jnp"][0])):
        raise SystemExit("path parity mismatch: cuda and jnp labels differ")
    head = results[policy().dbscan_blocks]
    if head["n_clusters"] > MAX_CLUSTERS:
        raise SystemExit(f"n_clusters {head['n_clusters']} exceeds "
                         f"MAX_CLUSTERS {MAX_CLUSTERS}")
    base = oracle_points_per_sec()
    print(json.dumps({
        "metric": "dbscan_icp_points_per_sec_per_chip",
        "value": head["pts_per_sec"],
        "unit": "points/sec",
        "vs_baseline": round(head["pts_per_sec"] / base, 2),
        "engine": policy().dbscan_blocks,
        "paths": results,
        "device": device,
        "card": card,
    }))


if __name__ == "__main__":
    main()
