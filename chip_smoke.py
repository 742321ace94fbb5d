"""Chip smoke test: the system's main paths on the GPU, each checked against
the repository's own references.

    python chip_smoke.py            # one GPU: phases 1-4
    python chip_smoke.py --four     # four GPUs: the sharded path only

Phases, in order; any failure exits non-zero before the last line:

1. device   -- JAX must report a GPU (no CPU fallback); prints the device
               and the card's name and power limit.
2. workflow -- a seeded scanner session of 500,000 points (survey markers
               plus background noise in motor-angle/range form, shaped like
               examples/demo.py) written as 3-column text scans and run
               through Engine: import_folder -> filter_by_distance ->
               cluster (reference mode, quirks=True) -> reject_by_radius ->
               register_to_truth -> match. Labels must be bit-equal to
               oracle.pipeline_oracle.blocked_dbscan_oracle on the same
               float32 motor coordinates, overflow counters 0, and ICP
               error / match RMSE within tolerance of a float64 CPU run on
               the same centroids.
3. bench    -- bench.py's fused job (500k points, block cap 1024, 1024
               cluster rows) on the CUDA kernel path and the plain XLA
               path: labels bit-equal, radii within tolerance; prints wall,
               compile time and peak device memory.
4. scale    -- a 5,000,000-point blob scan through
               cluster_scan(mode="balanced"), called eagerly on the kernel
               path, then on the plain path, then jitted on the kernel
               path: overflow counters 0, all three bit-equal.

With --four: only sharded_blocked_dbscan (halo_mode="hier",
skin_exchange="owner", noise_recluster="distributed") on a 10M-point disk
cloud with capacities from ParallelConfig.size_caps at the cloud's peak
eps-cell density, on a 4-card mesh against a 1-card mesh, and sharded_icp
against single-card icp (transform and error). One process drives all
cards.

The last line of stdout is {"ok": true, "device": {"platform", "kind",
"count"}}.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# ---- tolerances, each with its reason ----
# ICP error is a sum of squared correspondence distances over ~10^3-10^4
# centroids; float32 against float64 arithmetic on identical inputs
# differs by ~1e-7 relative per operation, accumulated over <= 100
# Horn iterations: 1e-3 relative (plus an absolute floor for a near-zero
# sum) holds that with room and still catches a wrong correspondence,
# which moves the sum by O(1) relative.
ICP_RTOL, ICP_ATOL = 1e-3, 1e-6
# sharded_icp against icp on the same problem: the two rank neighbours with
# differently tiled f32 matmuls, so near-tied neighbours can go either way
# (0.2% apart in the error on 8192 points on the CPU), and each run stops
# once successive errors differ by < tol, so stopping one iteration apart
# moves the reading by < tol. A psum counted per shard, or a shard left
# out, moves it by a factor of the device count.
SHARD_ICP_RTOL = 0.05
# Radii from the two engines go through the same shapes code on equal
# labels; only XLA's fusion choices differ between the two programs, so
# disagreement is last-bit rounding of f32 circle solves.
RADIUS_RTOL, RADIUS_ATOL = 1e-5, 1e-7


def log(phase, **kw):
    print(json.dumps(dict(phase=phase, **kw)), flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


# ---------------------------------------------------------------- device

def phase_device():
    from vtkcloudpoint_tpu.utils.device import card_lines, require_gpu

    device = require_gpu()
    card = card_lines()
    for line in card:
        print(f"card: {line}", flush=True)
    log("device", **device)
    return device, card


# -------------------------------------------------------------- workflow

def make_session(folder, n_points, seed=0, n_files=4, spacing=3.0):
    """Seeded survey session: markers like examples/demo.py's (clumps of
    sigma 0.03 in motor degrees, here ~245 points each) set out on a
    jittered square grid ``spacing`` degrees apart, plus 2% background
    noise over the field, ranges 40-45; written as tab-separated motor_x,
    motor_y, Distance text scans. Returns the markers' (motor, range)."""
    rng = np.random.default_rng(seed)
    pts_per = 245
    n_noise = max(n_points // 50, 1)
    g = max(int(round(math.sqrt((n_points - n_noise) / pts_per))), 1)
    n_markers = g * g
    pts_per = (n_points - n_noise) // n_markers
    n_noise = n_points - n_markers * pts_per
    side = g * spacing
    ij = np.stack(np.meshgrid(np.arange(g), np.arange(g)), -1).reshape(-1, 2)
    centers = (8.0 + spacing * (ij + 0.5)
               + rng.uniform(-0.5, 0.5, size=(n_markers, 2)))
    marks = (centers[:, None, :]
             + 0.03 * rng.standard_normal((n_markers, pts_per, 2)))
    rows = [np.concatenate([marks.reshape(-1, 2),
                            rng.uniform(40, 45, (n_markers * pts_per, 1))],
                           axis=1)]
    rows.append(np.concatenate([rng.uniform(8, 8 + side, (n_noise, 2)),
                                rng.uniform(40, 45, (n_noise, 1))], axis=1))
    data = np.concatenate(rows)
    rng.shuffle(data)
    for i, part in enumerate(np.array_split(data, n_files)):
        np.savetxt(os.path.join(folder, f"scan{i}.txt"), part,
                   fmt="%.6f", delimiter="\t")
    return centers, np.full(n_markers, 42.5)


def size_reference_blocks(motor, max_cap=1024):
    """Largest pts_in_cell (from a fixed ladder) whose clean-grid cells
    all fit ``max_cap`` points -> (pts_in_cell, block_capacity,
    max_blocks): the sizing a user does for the reference partition."""
    from vtkcloudpoint_tpu.oracle.pipeline_oracle import (
        partition_reference_oracle,
    )

    for pts_in_cell in (512, 384, 256, 192, 128, 96, 64, 48, 32):
        block, n_cells = partition_reference_oracle(motor, pts_in_cell)
        biggest = int(np.bincount(block, minlength=n_cells).max())
        if biggest <= max_cap:
            return pts_in_cell, max(32, -(-biggest // 32) * 32), int(n_cells)
    raise SystemExit("chip_smoke: FAILED: no clean-grid cell size keeps "
                     f"cells under {max_cap} points")


def icp_and_match_f64(eng, result, truth):
    """register_to_truth + match on the CPU in float64 on the device
    run's own centroids."""
    import jax
    import jax.numpy as jnp

    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu):
        r64 = result._replace(**{
            k: jnp.asarray(np.asarray(getattr(result, k)),
                           jnp.float64 if np.asarray(
                               getattr(result, k)).dtype.kind == "f"
                           else None)
            for k in ("count", "center3d", "center2d")})
        t64 = jnp.asarray(np.asarray(truth, np.float64))
        reg = eng.register_to_truth(r64, t64)
        mat = eng.match(r64, t64, reg)
        return float(reg.error), float(mat["rmse"]), int(mat["n_matched"])


def phase_workflow(n_points=500_000, seed=0):
    import jax.numpy as jnp

    from vtkcloudpoint_tpu.config import (
        ClusterConfig, EngineConfig, FilterConfig, ICPConfig,
    )
    from vtkcloudpoint_tpu.data.convert import motor_to_xyz
    from vtkcloudpoint_tpu.engine import Engine
    from vtkcloudpoint_tpu.oracle.pipeline_oracle import (
        blocked_dbscan_oracle,
    )

    eps, min_pts = 0.12, 10
    folder = tempfile.mkdtemp(prefix=".smoke_scans_", dir=ROOT)
    try:
        centers, ranges = make_session(folder, n_points, seed)
        eng = Engine(EngineConfig(
            filters=FilterConfig(dis_min=10.0, dis_max=100.0),
            icp=ICPConfig(max_iterations=80, match_distance=1.0)))
        t0 = time.perf_counter()
        batch, names = eng.import_folder(folder)
        batch = eng.filter_by_distance(batch, 10.0, 100.0)
        import_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    valid = np.asarray(batch.valid)
    motor = np.asarray(batch.motor)[valid]          # float32, batch order
    pts_in_cell, block_cap, n_cells = size_reference_blocks(motor)
    n_markers = len(centers)
    eng.cfg = eng.cfg.replace(cluster=ClusterConfig(
        eps=eps, min_pts=min_pts, pts_in_cell=pts_in_cell,
        block_capacity=block_cap))
    caps = dict(max_blocks=n_cells,
                max_clusters=1 << (4 * n_markers).bit_length(),
                cluster_capacity=512,
                noise_capacity=1 << (2 * (n_points // 50)).bit_length())
    log("workflow_config", points=int(valid.sum()), files=len(names),
        import_s=round(import_s, 2), eps=eps, min_pts=min_pts,
        pts_in_cell=pts_in_cell, block_capacity=block_cap, **caps)

    t0 = time.perf_counter()
    res = eng.cluster(batch, quirks=True, **caps)
    lab = np.asarray(res.label)
    cluster_s = time.perf_counter() - t0
    check(int(res.block_overflow) == 0,
          f"block_overflow {int(res.block_overflow)}")
    check(int(res.noise_overflow) == 0,
          f"noise_overflow {int(res.noise_overflow)}")
    check(int(res.n_clusters) < caps["max_clusters"],
          f"n_clusters {int(res.n_clusters)} >= {caps['max_clusters']}")

    t0 = time.perf_counter()
    olab, ototal, _ = blocked_dbscan_oracle(motor, eps, min_pts, pts_in_cell)
    oracle_s = time.perf_counter() - t0
    mismatch = int(np.sum(lab[valid] != olab))
    log("workflow_cluster", n_clusters=int(res.n_clusters),
        oracle_n_clusters=int(ototal), label_mismatches=mismatch,
        first_call_s=round(cluster_s, 2), oracle_s=round(oracle_s, 2))
    check(mismatch == 0 and int(res.n_clusters) == int(ototal),
          "Engine.cluster labels differ from blocked_dbscan_oracle")
    check(not np.any(lab[~valid]), "invalid points carry labels")

    batch2, rejected = eng.reject_by_radius(batch, res, radius=5.0)
    truth = np.asarray(motor_to_xyz(jnp.asarray(centers, jnp.float32),
                                    jnp.asarray(ranges, jnp.float32)))
    reg = eng.register_to_truth(res, truth)
    mat = eng.match(res, truth, reg)
    err32, rmse32 = float(reg.error), float(mat["rmse"])
    err64, rmse64, matched64 = icp_and_match_f64(eng, res, truth)
    log("workflow_register", rejected=int(np.sum(np.asarray(rejected))),
        kept_points=int(np.sum(np.asarray(batch2.valid))),
        icp_iterations=int(reg.iterations), icp_error=err32,
        icp_error_f64=err64, match_rmse=rmse32, match_rmse_f64=rmse64,
        n_matched=int(mat["n_matched"]), n_matched_f64=matched64,
        rtol=ICP_RTOL, atol=ICP_ATOL)
    check(np.isfinite([err32, rmse32]).all(), "non-finite ICP result")
    check(math.isclose(err32, err64, rel_tol=ICP_RTOL, abs_tol=ICP_ATOL),
          f"ICP error {err32} vs float64 {err64}")
    check(math.isclose(rmse32, rmse64, rel_tol=ICP_RTOL, abs_tol=ICP_ATOL),
          f"match RMSE {rmse32} vs float64 {rmse64}")
    check(int(mat["n_matched"]) == matched64, "matched count differs")


# ----------------------------------------------------------------- bench

def phase_bench(card, n_points=None, kernel="cuda", **sizes):
    """bench.py's fused job on the kernel path and the plain path."""
    import jax

    import bench

    n = n_points or bench.N_POINTS
    args = bench.job_args(n)
    max_clusters = sizes.get("max_clusters", bench.MAX_CLUSTERS)
    outs = {}
    for backend in (kernel, "jnp"):
        step = bench.make_step(backend, n=n, **sizes)
        first, med, best, out = bench.wall(step, *args, reps=5)
        outs[backend] = out
        # the compiled program's own footprint, per path; the process
        # peak below covers every phase run so far
        mem = step.lower(*args).compile().memory_analysis()
        log("bench", path=backend, points=n, steady_wall_ms=round(med, 3),
            min_wall_ms=round(best, 3), first_call_s=round(first, 2),
            n_clusters=int(out[1]), icp_error=float(out[6]),
            program_temp_bytes=getattr(mem, "temp_size_in_bytes", None),
            program_arg_out_bytes=(
                mem.argument_size_in_bytes + mem.output_size_in_bytes
                if mem is not None else None),
            card=card)
    a, b = outs[kernel], outs["jnp"]
    check(np.array_equal(np.asarray(a[0]), np.asarray(b[0])),
          "bench labels differ between the kernel and the plain path")
    check(int(a[1]) == int(b[1]) <= max_clusters,
          f"n_clusters {int(a[1])}/{int(b[1])} (table {max_clusters})")
    for i in (2, 3):
        ra, rb = np.asarray(a[i]), np.asarray(b[i])
        check(np.isfinite(ra).all() and ra.shape == (max_clusters,),
              "bench radii malformed")
        check(np.allclose(ra, rb, rtol=RADIUS_RTOL, atol=RADIUS_ATOL),
              f"bench radii differ by {float(np.max(np.abs(ra - rb)))}")
    stats = jax.devices()[0].memory_stats() or {}
    log("bench_memory", process_peak_bytes_after_both_paths=stats.get(
        "peak_bytes_in_use"), card=card)


# ----------------------------------------------------------------- scale

def blob_scan(n, seed=3, pts_per_cluster=800, noise_frac=0.004):
    """benchmarks/tier3_scale.py's cloud: sigma-8e-4 blobs of ~800 points
    in the unit square plus uniform noise, float32 motor coordinates."""
    rng = np.random.default_rng(seed)
    k = max(n // pts_per_cluster, 1)
    n_noise = int(n * noise_frac)
    nc = n - n_noise
    centers = rng.uniform(0.01, 0.99, size=(k, 2))
    per = nc // k
    pts = centers[:, None, :] + 0.0008 * rng.standard_normal((k, per, 2))
    motor = np.concatenate([pts.reshape(-1, 2),
                            rng.uniform(0, 1, (nc - per * k, 2)),
                            rng.uniform(0, 1, (n_noise, 2))])[:n]
    return motor.astype(np.float32)


def phase_scale(card, n_points=5_000_000, kernel="cuda", block_cap=1024,
                max_clusters=16384, noise_capacity=65536):
    import jax
    import jax.numpy as jnp

    from vtkcloudpoint_tpu.cluster.pipeline import cluster_scan
    from vtkcloudpoint_tpu.config import ClusterConfig, EngineConfig

    motor = blob_scan(n_points)
    xyz = np.concatenate([motor, np.ones((n_points, 1), np.float32)], 1)
    args = (jnp.asarray(xyz), jnp.asarray(motor), jnp.ones(n_points, bool))
    cfg = EngineConfig(cluster=ClusterConfig(eps=0.004, min_pts=8,
                                             block_capacity=block_cap))
    kw = dict(mode="balanced", max_blocks=-(-n_points // block_cap),
              quirks=False, noise_capacity=noise_capacity,
              max_clusters=max_clusters, cluster_capacity=block_cap,
              max_hull=32)
    runs = {}

    def run(name, fn):
        t0 = time.perf_counter()
        res = fn(*args)
        runs[name] = (np.asarray(res.label), res)
        log("scale", path=name, points=n_points,
            first_call_s=round(time.perf_counter() - t0, 2),
            n_clusters=int(res.n_clusters),
            block_overflow=int(res.block_overflow),
            noise_overflow=int(res.noise_overflow), card=card)
        check(int(res.block_overflow) == 0 and int(res.noise_overflow) == 0,
              f"scale overflow on {name}")
        check(int(res.n_clusters) < max_clusters,
              f"scale n_clusters {int(res.n_clusters)} >= {max_clusters}")
        check(np.isfinite(np.asarray(res.radius3d)).all(),
              f"scale radii not finite on {name}")

    # eager, one engine after the other, as a user calls cluster_scan; then
    # the kernel path again as one jitted program, as a batch job runs it
    for backend in (kernel, "jnp"):
        run(backend, lambda x, m, v, b=backend: cluster_scan(
            x, m, v, cfg, backend=b, **kw))
    run(f"{kernel}_jit", jax.jit(lambda x, m, v: cluster_scan(
        x, m, v, cfg, backend=kernel, **kw)))
    la, ra = runs[kernel]
    for other in ("jnp", f"{kernel}_jit"):
        lb, rb = runs[other]
        check(np.array_equal(la, lb)
              and int(ra.n_clusters) == int(rb.n_clusters),
              f"scale labels differ between {kernel} and {other}")


# ------------------------------------------------------------- four cards

def peak_density(motor, eps):
    """Points per unit area in the fullest eps x eps cell: the density the
    capacities must cover (disks drawn independently overlap, so the
    nominal per-disk density understates it several times)."""
    cells = np.floor(motor / eps).astype(np.int64)
    _, counts = np.unique(cells[:, 0] * (1 << 32) + cells[:, 1],
                          return_counts=True)
    return float(counts.max()) / (eps * eps)


def skin_points(motor, order, n_dev, eps):
    """Points with another device's point in their 3x3 eps-cell stencil:
    the size of the exchange between devices. ``order`` is the balanced
    partition's point order; device d owns its d-th n/n_dev slice."""
    n = len(motor)
    dev = np.empty(n, np.int64)
    dev[order] = np.arange(n) // (n // n_dev)
    c = np.floor(motor / eps).astype(np.int64) + 1
    key = c[:, 0] * (1 << 32) + c[:, 1]
    cells, inv = np.unique(key, return_inverse=True)
    lo = np.full(len(cells), n_dev)
    np.minimum.at(lo, inv, dev)
    hi = np.full(len(cells), -1)
    np.maximum.at(hi, inv, dev)
    skin = np.zeros(n, bool)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            want = key + dx * (1 << 32) + dy
            j = np.minimum(np.searchsorted(cells, want), len(cells) - 1)
            skin |= (cells[j] == want) & ((lo[j] != dev) | (hi[j] != dev))
    return int(skin.sum())


def phase_four(card, n_points=10_000_000, n_dev=4, block_cap=1024,
               pts_per_cluster=800, eps=0.001, min_pts=8, n_icp=1 << 16):
    """The sharded map on an n_dev mesh against a one-device mesh.

    eps is 0.001, not the 0.004 of benchmarks/tier5_sharded.py: sized at
    the cloud's peak density, eps 0.004 puts every point of a card in its
    skin buffer and gives the grid stages 4128-slot cell windows, about 40
    times the grid work of eps 0.001 (PERF.md). eps 0.001 still sends
    ~65k points (0.65%) across cards; ``skin_points`` logs the count."""
    import jax
    import jax.numpy as jnp

    from benchmarks.common import disk_cloud
    from vtkcloudpoint_tpu.cluster.blocks import (
        assign_blocks_balanced, gather_blocks_ordered,
    )
    from vtkcloudpoint_tpu.config import ICPConfig, ParallelConfig
    from vtkcloudpoint_tpu.ops import se3
    from vtkcloudpoint_tpu.parallel.mesh import make_mesh
    from vtkcloudpoint_tpu.parallel.sharded import (
        sharded_blocked_dbscan, sharded_icp,
    )
    from vtkcloudpoint_tpu.register.icp import icp

    check(len(jax.devices()) >= n_dev,
          f"--four needs {n_dev} devices, JAX sees {len(jax.devices())}")
    b = -(-n_points // block_cap)
    b += (-b) % n_dev
    n = b * block_cap
    radius = math.sqrt(pts_per_cluster / (math.pi * 3e7))
    motor, _, _, _ = disk_cloud(n, k=max(n // pts_per_cluster, 8),
                                radius=radius, seed=3)
    valid = jnp.ones(n, bool)
    part = assign_blocks_balanced(jnp.asarray(motor), valid, block_cap)
    bc, bv, _, _ = gather_blocks_ordered(jnp.asarray(motor), part["order"],
                                         valid, b, block_cap)
    density = peak_density(motor, eps)
    log("four_cloud", points=n, disks=max(n // pts_per_cluster, 8),
        disk_density=3e7, peak_density=density, eps=eps, min_pts=min_pts,
        cross_device_skin_points=skin_points(
            motor, np.asarray(part["order"]), n_dev, eps))
    max_ids = 1 << max(12, (4 * (n // pts_per_cluster)).bit_length())
    runs = {}
    for ndev in (n_dev, 1):
        caps = ParallelConfig.size_caps(eps, density, block_cap,
                                        blocks_per_device=b // ndev,
                                        noise_frac=0.004)
        log("four_caps", devices=ndev, points=n,
            **{k: v for k, v in caps.items() if k != "ball_points"})
        mesh = make_mesh(ndev)
        t0 = time.perf_counter()
        out = sharded_blocked_dbscan(
            mesh, bc, bv, eps=eps, min_pts=min_pts, quirks=False,
            noise_capacity_per_device=caps["noise_capacity"],
            halo_merge=True, max_ids=max_ids, halo_cap=caps["halo_cap"],
            halo_mode="hier", dev_halo_cap=caps["dev_halo_cap"],
            halo_cell_cap=caps["cell_cap"], skin_exchange="owner",
            noise_recluster="distributed",
            noise_skin_cap=caps["noise_skin_cap"],
            noise_root_cap=caps["noise_root_cap"],
            noise_cell_cap=caps["cell_cap"])
        lab = np.asarray(out["label"])
        runs[ndev] = (lab, int(out["n_total"]))
        log("four_sharded", devices=ndev, points=n,
            first_call_s=round(time.perf_counter() - t0, 2),
            n_clusters=int(out["n_total"]),
            noise_overflow=int(out["noise_overflow"]),
            halo_overflow=int(out["halo_overflow"]), card=card)
        check(int(out["noise_overflow"]) == 0
              and int(out["halo_overflow"]) == 0,
              f"sharded overflow on {ndev} device(s)")
    check(np.array_equal(runs[n_dev][0], runs[1][0])
          and runs[n_dev][1] == runs[1][1],
          f"{n_dev}-device labels differ from 1-device labels")

    rng = np.random.default_rng(0)
    tgt = np.concatenate([motor[:n_icp * 4:4],
                          np.zeros((n_icp, 1), np.float32)], axis=1)
    r_true = np.asarray(se3.rotz(0.02), np.float32)
    t_true = np.float32([2e-3, -1e-3, 5e-4])
    src = ((tgt - t_true) @ r_true)[rng.permutation(n_icp)]
    cfg = ICPConfig(max_iterations=30)
    ones = jnp.ones(n_icp, bool)
    r4, t4, e4, i4 = sharded_icp(make_mesh(n_dev), jnp.asarray(src), ones,
                                 jnp.asarray(tgt), ones, cfg)
    one = icp(jnp.asarray(src), ones, jnp.asarray(tgt), ones, cfg)
    log("four_icp", devices=n_dev, points=n_icp, error=float(e4),
        error_single=float(one.error), iterations=int(i4),
        iterations_single=int(one.iterations),
        rot_diff=float(np.abs(np.asarray(r4) - np.asarray(one.r)).max()),
        error_rtol=SHARD_ICP_RTOL, error_atol=cfg.tol, card=card)
    check(np.allclose(np.asarray(r4), np.asarray(one.r), atol=1e-4)
          and np.allclose(np.asarray(t4), np.asarray(one.t), atol=1e-4),
          "sharded_icp transform differs from single-card icp")
    check(math.isclose(float(e4), float(one.error), rel_tol=SHARD_ICP_RTOL,
                       abs_tol=cfg.tol),
          f"sharded_icp error {float(e4)} vs single-card {float(one.error)}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card sharded path")
    opts = p.parse_args(argv)

    device, card = phase_device()
    from vtkcloudpoint_tpu.utils.compile_cache import configure_compile_cache

    log("compile_cache", dir=configure_compile_cache())
    t0 = time.perf_counter()
    if opts.four:
        phase_four(card)
    else:
        phase_workflow()
        phase_bench(card)
        phase_scale(card)
    log("done", seconds=round(time.perf_counter() - t0, 1))
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
