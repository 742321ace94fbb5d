"""Tier 5 (BASELINE.json config 5): sharded map, distributed DBSCAN + ICP.

Weak-scaling sweep over the available devices (real chips if present, else
virtual CPU devices via --cpu N): per-device work is held constant while the
mesh grows; efficiency = T(1) / T(n). On virtual CPU devices the numbers
validate the program structure, not hardware scaling (single real chip in
this environment; BASELINE's >=70% target needs a real multi-chip slice).
"""
import sys

import numpy as np

from common import setup_jax, emit

import os
BLOCKS_PER_DEV = int(os.environ.get("BENCH_BLOCKS_PER_DEV", 8))
CAP = int(os.environ.get("BENCH_CAP", 512))
N_ICP_PER_DEV = int(os.environ.get("BENCH_ICP_PER_DEV", 8192))
SIZES = tuple(int(x) for x in os.environ.get("BENCH_SIZES", "1,2,4,8").split(","))
NOISE_CAP = int(os.environ.get("BENCH_NOISE_CAP", 1024))
HALO_CAP = int(os.environ.get("BENCH_HALO_CAP", 64))
REPS = int(os.environ.get("BENCH_REPS", 3))
DB_CHUNK = int(os.environ.get("BENCH_DB_CHUNK", 16))
# 10M-point recipe (see docs/PARITY.md "tier-5 at scale"): disk cloud +
# hierarchical halo union keep every overflow counter at 0.
CLOUD = os.environ.get("BENCH_CLOUD", "blob")          # "blob" | "disk"
EPS = float(os.environ.get("BENCH_EPS", 0.004))
MIN_PTS = int(os.environ.get("BENCH_MIN_PTS", 8))
HALO_MODE = os.environ.get("BENCH_HALO_MODE", "ring")  # ring|gather|hier
DEV_HALO_CAP = int(os.environ.get("BENCH_DEV_HALO_CAP", 512))
HALO_CELL_CAP = int(os.environ.get("BENCH_HALO_CELL_CAP", 64))
# hier stage-3 skin exchange: "owner" (all_to_all by cell ownership,
# per-device payload O(own boundary), flat across the sweep) | "gather"
SKIN_EXCHANGE = os.environ.get("BENCH_SKIN_EXCHANGE", "owner")
# split DBSCAN / fusion into two programs: mandatory for big runs on the
# oversubscribed CPU validation host (defeats the ~2-min XLA:CPU collective
# rendezvous watchdog -- program 2 reaches its first all_gather in ms)
SPLIT = os.environ.get("BENCH_SPLIT", "0") == "1"
# noise re-cluster: "grid" (replicated over gathered noise) or
# "distributed" (owner-sharded, O(boundary) collectives)
NOISE_MODE = os.environ.get("BENCH_NOISE_MODE", "grid")
NOISE_SKIN_CAP = int(os.environ.get("BENCH_NOISE_SKIN_CAP", 2048))
NOISE_ROOT_CAP = int(os.environ.get("BENCH_NOISE_ROOT_CAP", 4096))
PTS_PER_CLUSTER = int(os.environ.get("BENCH_PTS_PER_CLUSTER", 800))
# default disk radius targets the PARITY.md recorded density rho = 3e7
# (eps-ball ~18 points >= 2*min_pts core margin); override with an explicit
# BENCH_DISK_RADIUS to change the regime
_R = os.environ.get("BENCH_DISK_RADIUS", "auto")
DISK_RADIUS = (float(_R) if _R != "auto"
               else (PTS_PER_CLUSTER / (3.14159265 * 3e7)) ** 0.5)
NOISE_FRAC = 0.004                                     # disk_cloud default
# BENCH_AUTO_CAPS=1 (default for the disk cloud): derive halo/cell/skin/
# noise capacities from ParallelConfig.size_caps instead of hand-picked env
# values, and ASSERT all overflow counters are 0 -- a sized run silently
# dropping points is a regression, not a report (VERDICT r2 weak item 4).
AUTO_CAPS = os.environ.get(
    "BENCH_AUTO_CAPS", "1" if CLOUD == "disk" else "0") == "1"
CAP_SAFETY = float(os.environ.get("BENCH_CAP_SAFETY", 2.0))


def main():
    jax = setup_jax()
    import time
    import jax.numpy as jnp
    from vtkcloudpoint_tpu.parallel.mesh import make_mesh
    from vtkcloudpoint_tpu.parallel.sharded import (
        sharded_blocked_dbscan, sharded_icp,
    )
    from vtkcloudpoint_tpu.cluster.blocks import (
        assign_blocks_balanced, gather_blocks_ordered,
    )
    from vtkcloudpoint_tpu.config import ICPConfig
    from common import blob_cloud

    ndev_all = len(jax.devices())
    sizes = [d for d in SIZES if d <= ndev_all]
    base_t = None
    for ndev in sizes:
        mesh = make_mesh(ndev)
        B = BLOCKS_PER_DEV * ndev
        n = B * CAP
        k = max(n // PTS_PER_CLUSTER, 8)
        if CLOUD == "disk":
            from common import disk_cloud
            motor, xyz, truth, centers = disk_cloud(
                n, k=k, radius=DISK_RADIUS, seed=3)
        else:
            motor, xyz, truth, centers = blob_cloud(n, k=k, seed=3)
        valid = jnp.ones(n, bool)
        part = assign_blocks_balanced(jnp.asarray(motor), valid, CAP)
        bc, bv, pidx, _ = gather_blocks_ordered(
            jnp.asarray(motor), part["order"], valid, B, CAP)

        # id table sized for the cluster count (k clusters, split pieces)
        max_ids = 1 << max(12, (4 * k).bit_length())

        halo_cap, cell_cap = HALO_CAP, HALO_CELL_CAP
        dev_halo_cap, noise_cap = DEV_HALO_CAP, NOISE_CAP
        noise_skin_cap, noise_root_cap = NOISE_SKIN_CAP, NOISE_ROOT_CAP
        if AUTO_CAPS and CLOUD == "disk":
            import math
            from vtkcloudpoint_tpu.config import ParallelConfig
            density = PTS_PER_CLUSTER / (math.pi * DISK_RADIUS ** 2)
            caps = ParallelConfig.size_caps(
                EPS, density, CAP, blocks_per_device=BLOCKS_PER_DEV,
                noise_frac=NOISE_FRAC, safety=CAP_SAFETY)
            halo_cap, cell_cap = caps["halo_cap"], caps["cell_cap"]
            dev_halo_cap, noise_cap = (caps["dev_halo_cap"],
                                       caps["noise_capacity"])
            noise_skin_cap = caps["noise_skin_cap"]
            noise_root_cap = caps["noise_root_cap"]
            emit(metric="tier5_auto_caps", devices=ndev, density=density,
                 eps=EPS, **{k: v for k, v in caps.items()
                             if k != "ball_points"},
                 ball_points=round(caps["ball_points"], 1))

        R = 5                      # 2D half-stencil routes per skin point
        skin_dest_cap = max(64, (-(-2 * R * dev_halo_cap // ndev) + 7)
                            // 8 * 8)

        def run():
            return sharded_blocked_dbscan(
                mesh, bc, bv, eps=EPS, min_pts=MIN_PTS, quirks=False,
                noise_capacity_per_device=noise_cap, halo_merge=True,
                max_ids=max_ids, halo_cap=halo_cap, halo_mode=HALO_MODE,
                dev_halo_cap=dev_halo_cap, halo_cell_cap=cell_cap,
                skin_exchange=SKIN_EXCHANGE, skin_dest_cap=skin_dest_cap,
                noise_recluster=NOISE_MODE, noise_skin_cap=noise_skin_cap,
                noise_root_cap=noise_root_cap, dbscan_chunk=DB_CHUNK,
                split_programs=SPLIT,
                checkpoint_dir=os.environ.get("BENCH_CKPT_DIR") or None)

        ckpt_dir = os.environ.get("BENCH_CKPT_DIR") or None
        # BENCH_WARMUP=0: skip the untimed warmup run -- for multi-hour
        # record runs the timed rep then includes the (comparatively tiny)
        # compile, which beats paying the full job twice
        warmup = os.environ.get("BENCH_WARMUP", "1") == "1"
        ran_in_proc = False

        def clear_ckpt():
            # timed reps must recompute program 1 from scratch: resuming
            # from a checkpoint left by an EARLIER run in this process
            # would time the fusion alone and report a fiction. A stale
            # dir from a crashed prior process is the resume case, so only
            # clear after an in-process run. (The checkpoint still
            # protects each rep MID-run.)
            if ran_in_proc and ckpt_dir and os.path.isdir(ckpt_dir):
                import shutil
                shutil.rmtree(ckpt_dir)

        if warmup:
            out = run()
            _ = np.asarray(out["label"][:1, :8])
            ran_in_proc = True
        ts = []
        for _ in range(max(REPS, 1)):
            clear_ckpt()
            t0 = time.perf_counter()
            out = run()
            _ = np.asarray(out["label"][:1, :8])
            ran_in_proc = True
            ts.append(time.perf_counter() - t0)
        dt = min(ts)
        pps = n / dt
        if base_t is None:
            base_t = dt
        rec = dict(metric="tier5_sharded_dbscan", devices=ndev, points=n,
                   points_per_sec=round(pps, 1), wall_ms=round(dt * 1000, 1),
                   # on a virtual CPU mesh the devices CONTEND for
                   # os.cpu_count() cores, so per-device wall time cannot
                   # stay flat beyond that many devices; host_cores makes
                   # that visible in the record
                   host_cores=os.cpu_count(),
                   halo_mode=HALO_MODE, noise_mode=NOISE_MODE,
                   skin_exchange=(SKIN_EXCHANGE if HALO_MODE == "hier"
                                  else None),
                   skin_dest_cap=(skin_dest_cap if HALO_MODE == "hier"
                                  and SKIN_EXCHANGE == "owner" else None),
                   split_programs=SPLIT,
                   n_clusters=int(out["n_total"]),
                   noise_overflow=int(out["noise_overflow"]),
                   halo_overflow=int(out["halo_overflow"]))
        # weak_scaling_eff only when an actual sweep ran: a 1.0 printed
        # from a single-size run reads as "perfect scaling" to any JSON
        # consumer (VERDICT r3 weak item 7)
        if len(sizes) > 1:
            rec["weak_scaling_eff"] = round(base_t / dt, 3)
        emit(**rec)
        # analytic per-device collective payload for THIS config, so the
        # expectation on real devices is stated: the interconnect moves
        # these bytes, however fast the virtual-mesh host happens to be.
        # The fusion renumber now exchanges ONE kept-count int32 per device
        # (block_keep_rules is per-block-local; offsets are a scalar prefix
        # sum) -- the r4 design's [B, kmax] counts all_gather was
        # B*(CAP+1)*4 bytes/device = O(world points), 40 MB/device = 73%
        # of all collective bytes at the 10M record.
        counts_gather = ndev * 4
        noise_bytes = (
            # distributed: distinct-cell lists + skin (coords+gid+core+lab
            # per round) + root lists
            (max(1024, noise_cap // 2) * 8
             + noise_skin_cap * (2 * 4 + 4 + 1 + 4 * 4)
             + noise_root_cap * 4)
            if NOISE_MODE == "distributed"
            # replicated: every device's packed noise buffer, gathered
            else ndev * noise_cap * (2 * 4 + 1))
        if HALO_MODE == "hier":
            cells_bytes = max(4096, BLOCKS_PER_DEV * CAP // 4) * 8
            if SKIN_EXCHANGE == "owner":
                # all_to_all: sent == received == ndev x dest_cap slots
                # ~= 2 x R x dev_halo_cap -- FLAT in the mesh size
                skin_bytes = ndev * skin_dest_cap * (2 * 4 + 4 + 1)
            else:
                skin_bytes = dev_halo_cap * (2 * 4 + 4 + 1) * (1 + ndev)
            halo_bytes = cells_bytes + skin_bytes
        else:
            halo_bytes = ndev * BLOCKS_PER_DEV * halo_cap * (2 * 4 + 4 + 1)
        emit(metric="tier5_collective_bytes_per_device",
             devices=ndev, points=n,
             counts_gather=counts_gather, noise=noise_bytes,
             halo=halo_bytes,
             bytes_per_point=round(
                 (counts_gather + noise_bytes + halo_bytes) / (n / ndev),
                 3))
        if AUTO_CAPS and CLOUD == "disk":
            assert int(out["noise_overflow"]) == 0, \
                f"sized run dropped noise points: {int(out['noise_overflow'])}"
            assert int(out["halo_overflow"]) == 0, \
                f"sized run dropped halo points: {int(out['halo_overflow'])}"
        if os.environ.get("BENCH_CHECK_GATHER", "0") == "1":
            # exactness cross-check: the hierarchical (or ring) union must
            # reproduce the flat all_gather union bit-for-bit on the same
            # cloud (VERDICT r2 item 1 done-criterion)
            ref = sharded_blocked_dbscan(
                mesh, bc, bv, eps=EPS, min_pts=MIN_PTS, quirks=False,
                noise_capacity_per_device=noise_cap, halo_merge=True,
                max_ids=max_ids, halo_cap=halo_cap, halo_mode="gather",
                noise_recluster="grid", dbscan_chunk=DB_CHUNK)
            same = bool(np.array_equal(np.asarray(out["label"]),
                                       np.asarray(ref["label"])))
            emit(metric="tier5_check_gather", devices=ndev, points=n,
                 mode=HALO_MODE, labels_equal=same,
                 n_clusters_mode=int(out["n_total"]),
                 n_clusters_gather=int(ref["n_total"]))
            assert same, f"{HALO_MODE} union != gather union at {n} points"

    if os.environ.get("BENCH_SKIP_ICP", "0") == "1":
        return
    # distributed LARGE-TARGET ICP at the largest mesh: the full tier cloud
    # is the map (sharded over devices, per-shard grid locators), queries
    # ride the ppermute ring (parallel.sharded.sharded_icp_grid)
    from vtkcloudpoint_tpu.parallel.sharded import sharded_icp_grid
    from vtkcloudpoint_tpu.ops import se3

    ndev = sizes[-1]
    mesh = make_mesh(ndev)
    n_icp = N_ICP_PER_DEV * ndev
    m_tgt = n  # the last weak-scaling cloud size
    rng = np.random.default_rng(0)
    tgt3 = np.concatenate(
        [motor, np.zeros((m_tgt, 1), np.float32)], axis=1)
    sel = rng.choice(m_tgt, n_icp, replace=False)
    r_true = np.asarray(se3.rotz(0.02), np.float32)
    t_true = np.float32([2e-3, -1e-3, 5e-4])
    src = (tgt3[sel] - t_true) @ r_true
    if CLOUD == "disk":
        cell = float((32.0 / (PTS_PER_CLUSTER /
                              (3.14159265 * DISK_RADIUS ** 2))) ** 0.5)
    else:
        cell = 0.01
    t0 = time.perf_counter()
    r, t, d, it, ovf = sharded_icp_grid(
        mesh, jnp.asarray(src), jnp.ones(n_icp, bool), jnp.asarray(tgt3),
        jnp.ones(m_tgt, bool), ICPConfig(tol=1e-10, max_iterations=30),
        cell_size=cell, cell_cap=128,
        # the brute fallback budget is per nn_grid CALL: size it to the
        # per-device query count or large query batches overflow it (the
        # r4 sweep's 8192-query/device tail left ~38% of stencil-
        # unresolved queries beyond a fixed 4096 budget)
        fallback_cap=max(4096, n_icp // ndev),
        chunk=min(4096, n_icp // ndev))
    rot_err = float(np.abs(np.asarray(r) - r_true).max())
    dt = time.perf_counter() - t0
    emit(metric="tier5_sharded_icp_grid", devices=ndev,
         target_points=m_tgt, query_points=n_icp, cell_size=cell,
         residual=float(d), rot_err_vs_truth=rot_err, iters=int(it),
         nn_overflow=int(ovf), wall_s=round(dt, 2))
    # analytic ring payload (docstring contract of sharded_icp_grid): each
    # hop moves (query xyz, best d2, best y, ok) = 8 f32/query; the ring
    # does ndev hops per ICP iteration and the target NEVER moves --
    # collective bytes scale with the SOURCE, not the map
    q_loc = n_icp // ndev
    per_iter = q_loc * 8 * 4 * ndev
    emit(metric="tier5_icp_ring_bytes_per_device", devices=ndev,
         queries_per_device=q_loc, bytes_per_iteration=per_iter,
         total_bytes=per_iter * int(it),
         bytes_per_query_per_iter=8 * 4 * ndev,
         target_bytes_moved=0)


if __name__ == "__main__":
    main()
