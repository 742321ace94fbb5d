"""Multi-device shard_map paths vs single-device results (8 virtual CPU
devices; on four GPUs the sharded path runs in chip_smoke.py --four)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tests.conftest import make_blobs
from vtkcloudpoint_tpu.config import ICPConfig
from vtkcloudpoint_tpu.cluster.blocks import assign_blocks_balanced, gather_blocks
from vtkcloudpoint_tpu.cluster.dbscan import dbscan_blocks
from vtkcloudpoint_tpu.cluster.fusion import merge_blocks
from vtkcloudpoint_tpu.parallel.mesh import make_mesh
from vtkcloudpoint_tpu.parallel.sharded import sharded_blocked_dbscan, sharded_icp
from vtkcloudpoint_tpu.register.icp import icp
from vtkcloudpoint_tpu.ops import se3


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(8)


def test_sharded_dbscan_matches_single(mesh):
    rng = np.random.default_rng(0)
    motor = make_blobs(rng, n_clusters=8, pts_per=40, noise=80, spread=0.012)
    n = len(motor)
    valid = np.ones(n, bool)
    cap = 128
    part = assign_blocks_balanced(jnp.asarray(motor), jnp.asarray(valid), cap)
    B = 8  # pad block count to mesh size
    bc, bv, pidx, ov = gather_blocks(jnp.asarray(motor), part["block"],
                                     jnp.asarray(valid), B, cap)
    assert int(np.asarray(ov).sum()) == 0

    out = sharded_blocked_dbscan(
        mesh, bc, bv, eps=0.06, min_pts=9, quirks=True,
        noise_capacity_per_device=256)
    labels_sh, n_total_sh = out["label"], out["n_total"]
    assert int(out["noise_overflow"]) == 0

    db = dbscan_blocks(bc, bv, 0.06, 9, "l1_motor")
    fused = merge_blocks(db["label"], bv, bc, pidx, n, 0.06, 9, "l1_motor",
                         quirks=True, noise_capacity=2048)
    # compare per-point labels: scatter sharded labels back
    lab_sh = np.zeros(n, np.int64)
    tab = np.asarray(pidx)
    ls = np.asarray(labels_sh)
    m = tab >= 0
    lab_sh[tab[m]] = ls[m]
    np.testing.assert_array_equal(lab_sh, np.asarray(fused["label"]))
    assert int(n_total_sh) == int(fused["n_total"])


def test_sharded_icp_matches_single(mesh):
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1, 1, size=(512, 3)) * np.array([5, 5, 1])
    r_true = np.asarray(se3.rotz(0.12))
    t_true = np.array([0.4, -0.1, 0.2])
    target = pts @ r_true.T + t_true
    sv = np.ones(512, bool)
    tv = np.ones(512, bool)
    cfg = ICPConfig(tol=1e-12)
    r, t, d, it = sharded_icp(mesh, jnp.asarray(pts), jnp.asarray(sv),
                              jnp.asarray(target), jnp.asarray(tv), cfg)
    np.testing.assert_allclose(np.asarray(r), r_true, atol=1e-6)
    np.testing.assert_allclose(np.asarray(t), t_true, atol=1e-6)
    single = icp(jnp.asarray(pts), jnp.asarray(sv), jnp.asarray(target),
                 jnp.asarray(tv), cfg)
    # same trajectory: identical iteration count and near-identical error
    assert int(it) == int(single.iterations)
    np.testing.assert_allclose(np.asarray(r), np.asarray(single.r), atol=1e-9)


def test_sharded_icp_error_matches_single_f32(mesh):
    """float32 on a dense patch, where the residuals of the fit are as small
    as the rounding of the |p|^2 - 2py + |y|^2 expansion the neighbours are
    ranked by: both paths must read the error from the matched pairs'
    differences, so the two readings agree (the expansion's read ~3x low)."""
    rng = np.random.default_rng(0)
    n = 4096
    tgt = np.concatenate([0.5 + 0.02 * rng.uniform(size=(n, 2)),
                          np.zeros((n, 1))], 1).astype(np.float32)
    r_true = np.asarray(se3.rotz(0.02), np.float32)
    src = ((tgt - np.float32([2e-3, -1e-3, 5e-4])) @ r_true)[
        rng.permutation(n)]
    ones = jnp.ones(n, bool)
    cfg = ICPConfig(max_iterations=30)
    _, _, d, it = sharded_icp(mesh, jnp.asarray(src), ones, jnp.asarray(tgt),
                              ones, cfg)
    single = icp(jnp.asarray(src), ones, jnp.asarray(tgt), ones, cfg)
    assert int(it) == int(single.iterations)
    np.testing.assert_allclose(float(d), float(single.error), rtol=0.05)


def test_sharded_halo_merge_matches_single(mesh):
    """Sharded halo merge over the split-cluster scene equals the
    single-device halo pipeline result."""
    rng = np.random.default_rng(3)
    stripe = np.stack([np.linspace(0, 2.0, 120), np.zeros(120)], axis=1)
    stripe = np.repeat(stripe, 3, axis=0) + 0.005 * rng.standard_normal((360, 2))
    blob = np.array([5.0, 5.0]) + 0.01 * rng.standard_normal((40, 2))
    motor = np.concatenate([stripe, blob])
    rng.shuffle(motor)
    n = len(motor)
    cap = 64
    valid = np.ones(n, bool)
    part = assign_blocks_balanced(jnp.asarray(motor), jnp.asarray(valid), cap)
    B = 8
    bc, bv, pidx, _ = gather_blocks(jnp.asarray(motor), part["block"],
                                    jnp.asarray(valid), B, cap)
    out = sharded_blocked_dbscan(
        mesh, bc, bv, eps=0.08, min_pts=6, quirks=False,
        noise_capacity_per_device=128, halo_merge=True, halo_cap=64,
        max_ids=128)
    labels_sh, n_total_sh = out["label"], out["n_total"]
    # single-device comparison
    from vtkcloudpoint_tpu.cluster.dbscan import dbscan_blocks as dbb
    from vtkcloudpoint_tpu.cluster.halo_fusion import (
        halo_merge_labels, apply_halo_merge)
    db = dbb(bc, bv, 0.08, 6, "l1_motor")
    fused = merge_blocks(db["label"], bv, bc, pidx, n, 0.08, 6, "l1_motor",
                         quirks=False, noise_capacity=1024)
    pidx_np = np.asarray(pidx)
    bg = np.zeros((B, cap), np.int32)
    m = pidx_np >= 0
    bg[m] = np.asarray(fused["label"])[pidx_np[m]]
    hm = halo_merge_labels(bc, bv, jnp.asarray(bg), db["core"],
                           fused["n_total"], 0.08, halo_cap=64, max_ids=128)
    want = np.asarray(apply_halo_merge(jnp.asarray(bg), hm["remap"]))
    np.testing.assert_array_equal(np.asarray(labels_sh), want)
    assert int(n_total_sh) == int(hm["n_after"]) == 2


def test_sharded_halo_ring_matches_gather(mesh):
    """ppermute-ring halo union == all_gather union (VERDICT r1 item 3c)."""
    rng = np.random.default_rng(4)
    stripe = np.stack([np.linspace(0, 2.0, 120), np.zeros(120)], axis=1)
    stripe = np.repeat(stripe, 3, axis=0) + 0.005 * rng.standard_normal((360, 2))
    blob = np.array([5.0, 5.0]) + 0.01 * rng.standard_normal((40, 2))
    motor = np.concatenate([stripe, blob])
    rng.shuffle(motor)
    n = len(motor)
    cap = 64
    valid = np.ones(n, bool)
    part = assign_blocks_balanced(jnp.asarray(motor), jnp.asarray(valid), cap)
    bc, bv, pidx, _ = gather_blocks(jnp.asarray(motor), part["block"],
                                    jnp.asarray(valid), 8, cap)
    kw = dict(eps=0.08, min_pts=6, quirks=False,
              noise_capacity_per_device=128, halo_merge=True, halo_cap=64,
              max_ids=128)
    ring = sharded_blocked_dbscan(mesh, bc, bv, halo_mode="ring", **kw)
    gath = sharded_blocked_dbscan(mesh, bc, bv, halo_mode="gather", **kw)
    np.testing.assert_array_equal(np.asarray(ring["label"]),
                                  np.asarray(gath["label"]))
    assert int(ring["n_total"]) == int(gath["n_total"]) == 2


def test_sharded_halo_hier_matches_gather(mesh):
    """Hierarchical union (local grid components + device-boundary skin
    gather) == flat all_gather union, including a cluster whose pieces
    span devices (the stripe)."""
    rng = np.random.default_rng(4)
    stripe = np.stack([np.linspace(0, 2.0, 120), np.zeros(120)], axis=1)
    stripe = np.repeat(stripe, 3, axis=0) + 0.005 * rng.standard_normal((360, 2))
    blob = np.array([5.0, 5.0]) + 0.01 * rng.standard_normal((40, 2))
    motor = np.concatenate([stripe, blob])
    rng.shuffle(motor)
    n = len(motor)
    cap = 64
    valid = np.ones(n, bool)
    part = assign_blocks_balanced(jnp.asarray(motor), jnp.asarray(valid), cap)
    bc, bv, pidx, _ = gather_blocks(jnp.asarray(motor), part["block"],
                                    jnp.asarray(valid), 8, cap)
    kw = dict(eps=0.08, min_pts=6, quirks=False,
              noise_capacity_per_device=128, halo_merge=True, halo_cap=64,
              max_ids=128)
    hier = sharded_blocked_dbscan(mesh, bc, bv, halo_mode="hier",
                                  dev_halo_cap=512, halo_cell_cap=64, **kw)
    gath = sharded_blocked_dbscan(mesh, bc, bv, halo_mode="gather", **kw)
    np.testing.assert_array_equal(np.asarray(hier["label"]),
                                  np.asarray(gath["label"]))
    assert int(hier["n_total"]) == int(gath["n_total"]) == 2
    assert int(hier["halo_overflow"]) == 0


def test_sharded_noise_recluster_grid_matches_dense(mesh):
    rng = np.random.default_rng(5)
    motor = make_blobs(rng, n_clusters=8, pts_per=40, noise=80, spread=0.012)
    n = len(motor)
    valid = np.ones(n, bool)
    part = assign_blocks_balanced(jnp.asarray(motor), jnp.asarray(valid), 128)
    bc, bv, pidx, _ = gather_blocks(jnp.asarray(motor), part["block"],
                                    jnp.asarray(valid), 8, 128)
    kw = dict(eps=0.06, min_pts=9, quirks=True,
              noise_capacity_per_device=256)
    g = sharded_blocked_dbscan(mesh, bc, bv, noise_recluster="grid", **kw)
    d = sharded_blocked_dbscan(mesh, bc, bv, noise_recluster="dense", **kw)
    np.testing.assert_array_equal(np.asarray(g["label"]),
                                  np.asarray(d["label"]))
    assert int(g["n_total"]) == int(d["n_total"])
    assert int(g["noise_overflow"]) == 0


def test_sharded_noise_recluster_distributed_matches_grid(mesh):
    """Owner-sharded re-cluster (O(boundary) collectives) is bit-equal to
    the replicated gathered-grid path at zero overflow."""
    rng = np.random.default_rng(15)
    motor = make_blobs(rng, n_clusters=8, pts_per=40, noise=200,
                       spread=0.012)
    n = len(motor)
    valid = np.ones(n, bool)
    part = assign_blocks_balanced(jnp.asarray(motor), jnp.asarray(valid), 128)
    bc, bv, pidx, _ = gather_blocks(jnp.asarray(motor), part["block"],
                                    jnp.asarray(valid), 8, 128)
    kw = dict(eps=0.06, min_pts=9, quirks=True,
              noise_capacity_per_device=256, noise_cell_cap=256)
    g = sharded_blocked_dbscan(mesh, bc, bv, noise_recluster="grid", **kw)
    d = sharded_blocked_dbscan(mesh, bc, bv, noise_recluster="distributed",
                               noise_skin_cap=512, noise_root_cap=512, **kw)
    np.testing.assert_array_equal(np.asarray(g["label"]),
                                  np.asarray(d["label"]))
    assert int(g["n_total"]) == int(d["n_total"])
    assert int(d["noise_overflow"]) == 0


def test_sharded_split_programs_matches_fused(mesh):
    """Two-program mode (collective-free DBSCAN, then fusion) is bit-equal
    to the fused single program."""
    rng = np.random.default_rng(16)
    motor = make_blobs(rng, n_clusters=8, pts_per=40, noise=80, spread=0.012)
    n = len(motor)
    valid = np.ones(n, bool)
    part = assign_blocks_balanced(jnp.asarray(motor), jnp.asarray(valid), 128)
    bc, bv, pidx, _ = gather_blocks(jnp.asarray(motor), part["block"],
                                    jnp.asarray(valid), 8, 128)
    kw = dict(eps=0.06, min_pts=9, quirks=True,
              noise_capacity_per_device=256, halo_merge=True, max_ids=512,
              halo_mode="hier", dev_halo_cap=256, halo_cell_cap=128,
              noise_recluster="distributed", noise_skin_cap=512,
              noise_root_cap=512, noise_cell_cap=256)
    a = sharded_blocked_dbscan(mesh, bc, bv, **kw)
    b = sharded_blocked_dbscan(mesh, bc, bv, split_programs=True, **kw)
    np.testing.assert_array_equal(np.asarray(a["label"]),
                                  np.asarray(b["label"]))
    assert int(a["n_total"]) == int(b["n_total"])
    assert int(a["halo_overflow"]) == int(b["halo_overflow"])


def test_sharded_noise_overflow_counter(mesh):
    rng = np.random.default_rng(6)
    motor = make_blobs(rng, n_clusters=2, pts_per=30, noise=200, spread=0.01)
    n = len(motor)
    valid = np.ones(n, bool)
    part = assign_blocks_balanced(jnp.asarray(motor), jnp.asarray(valid), 64)
    bc, bv, pidx, _ = gather_blocks(jnp.asarray(motor), part["block"],
                                    jnp.asarray(valid), 8, 64)
    out = sharded_blocked_dbscan(mesh, bc, bv, eps=0.06, min_pts=9,
                                 quirks=False,
                                 noise_capacity_per_device=8)
    assert int(out["noise_overflow"]) > 0


def test_sharded_halo_hier_matches_gather_3d(mesh):
    """3D scale path (VERDICT r2 item 4): hier union == gather union under
    l2_xyz with a 3D stripe cluster split across devices."""
    rng = np.random.default_rng(7)
    stripe = np.stack([np.linspace(0, 2.0, 120), np.zeros(120),
                       np.zeros(120)], axis=1)
    stripe = np.repeat(stripe, 3, axis=0) + 0.005 * rng.standard_normal(
        (360, 3))
    blob = np.array([5.0, 5.0, 1.0]) + 0.01 * rng.standard_normal((40, 3))
    coords = np.concatenate([stripe, blob]).astype(np.float32)
    rng.shuffle(coords)
    n = len(coords)
    cap = 64
    valid = np.ones(n, bool)
    part = assign_blocks_balanced(jnp.asarray(coords), jnp.asarray(valid),
                                  cap)
    bc, bv, pidx, _ = gather_blocks(jnp.asarray(coords), part["block"],
                                    jnp.asarray(valid), 8, cap)
    kw = dict(eps=0.08, min_pts=6, metric="l2_xyz", quirks=False,
              noise_capacity_per_device=128, halo_merge=True, halo_cap=64,
              max_ids=128)
    hier = sharded_blocked_dbscan(mesh, bc, bv, halo_mode="hier",
                                  dev_halo_cap=512, halo_cell_cap=96, **kw)
    gath = sharded_blocked_dbscan(mesh, bc, bv, halo_mode="gather", **kw)
    np.testing.assert_array_equal(np.asarray(hier["label"]),
                                  np.asarray(gath["label"]))
    assert int(hier["n_total"]) == int(gath["n_total"]) == 2
    assert int(hier["halo_overflow"]) == 0


def test_sharded_icp_grid_matches_single_device(mesh):
    """Sharded large-target ICP (per-shard grid locators + query ring) ==
    single-device icp_grid on the gathered target (VERDICT r2 item 5)."""
    from vtkcloudpoint_tpu.parallel.sharded import sharded_icp_grid
    from vtkcloudpoint_tpu.register.nn_grid import icp_grid

    rng = np.random.default_rng(11)
    m = 8 * 2048
    n = 8 * 256
    tgt = rng.uniform(-2, 2, size=(m, 3)).astype(np.float32)
    src = np.asarray(tgt[rng.choice(m, n, replace=False)])
    r_true = np.asarray(se3.rotz(0.05), np.float32)
    t_true = np.float32([0.08, -0.05, 0.02])
    src = (src - t_true) @ r_true  # icp recovers (r_true, t_true)

    cfg = ICPConfig(max_iterations=30, tol=1e-12)
    cell = 0.25
    r_s, t_s, d_s, it_s, ovf = sharded_icp_grid(
        mesh, jnp.asarray(src), jnp.ones(n, bool), jnp.asarray(tgt),
        jnp.ones(m, bool), cfg, cell_size=cell, cell_cap=64,
        fallback_cap=512, chunk=512)
    assert int(ovf) == 0
    res, ovf1 = icp_grid(
        jnp.asarray(src), jnp.ones(n, bool), jnp.asarray(tgt),
        jnp.ones(m, bool), cfg, cell_size=cell, cell_cap=64,
        fallback_cap=512, chunk=512)
    assert int(ovf1) == 0
    # same correspondence sets + same moment-form solve => same trajectory
    np.testing.assert_allclose(np.asarray(r_s), np.asarray(res.r),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(np.asarray(t_s), np.asarray(res.t),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(np.asarray(r_s), r_true, atol=2e-3)
    np.testing.assert_allclose(np.asarray(t_s), t_true, atol=2e-3)
    # the brute per-shard locator (the policy's other choice) is exact too
    r_b, t_b, _, _, ovf_b = sharded_icp_grid(
        mesh, jnp.asarray(src), jnp.ones(n, bool), jnp.asarray(tgt),
        jnp.ones(m, bool), cfg, cell_size=cell, chunk=512, nn="brute")
    assert int(ovf_b) == 0
    np.testing.assert_allclose(np.asarray(r_b), np.asarray(r_s),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(np.asarray(t_b), np.asarray(t_s),
                               rtol=0, atol=2e-5)


def test_sharded_noise_local_engine_dense_matches_grid(mesh):
    """The distributed re-cluster's dense-chunked local engine is
    bit-equal to the grid local engine (the policy's choice today)."""
    rng = np.random.default_rng(17)
    motor = make_blobs(rng, n_clusters=8, pts_per=40, noise=200,
                       spread=0.012)
    n = len(motor)
    valid = np.ones(n, bool)
    part = assign_blocks_balanced(jnp.asarray(motor), jnp.asarray(valid), 128)
    bc, bv, pidx, _ = gather_blocks(jnp.asarray(motor), part["block"],
                                    jnp.asarray(valid), 8, 128)
    kw = dict(eps=0.06, min_pts=9, quirks=True,
              noise_capacity_per_device=256, noise_cell_cap=256,
              noise_recluster="distributed", noise_skin_cap=512,
              noise_root_cap=512)
    g = sharded_blocked_dbscan(mesh, bc, bv, noise_local_engine="grid", **kw)
    d = sharded_blocked_dbscan(mesh, bc, bv, noise_local_engine="dense",
                               **kw)
    np.testing.assert_array_equal(np.asarray(g["label"]),
                                  np.asarray(d["label"]))
    assert int(g["n_total"]) == int(d["n_total"])
    assert int(d["noise_overflow"]) == 0


def test_sharded_centroid_merge_matches_single(mesh):
    """C11 at scale: the psum'd sharded centroid merge equals applying
    merge_centroid_clusters to the same labels single-device."""
    from vtkcloudpoint_tpu.cluster.fusion import merge_centroid_clusters
    from vtkcloudpoint_tpu.ops.segment import cluster_means

    rng = np.random.default_rng(19)
    motor = make_blobs(rng, n_clusters=8, pts_per=40, noise=40, spread=0.012)
    n = len(motor)
    valid = np.ones(n, bool)
    part = assign_blocks_balanced(jnp.asarray(motor), jnp.asarray(valid), 128)
    bc, bv, pidx, _ = gather_blocks(jnp.asarray(motor), part["block"],
                                    jnp.asarray(valid), 8, 128)
    kw = dict(eps=0.06, min_pts=9, quirks=False,
              noise_capacity_per_device=256, max_ids=256)
    base = sharded_blocked_dbscan(mesh, bc, bv, **kw)
    merged = sharded_blocked_dbscan(mesh, bc, bv, centroid_merge=True,
                                    merge_eps=0.4, **kw)
    # single-device reference: centroids of the base labels, then the merge
    lab_flat = jnp.asarray(base["label"]).reshape(-1)
    coords_flat = bc.reshape(-1, 2)
    vflat = bv.reshape(-1) & (lab_flat > 0)
    cen, cnt = cluster_means(coords_flat, lab_flat, vflat, 256)
    mg = merge_centroid_clusters(cen[:, :2], cnt > 0, 0.4)
    want = np.asarray(mg["remap"])[
        np.clip(np.asarray(base["label"]), 0, 255)]
    np.testing.assert_array_equal(np.asarray(merged["label"]), want)
    assert int(merged["n_total"]) == int(mg["n_after"])
    assert int(merged["n_total"]) < int(base["n_total"])


def test_sharded_skin_exchange_owner_matches_gather(mesh):
    """Owner-routed all_to_all skin union (O(own boundary) payload) ==
    gathered-skin union, bit-for-bit, including cross-device stripes
    (VERDICT r4 missing item 3)."""
    rng = np.random.default_rng(11)
    stripe = np.stack([np.linspace(0, 2.0, 150), np.zeros(150)], axis=1)
    stripe = np.repeat(stripe, 3, axis=0) + 0.004 * rng.standard_normal(
        (450, 2))
    blob = np.array([5.0, 5.0]) + 0.01 * rng.standard_normal((62, 2))
    motor = np.concatenate([stripe, blob])
    rng.shuffle(motor)
    n = len(motor)
    cap = 64
    valid = np.ones(n, bool)
    part = assign_blocks_balanced(jnp.asarray(motor), jnp.asarray(valid), cap)
    bc, bv, pidx, _ = gather_blocks(jnp.asarray(motor), part["block"],
                                    jnp.asarray(valid), 8, cap)
    kw = dict(eps=0.08, min_pts=6, quirks=False,
              noise_capacity_per_device=128, halo_merge=True, halo_cap=64,
              max_ids=128, halo_mode="hier", dev_halo_cap=512,
              halo_cell_cap=64)
    own = sharded_blocked_dbscan(mesh, bc, bv, skin_exchange="owner", **kw)
    gat = sharded_blocked_dbscan(mesh, bc, bv, skin_exchange="gather", **kw)
    np.testing.assert_array_equal(np.asarray(own["label"]),
                                  np.asarray(gat["label"]))
    assert int(own["n_total"]) == int(gat["n_total"]) == 2
    assert int(own["halo_overflow"]) == 0


def test_sharded_skin_owner_dest_cap_overflow_surfaces(mesh):
    """An under-sized per-destination routing capacity must surface in
    halo_overflow, never silently drop skin copies."""
    rng = np.random.default_rng(12)
    stripe = np.stack([np.linspace(0, 2.0, 150), np.zeros(150)], axis=1)
    stripe = np.repeat(stripe, 3, axis=0) + 0.004 * rng.standard_normal(
        (450, 2))
    motor = np.concatenate(
        [stripe, np.array([5.0, 5.0]) + 0.01 * rng.standard_normal((62, 2))])
    rng.shuffle(motor)
    valid = np.ones(len(motor), bool)
    part = assign_blocks_balanced(jnp.asarray(motor), jnp.asarray(valid), 64)
    bc, bv, pidx, _ = gather_blocks(jnp.asarray(motor), part["block"],
                                    jnp.asarray(valid), 8, 64)
    out = sharded_blocked_dbscan(
        mesh, bc, bv, eps=0.08, min_pts=6, quirks=False,
        noise_capacity_per_device=128, halo_merge=True, halo_cap=64,
        max_ids=128, halo_mode="hier", dev_halo_cap=512, halo_cell_cap=64,
        skin_exchange="owner", skin_dest_cap=1)
    assert int(out["halo_overflow"]) > 0
