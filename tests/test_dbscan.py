"""DBSCAN engine vs sequential reference-semantics oracle.

The contract under test: dbscan_padded reproduces the oracle's labels
bit-for-bit, including the reference's quirky border-point assignment
(last-writer-wins => max adjacent cluster id, DBImproved.cs:87).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from tests.conftest import make_blobs
from vtkcloudpoint_tpu.cluster.dbscan import dbscan_padded, dbscan_blocks
from vtkcloudpoint_tpu.oracle.dbscan_oracle import dbscan_oracle


def run_engine(pts, eps, min_pts, metric="l1_motor", cf=0, cap=None):
    n = len(pts)
    cap = cap or n
    coords = np.zeros((cap, pts.shape[1]))
    coords[:n] = pts
    valid = np.zeros(cap, bool)
    valid[:n] = True
    out = dbscan_padded(jnp.asarray(coords), jnp.asarray(valid), eps, min_pts,
                        metric, cf)
    return np.asarray(out["label"]), int(out["n_clusters"]), np.asarray(out["core"])


@pytest.mark.parametrize("seed", range(8))
def test_matches_oracle_blobs(seed):
    rng = np.random.default_rng(seed)
    pts = make_blobs(rng, n_clusters=4, pts_per=30, noise=25, spread=0.01)
    eps, min_pts = 0.06, 9
    ref_labels, ref_k, _ = dbscan_oracle(pts, eps, min_pts)
    labels, k, _ = run_engine(pts, eps, min_pts)
    np.testing.assert_array_equal(labels[: len(pts)], ref_labels)
    assert k == ref_k


@pytest.mark.parametrize("seed", range(4))
def test_matches_oracle_uniform(seed):
    """Dense uniform data: many border/bridge points stress the max-id rule."""
    rng = np.random.default_rng(100 + seed)
    pts = rng.uniform(0, 1, size=(200, 2))
    eps, min_pts = 0.07, 5
    ref_labels, ref_k, _ = dbscan_oracle(pts, eps, min_pts)
    labels, k, _ = run_engine(pts, eps, min_pts)
    np.testing.assert_array_equal(labels[: len(pts)], ref_labels)
    assert k == ref_k


def test_cf_seeding():
    """cf seeds continued numbering (reference FrmMain.cs:1509)."""
    rng = np.random.default_rng(3)
    pts = make_blobs(rng, n_clusters=3, pts_per=25, noise=10)
    eps, min_pts = 0.06, 9
    ref_labels, ref_k, _ = dbscan_oracle(pts, eps, min_pts, cf=7)
    labels, k, _ = run_engine(pts, eps, min_pts, cf=7)
    np.testing.assert_array_equal(labels[: len(pts)], ref_labels)
    assert ref_labels[ref_labels > 0].min() >= 8


def test_padding_invariance():
    rng = np.random.default_rng(5)
    pts = make_blobs(rng, n_clusters=3, pts_per=25, noise=10)
    labels_a, k_a, _ = run_engine(pts, 0.06, 9, cap=len(pts))
    labels_b, k_b, _ = run_engine(pts, 0.06, 9, cap=len(pts) + 57)
    np.testing.assert_array_equal(labels_a, labels_b[: len(pts)])
    assert (labels_b[len(pts):] == 0).all()
    assert k_a == k_b


def test_all_noise_and_all_one_cluster():
    # spread points: all noise
    pts = np.stack([np.arange(20.0), np.zeros(20)], axis=1)
    labels, k, core = run_engine(pts, 0.5, 3)
    assert k == 0 and (labels == 0).all() and not core.any()
    # one tight ball
    pts = np.full((15, 2), 3.0) + 1e-4 * np.arange(30).reshape(15, 2)
    labels, k, _ = run_engine(pts, 0.1, 5)
    assert k == 1 and (labels[:15] == 1).all()


def test_l2_metric():
    rng = np.random.default_rng(9)
    pts3 = np.concatenate([
        rng.standard_normal((40, 3)) * 0.05 + np.array([1.0, 1, 1]),
        rng.standard_normal((40, 3)) * 0.05 + np.array([3.0, 3, 3]),
    ])
    ref_labels, ref_k, _ = dbscan_oracle(pts3, 0.3, 5, metric="l2_xyz")
    labels, k, _ = run_engine(pts3, 0.3, 5, metric="l2_xyz")
    np.testing.assert_array_equal(labels[: len(pts3)], ref_labels)
    assert k == ref_k == 2


def test_blocks_vmap():
    """dbscan_blocks == per-block dbscan_padded."""
    rng = np.random.default_rng(11)
    B, cap = 6, 128
    coords = np.zeros((B, cap, 2))
    valid = np.zeros((B, cap), bool)
    per_block = []
    for b in range(B):
        pts = make_blobs(rng, n_clusters=2, pts_per=20, noise=10)
        coords[b, : len(pts)] = pts
        valid[b, : len(pts)] = True
        per_block.append(pts)
    out = dbscan_blocks(jnp.asarray(coords), jnp.asarray(valid), 0.06, 9,
                        chunk=2)
    for b in range(B):
        ref_labels, ref_k, _ = dbscan_oracle(per_block[b], 0.06, 9)
        np.testing.assert_array_equal(
            np.asarray(out["label"])[b, : len(per_block[b])], ref_labels)
        assert int(out["n_clusters"][b]) == ref_k


def test_dense_chunked_matches_padded():
    """dbscan_dense_chunked (tile-recompute engine for mid-size noise
    re-clusters) is bit-identical to dbscan_padded."""
    import numpy as np
    import jax.numpy as jnp
    from vtkcloudpoint_tpu.cluster.dbscan import (
        dbscan_padded, dbscan_dense_chunked)

    rng = np.random.default_rng(11)
    for trial in range(3):
        n = 700 + 100 * trial
        k = 6
        centers = rng.uniform(0, 1, (k, 2))
        pts = np.concatenate(
            [c + 0.01 * rng.standard_normal((n // (k + 1), 2))
             for c in centers]
            + [rng.uniform(0, 1, (n - (n // (k + 1)) * k, 2))])[:n]
        coords = jnp.asarray(pts.astype(np.float32))
        valid = jnp.asarray(rng.random(n) < 0.9)
        a = dbscan_padded(coords, valid, 0.03, 5, "l1_motor", cf=7)
        b = dbscan_dense_chunked(coords, valid, 0.03, 5, "l1_motor",
                                 cf=7, chunk=128)
        np.testing.assert_array_equal(np.asarray(a["label"]),
                                      np.asarray(b["label"]))
        assert int(a["n_clusters"]) == int(b["n_clusters"])
        np.testing.assert_array_equal(np.asarray(a["core"]),
                                      np.asarray(b["core"]))


def test_dense_chunked_components_match_grid():
    """min_pts=1 components (the _hier_union stage-1 contract): the
    chunked-dense engine and the grid engine agree label-for-label, so
    either policy choice of the stage-1 engine in parallel.sharded is a
    drop-in."""
    import numpy as np
    import jax.numpy as jnp
    from vtkcloudpoint_tpu.cluster.dbscan import dbscan_dense_chunked
    from vtkcloudpoint_tpu.cluster.grid import dbscan_grid

    rng = np.random.default_rng(12)
    for metric in ("l1_motor", "l2_xy"):
        n = 600
        pts = np.concatenate([
            np.stack([np.linspace(0, 1, 200), np.zeros(200)], 1)
            + 0.002 * rng.standard_normal((200, 2)),
            rng.uniform(0, 1, (n - 200, 2)),
        ]).astype(np.float32)
        coords = jnp.asarray(pts)
        valid = jnp.asarray(rng.random(n) < 0.9)
        g = dbscan_grid(coords, valid, 0.01, 1, metric, cell_cap=64)
        d = dbscan_dense_chunked(coords, valid, 0.01, 1, metric, chunk=128)
        assert int(g["overflow"]) == 0
        np.testing.assert_array_equal(np.asarray(g["label"]),
                                      np.asarray(d["label"]))
        assert int(g["n_clusters"]) == int(d["n_clusters"])
