"""The plain XLA engines that every platform runs, each against an
independent NumPy oracle: per-block DBSCAN, cluster shapes and the ICP
nearest-neighbour search."""
import numpy as np
import jax.numpy as jnp
import pytest

from tests.conftest import make_blobs
from vtkcloudpoint_tpu.cluster.dbscan import dbscan_blocks
from vtkcloudpoint_tpu.ops.geometry import cluster_shapes
from vtkcloudpoint_tpu.oracle.dbscan_oracle import dbscan_oracle
from vtkcloudpoint_tpu.oracle.geometry_oracle import (
    hull_monotone_chain, mec_bruteforce, min_area_rect_bruteforce,
)
from vtkcloudpoint_tpu.register.icp import nn_correspond


@pytest.mark.parametrize("metric", ["l1_motor", "l2_xyz", "signed_sum_xy"])
@pytest.mark.parametrize("seed", range(3))
def test_dbscan_blocks_matches_oracle(seed, metric):
    rng = np.random.default_rng(seed)
    nd = 3 if metric == "l2_xyz" else 2
    n_blocks, cap = 3, 128
    coords = np.zeros((n_blocks, cap, nd))
    valid = np.zeros((n_blocks, cap), bool)
    fills = []
    for b in range(n_blocks):
        pts = make_blobs(rng, n_clusters=3, pts_per=25, noise=15,
                         spread=0.012)
        if nd == 3:
            pts = np.concatenate([pts, 0.01 * rng.random((len(pts), 1))], 1)
        coords[b, :len(pts)] = pts
        valid[b, :len(pts)] = True
        fills.append(len(pts))
    eps = 0.05 if metric == "l2_xyz" else 0.06
    out = dbscan_blocks(jnp.asarray(coords), jnp.asarray(valid), eps, 6,
                        metric)
    for b, m in enumerate(fills):
        lab, k, core = dbscan_oracle(coords[b, :m], eps, 6, metric)
        np.testing.assert_array_equal(np.asarray(out["core"][b, :m]), core)
        assert not np.any(np.asarray(out["label"][b, m:]))
        if metric == "signed_sum_xy":
            # dx + dy is not symmetric, so "within eps" is a directed
            # relation: the engine's label closure is reachability over it,
            # the reference's BFS is visit order over it, and the two
            # agree only for symmetric metrics. Core flags (out-degree
            # counts) agree either way.
            continue
        np.testing.assert_array_equal(np.asarray(out["label"][b, :m]), lab)
        assert int(out["n_clusters"][b]) == k


def _clusters(seed, k=12, cap=128):
    rng = np.random.default_rng(seed)
    points = np.zeros((k, cap, 2))
    valid = np.zeros((k, cap), bool)
    counts = np.zeros(k, np.int32)
    for i in range(k):
        n = int(rng.integers(2, cap))
        if i % 5 == 1:      # collinear (within max_hull: gift-wrap keeps
            n = min(n, 30)  # every boundary-collinear point)
            points[i, :n, 0] = np.linspace(0, 1, n)
            points[i, :n, 1] = 0.5
        elif i % 5 == 2:    # two points
            n = 2
            points[i, :n] = [[0.1, 0.2], [0.7, 0.9]]
        else:
            points[i, :n] = (rng.uniform(0.1, 0.9, 2)
                             + 0.05 * rng.standard_normal((n, 2)))
        valid[i, :n] = True
        counts[i] = n
    return points, valid, counts


@pytest.mark.parametrize("seed", range(4))
def test_cluster_shapes_match_oracle(seed):
    points, valid, counts = _clusters(seed)
    out = cluster_shapes(jnp.asarray(points), jnp.asarray(valid),
                         jnp.asarray(counts), max_hull=32, chunk_k=12)
    for i, n in enumerate(counts):
        pts = points[i, :n]
        if n < 4:       # circles only for clusters > 3 points
            assert float(out["radius"][i]) == 0.0
            continue
        _, _, r = mec_bruteforce(hull_monotone_chain(pts))
        _, _, area = min_area_rect_bruteforce(pts)
        np.testing.assert_allclose(float(out["radius"][i]), r, rtol=1e-9,
                                   atol=1e-12)
        np.testing.assert_allclose(float(out["rect_area"][i]), area,
                                   rtol=1e-9, atol=1e-12)


def test_cluster_shapes_empty_and_tiny():
    points = np.zeros((3, 64, 2))
    valid = np.zeros((3, 64), bool)
    counts = np.zeros(3, np.int32)
    points[1, 0] = [0.5, 0.5]
    valid[1, 0] = True
    counts[1] = 1
    points[2, :6] = 0.3 + 0.01 * np.random.default_rng(0).standard_normal(
        (6, 2))
    valid[2, :6] = True
    counts[2] = 6
    out = cluster_shapes(jnp.asarray(points), jnp.asarray(valid),
                         jnp.asarray(counts), max_hull=16)
    r = np.asarray(out["radius"])
    assert r[0] == 0.0 and r[1] == 0.0
    _, _, want = mec_bruteforce(points[2, :6])
    np.testing.assert_allclose(r[2], want, rtol=1e-9)


@pytest.mark.parametrize("ties", [False, True])
def test_nn_correspond_matches_brute_argmin(ties):
    rng = np.random.default_rng(3)
    q = rng.uniform(0, 1, size=(200, 3))
    r = rng.uniform(0, 1, size=(350, 3))
    if ties:        # duplicated references: the lowest index must win
        r[200:] = r[:150]
        q[:50] = r[:50]
    rv = rng.random(350) < 0.9
    idx, d2 = nn_correspond(jnp.asarray(q), jnp.asarray(r), jnp.asarray(rv),
                            chunk=64)
    dist = ((q[:, None, :] - r[None, :, :]) ** 2).sum(-1)
    dist[:, ~rv] = np.inf
    want = np.argmin(dist, axis=1)          # first minimum = lowest index
    if ties:
        # the expansion form rounds differently from the direct form, so
        # compare the index only where the best distance is unambiguous
        # beyond rounding or is an exact duplicate
        best = dist[np.arange(len(q)), want]
        second = np.sort(dist, axis=1)[:, 1]
        exact = np.isclose(dist, best[:, None], rtol=0, atol=0).sum(1) > 1
        clear = (second - best > 1e-9) | exact
        np.testing.assert_array_equal(np.asarray(idx)[clear], want[clear])
    else:
        np.testing.assert_array_equal(np.asarray(idx), want)
    np.testing.assert_allclose(np.asarray(d2), dist.min(axis=1), atol=1e-9)
