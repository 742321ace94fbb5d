"""Grid-hash NN correspondence vs exact brute force (VERDICT r1 item 2)."""
import numpy as np
import jax.numpy as jnp
import pytest

from vtkcloudpoint_tpu.register.icp import icp, nn_correspond
from vtkcloudpoint_tpu.register.nn_grid import (
    build_nn_grid, nn_grid, icp_grid,
)
from vtkcloudpoint_tpu.config import ICPConfig


def _brute(query, ref, ref_valid):
    """f64 NumPy exact NN oracle (the jnp brute path uses the |a|^2-2ab+|b|^2
    expansion, which rounds differently in f32; the grid path computes direct
    differences and is the more accurate of the two)."""
    q = np.asarray(query, np.float64)
    r = np.asarray(ref, np.float64)
    d2 = ((q[:, None, :] - r[None, :, :]) ** 2).sum(-1)
    d2[:, ~np.asarray(ref_valid)] = np.inf
    idx = d2.argmin(1)
    return idx.astype(np.int32), d2[np.arange(len(q)), idx]


@pytest.mark.parametrize("seed", range(3))
def test_exact_vs_brute(seed):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(0, 10, (2000, 3)).astype(np.float32)
    rv = rng.uniform(size=2000) > 0.1
    # queries near the cloud: almost all resolve in-stencil
    query = ref[rng.integers(0, 2000, 500)] + \
        0.05 * rng.standard_normal((500, 3)).astype(np.float32)
    cell = 0.5
    grid = build_nn_grid(jnp.asarray(ref), jnp.asarray(rv), cell)
    idx, d2, resolved, overflow = nn_grid(
        grid, jnp.asarray(query), jnp.asarray(ref), jnp.asarray(rv), cell,
        cell_cap=32, fallback_cap=500,
    )
    bi, bd = _brute(query, ref, rv)
    assert int(overflow) == 0
    assert bool(np.all(np.asarray(resolved)))
    np.testing.assert_allclose(np.asarray(d2), bd, rtol=1e-5, atol=1e-7)
    # indices may differ only at exact distance ties
    diff = np.asarray(idx) != bi
    if diff.any():
        np.testing.assert_allclose(np.asarray(d2)[diff], bd[diff],
                                   rtol=1e-6)


def test_far_queries_fall_back():
    rng = np.random.default_rng(7)
    ref = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    rv = np.ones(300, bool)
    query = (rng.uniform(5, 6, (50, 3))).astype(np.float32)  # off-grid
    cell = 0.2
    grid = build_nn_grid(jnp.asarray(ref), jnp.asarray(rv), cell)
    idx, d2, resolved, overflow = nn_grid(
        grid, jnp.asarray(query), jnp.asarray(ref), jnp.asarray(rv), cell,
        cell_cap=8, fallback_cap=64,
    )
    bi, bd = _brute(query, ref, rv)
    assert int(overflow) == 0
    np.testing.assert_allclose(np.asarray(d2), bd, rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(idx), bi)


def test_cell_overflow_is_conservative():
    """A cell denser than cell_cap must not silently return a wrong NN."""
    rng = np.random.default_rng(3)
    # 200 points crammed in one cell + a few outside
    dense = (0.5 + 0.001 * rng.standard_normal((200, 3))).astype(np.float32)
    sparse = rng.uniform(2, 3, (20, 3)).astype(np.float32)
    ref = np.concatenate([dense, sparse])
    rv = np.ones(len(ref), bool)
    query = (0.5 + 0.001 * rng.standard_normal((40, 3))).astype(np.float32)
    cell = 1.0
    grid = build_nn_grid(jnp.asarray(ref), jnp.asarray(rv), cell)
    idx, d2, resolved, overflow = nn_grid(
        grid, jnp.asarray(query), jnp.asarray(ref), jnp.asarray(rv), cell,
        cell_cap=8, fallback_cap=64,
    )
    bi, bd = _brute(query, ref, rv)
    assert int(overflow) == 0          # fallback absorbed them
    np.testing.assert_allclose(np.asarray(d2), bd, rtol=1e-5, atol=1e-9)


def test_overflow_counter_reports():
    rng = np.random.default_rng(5)
    ref = rng.uniform(0, 1, (100, 3)).astype(np.float32)
    rv = np.ones(100, bool)
    query = rng.uniform(9, 10, (30, 3)).astype(np.float32)  # all unresolved
    cell = 0.5
    grid = build_nn_grid(jnp.asarray(ref), jnp.asarray(rv), cell)
    _, _, resolved, overflow = nn_grid(
        grid, jnp.asarray(query), jnp.asarray(ref), jnp.asarray(rv), cell,
        cell_cap=8, fallback_cap=10,   # too small: 20 stay unresolved
    )
    assert int(overflow) == 20
    assert int(np.sum(~np.asarray(resolved))) == 20


def test_icp_grid_matches_brute_icp():
    rng = np.random.default_rng(11)
    src = rng.uniform(-2, 2, (400, 3)).astype(np.float32)
    ang = 0.15
    r = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    tgt = (src @ r.T + np.float32([0.3, -0.2, 0.1]))
    valid = jnp.ones(400, bool)
    cfg = ICPConfig(max_iterations=40)
    res_b = icp(jnp.asarray(src), valid, jnp.asarray(tgt), valid, cfg)
    res_g, overflow = icp_grid(jnp.asarray(src), valid, jnp.asarray(tgt),
                               valid, cfg, cell_size=1.0, cell_cap=64,
                               fallback_cap=400)
    assert int(overflow) == 0
    np.testing.assert_allclose(np.asarray(res_g.r), np.asarray(res_b.r),
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(res_g.t), np.asarray(res_b.t),
                               atol=2e-5)
