"""Round-3 primitives: capacity sizing, equilibrated solves, matmul segment
sums, grid-metric dispatch."""
import numpy as np
import jax
import jax.numpy as jnp

from vtkcloudpoint_tpu.config import ParallelConfig


def test_size_caps_formulas():
    # PARITY.md recorded configuration: eps=5.5e-4, rho=3e7, cap=1024
    caps = ParallelConfig.size_caps(5.5e-4, 3e7, 1024,
                                    blocks_per_device=1221,
                                    noise_frac=0.004, safety=2.0)
    assert abs(caps["ball_points"] - 18.15) < 0.1
    # shell estimate (385) exceeds cap/4 -> clamps to every block point
    assert caps["halo_cap"] == 1024
    # skin stays in the asymptotic regime: 2 * 16 * eps * sqrt(n_dev * rho)
    assert 40_000 < caps["dev_halo_cap"] < 250_000
    assert caps["dev_halo_cap"] < 1221 * 1024 / 4
    # Poisson margin: cell cap covers mean + 6 sigma, scaled by safety
    lam = 3e7 * 5.5e-4 ** 2
    assert caps["cell_cap"] >= 2.0 * (lam + 6 * lam ** 0.5)
    assert caps["noise_capacity"] >= 2.0 * 0.004 * 1221 * 1024


def test_size_caps_covers_measured_50m_skin():
    """TIER5_r05 calibration: the 50M disk run (12,208 blocks x 512 per
    device) needed ~267k skin slots; the old perimeter-only model capped
    at 241,008 and dropped 25,790 points. The linear allowance must
    cover the measured need without clamping to all device points."""
    caps = ParallelConfig.size_caps(5.5e-4, 3e7, 512,
                                    blocks_per_device=12208,
                                    noise_frac=0.004, safety=2.0)
    dev_pts = 12208 * 512
    assert caps["dev_halo_cap"] >= 267_000
    assert caps["dev_halo_cap"] < dev_pts          # not the clamp


def test_size_caps_degenerate_clamps():
    # block side << eps: everything is shell -> cap at all points
    caps = ParallelConfig.size_caps(0.1, 1e6, 256, blocks_per_device=2)
    assert caps["halo_cap"] == 256
    assert caps["dev_halo_cap"] == 512


def test_solve_spd_ill_conditioned_f32():
    """Equilibrated f32 solve must track the f64 solution of a
    gauge-style system (diag spread 1e6) -- the raw f32 solve does not."""
    from vtkcloudpoint_tpu.slam.ba import _solve_spd

    rng = np.random.default_rng(0)
    n = 120
    a = rng.standard_normal((n, n))
    h64 = a @ a.T + n * np.eye(n)
    h64[:6, :6] += 1e6 * np.eye(6)        # the gauge prior block
    x_true = rng.standard_normal(n)
    g64 = h64 @ x_true
    x32 = np.asarray(_solve_spd(jnp.asarray(h64, jnp.float32),
                                jnp.asarray(g64, jnp.float32)))
    rel = np.linalg.norm(x32 - x_true) / np.linalg.norm(x_true)
    assert rel < 1e-4, rel


def test_indicator_segment_sum_exact():
    from vtkcloudpoint_tpu.ops.segment import indicator_segment_sum

    rng = np.random.default_rng(1)
    n, k = 5000, 37
    seg = rng.integers(0, k + 1, n)        # k == sentinel drop row
    vals = rng.standard_normal((n, 4)).astype(np.float32)
    out = np.asarray(indicator_segment_sum(
        jnp.asarray(vals), jnp.asarray(seg, jnp.int32), k, chunk=512))
    ref = np.zeros((k, 4), np.float64)
    for s, v in zip(seg, vals):
        if s < k:
            ref[s] += v
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)


def test_grid_metric_dispatch():
    from vtkcloudpoint_tpu.cluster.grid import grid_metric

    assert grid_metric("l1_motor", 2) == "l1_motor"
    assert grid_metric("l2_xyz", 3) == "l2_xyz"
    assert grid_metric("l2_xyz", 2) == "l2_xy"
    assert grid_metric("signed_sum_xy", 2) is None
