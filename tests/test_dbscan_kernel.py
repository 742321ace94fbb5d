"""Per-block DBSCAN engines: the CUDA kernel's wrapper (padding, shapes,
engine choice) on the CPU, and the kernel itself against the plain path on
a GPU (marked ``gpu``)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vtkcloudpoint_tpu.cluster import dbscan_cuda
from vtkcloudpoint_tpu.cluster.dbscan import (
    dbscan_blocks, dbscan_blocks_dispatch, resolve_backend,
)
from vtkcloudpoint_tpu.policy import policy


def make_blobs(rng, n_clusters, pts_per, noise, spread):
    """Gaussian blobs + uniform noise in the unit square, shuffled (the
    conftest generator, kept here so the file imports nothing from
    ``tests`` -- another installed ``tests`` package can shadow it)."""
    centers = rng.uniform(0.1, 0.9, size=(n_clusters, 2))
    pts = [c + spread * rng.standard_normal((pts_per, 2)) for c in centers]
    pts.append(rng.uniform(0, 1, size=(noise, 2)))
    out = np.concatenate(pts)
    return out[rng.permutation(len(out))]


def _blocks(seed, n_blocks=4, cap=128, fill=None):
    rng = np.random.default_rng(seed)
    coords = np.zeros((n_blocks, cap, 2), np.float32)
    valid = np.zeros((n_blocks, cap), bool)
    for b in range(n_blocks):
        pts = make_blobs(rng, n_clusters=3, pts_per=25, noise=15,
                         spread=0.012).astype(np.float32)[:fill or cap]
        coords[b, :len(pts)] = pts
        valid[b, :len(pts)] = True
    return jnp.asarray(coords), jnp.asarray(valid)


@pytest.mark.parametrize("cap, nd, metric, dtype, ok", [
    (1024, 2, "l1_motor", jnp.float32, True),
    (200, 2, "signed_sum_xy", jnp.float32, True),
    (1025, 2, "l1_motor", jnp.float32, False),
    (256, 3, "l2_xyz", jnp.float32, False),
    (64, 2, "l2_xyz", jnp.float32, False),
    (256, 2, "l1_motor", jnp.float64, False),
])
def test_kernel_supports(cap, nd, metric, dtype, ok):
    assert dbscan_cuda.kernel_supports(cap, nd, metric, dtype) is ok


@pytest.mark.parametrize("cap", [1, 31, 32, 200, 1024])
def test_pad_blocks(cap):
    c = jnp.arange(3 * cap * 2, dtype=jnp.float32).reshape(3, cap, 2)
    v = jnp.ones((3, cap), bool)
    cp, vp = dbscan_cuda.pad_blocks(c, v)
    capp = dbscan_cuda.padded_cap(cap)
    assert capp % 32 == 0 and capp >= cap and capp - cap < 32
    assert cp.shape == (3, capp, 2) and vp.shape == (3, capp)
    np.testing.assert_array_equal(np.asarray(cp[:, :cap]), np.asarray(c))
    assert bool(jnp.all(vp[:, :cap])) and not bool(jnp.any(vp[:, cap:]))


@pytest.mark.parametrize("cap", [100, 128])
def test_padding_preserves_plain_labels(cap):
    """The wrapper's claim: invalid padding slots change nothing once the
    result is sliced back to ``cap``."""
    c, v = _blocks(5, cap=cap, fill=cap - 10)
    cp, vp = dbscan_cuda.pad_blocks(c, v)
    a = dbscan_blocks(c, v, 0.06, 6)
    b = dbscan_blocks(cp, vp, 0.06, 6)
    for k in ("label", "core"):
        np.testing.assert_array_equal(np.asarray(b[k][:, :cap]),
                                      np.asarray(a[k]))
    np.testing.assert_array_equal(np.asarray(b["n_clusters"]),
                                  np.asarray(a["n_clusters"]))


def test_ffi_call_shapes():
    c, v = _blocks(0, n_blocks=5, cap=96)
    out = jax.eval_shape(
        lambda c, v: dbscan_cuda._ffi_dbscan(c, v, 0.06, 9, "l1_motor"),
        c, v)
    assert [(o.shape, o.dtype) for o in out] == [
        ((5, 96), jnp.int32), ((5,), jnp.int32), ((5, 96), jnp.bool_)]


def test_engine_choice_per_platform():
    assert policy("gpu").dbscan_blocks == "cuda"
    assert policy("cpu").dbscan_blocks == "jnp"
    assert resolve_backend("auto") == "jnp"          # the tests run on CPU
    assert resolve_backend("jnp") == "jnp"
    with pytest.raises(ValueError):
        resolve_backend("pallas")


def test_explicit_cuda_raises_without_gpu():
    c, v = _blocks(1)
    with pytest.raises(RuntimeError):
        resolve_backend("cuda")
    with pytest.raises(RuntimeError):
        dbscan_blocks_dispatch(c, v, 0.06, 9, backend="cuda")
    with pytest.raises(RuntimeError):
        dbscan_cuda.dbscan_blocks_cuda(c, v, 0.06, 9)
    with pytest.raises(ValueError):
        dbscan_cuda.dbscan_blocks_cuda(c, v, 0.06, 9, metric="l2_xyz")


def test_backend_dispatch_pipeline(rng):
    """cluster_scan(backend="auto") is the plain path on the CPU, bit for
    bit."""
    from vtkcloudpoint_tpu.cluster.pipeline import cluster_scan
    from vtkcloudpoint_tpu.config import EngineConfig, ClusterConfig

    pts = make_blobs(rng, n_clusters=4, pts_per=40, noise=30,
                     spread=0.012).astype(np.float32)
    n = len(pts)
    motor = jnp.asarray(pts)
    xyz = jnp.concatenate([motor, jnp.zeros((n, 1), jnp.float32)], 1)
    valid = jnp.ones(n, bool)
    cfg = EngineConfig(cluster=ClusterConfig(eps=0.06, min_pts=6,
                                             block_capacity=128))
    kw = dict(max_blocks=8, max_clusters=64, cluster_capacity=128,
              noise_capacity=128, max_hull=16)
    a = cluster_scan(xyz, motor, valid, cfg, backend="auto", **kw)
    b = cluster_scan(xyz, motor, valid, cfg, backend="jnp", **kw)
    np.testing.assert_array_equal(np.asarray(a.label), np.asarray(b.label))
    assert int(a.n_clusters) == int(b.n_clusters)


def test_backend_dispatch_icp(rng):
    """ICP (one correspondence engine on every platform) recovers a known
    rigid motion."""
    from vtkcloudpoint_tpu.register.icp import icp
    from vtkcloudpoint_tpu.config import ICPConfig

    src = rng.uniform(-1, 1, (96, 3)).astype(np.float32)
    ang = 0.2
    r = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    t = np.float32([0.1, -0.05, 0.02])
    tgt = src @ r.T + t
    valid = jnp.ones(96, bool)
    res = icp(jnp.asarray(src), valid, jnp.asarray(tgt), valid,
              ICPConfig(max_iterations=30))
    np.testing.assert_allclose(np.asarray(res.r), r, atol=1e-5)
    np.testing.assert_allclose(np.asarray(res.t), t, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("cap, metric", [(128, "l1_motor"), (100, "l1_motor"),
                                         (1024, "l1_motor"),
                                         (64, "signed_sum_xy")])
def test_kernel_matches_plain_on_gpu(gpu, cap, metric):
    c, v = _blocks(7, n_blocks=6, cap=cap, fill=min(cap, 115))
    a = dbscan_blocks_dispatch(c, v, 0.06, 6, metric, backend="cuda")
    b = dbscan_blocks(c, v, 0.06, 6, metric)
    for k in ("label", "n_clusters", "core"):
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


@pytest.mark.gpu
def test_eager_scan_kernel_then_plain_on_gpu(gpu, rng):
    """cluster_scan called eagerly on the kernel path, then the plain path,
    then both again, with the grid noise engine (noise capacity > 8192):
    every call reuses the jitted stages of the one before, and all labels
    agree."""
    from vtkcloudpoint_tpu.cluster.pipeline import cluster_scan
    from vtkcloudpoint_tpu.config import EngineConfig, ClusterConfig

    pts = make_blobs(rng, n_clusters=40, pts_per=200, noise=2000,
                     spread=0.01).astype(np.float32)
    n = len(pts)
    motor = jnp.asarray(pts)
    xyz = jnp.concatenate([motor, jnp.zeros((n, 1), jnp.float32)], 1)
    valid = jnp.ones(n, bool)
    cfg = EngineConfig(cluster=ClusterConfig(eps=0.03, min_pts=6,
                                             block_capacity=256))
    kw = dict(mode="balanced", max_blocks=-(-n // 256), quirks=False,
              max_clusters=256, cluster_capacity=256, noise_capacity=16384,
              max_hull=16)
    runs = [cluster_scan(xyz, motor, valid, cfg, backend=b, **kw)
            for b in ("cuda", "jnp", "cuda", "jnp")]
    for r in runs[1:]:
        np.testing.assert_array_equal(np.asarray(r.label),
                                      np.asarray(runs[0].label))
        assert int(r.n_clusters) == int(runs[0].n_clusters)
