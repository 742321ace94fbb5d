"""Shared benchmark utilities: synthetic clouds, timing, JSON output."""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def setup_jax(force_cpu_devices: int | None = None):
    """--cpu N on any tier script forces N virtual CPU devices."""
    import jax

    if force_cpu_devices is None and "--cpu" in sys.argv:
        force_cpu_devices = int(sys.argv[sys.argv.index("--cpu") + 1])
    if force_cpu_devices:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={force_cpu_devices}"
            # virtual devices CONTEND for the host's few cores, so threads
            # reach each collective minutes apart at 10M+ points; XLA:CPU's
            # default rendezvous watchdog (40 s termination) would kill the
            # run. Raise it -- a virtual-mesh knob only; real devices run
            # in parallel and never come near the default.
            + " --xla_cpu_collective_call_terminate_timeout_seconds=14400"
            + " --xla_cpu_collective_call_warn_stuck_timeout_seconds=600"
            + " --xla_cpu_collective_timeout_seconds=14400"
        ).strip()
        jax.config.update("jax_platforms", "cpu")
    from vtkcloudpoint_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    return jax


def blob_cloud(n, k=600, spread=0.0008, noise_frac=0.006, seed=0,
               dtype=np.float32):
    rng = np.random.default_rng(seed)
    n_noise = int(n * noise_frac)
    nc = n - n_noise
    centers = rng.uniform(0.02, 0.98, size=(k, 2))
    per = nc // k
    pts = [centers[i] + spread * rng.standard_normal((per, 2))
           for i in range(k)]
    pts.append(rng.uniform(0, 1, size=(nc - per * k, 2)))
    pts.append(rng.uniform(0, 1, size=(n_noise, 2)))
    motor = np.concatenate(pts)[:n].astype(dtype)
    xyz = np.concatenate([motor, np.ones((n, 1), dtype)], axis=1)
    truth = np.concatenate([centers, np.ones((k, 1))], axis=1).astype(dtype)
    return motor, xyz, truth, centers


def disk_cloud(n, k, radius, noise_frac=0.004, seed=0, dtype=np.float32):
    """k uniform-density DISKS + uniform background noise.

    Unlike blob_cloud's point-like Gaussians, disks have bounded, uniform
    interior density, so eps/min_pts/cell_cap/halo caps can be sized
    analytically with no Gaussian tail turning into surprise noise -- the
    geometry for overflow-free capacity accounting at 10^7+ points."""
    rng = np.random.default_rng(seed)
    n_noise = int(n * noise_frac)
    nc = n - n_noise
    centers = rng.uniform(radius, 1 - radius, size=(k, 2))
    per = nc // k
    rr = radius * np.sqrt(rng.uniform(0, 1, size=(k, per)))
    th = rng.uniform(0, 2 * np.pi, size=(k, per))
    pts = centers[:, None, :] + np.stack(
        [rr * np.cos(th), rr * np.sin(th)], axis=-1)
    parts = [pts.reshape(-1, 2)]
    parts.append(rng.uniform(0, 1, size=(nc - per * k, 2)))
    parts.append(rng.uniform(0, 1, size=(n_noise, 2)))
    motor = np.concatenate(parts)[:n].astype(dtype)
    xyz = np.concatenate([motor, np.ones((n, 1), dtype)], axis=1)
    truth = np.concatenate([centers, np.ones((k, 1))], axis=1).astype(dtype)
    return motor, xyz, truth, centers


def timed(fn, sync, repeats=3):
    """Best-of-N wall time with explicit host-transfer sync."""
    out = fn()
    sync(out)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        sync(out)
        times.append(time.perf_counter() - t0)
    return min(times), out


def emit(**kw):
    print(json.dumps(kw))
