"""Platform policy, compile-cache placement, and the GPU-only entry points
(chip_smoke.py, bench.py) as far as the CPU can check them."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import pytest

from vtkcloudpoint_tpu.policy import POLICIES, PlatformPolicy, policy
from vtkcloudpoint_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_policy_keys():
    assert sorted(POLICIES) == ["cpu", "gpu"]
    fields = {f.name for f in dataclasses.fields(PlatformPolicy)}
    for p in POLICIES.values():
        assert {f: getattr(p, f) for f in fields}
    assert policy() is POLICIES["cpu"]
    assert policy("gpu").dbscan_blocks == "cuda"


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_policy_unknown_platform_raises(platform):
    with pytest.raises(ValueError, match="no platform policy"):
        policy(platform)


def test_compile_cache_from_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert compile_cache.configure_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_default_in_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = compile_cache.configure_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_entry_points_refuse_cpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, os.path.join(ROOT, script)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "no GPU" in res.stderr


def test_chip_smoke_phases_tiny(capsys):
    """The smoke phases' control flow and checks at tiny sizes, with the
    plain path standing in for the kernel."""
    import chip_smoke

    chip_smoke.phase_workflow(n_points=6000)
    chip_smoke.phase_bench(["cpu"], n_points=6000, kernel="jnp",
                           block_cap=128, max_clusters=1024,
                           cluster_cap=128)
    chip_smoke.phase_scale(["cpu"], n_points=40000, kernel="jnp",
                           block_cap=256, max_clusters=1024,
                           noise_capacity=4096)
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    phases = [x["phase"] for x in lines]
    for want in ("workflow_cluster", "workflow_register", "bench", "scale"):
        assert want in phases
    wf = next(x for x in lines if x["phase"] == "workflow_cluster")
    assert wf["label_mismatches"] == 0
