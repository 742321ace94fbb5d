"""No module of the package leaves a JAX tracer in its globals when it is
first imported while a jit is tracing (several modules are imported lazily
inside traced functions). A tracer kept at module level becomes a constant
of every later trace that reads it: jit then passes it as an extra argument
on the first call, but its cached fast path does not, and the next call with
the same shapes fails ("Executable expected N+1 arguments but got N" on a
GPU, "Execution supplied N buffers but compiled program expected N+1
buffers" on the CPU)."""
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = textwrap.dedent("""
    import importlib, pkgutil, sys
    import jax, jax.numpy as jnp
    import vtkcloudpoint_tpu as pkg

    names = sorted(m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                         pkg.__name__ + "."))
    skipped = []

    def import_all(x):
        for name in names:
            try:
                importlib.import_module(name)
            except ImportError as e:   # optional dependency absent
                skipped.append((name, str(e)))
        return x + 1

    jax.jit(import_all)(jnp.float32(0))
    leaked = [f"{n}.{k}" for n in names if n in sys.modules
              for k, v in vars(sys.modules[n]).items()
              if isinstance(v, jax.core.Tracer)]
    print("modules", len(names), "skipped", skipped)
    print("leaked", leaked)
    sys.exit(1 if leaked else 0)
""")


# the symptom: merge_blocks' first trace imports cluster.grid (noise
# capacity > 8192 picks the grid engine); a call with new static arguments
# traces again, and its second call used to fail
SYMPTOM = textwrap.dedent("""
    import jax.numpy as jnp, numpy as np
    from vtkcloudpoint_tpu.cluster.fusion import merge_blocks

    b, cap = 12, 1024
    rng = np.random.default_rng(0)
    coords = jnp.asarray(rng.uniform(0, 1, (b, cap, 2)), jnp.float32)
    args = (jnp.zeros((b, cap), jnp.int32), jnp.ones((b, cap), bool), coords,
            jnp.arange(b * cap, dtype=jnp.int32).reshape(b, cap))
    kw = dict(n_points=b * cap, eps=0.01, min_pts=8, quirks=False)
    first = int(merge_blocks(*args, noise_capacity=16384, **kw)["n_total"])
    for _ in range(2):
        again = merge_blocks(*args, noise_capacity=12288, **kw)
        assert int(again["n_total"]) == first
""")


def _run(code):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr[-2000:]


def test_no_module_global_is_a_tracer():
    _run(PROBE)


def test_merge_blocks_retraced_after_lazy_import():
    _run(SYMPTOM)
