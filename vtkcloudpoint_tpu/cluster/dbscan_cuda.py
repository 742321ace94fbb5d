"""Per-block DBSCAN as one CUDA kernel for Hopper (native/dbscan_blocks.cu).

The kernel is compiled with ``nvcc`` from the repository's source into
``native/`` at first use (keyed on the source's content), loaded with
ctypes and called through ``jax.ffi``. It returns what
cluster.dbscan.dbscan_blocks returns, bit for bit, for the metrics whose
distance has no multiply (``l1_motor``, ``signed_sum_xy``) on float32
coordinates with block capacity <= 1024; dbscan_blocks_dispatch sends every
other case to the plain path. There is no interpret mode: the CPU tests
cover the padding, shapes and choice of engine here, and the arithmetic
through the plain reference it is compared with on the GPU.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_SRC = os.path.join(_NATIVE_DIR, "dbscan_blocks.cu")
_TARGET = "vtkcp_dbscan_blocks"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC")

KERNEL_MAX_CAP = 1024
METRIC_CODES = {"l1_motor": 0, "signed_sum_xy": 1}


def kernel_supports(cap: int, nd: int, metric: str, dtype) -> bool:
    """Whether the kernel reproduces the plain path for these blocks."""
    return (metric in METRIC_CODES and nd == 2
            and jnp.dtype(dtype) == jnp.float32 and 0 < cap <= KERNEL_MAX_CAP)


def padded_cap(cap: int) -> int:
    """The kernel's capacity: a multiple of 32 (one ballot word)."""
    return max(32, -(-cap // 32) * 32)


def pad_blocks(coords, valid):
    """Pad the capacity axis to padded_cap with invalid slots, which join
    no neighbourhood and come back as label 0, so results sliced back to
    ``cap`` are unchanged."""
    cap = coords.shape[1]
    extra = padded_cap(cap) - cap
    if extra == 0:
        return coords, valid
    return (jnp.pad(coords, ((0, 0), (0, extra), (0, 0))),
            jnp.pad(valid, ((0, 0), (0, extra))))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA DBSCAN kernel is built "
                           "from native/dbscan_blocks.cu at first use")
    return path


def build_library() -> str:
    """Compile the kernel library unless an up-to-date one exists; returns
    its path. The build lands under a temporary name and is renamed into
    place, so a reader never loads a half-written file."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
    so = os.path.join(_NATIVE_DIR, f"libdbscan_blocks.{digest}.so")
    if os.path.exists(so):
        return so
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *_NVCC_FLAGS, "-I", jax.ffi.include_dir(), "-o", tmp,
           _SRC]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, so)
    return so


@functools.cache
def _register():
    """Build, load and register the kernel once per process; the returned
    library handle stays referenced for as long as the target exists."""
    lib = ctypes.CDLL(build_library())
    jax.ffi.register_ffi_target(
        _TARGET, jax.ffi.pycapsule(lib.VtkcpDbscanBlocks), platform="CUDA")
    return lib


def _ffi_dbscan(coords, valid, eps: float, min_pts: int, metric: str):
    """The raw kernel call on blocks already padded to a multiple of 32."""
    b, cap, _ = coords.shape
    out = (jax.ShapeDtypeStruct((b, cap), jnp.int32),
           jax.ShapeDtypeStruct((b,), jnp.int32),
           jax.ShapeDtypeStruct((b, cap), jnp.bool_))
    return jax.ffi.ffi_call(_TARGET, out, vmap_method="sequential")(
        coords, valid, eps=np.float32(eps), min_pts=np.int32(min_pts),
        metric=np.int32(METRIC_CODES[metric]))


def dbscan_blocks_cuda(coords, valid, eps: float, min_pts: int,
                       metric: str = "l1_motor"):
    """Per-block DBSCAN on the GPU: drop-in for dbscan_blocks.

    coords: [B, cap, 2] float32; valid: [B, cap] bool. Returns dict(label
    [B, cap] i32, n_clusters [B] i32, core [B, cap] bool).
    """
    b, cap, nd = coords.shape
    if not kernel_supports(cap, nd, metric, coords.dtype):
        raise ValueError(
            f"the CUDA DBSCAN kernel takes float32 [B, cap<={KERNEL_MAX_CAP},"
            f" 2] blocks under {sorted(METRIC_CODES)}; got {coords.dtype} "
            f"{coords.shape} under {metric!r}")
    if jax.default_backend() != "gpu":
        raise RuntimeError("the CUDA DBSCAN kernel needs a GPU; this process "
                           f"runs on {jax.default_backend()!r}")
    _register()
    cp, vp = pad_blocks(coords, valid.astype(jnp.bool_))
    label, n_clusters, core = _ffi_dbscan(cp, vp, eps, min_pts, metric)
    return {"label": label[:, :cap], "n_clusters": n_clusters,
            "core": core[:, :cap]}
