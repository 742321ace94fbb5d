"""Small dense linear algebra: the reference Matrix.cs role (SURVEY.md C17).

The reference ships a hand-rolled dense matrix library (LU solve/invert/det,
Strassen multiply, Jacobi symmetric eigensolver, Matrix.cs:48-668). Here
jnp.linalg covers the lapack-style pieces; what this module adds:

- jacobi_eigh: a cyclic-Jacobi symmetric eigensolver that is pure elementwise
  math under lax.fori_loop -- useful where jnp.linalg.eigh's QDWH path is
  overkill for tiny (4x4 Horn) matrices, and as the semantic stand-in for the
  reference's ComputeEvJacobi (whose transcribed index bugs,
  Matrix.cs:636-657, are documented and NOT reproduced).
- thin aliases for solve/inv/det so the capability mapping is explicit.

Strassen multiply is intentionally absent: a plain jnp.dot IS the fast path
(a library GEMM); Strassen-style recursion would only add passes.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

solve = jnp.linalg.solve        # Matrix.SolveWith (Matrix.cs:99-112)
inv = jnp.linalg.inv            # Matrix.Invert (Matrix.cs:156-170)
det = jnp.linalg.det            # Matrix.Det (Matrix.cs:173-179)


@partial(jax.jit, static_argnames=("sweeps",))
def jacobi_eigh(a, sweeps: int = 10):
    """Cyclic Jacobi eigensolve for a symmetric [n, n] matrix.

    Returns (eigenvalues [n] ascending, eigenvectors [n, n] columns).
    Fixed sweep count (each sweep rotates every off-diagonal pair once);
    10 sweeps converge far past float32 precision for n <= 8.
    """
    n = a.shape[0]
    pairs = [(p, q) for p in range(n - 1) for q in range(p + 1, n)]

    def rotate(state, pq):
        m, v = state
        p, q = pq
        app = m[p, p]
        aqq = m[q, q]
        apq = m[p, q]
        # rotation angle: theta = 0.5 atan2(2 apq, app - aqq)
        theta = 0.5 * jnp.arctan2(2.0 * apq, app - aqq)
        c = jnp.cos(theta)
        s = jnp.sin(theta)
        # G^T M G applied via row/col updates
        rp = m[p, :]
        rq = m[q, :]
        m = m.at[p, :].set(c * rp + s * rq)
        m = m.at[q, :].set(-s * rp + c * rq)
        cp = m[:, p]
        cq = m[:, q]
        m = m.at[:, p].set(c * cp + s * cq)
        m = m.at[:, q].set(-s * cp + c * cq)
        vp = v[:, p]
        vq = v[:, q]
        v = v.at[:, p].set(c * vp + s * vq)
        v = v.at[:, q].set(-s * vp + c * vq)
        return (m, v), None

    def sweep(state, _):
        for pq in pairs:
            state, _ = rotate(state, pq)
        return state, None

    (m, v), _ = jax.lax.scan(
        sweep, (a, jnp.eye(n, dtype=a.dtype)), None, length=sweeps
    )
    w = jnp.diagonal(m)
    order = jnp.argsort(w)
    return w[order], v[:, order]
