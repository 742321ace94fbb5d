"""SE(3) utilities: Horn quaternion / Kabsch SVD closed-form rigid alignment.

Closed-form replacement for the reference's registration solvers:
- production path: vtkLandmarkTransform rigid-body SVD solve inside
  vtkIterativeClosestPointTransform (FrmMain.cs:851-862)
- managed path: Horn quaternion via 4x4 Jacobi eigensolve (ICP.cs:18-181)

The managed reference has three transcribed bugs (SURVEY.md C18): it ADDS the
mean outer product where Horn subtracts (ICP.cs:65-66), uses delta[2]=A[0,0]
instead of A[0,1] (ICP.cs:74-76), and mis-indexes rotation accumulation
(ICP.cs:170-174). This module implements the CORRECT Horn/Kabsch math; parity
is validated against rigid-transform recovery and the VTK-style behavior, per
SURVEY.md §7 L5.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# Every matmul here is tiny (3x3 / Nx3) but CORRECTNESS-CRITICAL: an f32
# matmul with no precision may run reduced (TF32 on a GPU, ~1e-3 relative),
# and that error per R-composition/point-transform compounds across an ICP
# loop or a 100-scan trajectory (a bf16-truncating default once turned
# tier-4 odometry ATE from 1e-4 into 0.93). HIGHEST keeps full f32; cost is
# negligible at these shapes.
_HI = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HI)


def quat_to_rot(q):
    """Unit quaternion (w, x, y, z) -> 3x3 rotation (ICP.cs:274-285 layout)."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    return jnp.array(
        [
            [w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z],
        ]
    )


def horn_from_moments(sw, sp, sy, spy):
    """Horn solve from weighted moment sums (the psum-able form).

    sw = sum w, sp = sum w p, sy = sum w y, spy = sum w p y^T. This is the
    moment form used by the distributed ICP (parallel.sharded): each device
    psum-reduces its local moments, then every device runs this identical
    replicated 4x4 eigensolve. Mathematically equal to horn_solve (the
    cross-covariance M = spy/sw - mean_p mean_y^T); kept as THE single
    implementation so the sharded and single-device paths cannot drift.
    """
    dtype = spy.dtype
    sw = jnp.maximum(sw, 1e-30)
    mean_p = sp / sw
    mean_y = sy / sw
    m = spy / sw - jnp.outer(mean_p, mean_y)
    a = m - m.T
    delta = jnp.array([a[1, 2], a[2, 0], a[0, 1]])  # correct A[0,1] (vs ICP.cs:76)
    tr = jnp.trace(m)
    q_mat = jnp.zeros((4, 4), dtype)
    q_mat = q_mat.at[0, 0].set(tr)
    q_mat = q_mat.at[0, 1:].set(delta)
    q_mat = q_mat.at[1:, 0].set(delta)
    q_mat = q_mat.at[1:, 1:].set(m + m.T - tr * jnp.eye(3, dtype=dtype))
    evals, evecs = jnp.linalg.eigh(q_mat)
    q = evecs[:, jnp.argmax(evals)]
    r = quat_to_rot(q)
    t = mean_y - _mm(r, mean_p)
    return r, t


def horn_solve(p, y, weights=None):
    """Closed-form rigid alignment: find (R, t) minimizing sum w ||R p + t - y||^2.

    p, y: [N, 3] corresponding point sets; weights: optional [N] (0 masks a
    pair out). Horn's quaternion method: max-eigenvector of the 4x4 N-matrix
    built from the weighted cross-covariance.
    """
    if weights is None:
        weights = jnp.ones(p.shape[0], p.dtype)
    wsum = jnp.maximum(jnp.sum(weights), 1e-30)
    wn = (weights / wsum)[:, None]
    mean_p = jnp.sum(p * wn, axis=0)
    mean_y = jnp.sum(y * wn, axis=0)
    pc = p - mean_p
    yc = y - mean_y
    # cross-covariance M = sum w (p - mp)(y - my)^T  (correct Horn: the mean
    # term is SUBTRACTED, unlike reference ICP.cs:65-66). Centering before
    # the moment solve keeps the 4x4 well conditioned far from the origin.
    m = _mm((pc * wn).T, yc)
    zero3 = jnp.zeros(3, p.dtype)
    r, _ = horn_from_moments(jnp.asarray(1.0, p.dtype), zero3, zero3, m)
    t = mean_y - _mm(r, mean_p)
    return r, t


def kabsch_solve(p, y, weights=None):
    """Rigid alignment via SVD (Kabsch/Umeyama) -- the vtkLandmarkTransform
    RigidBody mode equivalent (vtkLandmarkTransform.h:34-63)."""
    if weights is None:
        weights = jnp.ones(p.shape[0], p.dtype)
    wsum = jnp.maximum(jnp.sum(weights), 1e-30)
    wn = (weights / wsum)[:, None]
    mean_p = jnp.sum(p * wn, axis=0)
    mean_y = jnp.sum(y * wn, axis=0)
    h = _mm(((p - mean_p) * wn).T, (y - mean_y))
    u, _, vt = jnp.linalg.svd(h)
    d = jnp.sign(jnp.linalg.det(_mm(vt.T, u.T)))
    s = jnp.diag(jnp.array([1.0, 1.0, d], p.dtype))
    r = _mm(_mm(vt.T, s), u.T)
    t = mean_y - _mm(r, mean_p)
    return r, t


def apply_rigid(r, t, pts):
    """x -> R x + t for [N,3] points."""
    return _mm(pts, r.T) + t


def compose(r1, t1, r0, t0):
    """(r1,t1) o (r0,t0): apply (r0,t0) first."""
    return _mm(r1, r0), _mm(r1, t0) + t1


def to_matrix4(r, t):
    """4x4 homogeneous matrix (vtk icp.GetMatrix() layout, FrmMain.cs:862)."""
    m = jnp.eye(4, dtype=r.dtype)
    m = m.at[:3, :3].set(r)
    m = m.at[:3, 3].set(t)
    return m


def rotz(theta):
    c, s = jnp.cos(theta), jnp.sin(theta)
    return jnp.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def so3_hat(w):
    """[3] -> skew-symmetric [3,3]."""
    z = jnp.zeros((), w.dtype)
    return jnp.array(
        [
            [z, -w[2], w[1]],
            [w[2], z, -w[0]],
            [-w[1], w[0], z],
        ]
    )


def so3_exp(w):
    """Rodrigues: rotation vector [3] -> R [3,3] (Taylor-safe near 0).

    Double-where guard: the non-Taylor branch's INPUT is replaced by a safe
    value inside the small region, not just its output -- otherwise
    d/dw sqrt(w.w) at w=0 is inf and jacfwd turns inf * 0 into NaN even
    though the Taylor branch is selected. The guard constants must be
    f32-representable (an earlier 1e-300 underflowed to 0 under f32 and
    NaN-poisoned every Gauss-Newton Jacobian in f32)."""
    theta2 = jnp.dot(w, w)
    small = theta2 <= 1e-12
    t2s = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(t2s)
    k = so3_hat(w)
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0,
                  (1.0 - jnp.cos(theta)) / t2s)
    return jnp.eye(3, dtype=w.dtype) + a * k + b * _mm(k, k)


def so3_log(r):
    """R [3,3] -> rotation vector [3], angle in [0, pi).

    atan2-based formulation with Taylor fallback so gradients stay finite at
    theta -> 0 (an arccos form has an infinite derivative there, which
    poisons Gauss-Newton jacobians). Angles at exactly pi are degenerate
    (w ~= 0) -- pose-graph increments never live there.
    """
    w = jnp.array(
        [r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]]
    )
    # sin(theta) = |w| / 2. Double-where: the sqrt's INPUT is replaced
    # inside the small region so its derivative stays finite at w = 0
    # (see so3_exp; the old +1e-300 guard underflowed to 0 in f32 and the
    # inf sqrt-gradient leaked NaN through every downstream where).
    n2 = jnp.dot(w, w)
    small = n2 < 1e-12
    n2s = jnp.where(small, 1.0, n2)
    sin_t = 0.5 * jnp.sqrt(n2s)
    cos_t = jnp.clip((jnp.trace(r) - 1.0) / 2.0, -1.0, 1.0)
    theta = jnp.arctan2(sin_t, cos_t)
    # small branch: theta ~= |w|/2, so theta^2/12 ~= n2/48
    scale = jnp.where(small, 0.5 + n2 / 48.0, theta / (2.0 * sin_t))
    return scale * w


def random_rotation(key):
    """Uniform random rotation from a random unit quaternion."""
    q = jax.random.normal(key, (4,))
    q = q / jnp.linalg.norm(q)
    return quat_to_rot(q)
