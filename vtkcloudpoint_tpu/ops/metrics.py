"""Point-pair distance metrics.

The reference has three metrics in its two DBSCAN variants:
- "l1_motor": |dx|+|dy| over motor coords -- production (DBImproved.cs:14-25)
- "signed_sum_xy": dx+dy over X/Y, no abs -- legacy latent bug (DB.cs:14-25)
- "l2_xyz": Euclidean over xyz -- commented-out variant (DBImproved.cs:20) and
  the ICP correspondence metric (ICP.cs:224-250)

All functions compute dense tiled distance blocks [M, N] from coordinate
blocks; they are the innermost compute of neighbor search (L1 as elementwise
vector work, L2 via the expansion trick as one matmul).
"""
from __future__ import annotations

import jax.numpy as jnp


def pairwise_l1(a, b):
    """L1 distance block: a [M,D], b [N,D] -> [M,N]."""
    return jnp.sum(jnp.abs(a[:, None, :] - b[None, :, :]), axis=-1)


def pairwise_signed_sum(a, b):
    """Reference legacy metric (DB.cs:14-25): sum of SIGNED coordinate deltas."""
    return jnp.sum(a[:, None, :] - b[None, :, :], axis=-1)


def pairwise_sqdist(a, b):
    """Squared L2 block via the |a|^2 - 2ab + |b|^2 expansion (one matmul).

    precision=HIGHEST is load-bearing: an f32 matmul with no precision may
    run reduced (TF32 on a GPU keeps ~10 mantissa bits), and with |a|^2 ~
    10^2 the expansion's cancellation then corrupts small distances by
    O(0.1) -- enough to return a WRONG nearest neighbor. At HIGHEST, NN
    results match the direct-difference form to f32 rounding."""
    import jax

    a2 = jnp.sum(a * a, axis=-1)[:, None]
    b2 = jnp.sum(b * b, axis=-1)[None, :]
    ab = jnp.dot(a, b.T, preferred_element_type=a.dtype,
                 precision=jax.lax.Precision.HIGHEST)
    return jnp.maximum(a2 - 2.0 * ab + b2, 0.0)


def pairwise_l2(a, b):
    return jnp.sqrt(pairwise_sqdist(a, b))


def pairwise(a, b, metric: str):
    if metric == "l1_motor":
        return pairwise_l1(a, b)
    if metric == "signed_sum_xy":
        return pairwise_signed_sum(a, b)
    if metric in ("l2_xyz", "l2_xy"):
        # dimension-agnostic Euclidean; "l2_xy" is the grid engine's name
        # for the 2D case (cluster.grid.grid_metric)
        return pairwise_l2(a, b)
    raise ValueError(f"unknown metric {metric!r}")


def coords_for_metric(xyz, motor, metric: str):
    """Select the coordinate set a metric operates on (mirrors the reference's
    dual 2D-motor / 3D-cartesian modes)."""
    if metric == "l1_motor":
        return motor
    if metric == "signed_sum_xy":
        return xyz[..., :2]
    if metric == "l2_xyz":
        return xyz
    raise ValueError(f"unknown metric {metric!r}")
