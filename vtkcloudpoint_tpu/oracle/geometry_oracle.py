"""NumPy oracles for cluster shape analytics.

Independent implementations (monotone-chain hull; exhaustive MEC over ALL
point pairs/triples, not just hull points) used to validate the engine's
gift-wrap + hull-candidate path. The minimal enclosing circle is unique, so
any two correct algorithms agree to float tolerance.
"""
from __future__ import annotations

import itertools

import numpy as np


def _cross2(a, b):
    return a[0] * b[1] - a[1] * b[0]


def hull_monotone_chain(pts: np.ndarray) -> np.ndarray:
    """Convex hull (CCW, no duplicate endpoint) of [N,2] points."""
    pts = np.unique(pts, axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def half(iterable):
        out = []
        for p in iterable:
            while len(out) >= 2 and _cross2(out[-1] - out[-2], p - out[-2]) <= 0:
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.array(lower[:-1] + upper[:-1])


def mec_bruteforce(pts: np.ndarray):
    """Exact minimal enclosing circle via exhaustive pair/triple candidates."""
    n = len(pts)
    best = (None, None, np.inf)  # cx, cy, r2
    eps = 1e-9

    def encloses(cx, cy, r2):
        d2 = (pts[:, 0] - cx) ** 2 + (pts[:, 1] - cy) ** 2
        return np.all(d2 <= r2 * (1 + eps) + eps)

    for i, j in itertools.combinations(range(n), 2):
        cx = (pts[i, 0] + pts[j, 0]) / 2
        cy = (pts[i, 1] + pts[j, 1]) / 2
        r2 = (cx - pts[i, 0]) ** 2 + (cy - pts[i, 1]) ** 2
        if r2 < best[2] and encloses(cx, cy, r2):
            best = (cx, cy, r2)
    for i, j, k in itertools.combinations(range(n), 3):
        ax, ay = pts[i]
        bx, by = pts[j]
        cx_, cy_ = pts[k]
        d = 2 * (ax * (by - cy_) + bx * (cy_ - ay) + cx_ * (ay - by))
        if abs(d) < 1e-300:
            continue
        ux = (
            (ax**2 + ay**2) * (by - cy_)
            + (bx**2 + by**2) * (cy_ - ay)
            + (cx_**2 + cy_**2) * (ay - by)
        ) / d
        uy = (
            (ax**2 + ay**2) * (cx_ - bx)
            + (bx**2 + by**2) * (ax - cx_)
            + (cx_**2 + cy_**2) * (bx - ax)
        ) / d
        r2 = (ux - ax) ** 2 + (uy - ay) ** 2
        if r2 < best[2] and encloses(ux, uy, r2):
            best = (ux, uy, r2)
    if not np.isfinite(best[2]):
        return pts[0, 0], pts[0, 1], 0.0
    return best[0], best[1], float(np.sqrt(best[2]))


def min_area_rect_bruteforce(pts: np.ndarray):
    """Min-area enclosing rectangle via hull-edge directions. Returns
    (len_long, len_short, area)."""
    hull = hull_monotone_chain(pts)
    if len(hull) < 2:
        return 0.0, 0.0, 0.0
    best = (0.0, 0.0, np.inf)
    m = len(hull)
    for i in range(m):
        e = hull[(i + 1) % m] - hull[i]
        L = np.hypot(*e)
        if L == 0:
            continue
        u = e / L
        v = np.array([-u[1], u[0]])
        pu = pts @ u
        pv = pts @ v
        du = pu.max() - pu.min()
        dv = pv.max() - pv.min()
        if du * dv < best[2]:
            best = (max(du, dv), min(du, dv), du * dv)
    if not np.isfinite(best[2]):
        return 0.0, 0.0, 0.0
    return best
