"""Cluster shape analytics: convex hull, minimal enclosing circle, min-area
bounding rectangle.

Data-parallel equivalents of reference Geometry.cs / Polygon.cs:
- hull: gift wrapping with the reference's pseudo-angle ordering
  (Geometry.cs:122-246, AngleValue :210-246), vectorized as a lax.scan over a
  fixed max hull size with argmin sweeps over all cluster points.
- minimal enclosing circle: brute force over hull point pairs and triples
  with containment check (Geometry.cs:247-337). The MEC is unique, so this
  matches the reference output to float tolerance; degenerate triples produce
  inf radius and drop out exactly like the reference's parallel-line case
  (Geometry.cs:393-404 -- double division yields inf, never the catch).
- min-area rectangle: per-hull-edge projection sweep, equivalent to rotating
  calipers (Polygon.cs:360-702, bestLen0/bestLen1 side lengths for the
  README's aspect-ratio rejection).

All functions take a padded point block [cap, 2] + valid mask and are designed
to be vmapped over a cluster table (see ops.segment.bucket_by_cluster).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as _np

BIG = 1e30


def pseudo_angle(x1, y1, x2, y2):
    """Reference AngleValue (Geometry.cs:210-246): monotone angle surrogate
    t*90 in [0, 360); identical points map to 40 (= 360/9)."""
    dx = x2 - x1
    dy = y2 - y1
    ax = jnp.abs(dx)
    ay = jnp.abs(dy)
    denom = ax + ay
    t = jnp.where(denom == 0, 360.0 / 9.0, dy / jnp.where(denom == 0, 1.0, denom))
    t = jnp.where(denom == 0, t, jnp.where(dx < 0, 2.0 - t, jnp.where(dy < 0, 4.0 + t, t)))
    return t * 90.0


def convex_hull(pts, valid, max_hull: int = 64):
    """Gift-wrapping hull of a padded 2D point block.

    Returns (hull_pts [max_hull, 2], hull_valid [max_hull]). Hull vertex 0 is
    the lowest-y (then lowest-x) point, per Geometry.cs:128-150; subsequent
    vertices follow the reference's min-pseudo-angle sweep. Points already on
    the hull are masked out (the reference removes them from its working
    list). If the true hull has more than max_hull vertices the result is
    truncated (callers size max_hull for their data).
    """
    cap = pts.shape[0]
    x = pts[:, 0]
    y = pts[:, 1]
    # start: min (y, x) among valid
    key = jnp.where(valid, y, BIG) * 1.0
    # lexicographic (y, x): use tuple trick via argmin over (y, then x)
    ymin = jnp.min(jnp.where(valid, y, BIG))
    cand = valid & (y == ymin)
    start = jnp.argmin(jnp.where(cand, x, BIG))

    def step(carry):
        cur, sweep, picked, done, out, i = carry
        cx = x[cur]
        cy = y[cur]
        ang = pseudo_angle(cx, cy, x, y)
        ok = valid & ~picked & (ang >= sweep)
        # strict improvement scan order: first index among minimal angle
        best_key = jnp.where(ok, ang, BIG)
        best = jnp.argmin(best_key)
        best_angle = best_key[best]
        first_angle = pseudo_angle(cx, cy, x[start], y[start])
        finish = (first_angle >= sweep) & (best_angle >= first_angle)
        finish = finish | (best_angle >= BIG)
        new_done = done | finish
        emit = ~new_done
        new_cur = jnp.where(emit, best, cur)
        new_sweep = jnp.where(emit, best_angle, sweep)
        new_picked = picked.at[best].set(picked[best] | emit)
        out = out.at[i].set(jnp.where(emit, best.astype(jnp.int32), -1))
        return new_cur, new_sweep, new_picked, new_done, out, i + 1

    # while_loop instead of a fixed-length scan: the sweep stops at the
    # ACTUAL hull size (typically ~2/3 of max_hull for dense clusters;
    # under vmap the loop runs to the batch's largest hull). Unvisited
    # out slots keep -1, identical to the scan's post-done emissions.
    picked0 = jnp.zeros(cap, bool).at[start].set(True)
    out0 = jnp.full(max_hull - 1, -1, jnp.int32)
    state = (start, 0.0, picked0, ~jnp.any(valid), out0, jnp.int32(0))
    *_, out, _ = jax.lax.while_loop(
        lambda s: (~s[3]) & (s[5] < max_hull - 1),
        lambda s: step(s), state)
    hull_idx = jnp.concatenate([start[None].astype(jnp.int32), out])
    hull_valid = hull_idx >= 0
    hull_valid = hull_valid & jnp.concatenate([jnp.any(valid)[None], jnp.ones(max_hull - 1, bool)])
    safe = jnp.clip(hull_idx, 0, cap - 1)
    hull_pts = jnp.stack([x[safe], y[safe]], axis=-1)
    return hull_pts, hull_valid


def convex_hull_quick(pts, valid, max_hull: int = 64):
    """Hull vertices via batched quickhull: O(log h) data-parallel rounds
    instead of gift-wrapping's h SEQUENTIAL steps (the gift-wrap scan was
    the dominant cost of the shapes stage on the real chip -- each of its
    max_hull-1 steps is a dependent argmin+scatter over [K, cap]).

    Same contract as convex_hull: (hull_pts [max_hull, 2], hull_valid
    [max_hull]), vertices in convex position, CCW cyclic order (by
    pseudo-angle around the vertex centroid -- valid for points in convex
    position). The VERTEX SET equals the true hull's (strictly interior
    points never selected; boundary-collinear points may be omitted, which
    gift-wrap includes -- MEC and min-rect outputs are identical either
    way: MEC containment over vertices bounds the whole hull, and
    collinear points add no edge directions). Truncated at max_hull like
    convex_hull.

    Per round: order current vertices by pseudo-angle; every directed hull
    edge picks the point with max outward cross-distance (argmax over ALL
    strictly-outside points, not a partition -- the farthest point from a
    hull edge is always a true hull vertex); picks dedupe and append.
    Each round grows every unfinished edge by >= 1 vertex, so rounds <=
    max_hull, typically ~log2(h).
    """
    cap = pts.shape[0]
    h = max_hull
    x = pts[:, 0]
    y = pts[:, 1]
    any_valid = jnp.any(valid)

    # two extreme seeds: min-(x, y) and max-(x, y), lexicographic
    xmin = jnp.min(jnp.where(valid, x, BIG))
    i_min = jnp.argmin(jnp.where(valid & (x == xmin), y, BIG))
    xmax = jnp.max(jnp.where(valid, x, -BIG))
    i_max = jnp.argmax(jnp.where(valid & (x == xmax), y, -BIG))

    idx0 = jnp.full(h, -1, jnp.int32)
    idx0 = idx0.at[0].set(i_min.astype(jnp.int32))
    # degenerate single-point set: keep one slot
    two = i_max.astype(jnp.int32) != i_min.astype(jnp.int32)
    idx0 = idx0.at[1].set(jnp.where(two, i_max.astype(jnp.int32), -1))

    def order_ccw(idx):
        """Sort the slot list into CCW cyclic order (pads last)."""
        ok = idx >= 0
        safe = jnp.clip(idx, 0, cap - 1)
        vx = x[safe]
        vy = y[safe]
        nv = jnp.maximum(jnp.sum(ok, dtype=jnp.int32), 1)
        cx = jnp.sum(jnp.where(ok, vx, 0.0)) / nv
        cy = jnp.sum(jnp.where(ok, vy, 0.0)) / nv
        ang = pseudo_angle(cx, cy, vx, vy)
        key = jnp.where(ok, ang, BIG)
        o = jnp.argsort(key)
        return jnp.where(ok[o], idx[o], -1)

    def round_step(state):
        idx, _, it = state
        idx = order_ccw(idx)
        ok = idx >= 0
        nv = jnp.sum(ok, dtype=jnp.int32)
        safe = jnp.clip(idx, 0, cap - 1)
        vx = x[safe]
        vy = y[safe]
        # directed edges i -> (i+1) mod nv over the valid prefix
        nxt = jnp.where(jnp.arange(h) + 1 >= nv, 0, jnp.arange(h) + 1)
        ex = vx[nxt] - vx
        ey = vy[nxt] - vy
        # outward distance: CCW polygon => outside is cross < 0
        crossd = (ex[:, None] * (y[None, :] - vy[:, None])
                  - ey[:, None] * (x[None, :] - vx[:, None]))  # [h, cap]
        edge_ok = ok & (jnp.arange(h) < nv)
        outside = (crossd < 0) & valid[None, :] & edge_ok[:, None]
        dist = jnp.where(outside, -crossd, -BIG)
        pick = jnp.argmax(dist, axis=1).astype(jnp.int32)      # [h]
        has = jnp.any(outside, axis=1)
        pick = jnp.where(has, pick, -1)
        # dedupe this round's picks (a vertex can be outside two edges)
        ps = jnp.sort(jnp.where(pick >= 0, pick, cap))
        first = jnp.concatenate([ps[:1] < cap,
                                 (ps[1:] != ps[:-1]) & (ps[1:] < cap)])
        new = jnp.where(first, ps, -1)
        n_new = jnp.sum(first, dtype=jnp.int32)
        # append unique picks after the current vertices (capacity h)
        napp = jnp.argsort(jnp.where(new >= 0, jnp.arange(h), h))
        new_c = jnp.where(jnp.arange(h) < n_new, new[napp], -1)
        space = h - nv
        take = jnp.minimum(n_new, space)
        dst = nv + jnp.arange(h)
        idx = idx.at[jnp.where(jnp.arange(h) < take, dst, h)].set(
            new_c, mode="drop")
        done = (~jnp.any(has)) | (take == 0)
        return idx, done, it + 1

    def cond(state):
        return (~state[1]) & (state[2] < h)

    st = round_step((idx0, ~any_valid, jnp.int32(0)))
    idx, _, _ = jax.lax.while_loop(cond, round_step, st)
    idx = order_ccw(idx)
    hull_valid = (idx >= 0) & any_valid
    safe = jnp.clip(idx, 0, cap - 1)
    hull_pts = jnp.stack([x[safe], y[safe]], axis=-1)
    return hull_pts, hull_valid


def _circumcircle(a, b, c):
    """Circumcenter via perpendicular-bisector intersection, matching
    Geometry.cs:340-432 (degenerate -> inf center -> inf radius2)."""
    x1 = (b[..., 0] + a[..., 0]) / 2
    y1 = (b[..., 1] + a[..., 1]) / 2
    dy1 = b[..., 0] - a[..., 0]
    dx1 = -(b[..., 1] - a[..., 1])
    x2 = (c[..., 0] + b[..., 0]) / 2
    y2 = (c[..., 1] + b[..., 1]) / 2
    dy2 = c[..., 0] - b[..., 0]
    dx2 = -(c[..., 1] - b[..., 1])
    denom = dy1 * dx2 - dx1 * dy2
    t1 = ((x1 - x2) * dy2 + (y2 - y1) * dx2) / denom  # inf when parallel
    cx = x1 + dx1 * t1
    cy = y1 + dy1 * t1
    r2 = (cx - a[..., 0]) ** 2 + (cy - a[..., 1]) ** 2
    return cx, cy, r2


def _triple_table(h: int):
    """All (a, b, c) with a < b < c < h, lexicographic, as an int32 [T, 3]
    numpy array -- built from index arithmetic only (np.triu_indices-style;
    peak host memory O(C(h,3)), never the [h,h,h] cube)."""
    ib, ic = _np.triu_indices(h, k=1)          # all b < c pairs, lex in (b,c)
    # lexicographic (a, b, c) order = sort pairs by b then c (triu_indices
    # already emits that), each pair expanded with a = 0..b-1; to get
    # a-major lex order, group by a instead: for each pair, the triples
    # (a, b, c) for a < b. Emitting pair-major then sorting by (a, b, c)
    # keys reproduces exact lex order.
    reps = ib.astype(_np.int64)                # number of a's per pair
    total = int(reps.sum())
    if total == 0:
        return _np.zeros((1, 3), _np.int32)    # h < 3: degenerate self-triple
    pair_of = _np.repeat(_np.arange(len(ib)), reps)
    starts = _np.cumsum(reps) - reps
    a = (_np.arange(total) - starts[pair_of]).astype(_np.int64)
    key = (a * h + ib[pair_of]) * h + ic[pair_of]
    order = _np.argsort(key, kind="stable")
    return _np.stack(
        [a[order], ib[pair_of][order], ic[pair_of][order]], axis=-1
    ).astype(_np.int32)


def min_enclosing_circle(hull_pts, hull_valid, tri_chunk: int = 512):
    """Minimal enclosing circle from hull points (center, radius).

    Brute force over hull pairs and triples + containment, per
    Geometry.cs:247-337. Returns (cx, cy, radius); radius 0 when fewer than
    2 valid hull points (reference returns radius 0 on no solution).
    ``tri_chunk`` trades scan depth for per-step working set in the
    C(h,3) triple sweep.
    """
    h = hull_pts.shape[0]
    px = jnp.where(hull_valid, hull_pts[:, 0], BIG)
    py = jnp.where(hull_valid, hull_pts[:, 1], BIG)
    pts = jnp.stack([px, py], axis=-1)

    def encloses(cx, cy, r2, skip):
        # Containment over valid hull points with the candidate's OWN defining
        # points excluded, exactly like the reference (CircleEnclosesPoints
        # skip1/skip2/skip3, Geometry.cs:322-337). Skipping the defining
        # points is what makes the exact <= comparison robust: they sit on
        # the circle and may round marginally outside.
        d2 = (cx[..., None] - px) ** 2 + (cy[..., None] - py) ** 2
        inside = (d2 <= r2[..., None]) | ~hull_valid | skip
        return jnp.all(inside, axis=-1)

    ar = jnp.arange(h)
    # pairs
    cx2 = (px[:, None] + px[None, :]) / 2
    cy2 = (py[:, None] + py[None, :]) / 2
    r2_2 = (cx2 - px[:, None]) ** 2 + (cy2 - py[:, None]) ** 2
    pair_ok = (
        hull_valid[:, None]
        & hull_valid[None, :]
        & (jnp.arange(h)[:, None] < jnp.arange(h)[None, :])
    )
    pair_skip = (ar[None, None, :] == ar[:, None, None]) | (
        ar[None, None, :] == ar[None, :, None]
    )
    pair_enc = encloses(cx2, cy2, r2_2, pair_skip) & pair_ok
    pair_r2 = jnp.where(pair_enc, r2_2, BIG)
    i2 = jnp.argmin(pair_r2.reshape(-1))
    best_pair_r2 = pair_r2.reshape(-1)[i2]

    # triples: enumerate ONLY the C(h,3) lexicographic combinations as a
    # static index table, scanned in fixed chunks -- ~6x less work than the
    # masked [h^3] cube and the per-step working set stays [chunk, h]
    # (VERDICT r1 item 6: bound the memory; the min over all triples is
    # identical, and lex order preserves the first-minimum tie-break of the
    # cube enumeration). Built index-only in O(C(h,3)) host memory -- the
    # earlier [h,h,h] meshgrid allocated 3x h^3 int32 temporaries per jit
    # trace, a real spike at the documented max_hull=256 ceiling.
    tri = _triple_table(h)
    if tri.shape[0] == 0:                      # h < 3: pairs only
        tri = _np.zeros((1, 3), _np.int32)     # self-triple: degenerate, BIG
    chunk = min(tri_chunk, tri.shape[0])
    pad = (-tri.shape[0]) % chunk
    # padding repeats the last real triple; it can never win strictly
    tri = _np.concatenate([tri, _np.repeat(tri[-1:], pad, axis=0)])
    tri = jnp.asarray(tri.reshape(-1, chunk, 3))

    def trip_step(carry, idx):
        best_r2_c, bcx_c, bcy_c = carry
        ia, ib, ic = idx[:, 0], idx[:, 1], idx[:, 2]
        cx3, cy3, r2_3 = _circumcircle(pts[ia], pts[ib], pts[ic])  # [chunk]
        r2_3 = jnp.where(jnp.isfinite(r2_3), r2_3, BIG)
        trip_ok = hull_valid[ia] & hull_valid[ib] & hull_valid[ic]
        skip = (
            (ar[None, :] == ia[:, None])
            | (ar[None, :] == ib[:, None])
            | (ar[None, :] == ic[:, None])
        )
        enc = encloses(cx3, cy3, r2_3, skip) & trip_ok
        r2m = jnp.where(enc, r2_3, BIG)
        b = jnp.argmin(r2m)
        better = r2m[b] < best_r2_c
        return (
            jnp.where(better, r2m[b], best_r2_c),
            jnp.where(better, cx3[b], bcx_c),
            jnp.where(better, cy3[b], bcy_c),
        ), None

    (best_trip_r2, tcx, tcy), _ = jax.lax.scan(
        trip_step, (jnp.asarray(BIG, pts.dtype), pts[0, 0], pts[0, 1]), tri
    )

    use_trip = best_trip_r2 < best_pair_r2
    best_r2 = jnp.where(use_trip, best_trip_r2, best_pair_r2)
    bcx = jnp.where(use_trip, tcx, cx2.reshape(-1)[i2])
    bcy = jnp.where(use_trip, tcy, cy2.reshape(-1)[i2])
    none_found = best_r2 >= BIG
    radius = jnp.where(none_found, 0.0, jnp.sqrt(jnp.maximum(best_r2, 0.0)))
    bcx = jnp.where(none_found, hull_pts[0, 0], bcx)
    bcy = jnp.where(none_found, hull_pts[0, 1], bcy)
    return bcx, bcy, radius


def hull_prune_pack(pts, valid, cap_out: int, m: int = 16):
    """Exact hull-candidate reduction (Akl-Toussaint): the extreme points
    in ``m`` fixed directions form a convex polygon; any point STRICTLY
    inside it is strictly inside the convex hull and can never be a hull
    vertex. Survivors (boundary-or-outside points) pack into a
    [cap_out, 2] block for the gift-wrap sweep, whose per-step cost is
    O(width) -- at the bench shape this cuts the sweep width 1024 -> 192.

    Exactness: pruning only removes provably-interior points; boundary
    points (cross == 0) and all m-gon vertices survive. Degenerate m-gons
    (few distinct extremes, collinear clusters) mask their zero-length
    edges, the strict-inside test then fails for every point, and nothing
    is pruned -- sound, never wrong, possibly slow. ``overflow`` counts
    survivors beyond cap_out (a DROPPED survivor can lose a hull vertex:
    callers treat nonzero like any other capacity overflow).

    Returns (packed_pts [cap_out, 2], packed_valid [cap_out], overflow).
    """
    cap = pts.shape[0]
    th = _np.linspace(0, 2 * _np.pi, m, endpoint=False)
    dirs = jnp.asarray(_np.stack([_np.cos(th), _np.sin(th)]), pts.dtype)
    # HIGHEST: a reduced-precision matmul (TF32 on a GPU, ~1e-3 relative)
    # scrambles the argmax among points spread 1e-3 apart, and the
    # "extremes" polygon then misses most of the cloud
    proj = jnp.where(valid[:, None],
                     jnp.matmul(pts, dirs,
                                precision=jax.lax.Precision.HIGHEST),
                     -BIG)                                  # [cap, m]
    ext = jnp.argmax(proj, axis=0)                          # [m]
    gx = pts[ext, 0]
    gy = pts[ext, 1]
    nxt = (jnp.arange(m) + 1) % m
    ex = gx[nxt] - gx
    ey = gy[nxt] - gy
    edge_ok = (ex * ex + ey * ey) > 0
    # extremes ordered by direction angle are in CCW convex position:
    # strictly inside <=> cross > 0 for every nonzero edge
    cross = (ex[None, :] * (pts[:, 1:2] - gy[None, :])
             - ey[None, :] * (pts[:, 0:1] - gx[None, :]))   # [cap, m]
    inside = jnp.all((cross > 0) | ~edge_ok[None, :], axis=1) & jnp.any(
        edge_ok)
    keep = valid & ~inside
    # pack by rank-compare one-hot matmul (cumsum rank + a [cap_out, cap]
    # one-hot) instead of a per-row argsort/top_k. Exactly one nonzero
    # per kept output row => f32 products are the original coordinates
    rank = jnp.cumsum(keep.astype(jnp.int32)) - 1           # [cap]
    total = jnp.sum(keep, dtype=jnp.int32)
    oh = (keep[:, None]
          & (rank[:, None] == jnp.arange(cap_out)[None, :]))  # [cap, out]
    out = jax.lax.dot_general(
        oh.astype(pts.dtype), pts, (((0,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST)                # [cap_out, 2]
    sel = jnp.arange(cap_out) < total
    out = jnp.where(sel[:, None], out, jnp.asarray(BIG, pts.dtype))
    overflow = jnp.maximum(total - cap_out, 0)
    return out, sel, overflow


_PAIRS4 = _np.asarray([(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)],
                      _np.int32)
_TRIPS4 = _np.asarray([(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)],
                      _np.int32)


def _mec_of_4(sx, sy, sv):
    """Exact MEC of <= 4 masked points: brute over the 6 pairs + 4 triples
    with containment over the (valid) 4, pair winning exact ties like
    min_enclosing_circle. Returns (cx, cy, r2, on bool[4] -- the winner's
    defining slots)."""
    pi, pj = _PAIRS4[:, 0], _PAIRS4[:, 1]
    cx2 = (sx[pi] + sx[pj]) / 2
    cy2 = (sy[pi] + sy[pj]) / 2
    r2_2 = (cx2 - sx[pi]) ** 2 + (cy2 - sy[pi]) ** 2
    ar4 = jnp.arange(4)
    pskip = (ar4[None, :] == pi[:, None]) | (ar4[None, :] == pj[:, None])

    def encl(cx, cy, r2, skip):
        d2 = (cx[:, None] - sx[None, :]) ** 2 + (
            cy[:, None] - sy[None, :]) ** 2
        return jnp.all((d2 <= r2[:, None]) | ~sv[None, :] | skip, axis=1)

    p_ok = sv[pi] & sv[pj] & encl(cx2, cy2, r2_2, pskip)
    pr2 = jnp.where(p_ok, r2_2, BIG)
    bp = jnp.argmin(pr2)
    best_pair = pr2[bp]

    ta, tb, tc = _TRIPS4[:, 0], _TRIPS4[:, 1], _TRIPS4[:, 2]
    pts4 = jnp.stack([sx, sy], axis=-1)
    cx3, cy3, r2_3 = _circumcircle(pts4[ta], pts4[tb], pts4[tc])
    r2_3 = jnp.where(jnp.isfinite(r2_3), r2_3, BIG)
    tskip = ((ar4[None, :] == ta[:, None]) | (ar4[None, :] == tb[:, None])
             | (ar4[None, :] == tc[:, None]))
    t_ok = sv[ta] & sv[tb] & sv[tc] & encl(cx3, cy3, r2_3, tskip)
    tr2 = jnp.where(t_ok, r2_3, BIG)
    bt = jnp.argmin(tr2)
    best_trip = tr2[bt]

    use_t = best_trip < best_pair
    cx = jnp.where(use_t, cx3[bt], cx2[bp])
    cy = jnp.where(use_t, cy3[bt], cy2[bp])
    r2 = jnp.where(use_t, best_trip, best_pair)
    on = jnp.where(use_t, tskip[bt], pskip[bp]) & sv
    return cx, cy, r2, on


def min_enclosing_circle_eh(hull_pts, hull_valid, max_rounds: int = None):
    """Minimal enclosing circle by Elzinga-Hearn support iteration.

    Keep a support set of <= 4 points, solve ITS MEC in closed form
    (_mec_of_4), prune to the defining points, and add the farthest point
    strictly outside; terminate when no point lies outside -- then the
    circle encloses everything while being the MEC of a subset, hence THE
    unique MEC. Exact in f64 (tests); expected rounds ~= support changes.

    Not the production MEC: blob hulls are NEAR-COCIRCULAR, E-H's worst
    case -- many points sit within f32 rounding of the circle, the
    per-round radius increase drops below ULP, the support cycles, and the
    vmapped while_loop both runs to the worst lane's round cap and exits
    unconverged with a non-enclosing circle (up to 21% radius error in f32
    at the bench shape). The C(h,3) scan has neither failure mode. Kept
    for f64 host-side use.
    """
    h = hull_pts.shape[0]
    if max_rounds is None:
        max_rounds = h
    px = jnp.where(hull_valid, hull_pts[:, 0], BIG)
    py = jnp.where(hull_valid, hull_pts[:, 1], BIG)
    n_valid = jnp.sum(hull_valid, dtype=jnp.int32)
    ar = jnp.arange(h)

    # init support: first valid point + the farthest valid point from it
    i0 = jnp.argmax(hull_valid).astype(jnp.int32)
    d0 = jnp.where(hull_valid, (px - px[i0]) ** 2 + (py - py[i0]) ** 2,
                   -1.0)
    i1 = jnp.argmax(d0).astype(jnp.int32)
    s_idx0 = jnp.stack([i0, i1, i0, i0])
    s_val0 = jnp.asarray([True, True, False, False])

    def body(state):
        s_idx, s_val, _, _, _, _, it = state
        cx, cy, r2, on = _mec_of_4(px[s_idx], py[s_idx], s_val)
        s_val = s_val & on
        is_sup = jnp.any(
            (ar[:, None] == s_idx[None, :]) & s_val[None, :], axis=1)
        d2 = jnp.where(hull_valid & ~is_sup,
                       (cx - px) ** 2 + (cy - py) ** 2, -1.0)
        f = jnp.argmax(d2).astype(jnp.int32)
        outside = d2[f] > r2
        free = jnp.argmin(s_val)          # first pruned slot (<= 3 on)
        s_idx = s_idx.at[free].set(jnp.where(outside, f, s_idx[free]))
        s_val = s_val.at[free].set(s_val[free] | outside)
        return s_idx, s_val, cx, cy, r2, ~outside, it + 1

    st = body((s_idx0, s_val0, px[0], py[0], jnp.asarray(0.0, px.dtype),
               jnp.array(False), jnp.int32(0)))
    *_, cx, cy, r2, done, _ = jax.lax.while_loop(
        lambda s: (~s[5]) & (s[6] < max_rounds), body, st)

    none = n_valid < 2
    radius = jnp.where(none, 0.0, jnp.sqrt(jnp.maximum(r2, 0.0)))
    bcx = jnp.where(none, hull_pts[0, 0], cx)
    bcy = jnp.where(none, hull_pts[0, 1], cy)
    return bcx, bcy, radius


def min_area_rect(hull_pts, hull_valid):
    """Smallest enclosing rectangle side lengths (len0 >= len1) + area.

    Rotating-calipers equivalent (Polygon.cs:360-702): for each hull edge,
    project hull points on the edge direction and its normal; the smallest
    (extent_u * extent_v) over edges is the min-area rectangle.
    """
    h = hull_pts.shape[0]
    nxt_idx = jnp.arange(1, h + 1) % h
    # next valid wraps to vertex 0: roll valid hull points
    last = jnp.maximum(jnp.sum(hull_valid.astype(jnp.int32)) - 1, 0)
    nxt = jnp.where(jnp.arange(h) == last, 0, jnp.minimum(nxt_idx, last))
    e = hull_pts[nxt] - hull_pts
    elen = jnp.sqrt(jnp.sum(e * e, axis=-1))
    edge_ok = hull_valid & (elen > 0)
    u = e / jnp.maximum(elen, 1e-30)[:, None]
    v = jnp.stack([-u[:, 1], u[:, 0]], axis=-1)
    # HIGHEST: a reduced-precision matmul (TF32 on a GPU) would carry
    # ~1e-3 relative noise into the extents
    pu = jnp.matmul(hull_pts, u.T,
                    precision=jax.lax.Precision.HIGHEST)
    pv = jnp.matmul(hull_pts, v.T,
                    precision=jax.lax.Precision.HIGHEST)
    mask = hull_valid[:, None]
    ext_u = jnp.max(jnp.where(mask, pu, -BIG), axis=0) - jnp.min(
        jnp.where(mask, pu, BIG), axis=0
    )
    ext_v = jnp.max(jnp.where(mask, pv, -BIG), axis=0) - jnp.min(
        jnp.where(mask, pv, BIG), axis=0
    )
    area = jnp.where(edge_ok, ext_u * ext_v, BIG)
    best = jnp.argmin(area)
    l0 = ext_u[best]
    l1 = ext_v[best]
    len_long = jnp.maximum(l0, l1)
    len_short = jnp.minimum(l0, l1)
    ok = area[best] < BIG
    return (
        jnp.where(ok, len_long, 0.0),
        jnp.where(ok, len_short, 0.0),
        jnp.where(ok, area[best], 0.0),
    )


@partial(jax.jit,
         static_argnames=("max_hull", "min_points", "chunk_k", "hull",
                          "tri_chunk", "mec", "prune_cap"))
def cluster_shapes(points, valid, counts, max_hull: int = 64,
                   min_points: int = 4, chunk_k: int = 256,
                   hull: str = "wrap", tri_chunk: int = 512,
                   mec: str = "scan", prune_cap: int = 0):
    """Hull + MEC + min-rect for a batch of padded clusters.

    points: [K, cap, 2]; valid: [K, cap]; counts: [K] true point counts.
    Clusters with count < min_points get radius 0 (reference skips circles
    for clusters <= 3 points, Tools.cs:400-401).

    Processed ``chunk_k`` clusters at a time; the triple enumeration scans
    the C(max_hull, 3) lexicographic index table in fixed chunks, so the
    peak intermediate working set is ~chunk_k * chunk * max_hull floats
    (chunk <= 512) regardless of K or max_hull.

    ``hull``: "wrap" (default) = the reference-ordered gift-wrap
    (Geometry.cs parity); "quick" = batched quickhull in O(log h) rounds.
    Despite the asymptotic edge, quick runs a per-round [h]-argsort +
    dedupe + append sequence under a while_loop where gift-wrap does one
    argmin sweep per step. Kept for max_hull
    truncation cases, where quick retains a SPREAD of true vertices and is
    strictly more accurate than wrap's angular-arc truncation. MEC and
    rect outputs are otherwise identical except the len0/len1 split of
    EXACT-TIE minimal rectangles (every edge of a triangle hull ties; the
    split follows hull edge order; area and radius are always identical).

    Returns dict of [K]-shaped circle centers/radii and rect side lengths.
    """
    hull_fn = {"wrap": convex_hull, "quick": convex_hull_quick}[hull]

    def one(p, v):
        if prune_cap:
            p, v, povf = hull_prune_pack(p, v, prune_cap)
        else:
            povf = jnp.int32(0)
        hp, hv = hull_fn(p, v, max_hull)
        if mec == "eh":
            # not the default: f32-fragile on near-cocircular hulls (see
            # the min_enclosing_circle_eh docstring)
            cx, cy, r = min_enclosing_circle_eh(hp, hv)
        else:
            cx, cy, r = min_enclosing_circle(hp, hv, tri_chunk)
        l0, l1, area = min_area_rect(hp, hv)
        return cx, cy, r, l0, l1, area, povf

    k = points.shape[0]
    pad = (-k) % min(chunk_k, k)
    pp = jnp.pad(points, ((0, pad), (0, 0), (0, 0)))
    vp = jnp.pad(valid, ((0, pad), (0, 0)))
    ck = min(chunk_k, k)
    outs = jax.lax.map(
        lambda args: jax.vmap(one)(*args),
        (pp.reshape(-1, ck, *points.shape[1:]),
         vp.reshape(-1, ck, valid.shape[1])),
    )
    cx, cy, r, l0, l1, area = [o.reshape(-1)[:k] for o in outs[:6]]
    prune_ovf = jnp.sum(outs[6].reshape(-1)[:k])
    skip = counts < min_points
    zero = jnp.zeros_like(r)
    return {
        "prune_overflow": prune_ovf,
        "center_x": cx,
        "center_y": cy,
        "radius": jnp.where(skip, zero, r),
        "rect_len0": jnp.where(skip, zero, l0),
        "rect_len1": jnp.where(skip, zero, l1),
        "rect_area": jnp.where(skip, zero, area),
        "aspect": jnp.where(
            skip | (l1 <= 0), zero, l0 / jnp.maximum(l1, 1e-30)
        ),
    }
