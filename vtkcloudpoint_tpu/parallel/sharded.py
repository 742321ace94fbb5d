"""Multi-device clustering + registration via shard_map + collectives.

Distributed equivalents of the reference's single-process machinery
(SURVEY.md §2 "Parallelism & communication inventory"):

- per-block DBSCAN: blocks shard over the mesh ``blocks`` axis; each device
  clusters its blocks locally (the ThreadPool fan-out, FrmMain.cs:1356-1361,
  with the barrier now an XLA program boundary).
- cross-block fusion: the cull rules are per-block-local, so each device
  computes keep/renumber on its OWN count rows; only the per-device
  kept-count scalars cross the mesh (one ndev-int32 all_gather) to form
  the prefix offsets -- O(boundary) collectives, bit-equal to the
  replicated renumber by construction.
- noise re-cluster: each device packs its noise points into a fixed-capacity
  buffer, all_gather produces the globally-ordered noise list (device-major
  = block-major order, matching the sequential reference order), and the
  small re-cluster runs replicated (FrmMain.cs:1507-1520 semantics).
- ICP: source points shard over devices; each ICP iteration computes local
  correspondence partial sums and psum-reduces the 3x3 cross-covariance +
  means + error (the distributed normal equations); the 4x4 Horn eigensolve
  is replicated. One psum per iteration, no host sync.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import ICPConfig, ParallelConfig
from ..cluster.dbscan import dbscan_padded, dbscan_blocks_dispatch
from ..cluster.grid import dbscan_grid, grid_metric
from ..ops import se3
from ..ops.metrics import pairwise, pairwise_sqdist


def _ring_union(hx, hlab, hval, n_used, eps: float, metric: str,
                max_ids: int, axis: str, ndev: int, max_rounds: int,
                halo_chunk: int = 2048, idm_init=None):
    """Union-find over cluster ids implied by cross-shard halo adjacency,
    with the halo shells circulating the device ring via ppermute.

    Per outer round: the local shell stays put while every other device's
    shell visits once (ndev ppermute hops, step 0 = self-pairs); each visit
    scatter-mins "smallest adjacent current id" into a local constraint map;
    a pmin unifies the maps and one path-compression sweep applies them.
    Constraints are re-derived from CURRENT ids each round, so transitive
    merges that span devices converge (Jacobi iteration over the id graph),
    bounded by ``max_rounds`` (ParallelConfig.fixpoint_max_rounds).

    Same result contract as cluster.halo_fusion.union_ids; the collective
    payload per hop is ONE device's eps-shell instead of the gathered world.
    """
    inf = jnp.int32(max_ids)
    idm0 = (jnp.arange(max_ids, dtype=jnp.int32)
            if idm_init is None else idm_init)
    la_idx = jnp.clip(hlab, 0, max_ids - 1)
    perm = [(i, (i + 1) % ndev) for i in range(ndev)]

    # row-chunk the [H, H] distance block so the halo working set stays
    # bounded no matter how many blocks a device owns
    hn = hx.shape[0]
    chunk = min(halo_chunk, hn)
    pad = (-hn) % chunk
    hxp = jnp.pad(hx, ((0, pad), (0, 0)), constant_values=1e30)
    hvp = jnp.pad(hval, (0, pad))

    def outer(state):
        idm, _, rounds = state
        la = idm[la_idx]
        lap = jnp.pad(la, (0, pad), constant_values=max_ids - 1)

        def hop(_step, carry):
            vx, vlab, vval, upd = carry
            lb = idm[jnp.clip(vlab, 0, max_ids - 1)]

            def rows(args):
                xc, vc, lc = args
                dist = pairwise(xc, vx, metric)
                adj = (
                    (dist <= eps)
                    & vc[:, None]
                    & vval[None, :]
                    & (lc[:, None] != lb[None, :])
                )
                return jnp.min(jnp.where(adj, lb[None, :], inf), axis=1)

            nbr_min = jax.lax.map(
                rows,
                (hxp.reshape(-1, chunk, hx.shape[1]),
                 hvp.reshape(-1, chunk), lap.reshape(-1, chunk)),
            ).reshape(-1)[:hn]
            upd = upd.at[la_idx].min(jnp.where(hval, nbr_min, inf))
            vx = jax.lax.ppermute(vx, axis, perm)
            vlab = jax.lax.ppermute(vlab, axis, perm)
            vval = jax.lax.ppermute(vval, axis, perm)
            return vx, vlab, vval, upd

        # the constraint map starts as a literal (unvarying under shard_map)
        # but becomes device-varying inside the loop -- mark it varying up
        # front so the fori_loop carry types match
        upd0 = jax.lax.pcast(jnp.full((max_ids,), inf, jnp.int32), (axis,),
                             to="varying")
        _, _, _, upd = jax.lax.fori_loop(
            0, ndev, hop, (hx, hlab, hval, upd0)
        )
        upd = jax.lax.pmin(upd, axis)
        new = jnp.minimum(idm, jnp.minimum(upd, inf - 1))
        new = new.at[0].set(0)
        # path compression to a local fixpoint (chains only shorten)
        def compress(s):
            m, _ = s
            m2 = jnp.minimum(m, m[m])
            return m2, jnp.any(m2 != m)

        new, _ = jax.lax.while_loop(
            lambda s: s[1], compress, (new, jnp.array(True))
        )
        return new, jnp.any(new != idm), rounds + 1

    idm1, ch1, r1 = outer((idm0, jnp.array(True), jnp.int32(0)))
    idm, _, _ = jax.lax.while_loop(
        lambda s: s[1] & (s[2] < max_rounds), outer, (idm1, ch1, r1)
    )

    ids = jnp.arange(max_ids)
    used = (ids >= 1) & (ids <= n_used)
    survivor = used & (idm == ids)
    new_id = jnp.cumsum(survivor.astype(jnp.int32))
    remap = jnp.where(used, new_id[idm], 0).astype(jnp.int32)
    remap = remap.at[0].set(0)
    return {
        "remap": remap,
        "n_after": jnp.sum(survivor.astype(jnp.int32)),
        "idmap": idm,
    }


def _half_stencil_offsets(ndim: int):
    """Self + lexicographically-positive stencil offsets: for ANY pair of
    cells within one step of each other, one of the two contains the other
    in its half stencil -- so routing every point to the owners of these
    (3^D+1)/2 cells guarantees each eps-pair meets at >= one owner, at
    half the copy count of the full 3^D stencil."""
    from itertools import product

    offs = [o for o in product((-1, 0, 1), repeat=ndim)
            if o > (0,) * ndim]
    return [(0,) * ndim] + offs


def _owner_route(bx, blab, sel, eps: float, axis: str, ndev: int,
                 dest_cap: int):
    """Pack + all_to_all skin points to the hash-owners of their
    half-stencil cells.

    Every device sends each of its valid skin points to owner(cell) for
    its (3^D+1)/2 half-stencil cells (owner = mixed cell hash mod ndev),
    deduplicated per point when offsets share an owner.  Sent AND received
    payload per device is O(own boundary) x (3^D+1)/2 -- FLAT as the mesh
    grows -- where the gathered-skin union's per-device payload was
    O(ndev x dev_halo_cap) = O(total boundary) (VERDICT r4 missing item 3).

    Returns (rx [ndev*dest_cap, D], rlab, rok, dropped) in received
    (source-device-major) order; ``dropped`` counts valid copies beyond
    dest_cap on THIS device (callers psum it into overflow -- exactness
    requires 0).
    """
    from ..cluster.grid import _PRIMES

    S, D = bx.shape
    offs = _half_stencil_offsets(D)
    R = len(offs)
    cidx = jnp.floor(bx / eps).astype(jnp.int32)

    def wrap32(v):
        return ((v + 2**31) % 2**32) - 2**31

    raw = jnp.zeros(S, jnp.int32)
    for ax in range(D):
        raw = raw + cidx[:, ax] * jnp.int32(_PRIMES[ax])
    deltas = [
        wrap32(sum(int(o[ax]) * _PRIMES[ax] for ax in range(D)))
        for o in offs
    ]
    # Fibonacci-mix the cell hash before the mod so owner load balances
    # (raw is a linear form of the cell coords; adjacent cells would
    # otherwise stripe across owners with visible bias)
    dests = []
    for d in deltas:
        m = (raw + jnp.int32(d)) * jnp.int32(-1640531527)  # 0x9E3779B9
        dests.append(jnp.abs(m >> 8) % ndev)
    dest = jnp.stack(dests, axis=1)                        # [S, R]
    # dedupe offsets sharing an owner for the same point (R is tiny)
    dup = jnp.zeros((S, R), bool)
    for j in range(1, R):
        for i in range(j):
            dup = dup.at[:, j].set(dup[:, j] | (dest[:, j] == dest[:, i]))
    ok = sel[:, None] & ~dup                               # [S, R]

    flat_dest = jnp.where(ok, dest, ndev).reshape(-1)      # [S*R]
    skey, sidx = jax.lax.sort(
        (flat_dest, jnp.arange(S * R, dtype=jnp.int32)), num_keys=1,
        is_stable=True)
    seg_start = jnp.searchsorted(skey, jnp.arange(ndev, dtype=jnp.int32))
    rank = jnp.arange(S * R) - seg_start[jnp.clip(skey, 0, ndev - 1)]
    valid = (skey < ndev) & (rank < dest_cap)
    slot = jnp.where(valid, skey * dest_cap + rank, ndev * dest_cap)
    dropped = jnp.sum(skey < ndev, dtype=jnp.int32) - jnp.sum(
        valid, dtype=jnp.int32)
    src_pt = sidx // R                                     # source point row

    big = jnp.asarray(1e30, bx.dtype)
    buf_x = jnp.full((ndev * dest_cap, D), big, bx.dtype).at[slot].set(
        bx[src_pt], mode="drop")
    buf_l = jnp.zeros(ndev * dest_cap, jnp.int32).at[slot].set(
        blab[src_pt], mode="drop")
    buf_ok = jnp.zeros(ndev * dest_cap, bool).at[slot].set(
        valid, mode="drop")

    rx = jax.lax.all_to_all(
        buf_x.reshape(ndev, dest_cap, D), axis, 0, 0).reshape(-1, D)
    rlab = jax.lax.all_to_all(
        buf_l.reshape(ndev, dest_cap), axis, 0, 0).reshape(-1)
    rok = jax.lax.all_to_all(
        buf_ok.reshape(ndev, dest_cap).astype(jnp.int8), axis, 0, 0
    ).reshape(-1).astype(bool)
    return rx, rlab, rok, dropped


def _skin_union_a2a(bx, blab, sel, n_used, eps: float, metric: str,
                    max_ids: int, axis: str, ndev: int, max_rounds: int,
                    dest_cap: int, cell_cap: int, idm_init):
    """Owner-routed skin union: cross-device id union over skins exchanged
    by cell ownership instead of a full all_gather.

    Each owner computes eps-connected components of its RECEIVED points
    once (geometry is fixed), then iterates Jacobi rounds over the
    replicated [max_ids] id table: component -> min current id, scatter-min
    constraints, pmin across the mesh, path-compress.  Every direct
    eps-pair is visible at some owner (half-stencil routing), so the
    fixpoint is the same transitive min-id closure grid_union_ids computes
    over the gathered skins -- bit-equal labels, with collective payload
    per device O(own boundary) + the [max_ids] table per round.

    Returns (union dict with remap/n_after/idmap, overflow) where overflow
    counts routing drops, component-engine truncation, and fixpoint
    non-convergence at max_rounds (exactness requires 0).
    """
    inf = jnp.int32(max_ids)
    rx, rlab, rok, route_drop = _owner_route(
        bx, blab, sel, eps, axis, ndev, dest_cap)
    hn = rx.shape[0]
    use = rok & (rlab > 0)

    # component engine over the received set: grid stencils, as in the
    # hier local stage
    comp = dbscan_grid(rx, use, eps, 1, metric, cell_cap=cell_cap)
    eng_ovf = comp["overflow"]
    clab = comp["label"]
    la_idx = jnp.clip(rlab, 0, max_ids - 1)

    def round_fn(state):
        idm, _, it = state
        cur = jnp.where(use, idm[la_idx], inf)
        cmin = jnp.full(hn + 1, inf, jnp.int32).at[clab].min(cur)
        upd = jnp.full(max_ids, inf, jnp.int32).at[la_idx].min(
            jnp.where(use, cmin[clab], inf))
        upd = jax.lax.pmin(upd, axis)
        new = jnp.minimum(idm, jnp.minimum(upd, inf - 1))
        new = new.at[0].set(0)

        def compress(s):
            m, _ = s
            m2 = jnp.minimum(m, m[m])
            return m2, jnp.any(m2 != m)

        new, _ = jax.lax.while_loop(
            lambda s: s[1], compress, (new, jnp.array(True)))
        # pure function of (idm, pmin'd upd) => identical on all devices
        return new, jnp.any(new != idm), it + 1

    st = round_fn((idm_init, jnp.array(True), jnp.int32(0)))
    idm, still, _ = jax.lax.while_loop(
        lambda s: s[1] & (s[2] < max_rounds), round_fn, st)
    unconverged = still.astype(jnp.int32)

    ids = jnp.arange(max_ids)
    used_ids = (ids >= 1) & (ids <= n_used)
    survivor = used_ids & (idm == ids)
    new_id = jnp.cumsum(survivor.astype(jnp.int32))
    remap = jnp.where(used_ids, new_id[idm], 0).astype(jnp.int32)
    remap = remap.at[0].set(0)
    uni = {
        "remap": remap,
        "n_after": jnp.sum(survivor.astype(jnp.int32)),
        "idmap": idm,
    }
    ovf = jax.lax.psum(route_drop + eng_ovf + unconverged, axis)
    return uni, ovf


def _hier_union(hx, hlab, hval, n_used, eps: float,
                metric: str, max_ids: int, axis: str, ndev: int,
                max_rounds: int, dev_halo_cap: int, cell_cap: int,
                cell_table_bits: int = 24, skin_exchange: str = "owner",
                skin_dest_cap: int = None):
    """Two-level halo union: device-local grid-hash components, then a
    gathered union over ONLY the device-boundary skin.

    The flat ring (_ring_union) pairs every shell point against every
    visiting shell point -- O(H^2) per hop, where H ~ (blocks/device) x
    halo_cap.  At pod scale most halo pairs are INTRA-device (block-to-block
    inside one shard) and need no communication at all, so:

    1. local: every halo point is a core point (halo_buffers requires
       block_core), hence two halo points within eps are provably one
       cluster.  Connected components of the local shell under eps-adjacency
       come from the grid-hash engine (dbscan_grid, min_pts=1 => no noise,
       components = clusters) in O(H x stencil) instead of O(H^2).  Each
       component scatter-mins its smallest current global id into the id
       table; the tables pmin across devices (noise-recluster ids are shared
       by all devices, so the table must stay consistent) and path-compress,
       iterated to a fixpoint (Jacobi over the id graph).
    2. skin: each device packs its DISTINCT occupied eps-cell (raw1, raw2)
       hash pairs (halo_fusion.pack_cells) and one all_gather of the cell
       LISTS (O(distinct cells), a few MB at 10^7 points) feeds a local
       two-hash Bloom-AND membership filter (foreign_cell_filter): a halo
       point is skin iff some 3^D stencil cell appears in another device's
       list.  Partition-shape-agnostic -- unlike a bounding-box test it
       cannot blow up when Morton/L-inf device footprints straddle
       quadrant boundaries -- and filter false positives only ADD skin
       points (sound; FP rate = table load SQUARED).  Skins enter
       fixed-capacity [dev_halo_cap] buffers; one all_gather feeds a
       replicated grid-hash union (grid_union_ids) seeded with the
       stage-1 table.  Collective payload and union cost scale with the
       device BOUNDARY, not the shell or the world.

    Exact iff nothing overflows: returns (union dict, overflow) where
    overflow counts device-boundary points dropped by dev_halo_cap plus
    grid-cell truncation in both union stages.
    """
    inf = jnp.int32(max_ids)
    hn = hx.shape[0]
    la_idx = jnp.clip(hlab, 0, max_ids - 1)
    use = hval & (hlab > 0)

    # ---- stage 1: local components of the device shell ----
    # grid stencils: linear work; cell-cap truncation counts as overflow
    comp = dbscan_grid(hx, use, eps, 1, metric, cell_cap=cell_cap)
    grid_ovf = jax.lax.psum(comp["overflow"], axis)
    clab = comp["label"]                       # [hn] 1..K, 0 invalid

    def local_round(state):
        idm, _, it = state
        cur = jnp.where(use, idm[la_idx], inf)
        cmin = jnp.full(hn + 1, inf, jnp.int32).at[clab].min(cur)
        upd = jnp.full(max_ids, inf, jnp.int32).at[la_idx].min(
            jnp.where(use, cmin[clab], inf)
        )
        # the table must stay identical across devices (noise-recluster ids
        # are shared by every device), so constraints pmin before applying
        upd = jax.lax.pmin(upd, axis)
        new = jnp.minimum(idm, jnp.minimum(upd, inf - 1))
        new = new.at[0].set(0)

        def compress(s):
            m, _ = s
            m2 = jnp.minimum(m, m[m])
            return m2, jnp.any(m2 != m)

        new, _ = jax.lax.while_loop(
            lambda s: s[1], compress, (new, jnp.array(True))
        )
        # `new` is a pure function of (idm, pmin'd upd) => identical on all
        # devices, so this change flag cannot diverge the while_loop trips
        return new, jnp.any(new != idm), it + 1

    idm0 = jnp.arange(max_ids, dtype=jnp.int32)
    st = local_round((idm0, jnp.array(True), jnp.int32(0)))
    idm, _, _ = jax.lax.while_loop(
        lambda s: s[1] & (s[2] < max_rounds), local_round, st
    )

    # ---- stage 2: reduce to the device-boundary skin ----
    # global (origin-free) eps-cell coords are consistent across devices;
    # each device packs its DISTINCT occupied halo cells and one
    # all_gather (O(cells), a few MB at 10M points) feeds a local
    # two-hash (Bloom k=2) membership filter: zero false negatives,
    # false positives at load^2 per stencil lookup. History: a psum'd
    # single-hash table false-flagged ~37% of the halo (5.7M overflow at
    # 10M), and psum'ing 64 MB tables tripped the XLA CPU rendezvous
    # watchdog -- the gathered-list form fixes both.
    from ..cluster.grid import _PRIMES, _PRIMES2
    from ..cluster.halo_fusion import (
        cell_hashes, foreign_cell_filter, pack_cells,
    )

    raw1, deltas1 = cell_hashes(hx, eps, _PRIMES)
    raw2, deltas2 = cell_hashes(hx, eps, _PRIMES2)
    dev = jax.lax.axis_index(axis)
    list_cap = max(4096, hn // 4)
    cells, cells_sel, cell_dropped = pack_cells(raw1, raw2, use, list_cap)
    gcells = jax.lax.all_gather(cells, axis)
    gcsel = jax.lax.all_gather(cells_sel, axis)
    other = jnp.arange(ndev) != dev
    near = use & foreign_cell_filter(
        raw1, raw2, deltas1, deltas2,
        gcells.reshape(-1, 2), (gcsel & other[:, None]).reshape(-1),
        cell_table_bits,
    )

    slot = jnp.where(near, jnp.arange(hn, dtype=jnp.int32), hn)
    order = jnp.argsort(slot, stable=True)[:dev_halo_cap]
    sel = slot[order] < hn
    bx = jnp.where(sel[:, None], hx[order], jnp.asarray(1e30, hx.dtype))
    blab = jnp.where(sel, idm[la_idx[order]], 0)
    dev_ovf = jax.lax.psum(
        jnp.sum(near, dtype=jnp.int32) - jnp.sum(sel, dtype=jnp.int32)
        # dropped distinct cells could hide cross-device boundary points
        + cell_dropped, axis
    )

    # ---- stage 3: cross-device union over the skins ----
    if skin_exchange == "owner":
        # owner-routed all_to_all: per-device payload O(own boundary),
        # flat as the mesh grows (the pod-scale form; VERDICT r4 item 3).
        # The gathered form moves O(ndev x dev_halo_cap) to EVERY device.
        if skin_dest_cap is None:
            # 2x headroom over perfectly-balanced owner load, min 64
            R = (3 ** hx.shape[1] + 1) // 2
            per = -(-2 * R * dev_halo_cap // max(ndev, 1))   # ceil
            skin_dest_cap = max(64, (per + 7) // 8 * 8)
        uni, a2a_ovf = _skin_union_a2a(
            bx, blab, sel, n_used, eps, metric, max_ids, axis, ndev,
            max_rounds, skin_dest_cap, cell_cap, idm_init=idm)
        return uni, grid_ovf + dev_ovf + a2a_ovf

    from ..cluster.halo_fusion import grid_union_ids

    gx = jax.lax.all_gather(bx, axis).reshape(-1, hx.shape[1])
    glab = jax.lax.all_gather(blab, axis).reshape(-1)
    gsel = jax.lax.all_gather(sel, axis).reshape(-1)
    uni = grid_union_ids(gx, glab, gsel, n_used, eps, metric, max_ids,
                         cell_cap=cell_cap, idm_init=idm,
                         max_rounds=max_rounds)
    return uni, grid_ovf + dev_ovf + uni["overflow"]


def sharded_blocked_dbscan(
    mesh: Mesh,
    block_coords,
    block_valid,
    eps: float,
    min_pts: int,
    metric: str = "l1_motor",
    min_cluster_size: int = 3,
    quirks: bool = True,
    noise_capacity_per_device: int = 1024,
    halo_merge: bool = False,
    halo_cap: int = 64,
    max_ids: int = 4096,
    axis: str = "blocks",
    backend: str = "auto",
    noise_recluster: str = "auto",   # "grid" | "dense" | "distributed" | "auto"
    noise_cell_cap: int = 32,
    noise_skin_cap: int = 1024,      # "distributed": boundary-noise buffer
    noise_root_cap: int = 4096,      # "distributed": per-device root list
    noise_local_engine: str = "auto",  # "distributed": grid|dense|auto
    centroid_merge: bool = False,    # C11 at scale: merge by centroid dist
    merge_eps: float = 0.0,
    merge_min_pts: int = 2,
    halo_mode: str = "ring",         # "ring" | "gather" | "hier"
    dev_halo_cap: int = 512,         # "hier": device-boundary skin capacity
    halo_cell_cap: int = 64,         # "hier": grid cells in the local stage
    skin_exchange: str = "owner",    # "hier" stage 3: "owner" | "gather"
    skin_dest_cap: int = None,       # "owner": per-destination slot cap
    fixpoint_max_rounds: int = None,  # None -> ParallelConfig default
    halo_width_eps: float = None,     # shell width multiple of eps
    dbscan_chunk: int = 64,          # per-device blocks in flight (jnp path)
    cell_table_bits: int = 24,       # halo/skin occupancy-table size (2^bits)
    split_programs: bool = False,    # run DBSCAN and fusion as two programs
    checkpoint_dir: str = None,      # split_programs: persist program-1 out
):
    """Distributed blocked DBSCAN + fusion.

    block_coords: [B, cap, D], block_valid: [B, cap]; B must divide by the
    mesh size. Returns dict(label [B, cap] global ids, n_total,
    noise_overflow, halo_overflow) -- overflow counters report any point
    silently dropped by the fixed capacities (VERDICT r1 item 3b).

    ``split_programs=True`` compiles TWO shard_map programs instead of one:
    program 1 is the collective-FREE per-device DBSCAN (labels/core stay
    device-resident between programs), program 2 is the fusion, which
    issues its first all_gather within milliseconds of launch. The fused
    single program stalls XLA:CPU validation hosts at scale: each virtual
    device computes minutes of per-device DBSCAN before its first
    collective, and with fewer host cores than devices the workers reach
    the rendezvous farther apart than the runtime's ~2-minute collective
    watchdog allows; devices of a real mesh run in parallel and don't
    need this. Results are bit-equal;
    both modes share the same fusion body.

    The cross-boundary noise re-cluster (FrmMain.cs:1507-1520 semantics)
    gathers each device's noise shell and re-clusters it replicated; with
    noise_recluster="grid" (default on supported metrics) that re-cluster is
    the O(N * stencil) grid-hash engine instead of the O(N^2) dense one, so
    it survives pod-scale noise counts (VERDICT r1 item 3a).

    halo_merge=True unifies clusters split across blocks/devices. With
    halo_mode="ring" the per-device eps-shells circulate the mesh ring via
    ppermute (SURVEY.md §5 long-context row) -- per-step working set is one
    shell, not the world -- and the id union-find runs as a replicated
    fixpoint over psum/pmin'd constraints, at most ``fixpoint_max_rounds``
    ring sweeps (ParallelConfig.fixpoint_max_rounds). halo_mode="gather"
    keeps the all_gather + replicated union-find of round 1.
    """
    B, cap, D = block_coords.shape
    ndev = mesh.shape[axis]
    assert B % ndev == 0, f"blocks {B} not divisible by mesh size {ndev}"
    kmax = cap + 1

    pc = ParallelConfig()
    if fixpoint_max_rounds is None:
        fixpoint_max_rounds = pc.fixpoint_max_rounds
    if halo_width_eps is None:
        halo_width_eps = pc.halo_width_eps
    gmetric = grid_metric(metric, D)
    if noise_recluster == "auto":
        # the stored [T, T] adjacency up to 8k gathered noise points, above
        # it the grid engine (stored dense when the metric has no grid
        # form)
        total_noise = ndev * noise_capacity_per_device
        if total_noise <= 8192:
            noise_recluster = "dense"
        elif gmetric is not None:
            noise_recluster = "grid"
        else:
            noise_recluster = "dense"
    if noise_recluster in ("grid", "distributed") and gmetric is None:
        raise ValueError(
            f"metric {metric!r} has no grid form; use noise_recluster='dense'")
    if halo_mode == "hier" and gmetric is None:
        raise ValueError(
            f"metric {metric!r} has no grid form; use halo_mode='ring'")

    def local_dbscan(coords_loc, valid_loc):
        db = dbscan_blocks_dispatch(
            coords_loc, valid_loc, eps, min_pts, metric,
            chunk=dbscan_chunk, backend=backend
        )
        return db["label"], db["core"]

    def fusion_fn(coords_loc, valid_loc, labels_loc, core_loc):
        from ..cluster.fusion import (
            _block_label_counts, apply_block_gid, block_keep_rules,
            noise_pack_order,
        )

        dev = jax.lax.axis_index(axis)
        counts_loc = _block_label_counts(labels_loc, valid_loc, kmax)

        # O(boundary) keep/renumber (VERDICT r4 missing item 2): the cull
        # rules are PER-BLOCK-LOCAL (cluster.fusion.block_keep_rules --
        # each row depends only on its own counts) and the global renumber
        # is a plain prefix sum in device-major block order, so only the
        # per-device kept-count SCALARS cross the mesh -- one all_gather
        # of ndev int32s replaces the old [B, kmax] counts all_gather
        # (B*kmax*4 bytes/device = O(world points): 40 MB/device = 73% of
        # all collective bytes at the 10M tier-5 record). Bit-equal to
        # block_keep_renumber on the gathered counts by construction.
        keep_loc = block_keep_rules(counts_loc, min_cluster_size, quirks)
        bloc = labels_loc.shape[0]
        gid_cum = jnp.cumsum(
            keep_loc.reshape(-1).astype(jnp.int32)).reshape(bloc, kmax - 1)
        kept_loc = gid_cum.reshape(-1)[-1]
        kept_all = jax.lax.all_gather(kept_loc, axis)       # [ndev] i32
        offset = jnp.sum(
            jnp.where(jnp.arange(ndev) < dev, kept_all, 0), dtype=jnp.int32)
        n_kept = jnp.sum(kept_all, dtype=jnp.int32)
        point_gid = apply_block_gid(
            labels_loc, valid_loc, keep_loc, gid_cum + offset)

        # ---- noise re-cluster across shards ----
        noise_mask = valid_loc & (point_gid == 0)
        order, sel_valid = noise_pack_order(
            labels_loc, noise_mask, noise_capacity_per_device)
        n_noise = jnp.sum(noise_mask, dtype=jnp.int32)
        noise_ovf = jax.lax.psum(
            n_noise - jnp.sum(sel_valid, dtype=jnp.int32), axis
        )
        cflat = coords_loc.reshape(bloc * cap, D)
        my_noise = jnp.where(sel_valid[:, None], cflat[order], 0.0)
        cf_seed = (n_kept - 1) if quirks else n_kept
        if noise_recluster == "distributed":
            # owner-sharded re-cluster: collectives scale with the device
            # BOUNDARY (skin + distinct cells + roots), never the world's
            # noise; bit-equal to the gathered path at zero overflow
            from .noise_shard import sharded_noise_recluster

            my_re, n_new, novf2 = sharded_noise_recluster(
                my_noise, sel_valid, eps, min_pts, gmetric, cf_seed,
                axis, ndev, skin_cap=noise_skin_cap,
                root_cap=noise_root_cap, cell_cap=noise_cell_cap,
                max_rounds=fixpoint_max_rounds,
                cell_table_bits=cell_table_bits,
                local_engine=noise_local_engine,
            )
            noise_ovf = noise_ovf + novf2
            n_total = cf_seed + n_new
        else:
            all_noise = jax.lax.all_gather(my_noise, axis).reshape(-1, D)
            all_sel = jax.lax.all_gather(sel_valid, axis).reshape(-1)
            if noise_recluster == "grid":
                re = dbscan_grid(
                    all_noise, all_sel, eps, min_pts, gmetric,
                    cf=cf_seed, cell_cap=noise_cell_cap,
                )
                noise_ovf = noise_ovf + re["overflow"]
            elif noise_recluster == "dense_chunked":
                from ..cluster.dbscan import dbscan_dense_chunked

                re = dbscan_dense_chunked(
                    all_noise, all_sel, eps, min_pts, metric, cf=cf_seed
                )
            else:
                re = dbscan_padded(
                    all_noise, all_sel, eps, min_pts, metric, cf=cf_seed
                )
            n_total = cf_seed + re["n_clusters"]
            my_re = re["label"].reshape(ndev, -1)[dev]

        flat_gid = point_gid.reshape(-1)
        flat_gid = flat_gid.at[order].set(
            jnp.where(sel_valid, my_re, flat_gid[order])
        )
        out_labels = flat_gid.reshape(bloc, cap)

        halo_ovf = jnp.int32(0)
        if halo_merge:
            from ..cluster.halo_fusion import (
                halo_buffers, union_ids, apply_halo_merge,
            )

            hx, hlab, hval, hov = halo_buffers(
                coords_loc, valid_loc, out_labels,
                core_loc, eps, halo_cap,
                shell_eps=eps * halo_width_eps,
                # globally-unique block ids + mesh-reduced occupancy tables
                # so the boundary test sees every other device's blocks
                block_id_offset=dev * labels_loc.shape[0], axis=axis,
                cell_table_bits=cell_table_bits,
            )
            halo_ovf = jax.lax.psum(hov, axis)
            if halo_mode == "gather":
                hx = jax.lax.all_gather(hx, axis).reshape(-1, D)
                hlab = jax.lax.all_gather(hlab, axis).reshape(-1)
                hval = jax.lax.all_gather(hval, axis).reshape(-1)
                if gmetric is not None:
                    # O(H x stencil) grid union: the dense [H, H] pairwise
                    # union is quadratic in the WORLD halo count (5 TB at
                    # 1M halo points) and only survives toy scales
                    from ..cluster.halo_fusion import grid_union_ids

                    uni = grid_union_ids(
                        hx, hlab, hval, n_total, eps, gmetric, max_ids,
                        cell_cap=halo_cell_cap,
                        max_rounds=fixpoint_max_rounds)
                    halo_ovf = halo_ovf + uni["overflow"]
                else:
                    uni = union_ids(hx, hlab, hval, n_total, eps, metric,
                                    max_ids)
            elif halo_mode == "hier":
                uni, hovf2 = _hier_union(
                    hx, hlab, hval, n_total, eps,
                    gmetric, max_ids, axis, ndev, fixpoint_max_rounds,
                    dev_halo_cap, halo_cell_cap,
                    cell_table_bits=cell_table_bits,
                    skin_exchange=skin_exchange,
                    skin_dest_cap=skin_dest_cap,
                )
                halo_ovf = halo_ovf + hovf2
            else:
                uni = _ring_union(
                    hx, hlab, hval, n_total, eps, metric, max_ids,
                    axis, ndev, fixpoint_max_rounds,
                )
            out_labels = apply_halo_merge(out_labels, uni["remap"])
            n_total = uni["n_after"]

        if centroid_merge:
            # C11 at scale (Tools.cs:580-621): psum the per-id centroid
            # moments -- the [max_ids, 3] table is tiny -- and run
            # the reference's centroid DBSCAN replicated. Deterministic
            # per mesh; vs the single-device path the psum summation
            # order can differ in float, so the contract is tolerance,
            # not bit-parity (marginal eps-boundary pairs could differ).
            # Centroids come from the first two METRIC-coordinate
            # components (what the block layout carries); the reference
            # merges on cartesian X/Y, which coincides under l2 metrics
            # -- for exact C11 parity under l1_motor, run the
            # single-device merge on the xyz centroid table instead.
            from ..cluster.fusion import merge_centroid_clusters

            w = (out_labels > 0) & valid_loc
            seg = jnp.where(w, out_labels, max_ids).reshape(-1)
            cflat2 = coords_loc.reshape(-1, D)
            moments = jnp.concatenate(
                [jnp.where(w.reshape(-1)[:, None], cflat2[:, :2], 0.0),
                 w.reshape(-1, 1).astype(cflat2.dtype)], axis=1)
            sums = jax.ops.segment_sum(moments, seg,
                                       num_segments=max_ids + 1)[:max_ids]
            sums = jax.lax.psum(sums, axis)
            cnt = sums[:, 2]
            cen = sums[:, :2] / jnp.maximum(cnt, 1.0)[:, None]
            mg = merge_centroid_clusters(cen, cnt > 0, merge_eps,
                                         merge_min_pts)
            out_labels = mg["remap"][jnp.clip(out_labels, 0, max_ids - 1)]
            n_total = mg["n_after"]

        return out_labels, n_total[None], noise_ovf[None], halo_ovf[None]

    if split_programs:
        # The program boundary is a natural persistence point (VERDICT r4
        # item 8): a 10M-point virtual-mesh run costs ~19 host-minutes of
        # per-device DBSCAN before the fusion, and a watchdog kill or OOM
        # loses it all. With checkpoint_dir set, each PROCESS saves its
        # local label/core rows after program 1 and a rerun with the same
        # configuration resumes straight into the fusion.
        labels = core = None
        mgr = None
        if checkpoint_dir is not None and B % jax.process_count() == 0:
            import os as _os

            import numpy as _np

            from ..utils.checkpoint import CheckpointManager
            from .distributed import make_global_blocks

            nproc = jax.process_count()
            bproc = B // nproc
            fp = dict(B=B, cap=cap, eps=float(eps), min_pts=int(min_pts),
                      metric=metric, backend=backend, nproc=nproc)
            mgr = CheckpointManager(
                _os.path.join(checkpoint_dir,
                              f"p{jax.process_index()}"), keep=1)
            import zlib as _zlib

            like = {"label": _np.zeros((bproc, cap), _np.int32),
                    "core": _np.zeros((bproc, cap), bool),
                    "fp": _np.zeros(1, _np.int64)}
            # stable config fingerprint (python hash() is seed-randomized
            # across runs, which would defeat every resume)
            fpv = _np.asarray(
                [_zlib.crc32(repr(sorted(fp.items())).encode())], _np.int64)
            try:
                tree, _ = mgr.restore_latest(like)
            except Exception:
                tree = None
            if (tree is not None
                    and tree["label"].shape == (bproc, cap)
                    and tree["fp"].shape == fpv.shape
                    and bool((tree["fp"] == fpv).all())):
                labels = make_global_blocks(tree["label"], mesh, axis)
                core = make_global_blocks(tree["core"], mesh, axis)
        if labels is None:
            # program 1: collective-free per-device DBSCAN
            labels, core = jax.jit(
                shard_map(
                    local_dbscan,
                    mesh=mesh,
                    in_specs=(P(axis), P(axis)),
                    out_specs=(P(axis), P(axis)),
                    check_vma=False,
                )
            )(block_coords, block_valid)
            if mgr is not None:
                def _local_rows(garr):
                    shards = sorted(
                        garr.addressable_shards,
                        key=lambda s: s.index[0].start or 0)
                    return _np.concatenate(
                        [_np.asarray(s.data) for s in shards], axis=0)

                mgr.save(0, {"label": _local_rows(labels),
                             "core": _local_rows(core), "fp": fpv})
        # program 2: fusion -- first collective fires right after launch
        out_labels, n_total, noise_ovf, halo_ovf = jax.jit(
            shard_map(
                fusion_fn,
                mesh=mesh,
                in_specs=(P(axis), P(axis), P(axis), P(axis)),
                out_specs=(P(axis), P(axis), P(axis), P(axis)),
                check_vma=False,
            )
        )(block_coords, block_valid, labels, core)
        return {
            "label": out_labels,
            "n_total": n_total[0],
            "noise_overflow": noise_ovf[0],
            "halo_overflow": halo_ovf[0],
        }

    def fn(coords_loc, valid_loc):
        labels_loc, core_loc = local_dbscan(coords_loc, valid_loc)
        return fusion_fn(coords_loc, valid_loc, labels_loc, core_loc)

    out_labels, n_total, noise_ovf, halo_ovf = jax.jit(
        shard_map(
            fn,
            mesh=mesh,
            in_specs=(P(axis), P(axis)),
            out_specs=(P(axis), P(axis), P(axis), P(axis)),
            # ffi_call outputs (the CUDA DBSCAN kernel) carry no
            # varying-mesh-axes metadata; VMA checking would reject them
            check_vma=False,
        )
    )(block_coords, block_valid)
    return {
        "label": out_labels,
        "n_total": n_total[0],
        "noise_overflow": noise_ovf[0],
        "halo_overflow": halo_ovf[0],
    }


def sharded_icp_grid(
    mesh: Mesh,
    source,
    source_valid,
    target,
    target_valid,
    cfg: ICPConfig = ICPConfig(),
    cell_size: float = 1.0,
    cell_cap: int = 16,
    fallback_cap: int = 1024,
    chunk: int = 4096,
    axis: str = "blocks",
    nn: str = "auto",          # "auto" | "grid" | "brute"
):
    """Distributed LARGE-TARGET ICP: target sharded over the mesh, queries
    ride a ppermute ring, correspondences resolve against per-shard
    locators (VERDICT r2 item 5; the tier-5 "50M-pt map" registration path).

    nn="auto" is the grid locator; "brute" is tiled brute-force pairwise
    NN. Both are exact, so the choice never changes the transform.

    Layout: source AND target shard over the mesh ``axis``. Each device
    builds ONE grid (register.nn_grid.build_nn_grid) over its local target
    shard. Per ICP iteration the device's transformed source block
    circulates the ring; at each of the ndev hops the visiting queries
    resolve their exact local-shard NN in O(q * 3^3 * cell_cap) (grid
    stencil + brute fallback, same exactness contract as nn_grid) and fold
    it into a running (best_d2, best_y); after ndev hops the buffer is home
    carrying the exact GLOBAL nearest neighbor. The Horn solve reduces with
    one psum of the weighted moments (ops.se3.horn_from_moments, shared
    with every other ICP path).

    Per-hop payload is 7 floats/query -- the ring moves queries, never the
    target, so collective bytes scale with the source, not the map.
    Queries whose NN was not provably resolved on every shard (stencil
    overflow beyond fallback_cap) drop out of that iteration's solve
    (trimmed ICP, weight 0) and are counted in the returned overflow.

    Returns (r, t, error, iterations, overflow). With zero overflow the
    transform equals single-device register.nn_grid.icp_grid on the
    gathered target (tested in tests/test_sharded.py).
    """
    n = source.shape[0]
    m = target.shape[0]
    ndev = mesh.shape[axis]
    assert n % ndev == 0 and m % ndev == 0
    perm = [(i, (i + 1) % ndev) for i in range(ndev)]

    from ..register.nn_grid import build_nn_grid, nn_grid, _brute_direct

    if nn == "auto":
        nn = "grid"

    def fn(src_loc, sv_loc, tgt_loc, tv_loc):
        dtype = src_loc.dtype
        grid = None if nn == "brute" else build_nn_grid(
            tgt_loc, tv_loc, cell_size)
        nloc = src_loc.shape[0]

        def global_nn(p):
            """Exact global NN via the query ring: (y [nloc,3], d2, ok)."""
            big = jnp.asarray(jnp.inf, dtype)

            def hop(_step, carry):
                vq, vd2, vy, vok, ovf = carry
                if nn == "brute":
                    idx, d2 = _brute_direct(vq, tgt_loc, tv_loc,
                                            min(chunk, nloc))
                    resolved = jnp.ones(nloc, bool)
                    o = jnp.int32(0)
                else:
                    idx, d2, resolved, o = nn_grid(
                        grid, vq, tgt_loc, tv_loc, cell_size,
                        cell_cap=cell_cap, fallback_cap=fallback_cap,
                        chunk=chunk,
                    )
                better = d2 < vd2
                vd2 = jnp.where(better, d2, vd2)
                vy = jnp.where(better[:, None], tgt_loc[idx], vy)
                vok = vok & resolved
                ovf = ovf + o
                vq = jax.lax.ppermute(vq, axis, perm)
                vd2 = jax.lax.ppermute(vd2, axis, perm)
                vy = jax.lax.ppermute(vy, axis, perm)
                vok = jax.lax.ppermute(vok, axis, perm)
                return vq, vd2, vy, vok, ovf

            # literal inits must be marked device-varying up front so the
            # fori_loop carry types match after the first ppermute (same
            # trick as _ring_union's constraint map)
            init = (
                p,
                jax.lax.pcast(jnp.full(nloc, big, dtype), (axis,),
                              to="varying"),
                jax.lax.pcast(jnp.zeros((nloc, 3), dtype), (axis,),
                              to="varying"),
                jax.lax.pcast(jnp.ones(nloc, bool), (axis,), to="varying"),
                jnp.int32(0),
            )
            _, d2, y, ok, ovf = jax.lax.fori_loop(0, ndev, hop, init)
            return y, d2, ok, ovf

        def body(state):
            r, t, prev_d, it, _, ovf = state
            p = se3.apply_rigid(r, t, src_loc)
            y, d2, ok, o = global_nn(p)
            w = (sv_loc & ok & jnp.isfinite(d2)).astype(dtype)
            sw = jnp.sum(w)
            sp = jnp.sum(p * w[:, None], 0)
            sy = jnp.sum(y * w[:, None], 0)
            spy = jnp.matmul((p * w[:, None]).T, y,
                             precision=jax.lax.Precision.HIGHEST)
            sd = jnp.sum(jnp.where(w > 0, d2, 0.0))
            tot = jax.lax.psum(
                jnp.concatenate(
                    [sw[None], sp, sy, spy.reshape(-1), sd[None]]
                ),
                axis,
            )
            d = tot[16]
            r1, t1 = se3.horn_from_moments(
                tot[0], tot[1:4], tot[4:7], tot[7:16].reshape(3, 3)
            )
            r_new, t_new = se3.compose(r1, t1, r, t)
            return (r_new, t_new, d, it + 1,
                    jnp.abs(d - prev_d) < cfg.tol,
                    ovf + jax.lax.psum(o, axis))

        def cond(state):
            return (~state[4]) & (state[3] < cfg.max_iterations)

        r0 = jnp.eye(3, dtype=dtype)
        if cfg.start_by_matching_centroids:
            sw = jax.lax.psum(jnp.sum(sv_loc.astype(dtype)), axis)
            sp = jax.lax.psum(
                jnp.sum(src_loc * sv_loc.astype(dtype)[:, None], 0), axis
            )
            tw = jax.lax.psum(jnp.sum(tv_loc.astype(dtype)), axis)
            tp = jax.lax.psum(
                jnp.sum(tgt_loc * tv_loc.astype(dtype)[:, None], 0), axis
            )
            t0 = tp / jnp.maximum(tw, 1.0) - sp / jnp.maximum(sw, 1.0)
        else:
            t0 = jnp.zeros(3, dtype)
        r, t, d, it, conv, ovf = jax.lax.while_loop(
            cond, body,
            (r0, t0, jnp.inf, jnp.int32(0), jnp.array(False), jnp.int32(0)),
        )
        return r[None], t[None], d[None], it[None], ovf[None]

    r, t, d, it, ovf = jax.jit(
        shard_map(
            fn,
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis)),
            out_specs=(P(), P(), P(), P(), P()),
            check_vma=False,
        )
    )(source, source_valid, target, target_valid)
    return r[0], t[0], d[0], it[0], ovf[0]


def sharded_icp(
    mesh: Mesh,
    source,
    source_valid,
    target,
    target_valid,
    cfg: ICPConfig = ICPConfig(),
    axis: str = "blocks",
):
    """Distributed ICP: source sharded over the mesh, target replicated.

    Per iteration: local NN correspondence + psum-reduced weighted sums for
    the Horn solve. Returns (R, t, error, iterations).
    """
    n = source.shape[0]
    ndev = mesh.shape[axis]
    assert n % ndev == 0

    def fn(src_loc, sv_loc, tgt, tv):
        w_loc = sv_loc.astype(src_loc.dtype)
        bad = jnp.where(tv, 0.0, jnp.inf)

        def psums(p):
            idx = jnp.argmin(pairwise_sqdist(p, tgt) + bad[None, :], axis=1)
            y = tgt[idx]
            d2 = jnp.sum((p - y) ** 2, axis=1)
            # partial sums for the weighted Horn solve
            sw = jnp.sum(w_loc)
            sp = jnp.sum(p * w_loc[:, None], 0)
            sy = jnp.sum(y * w_loc[:, None], 0)
            # HIGHEST: a reduced-precision matmul (TF32 on a GPU) corrupts
            # the Horn moments (se3.py note)
            spy = jnp.matmul((p * w_loc[:, None]).T, y,
                             precision=jax.lax.Precision.HIGHEST)
            sd = jnp.sum(jnp.where(sv_loc, d2, 0.0))
            tot = jax.lax.psum(
                jnp.concatenate(
                    [sw[None], sp, sy, spy.reshape(-1), sd[None]]
                ),
                axis,
            )
            return tot

        def horn_from_sums(tot):
            # single shared moment-form solve (ops.se3) so the sharded and
            # single-device paths cannot drift
            return se3.horn_from_moments(
                tot[0], tot[1:4], tot[4:7], tot[7:16].reshape(3, 3)
            )

        def body(state):
            r, t, prev_d, it, _ = state
            p = se3.apply_rigid(r, t, src_loc)
            tot = psums(p)
            d = tot[16]
            r1, t1 = horn_from_sums(tot)
            r_new, t_new = se3.compose(r1, t1, r, t)
            return r_new, t_new, d, it + 1, jnp.abs(d - prev_d) < cfg.tol

        def cond(state):
            return (~state[4]) & (state[3] < cfg.max_iterations)

        r0 = jnp.eye(3, dtype=src_loc.dtype)
        if cfg.start_by_matching_centroids:
            sw = jax.lax.psum(jnp.sum(w_loc), axis)
            sp = jax.lax.psum(jnp.sum(src_loc * w_loc[:, None], 0), axis)
            wt = tv.astype(src_loc.dtype)
            t0 = jnp.sum(tgt * wt[:, None], 0) / jnp.maximum(
                jnp.sum(wt), 1.0
            ) - sp / jnp.maximum(sw, 1.0)
        else:
            t0 = jnp.zeros(3, src_loc.dtype)
        r, t, d, it, conv = jax.lax.while_loop(
            cond, body, (r0, t0, jnp.inf, jnp.int32(0), jnp.array(False))
        )
        return r[None], t[None], d[None], it[None]

    r, t, d, it = jax.jit(
        shard_map(
            fn,
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(), P()),
            out_specs=(P(), P(), P(), P()),
            check_vma=False,
        )
    )(source, source_valid, target, target_valid)
    return r[0], t[0], d[0], it[0]
