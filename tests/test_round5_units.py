"""Round-5 primitives: O(boundary) fusion renumber equivalence, auto
noise-engine fallback for grid-less metrics."""
import numpy as np
import jax.numpy as jnp
import pytest


@pytest.mark.parametrize("quirks", [False, True])
@pytest.mark.parametrize("mcs", [0, 1, 3])
def test_local_renumber_matches_global(quirks, mcs):
    """The sharded path's device-local keep + scalar prefix offsets must
    reproduce block_keep_renumber on the gathered counts exactly (the
    bit-equality claim of parallel.sharded's O(boundary) fusion)."""
    from vtkcloudpoint_tpu.cluster.fusion import (
        block_keep_renumber, block_keep_rules,
    )

    rng = np.random.default_rng(0)
    B, kmax, ndev = 24, 9, 4
    counts = rng.integers(0, 7, size=(B, kmax)).astype(np.int32)
    keep_g, gid_g, n_kept_g = block_keep_renumber(
        jnp.asarray(counts), mcs, quirks)

    bloc = B // ndev
    kept_all = []
    locs = []
    for d in range(ndev):
        rows = jnp.asarray(counts[d * bloc:(d + 1) * bloc])
        keep_l = block_keep_rules(rows, mcs, quirks)
        gid_cum = jnp.cumsum(
            keep_l.reshape(-1).astype(jnp.int32)).reshape(bloc, kmax - 1)
        kept_all.append(int(gid_cum.reshape(-1)[-1]))
        locs.append((np.asarray(keep_l), np.asarray(gid_cum)))
    offsets = np.concatenate([[0], np.cumsum(kept_all)[:-1]])
    assert sum(kept_all) == int(n_kept_g)
    for d in range(ndev):
        keep_l, gid_cum = locs[d]
        rows = slice(d * bloc, (d + 1) * bloc)
        assert (keep_l == np.asarray(keep_g)[rows]).all()
        # gids only meaningful at kept slots
        want = np.asarray(gid_g)[rows]
        got = gid_cum + offsets[d]
        assert (got[keep_l] == want[keep_l]).all()


def test_merge_blocks_auto_engine_gridless_metric():
    """noise_engine='auto' must never raise for metrics with no grid form
    (signed_sum_xy is a supported legacy-parity config), even past the
    8192 dense-capacity threshold on CPU hosts (ADVICE r4 low #2)."""
    from vtkcloudpoint_tpu.cluster.blocks import (
        assign_blocks_balanced, gather_blocks,
    )
    from vtkcloudpoint_tpu.cluster.dbscan import dbscan_blocks
    from vtkcloudpoint_tpu.cluster.fusion import merge_blocks

    rng = np.random.default_rng(2)
    n, cap = 512, 64
    motor = jnp.asarray(rng.uniform(0, 1, (n, 2)).astype(np.float32))
    valid = jnp.ones(n, bool)
    part = assign_blocks_balanced(motor, valid, cap)
    bc, bv, pidx, _ = gather_blocks(motor, part["block"], valid,
                                    n // cap, cap)
    db = dbscan_blocks(bc, bv, 0.05, 4, "signed_sum_xy")
    out = merge_blocks(db["label"], bv, bc, pidx, n, 0.05, 4,
                       "signed_sum_xy", quirks=False,
                       noise_capacity=16384, noise_engine="auto")
    assert out["label"].shape == (n,)
