"""Sort-merge bulk lookup (graph/lookup._find_merge) vs binary search."""

import jax.numpy as jnp
import numpy as np
import pytest

from metafast_jax.core import bitpack as bp
from metafast_jax.graph import lookup


def _mk_table(rng, t):
    keys = np.sort(rng.choice(1 << 40, t, replace=False).astype(np.uint64))
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    # sentinel-padded tail
    pad = 16
    hi = np.concatenate([hi, np.full(pad, bp.SENTINEL, np.uint32)])
    lo = np.concatenate([lo, np.full(pad, bp.SENTINEL, np.uint32)])
    return hi, lo, keys


@pytest.mark.parametrize("q_shape", [(4000,), (8, 700)])
def test_merge_find_matches_binary(q_shape):
    rng = np.random.default_rng(0)
    thi, tlo, keys = _mk_table(rng, 2000)
    q = int(np.prod(q_shape))
    # mix of hits, misses, duplicates, and sentinel queries
    hit = keys[rng.integers(0, len(keys), q)]
    miss = rng.choice(1 << 40, q, replace=False).astype(np.uint64)
    pick = rng.random(q)
    qk = np.where(pick < 0.5, hit, miss)
    qhi = (qk >> np.uint64(32)).astype(np.uint32)
    qlo = (qk & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    sent = pick > 0.9
    qhi[sent] = np.uint32(bp.SENTINEL)
    qlo[sent] = np.uint32(bp.SENTINEL)
    qhi = qhi.reshape(q_shape)
    qlo = qlo.reshape(q_shape)

    bi, bf = lookup.find(jnp.asarray(thi), jnp.asarray(tlo),
                         jnp.asarray(qhi), jnp.asarray(qlo))
    mi, mf = lookup._find_merge(jnp.asarray(thi), jnp.asarray(tlo),
                                jnp.asarray(qhi), jnp.asarray(qlo))
    np.testing.assert_array_equal(np.asarray(bf), np.asarray(mf))
    # indices must agree wherever found
    f = np.asarray(bf)
    np.testing.assert_array_equal(np.asarray(bi)[f], np.asarray(mi)[f])


def test_merge_find_all_miss_and_all_hit():
    rng = np.random.default_rng(1)
    thi, tlo, keys = _mk_table(rng, 512)
    qk = keys.copy()
    qhi = (qk >> np.uint64(32)).astype(np.uint32)
    qlo = (qk & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    mi, mf = lookup._find_merge(jnp.asarray(thi), jnp.asarray(tlo),
                                jnp.asarray(qhi), jnp.asarray(qlo))
    assert bool(np.all(np.asarray(mf)))
    np.testing.assert_array_equal(np.asarray(mi), np.arange(len(keys)))

    miss = (qk + np.uint64(1))  # off-by-one keys: all absent w.h.p.
    in_table = np.isin(miss, keys)
    qhi = (miss >> np.uint64(32)).astype(np.uint32)
    qlo = (miss & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    _, mf = lookup._find_merge(jnp.asarray(thi), jnp.asarray(tlo),
                               jnp.asarray(qhi), jnp.asarray(qlo))
    np.testing.assert_array_equal(np.asarray(mf), in_table)


def test_merge_find_long_decomposed_cumsum():
    """_find_merge at a length that triggers the _cumsum_flat row
    decomposition (T + Q > 8 * 1024) matches the numpy oracle."""
    rng = np.random.default_rng(2)
    thi, tlo, keys = _mk_table(rng, 12000)
    q = 40000
    hit = keys[rng.integers(0, len(keys), q)]
    miss = rng.choice(1 << 40, q, replace=False).astype(np.uint64)
    qk = np.where(rng.random(q) < 0.5, hit, miss)
    qhi = (qk >> np.uint64(32)).astype(np.uint32)
    qlo = (qk & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    mi, mf = lookup._find_merge(jnp.asarray(thi), jnp.asarray(tlo),
                                jnp.asarray(qhi), jnp.asarray(qlo))
    exp_found = np.isin(qk, keys)
    np.testing.assert_array_equal(np.asarray(mf), exp_found)
    pos = np.searchsorted(keys, qk[exp_found])
    np.testing.assert_array_equal(np.asarray(mi)[exp_found], pos)


def test_find_bounded_matches_find(monkeypatch):
    """Gather-free bounded verify == generic find when duplicates fit
    the bound; overflow certifies the bound."""
    monkeypatch.setattr(lookup, "MERGE_MIN", 1)
    rng = np.random.default_rng(9)
    thi, tlo, keys = _mk_table(rng, 3000)
    q = 20000
    hit = keys[rng.integers(0, len(keys), q)]
    miss = rng.choice(1 << 40, q, replace=False).astype(np.uint64)
    pick = rng.random(q)
    qk = np.where(pick < 0.5, hit, miss)
    qhi = (qk >> np.uint64(32)).astype(np.uint32)
    qlo = (qk & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    sent = pick > 0.9
    qhi[sent] = np.uint32(bp.SENTINEL)
    qlo[sent] = np.uint32(bp.SENTINEL)
    # cap duplicates under the bound: hits drawn uniformly from 3000
    # keys, 10k draws -> max multiplicity ~ 12; use max_dup = 24
    gi, gf = lookup.find(jnp.asarray(thi), jnp.asarray(tlo),
                         jnp.asarray(qhi), jnp.asarray(qlo))
    bi, bf, ov = lookup.find_bounded(jnp.asarray(thi), jnp.asarray(tlo),
                                     jnp.asarray(qhi), jnp.asarray(qlo),
                                     max_dup=24)
    assert int(ov) == 0
    np.testing.assert_array_equal(np.asarray(gf), np.asarray(bf))
    f = np.asarray(gf)
    np.testing.assert_array_equal(np.asarray(gi)[f], np.asarray(bi)[f])


def test_find_bounded_overflow_fires(monkeypatch):
    """A query key repeated past the bound must raise the overflow flag
    (the caller's signal to fall back to the gather verify)."""
    monkeypatch.setattr(lookup, "MERGE_MIN", 1)
    rng = np.random.default_rng(10)
    thi, tlo, keys = _mk_table(rng, 64)
    qk = np.full(500, keys[7], dtype=np.uint64)     # one key x500
    qhi = (qk >> np.uint64(32)).astype(np.uint32)
    qlo = (qk & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    bi, bf, ov = lookup.find_bounded(jnp.asarray(thi), jnp.asarray(tlo),
                                     jnp.asarray(qhi), jnp.asarray(qlo),
                                     max_dup=8)
    assert int(ov) > 0
    # sentinel-only runs must NOT fire the flag
    qhi2 = np.full(500, bp.SENTINEL, np.uint32)
    _, _, ov2 = lookup.find_bounded(jnp.asarray(thi), jnp.asarray(tlo),
                                    jnp.asarray(qhi2), jnp.asarray(qhi2),
                                    max_dup=8)
    assert int(ov2) == 0


def test_neighbor_tables_merge_vs_binary_dispatch(monkeypatch):
    """neighbor_tables above MERGE_MIN must equal the binary-search path.

    The real dispatch flips at 2^20 queries (table >= 2^18 keys); to keep
    CI light the threshold is patched instead of the table inflated.
    The two calls use DIFFERENT sentinel paddings: lookup.find is jitted,
    so identical shapes would replay the first trace's path and never
    exercise the merge join.
    """
    import jax.numpy as jnp
    from metafast_jax.graph import dbg

    rng = np.random.default_rng(5)
    k = 15
    n_keys = 5000
    keys = np.sort(rng.choice(1 << (2 * k), n_keys, replace=False)
                   .astype(np.uint64))

    def table(pad):
        hi = np.concatenate([(keys >> np.uint64(32)).astype(np.uint32),
                             np.full(pad, bp.SENTINEL, np.uint32)])
        lo = np.concatenate([(keys & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                             np.full(pad, bp.SENTINEL, np.uint32)])
        return jnp.asarray(hi), jnp.asarray(lo)

    monkeypatch.setattr(lookup, "MERGE_MIN", 1 << 62)
    t_bin = dbg.neighbor_tables(*table(16), k)
    monkeypatch.setattr(lookup, "MERGE_MIN", 1)
    t_mrg = dbg.neighbor_tables(*table(32), k)

    for side in ("left", "right"):
        for field in ("present", "ext", "is_fw"):
            a = np.asarray(t_bin[side][field])[..., :n_keys]
            b = np.asarray(t_mrg[side][field])[..., :n_keys]
            np.testing.assert_array_equal(a, b, err_msg=f"{side}.{field}")
        pb = np.asarray(t_bin[side]["present"])[..., :n_keys]
        np.testing.assert_array_equal(
            np.asarray(t_bin[side]["idx"])[..., :n_keys][pb],
            np.asarray(t_mrg[side]["idx"])[..., :n_keys][pb],
            err_msg=f"{side}.idx")
