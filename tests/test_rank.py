"""Splitter-walk list ranking (graph/rank.py).

The contig stage takes (term, dist, reached) from chain_rank on large
tables on a GPU.  These tests pin it against an exact recursive oracle on random chain forests
(with cycles), against the pointer-doubling path on real de Bruijn
successor graphs, and pin the _compact_walks payload pairing that once
broke silently (the done-mask was sliced from the unsorted sort key,
killing ~87% of live walks after the first compaction).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from metafast_jax.graph import rank


def _walk_oracle(succ):
    """Exact (terminal, dist, reached) per node, iteratively memoized."""
    n = len(succ)
    term = np.full(n, -1)
    dist = np.zeros(n, np.int64)
    reached = np.zeros(n, bool)
    memo = {}
    for v0 in range(n):
        if v0 in memo:
            continue
        chain = []
        v = v0
        seen = set()
        while True:
            if v in memo:
                base = memo[v]
                break
            if v in seen:
                base = None
                break
            seen.add(v)
            chain.append(v)
            if succ[v] < 0:
                base = (v, -1)   # v itself terminal; handled below
                break
            v = succ[v]
        for i in range(len(chain) - 1, -1, -1):
            c = chain[i]
            if base is None:
                memo[c] = None
            elif base[1] == -1 and c == base[0]:
                memo[c] = (c, 0)
                base = memo[c]
            else:
                memo[c] = (base[0], base[1] + 1)
                base = memo[c]
    for v in range(n):
        r = memo[v]
        if r is not None:
            term[v], dist[v], reached[v] = r[0], r[1], True
    return term, dist, reached


def _random_forest(rng, n, cycle_p=0.25):
    perm = rng.permutation(n)
    succ = np.full(n, -1, dtype=np.int32)
    i = 0
    while i < n:
        L = int(rng.integers(1, 200))
        seg = perm[i:i + L]
        succ[seg[:-1]] = seg[1:]
        if rng.random() < cycle_p and len(seg) > 2:
            succ[seg[-1]] = seg[0]
        i += L
    return succ


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chain_rank_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    for _ in range(4):
        n = int(rng.integers(60, 4000))
        succ = _random_forest(rng, n)
        valid = np.ones(n, bool)
        o_term, o_dist, o_reached = _walk_oracle(succ)
        r = rank.chain_rank(jnp.asarray(succ), jnp.asarray(valid))
        term = np.asarray(r["term"])
        dist = np.asarray(r["dist"])
        reached = np.asarray(r["reached"])
        assert np.array_equal(reached, o_reached)
        assert np.array_equal(term[o_reached], o_term[o_reached])
        assert np.array_equal(dist[o_reached], o_dist[o_reached])
        assert (np.asarray(r["walkid"]) >= 0).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_chain_rank_walks_outgrowing_the_step_field(seed):
    """Walks longer than the packed off field can count stop there and
    the rest of their segment is ranked by the second pass — the case a
    ~2^26-node table hits with the full 31-bit record."""
    rng = np.random.default_rng(seed)
    n = 20000
    perm = rng.permutation(n)
    succ = np.full(n, -1, dtype=np.int32)
    bounds = np.r_[0, np.sort(rng.choice(np.arange(1, n), 5, replace=False)),
                   n]
    for j, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        seg = perm[a:b]
        succ[seg[:-1]] = seg[1:]
        if j == 0 and len(seg) > 2:
            succ[seg[-1]] = seg[0]                        # one cycle
    o_term, o_dist, o_reached = _walk_oracle(succ)
    r = rank.chain_rank(jnp.asarray(succ), jnp.asarray(np.ones(n, bool)),
                        max_off_bits=7)                  # walks of <= 126
    term, dist = np.asarray(r["term"]), np.asarray(r["dist"])
    assert np.array_equal(np.asarray(r["reached"]), o_reached)
    assert np.array_equal(term[o_reached], o_term[o_reached])
    assert np.array_equal(dist[o_reached], o_dist[o_reached])
    assert (np.asarray(r["walkid"]) >= 0).all()


def test_chain_rank_matches_doubling_on_dbg():
    """On a real de Bruijn successor graph, chain_rank must agree with
    the pointer-doubling path on every valid row."""
    from metafast_jax.core import bitpack as bp
    from metafast_jax.graph import contigs as ct, dbg
    from metafast_jax.oracle import reference as oracle

    rng = np.random.default_rng(3)
    bases = "ACGT"
    genome = "".join(bases[i] for i in rng.integers(0, 4, 3000))
    reads = [genome[s:s + 70] for s in rng.integers(0, 2930, 500)]
    k = 13
    table = oracle.count_reads(reads, k)
    keys = np.array(sorted(table), dtype=np.uint64)
    M0 = len(keys)
    M = 1 << int(np.ceil(np.log2(M0)))
    khi = np.full(M, bp.SENTINEL, dtype=np.uint32)
    klo = np.full(M, bp.SENTINEL, dtype=np.uint32)
    khi[:M0] = (keys >> np.uint64(32)).astype(np.uint32)
    klo[:M0] = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    t = dbg.neighbor_tables(jnp.asarray(khi), jnp.asarray(klo), k)
    L, R = t["left"], t["right"]
    st = ct._succ_from_tables(jnp.asarray(khi), jnp.asarray(klo),
                              L["idx"], L["is_fw"], L["ext"],
                              R["idx"], R["is_fw"], R["ext"], k)
    v = np.asarray(st["valid2"])
    term_d, dist_d, reach_d = [np.asarray(x)
                               for x in ct._doubling(st["succ"])]
    r = rank.chain_rank(st["succ"], st["valid2"])
    reached = np.asarray(r["reached"])
    m = v & reach_d
    assert np.array_equal(reached[v], reach_d[v])
    assert np.array_equal(np.asarray(r["term"])[m], term_d[m])
    assert np.array_equal(np.asarray(r["dist"])[m], dist_d[m])


@pytest.mark.parametrize("w_in,w_out", [(4096, 512), (1536, 96)])
def test_compact_walks_preserves_live_tuples(w_in, w_out):
    """Regression for the walk-death bug: the compacted done mask
    must come from the SORTED key, or live walks are randomly marked
    done and their chain ranges go unvisited."""
    rng = np.random.default_rng(0)
    cur = rng.integers(0, 1 << 20, w_in).astype(np.int32)
    wid = rng.integers(0, 1 << 15, w_in).astype(np.int32)
    t = rng.integers(0, 1000, w_in).astype(np.int32)
    done = rng.random(w_in) < 0.95
    alive_idx = np.nonzero(~done)[0]
    if len(alive_idx) > w_out:
        done[alive_idx[w_out:]] = True
    c2, wd2, t2, d2 = [np.asarray(x) for x in rank._compact_walks(
        jnp.asarray(cur), jnp.asarray(wid), jnp.asarray(t),
        jnp.asarray(done), w_in, w_out)]
    live_in = sorted(zip(cur[~done].tolist(), wid[~done].tolist(),
                         t[~done].tolist()))
    live_out = sorted(zip(c2[~d2].tolist(), wd2[~d2].tolist(),
                          t2[~d2].tolist()))
    assert live_in == live_out
