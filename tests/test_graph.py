"""Contig extraction and component splitting vs the python oracle."""

import numpy as np
import pytest

from metafast_jax.graph.contigs import build_contigs
from metafast_jax.graph.components import split_components
from metafast_jax.oracle import reference as oracle


def make_counts(reads, k, b=0):
    counts = oracle.count_reads(reads, k)
    return oracle.filter_counts(counts, b)


def as_table(counts):
    keys = np.array(sorted(counts), dtype=np.int64)
    vals = np.array([counts[int(key)] for key in keys], dtype=np.int32)
    return keys, vals


def norm_contigs(contigs, k):
    """Canonicalize contig set: min(seq, rc(seq)) string + weights."""
    out = []
    for seq, avg, mn, mx in contigs:
        comp = {"A": "T", "T": "A", "G": "C", "C": "G"}
        rcs = "".join(comp[c] for c in reversed(seq))
        out.append((min(seq, rcs), avg, mn, mx))
    return sorted(out)


@pytest.mark.parametrize("k,nreads,readlen,seed", [
    (5, 30, 25, 0),
    (5, 10, 60, 1),
    (7, 40, 30, 2),
    (4, 25, 20, 3),   # even k: palindromes possible
    (31, 12, 70, 4),
    (16, 12, 50, 5),  # even k straddling the 32-bit word boundary
])
def test_contigs_match_oracle(k, nreads, readlen, seed):
    rng = np.random.default_rng(seed)
    reads = ["".join(rng.choice(list("AGCT"), size=readlen)) for _ in range(nreads)]
    # duplicate some reads so counts vary
    reads += reads[: nreads // 3]
    counts = make_counts(reads, k)
    want = norm_contigs(oracle.build_contigs(counts, k, k), k)

    keys, vals = as_table(counts)
    got = norm_contigs(build_contigs(keys, vals, k, k), k)
    assert got == want


def test_contigs_len_threshold():
    rng = np.random.default_rng(10)
    reads = ["".join(rng.choice(list("AGCT"), size=40)) for _ in range(20)]
    counts = make_counts(reads, 5)
    keys, vals = as_table(counts)
    for l in (5, 10, 20):
        want = norm_contigs(oracle.build_contigs(counts, 5, l), 5)
        got = norm_contigs(build_contigs(keys, vals, 5, l), 5)
        assert got == want


def norm_comps(comps):
    """Order-insensitive component multiset: (sorted kmers tuple, weight, thr)."""
    return sorted((tuple(sorted(int(x) for x in km)), w, t) for km, w, t in comps)


@pytest.mark.parametrize("k,b1,b2,seed", [
    (5, 1, 10000, 0),      # no split
    (5, 3, 20, 1),         # drop small, split big
    (7, 2, 15, 2),
    (31, 1, 30, 3),
    (4, 1, 12, 4),         # even k
])
def test_components_match_oracle(k, b1, b2, seed):
    rng = np.random.default_rng(seed)
    reads = ["".join(rng.choice(list("AGCT"), size=35)) for _ in range(25)]
    reads += reads[:10] + reads[:5]   # multiplicity for thresholds
    counts = oracle.count_reads(reads, k)
    want_raw = oracle.split_components(counts, k, b1, b2)
    want = norm_comps([(kset, w, t) for kset, w, t in want_raw])

    keys, vals = as_table(counts)
    got_raw = split_components(keys, vals, k, b1, b2)
    got = norm_comps([(c.kmers, c.weight, c.used_freq_threshold) for c in got_raw])
    assert got == want


def _padded(keys):
    """(khi, klo, M) of sorted uint64 keys padded with SENTINEL rows."""
    import metafast_jax.core.bitpack as bp

    M0 = len(keys)
    M = 1 << int(np.ceil(np.log2(max(M0, 16))))
    khi = np.full(M, bp.SENTINEL, dtype=np.uint32)
    klo = np.full(M, bp.SENTINEL, dtype=np.uint32)
    khi[:M0] = (keys >> np.uint64(32)).astype(np.uint32)
    klo[:M0] = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return khi, klo, M


def test_component_labels_match_oracle_with_cycles():
    """Level-1 labels partition the table as the oracle's BFS does,
    including circular genomes (pure cycle chains, no heads)."""
    from metafast_jax.graph.components import table_labels

    rng = np.random.default_rng(11)
    k = 13
    table = {}
    for g in range(4):
        glen = int(rng.integers(300, 1200))
        genome = "".join("ACGT"[i] for i in rng.integers(0, 4, glen))
        if g < 3:                                   # circular
            reads = [(genome + genome[:60])[s:s + 60]
                     for s in range(0, glen, 7)]
        else:
            reads = [genome[s:s + 60] for s in rng.integers(0, glen - 60, 300)]
        for key, c in oracle.count_reads(reads, k).items():
            table[key] = table.get(key, 0) + c
    keys = np.array(sorted(table), dtype=np.uint64)
    khi, klo, _ = _padded(keys)
    labels = table_labels(khi, klo, k)[:len(keys)]
    got = {}
    for key, lab in zip(keys.tolist(), labels.tolist()):
        got.setdefault(lab, set()).add(key)
    want = oracle._connected_components(set(table), k)
    assert sorted(map(sorted, got.values())) == sorted(map(sorted, want))


@pytest.mark.parametrize("seed", [0, 3, 31])
def test_connected_labels_match_scipy(seed):
    """The label fixed point on random symmetric graphs with inactive
    vertices: each active vertex gets its component's minimum index,
    inactive ones M."""
    import jax.numpy as jnp
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    from metafast_jax.graph.components import connected_labels

    rng = np.random.default_rng(seed)
    M = int(rng.integers(64, 2000))
    nbr = np.full((8, M), -1, dtype=np.int32)
    for _ in range(int(rng.integers(0, 3 * M))):
        u, v = rng.integers(0, M, 2)
        su, sv = rng.integers(0, 8, 2)
        if u != v and nbr[su, u] < 0 and nbr[sv, v] < 0:
            nbr[su, u], nbr[sv, v] = v, u
    active = rng.random(M) < 0.6
    labels = connected_labels(jnp.asarray(nbr), jnp.asarray(active))

    src = np.broadcast_to(np.arange(M), nbr.shape)
    e = (nbr >= 0) & active[src] & active[np.maximum(nbr, 0)]
    graph = coo_matrix((np.ones(e.sum()), (src[e], nbr[e])), shape=(M, M))
    _, comp = connected_components(graph, directed=False)
    want = np.full(M, M)
    idx = np.flatnonzero(active)
    first = {}
    for i in idx:
        first.setdefault(comp[i], i)
    want[idx] = [first[comp[i]] for i in idx]
    assert np.array_equal(labels, want)
