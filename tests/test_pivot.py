"""Pivot component extraction + filter tools."""

import numpy as np
import pytest

from metafast_jax.cli import main
from metafast_jax.graph.pivot import (canonical_np, left_neighbors_np, rc_np,
                                      right_neighbors_np, split_around_pivot)
from metafast_jax.io import binfmt
from metafast_jax.oracle import reference as oracle
from metafast_jax.utils.kmers import sequence_kmers


def test_rc_matches_oracle():
    rng = np.random.default_rng(1)
    for k in (3, 17, 31):
        keys = rng.integers(0, 1 << (2 * k), 50, dtype=np.int64)
        got = rc_np(keys, k)
        want = [oracle.rc64(int(x), k) for x in keys]
        assert got.tolist() == want


def test_neighbors_match_oracle():
    rng = np.random.default_rng(2)
    k = 7
    keys = canonical_np(rng.integers(0, 1 << (2 * k), 30, dtype=np.int64), k)
    rn = right_neighbors_np(keys, k)
    ln = left_neighbors_np(keys, k)
    for i, key in enumerate(keys):
        n8 = oracle.neighbors8(int(key), k)
        # oracle.neighbors8 interleaves [right nuc0, left nuc0, right nuc1, ...]
        assert sorted(rn[i].tolist() + ln[i].tolist()) == sorted(n8)


def _line_graph(seq, k):
    kk = sequence_kmers(seq, k)
    keys, counts = np.unique(kk, return_counts=True)
    return keys.astype(np.int64), counts.astype(np.int64)


def test_pivot_simple_path():
    # a single unambiguous path (k=9: no repeated (k-1)-mers, so no forks):
    # one pivot k-mer pulls in the whole path
    seq = "ACGGTCAGATTCAGGACTT"
    k = 9
    keys, counts = _line_graph(seq, k)
    pivot = keys[3:4]
    comps = split_around_pivot(keys, counts, k, pivot)
    assert len(comps) == 1
    assert comps[0].n_pivot == 1
    assert set(comps[0].kmers.tolist()) == set(keys.tolist())
    assert comps[0].weight == int(counts.sum())


def test_pivot_fork_requires_second_pivot():
    # two sequences sharing a prefix: a fork; branch without pivot is not
    # entered, branch leading to another pivot is absorbed
    k = 9
    s_common = "ACGGTCAGATC"
    s1 = s_common + "TACGG"       # branch 1
    s2 = s_common + "GTTAC"       # branch 2
    k1 = set(np.unique(sequence_kmers(s1, k)).tolist())
    k2 = set(np.unique(sequence_kmers(s2, k)).tolist())
    keys = np.array(sorted(k1 | k2), dtype=np.int64)
    counts = np.ones(len(keys), dtype=np.int64)

    common = sorted(k1 & k2)
    only1 = sorted(k1 - k2)
    only2 = sorted(k2 - k1)
    # pivots: one in the shared prefix and one deep in branch 1
    pivot = np.array([common[0], only1[-1]], dtype=np.int64)
    comps = split_around_pivot(keys, counts, k, pivot)
    got = set()
    for c in comps:
        got |= set(c.kmers.tolist())
    # branch-1 k-mers reachable (has a pivot); branch 2 should not be
    # fully absorbed (no pivot beyond its fork)
    assert set(only1) <= got
    assert not (set(only2) <= got)


def test_component_extractor_tool(tmp_path):
    k = 9
    seq = "ACGGTCAGATTCAGGACTT"
    keys, counts = _line_graph(seq, k)
    kf = tmp_path / "graph.kmers.bin"
    binfmt.write_kmers_bin(str(kf), keys, counts.astype(np.int32))
    pf = tmp_path / "pivot.kmers.bin"
    binfmt.write_kmers_bin(str(pf), keys[2:3], np.array([1], dtype=np.int32))
    wd = tmp_path / "wd"
    assert main(["-t", "component-extractor", "-k", str(k),
                 "-i", str(kf), "--pivot", str(pf), "-w", str(wd)]) == 0
    comps = binfmt.read_components_bin(str(wd / "components.bin"))
    assert len(comps) == 1
    assert (wd / "components-stat.txt").exists()


def test_unique_kmers_tool(tmp_path):
    a = tmp_path / "a.kmers.bin"
    f = tmp_path / "f.kmers.bin"
    binfmt.write_kmers_bin(str(a), np.array([10, 20, 30], dtype=np.int64),
                           np.array([5, 5, 5], dtype=np.int32))
    binfmt.write_kmers_bin(str(f), np.array([20], dtype=np.int64),
                           np.array([9], dtype=np.int32))
    wd = tmp_path / "wd"
    assert main(["-t", "unique-kmers", "-k", "5", "-i", str(a),
                 "--filter-kmers", str(f), "-w", str(wd)]) == 0
    keys, counts = binfmt.read_kmers_bin(str(wd / "kmers" / "filtered.kmers.bin"))
    assert keys.tolist() == [10, 30]


def test_unique_kmers_multi_tool(tmp_path):
    files = []
    for i, content in enumerate([{10: 5, 20: 5}, {10: 4, 30: 7}, {10: 3}]):
        fp = tmp_path / f"s{i}.kmers.bin"
        ks = np.array(sorted(content), dtype=np.int64)
        cs = np.array([content[x] for x in ks], dtype=np.int32)
        binfmt.write_kmers_bin(str(fp), ks, cs)
        files.append(str(fp))
    filt = tmp_path / "filt.kmers.bin"
    binfmt.write_kmers_bin(str(filt), np.array([30], dtype=np.int64),
                           np.array([9], dtype=np.int32))
    wd = tmp_path / "wd"
    assert main(["-t", "unique-kmers-multi", "-k", "5",
                 "-i"] + files + ["--filter-kmers", str(filt),
                 "--min-samples", "1", "--max-samples", "3",
                 "-w", str(wd)]) == 0
    k1, v1 = binfmt.read_kmers_bin(str(wd / "kmers" / "filtered_1.kmers.bin"))
    # 30 filtered out; 10 (3 samples, sum 12) and 20 (1 sample, sum 5) stay
    assert k1.tolist() == [10, 20]
    assert v1.tolist() == [12, 5]
    k3, v3 = binfmt.read_kmers_bin(str(wd / "kmers" / "filtered_3.kmers.bin"))
    assert k3.tolist() == [10]


def test_kmers_filter_tool(tmp_path):
    a = tmp_path / "a.kmers.bin"
    f = tmp_path / "f.kmers.bin"
    binfmt.write_kmers_bin(str(a), np.array([10, 20], dtype=np.int64),
                           np.array([5, 5], dtype=np.int32))
    binfmt.write_kmers_bin(str(f), np.array([20], dtype=np.int64),
                           np.array([9], dtype=np.int32))
    wd = tmp_path / "wd"
    assert main(["-t", "kmers-filter", "-k", "5", "-i", str(a),
                 "--filter-kmers", str(f), "-w", str(wd)]) == 0
    keys, _ = binfmt.read_kmers_bin(str(wd / "kmers" / "a.kmers.bin"))
    assert keys.tolist() == [20]


def test_posneg_counter(tmp_path, ref_data):
    wd = tmp_path / "wd"
    assert main(["-t", "kmer-counter-posneg", "-k", "31",
                 "-pos", str(ref_data / "meta_test_1.fa"),
                 "-neg", str(ref_data / "meta_test_2.fa"),
                 "-w", str(wd)]) == 0
    assert (wd / "kmer-counter-posneg" / "pos" / "kmers"
            / "meta_test_1.kmers.bin").exists() or \
           (wd / "pos" / "kmers" / "meta_test_1.kmers.bin").exists()


def test_native_pivot_bfs_matches_python():
    """The native depth-1 traversal (fastparse.cpp pivot_bfs_depth1) is
    an exact mirror of the Python BFS — same components, weights, pivot
    counts, fuzzing over random multi-genome tables."""
    from metafast_jax.oracle import reference as oracle

    rng = np.random.default_rng(21)
    bases = "ACGT"
    for trial in range(6):
        table = {}
        k = 13
        for g in range(int(rng.integers(1, 4))):
            glen = int(rng.integers(300, 2000))
            genome = "".join(bases[i] for i in rng.integers(0, 4, glen))
            reads = [genome[s:s + 60]
                     for s in rng.integers(0, max(glen - 60, 1), 400)]
            for key, c in oracle.count_reads(reads, k).items():
                table[key] = table.get(key, 0) + c
        keys = np.array(sorted(table), dtype=np.int64)
        counts = np.array([table[int(x)] for x in keys], dtype=np.int64)
        n_piv = int(rng.integers(1, max(len(keys) // 8, 2)))
        pivots = np.sort(rng.choice(keys, n_piv, replace=False))
        nat = split_around_pivot(keys, counts, k, pivots)
        py = split_around_pivot(keys, counts, k, pivots,
                                force_python=True)
        assert len(nat) == len(py)
        for a, b in zip(nat, py):
            assert np.array_equal(a.kmers, b.kmers)
            assert a.weight == b.weight
            assert a.n_pivot == b.n_pivot


def test_native_colored_bfs_matches_python():
    """The native colored-component traversal (fastparse.cpp colored_bfs)
    exactly mirrors the Python _bfs, including gray multi-membership,
    separate mode, and the per-group component cap."""
    import metafast_jax.native.build as nb
    from metafast_jax.graph import colored as C
    from metafast_jax.oracle import reference as oracle

    rng = np.random.default_rng(17)
    bases = "ACGT"
    for trial in range(4):
        k = 13
        table = {}
        share = "".join(bases[i] for i in rng.integers(0, 4, 300))
        for g in range(3):
            genome = share + "".join(
                bases[i] for i in rng.integers(0, 4,
                                               int(rng.integers(400, 1200))))
            reads = [genome[s:s + 60]
                     for s in rng.integers(0, max(len(genome) - 60, 1), 350)]
            for key, c in oracle.count_reads(reads, k).items():
                v = table.get(key, 0)
                table[key] = C.add_value(np.array([v]), g, min(c, 100))[0]
        keys = np.array(sorted(table), dtype=np.int64)
        values = np.array([table[int(x)] for x in keys], dtype=np.int64)
        sep = bool(trial % 2)
        ncmp = -1 if trial % 2 else 3
        nat = C.split_colored(keys, values, k, separate=sep, n_comps=ncmp)
        saved = nb._lib
        nb._lib = None
        try:
            py = C.split_colored(keys, values, k, separate=sep,
                                 n_comps=ncmp)
        finally:
            nb._lib = saved
        assert set(nat) == set(py)
        for g in nat:
            assert len(nat[g]) == len(py[g])
            for a, b in zip(nat[g], py[g]):
                assert np.array_equal(a.kmers, b.kmers)
                assert a.weight == b.weight and a.color == b.color
