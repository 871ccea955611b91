"""Sharded multi-device k-mer counting vs the single-device counter."""

from pathlib import Path

import numpy as np
import pytest

import jax

from metafast_jax.ops.count import KmerCounter
from metafast_jax.parallel.count import make_mesh, sharded_count, gather_counts


needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="needs 8 virtual devices")


@needs_8
@pytest.mark.parametrize("seed,B,L,k", [(0, 64, 40, 21), (1, 128, 90, 31),
                                        (2, 64, 33, 1)])
def test_sharded_matches_single(seed, B, L, k):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    lengths = rng.integers(k, L + 1, B).astype(np.int32)
    mesh = make_mesh(8)
    hi, lo, cnt, nuq, drop = sharded_count(codes, lengths, k=k, mesh=mesh)
    keys, counts = gather_counts(hi, lo, cnt)

    ref = KmerCounter(k, capacity=1 << 12)
    ref.add_batch(codes, lengths)
    rk, rc = ref.finish()
    assert np.array_equal(keys, rk)
    assert np.array_equal(counts, rc)
    assert int(np.asarray(drop).sum()) == 0


@needs_8
def test_capacity_overflow_reported():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, (64, 40), dtype=np.uint8)
    lengths = np.full(64, 40, dtype=np.int32)
    mesh = make_mesh(8)
    hi, lo, cnt, nuq, drop = sharded_count(codes, lengths, k=21, mesh=mesh,
                                           cap_per_shard=2)
    assert int(np.asarray(drop).sum()) > 0


def test_dryrun_multichip():
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import __graft_entry__ as ge
    n = min(8, len(jax.devices()))
    ge.dryrun_multichip(n)


def test_entry_compiles():
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)


@needs_8
def test_sharded_components_match():
    import jax.numpy as jnp
    import metafast_jax.core.bitpack as bp
    from metafast_jax.graph.components import adjacency, connected_labels
    from metafast_jax.parallel.components import sharded_connected_labels
    from metafast_jax.utils.kmers import sequence_kmers

    seqs = ["ACGGTCAGATTCAGGACTT", "GGTTGACCAGTAGGCAT", "TTTTTCCCCGGGAAA"]
    k = 9
    keys = np.unique(np.concatenate([sequence_kmers(s, k) for s in seqs]))
    M0 = len(keys)
    M = 64
    khi = np.full(M, bp.SENTINEL, np.uint32)
    klo = np.full(M, bp.SENTINEL, np.uint32)
    u = keys.astype(np.uint64)
    khi[:M0] = (u >> np.uint64(32)).astype(np.uint32)
    klo[:M0] = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    nbr = np.asarray(adjacency(jnp.asarray(khi), jnp.asarray(klo), k))
    active = np.zeros(M, bool)
    active[:M0] = True

    single = np.asarray(connected_labels(jnp.asarray(nbr), jnp.asarray(active)))
    sharded = sharded_connected_labels(nbr, active, make_mesh(8))
    assert np.array_equal(single, sharded)


# ---------------------------------------------------------------------------
# Streaming ShardedKmerCounter
# ---------------------------------------------------------------------------

def _random_stream(rng, k, n_reads, lo=None, hi=170):
    lengths = rng.integers(lo or max(1, k - 3), hi, n_reads).astype(np.int32)
    codes = rng.integers(0, 4, int(lengths.sum()), dtype=np.uint8)
    return codes, lengths


@needs_8
@pytest.mark.parametrize("k", [21, 31])
def test_streaming_sharded_counter_matches_single(k):
    from metafast_jax.ops.stream_extract import build_stream
    from metafast_jax.parallel.count import ShardedKmerCounter

    rng = np.random.default_rng(17)
    mesh = make_mesh(8)
    # tiny chunk forces multiple consolidations (streaming accumulation,
    # exchange, and binary-counter merges all exercised)
    counter = ShardedKmerCounter(k, mesh, chunk=1 << 18)
    ref = KmerCounter(k)
    for batch in range(3):
        codes, lengths = _random_stream(rng, k, 400)
        words, vmask, _ = build_stream(codes, lengths, k,
                                       lane_multiple=8 * 8)
        counter.add_stream(words, vmask, lengths)
        ref.add_stream(codes, lengths)
    keys, counts = counter.finish()
    rk, rc = ref.finish()
    assert np.array_equal(keys, rk)
    assert np.array_equal(counts, rc)
    assert counter.total_kmers_seen == ref.total_kmers_seen


@needs_8
def test_streaming_sharded_counter_extreme_skew():
    # every k-mer hashes to ONE shard (single repeated k-mer): the exact
    # bucket sizing must absorb the worst-case skew with zero drops
    # (the old heuristic cap would have overflowed here)
    from metafast_jax.ops.stream_extract import build_stream
    from metafast_jax.parallel.count import ShardedKmerCounter

    k = 21
    mesh = make_mesh(8)
    codes = np.tile(np.zeros(k, np.uint8), 500)      # poly-A reads
    lengths = np.full(500, k, np.int32)
    counter = ShardedKmerCounter(k, mesh, chunk=1 << 12)
    words, vmask, _ = build_stream(codes, lengths, k, lane_multiple=8 * 8)
    counter.add_stream(words, vmask, lengths)
    keys, counts = counter.finish()
    ref = KmerCounter(k)
    ref.add_stream(codes, lengths)
    rk, rc = ref.finish()
    assert np.array_equal(keys, rk)
    assert np.array_equal(counts, rc)


@needs_8
def test_streaming_sharded_counter_spill_matches():
    # a tiny spill threshold forces every consolidated level to host RAM;
    # the final table must be bit-identical to the no-spill path
    from metafast_jax.ops.stream_extract import build_stream
    from metafast_jax.parallel.count import ShardedKmerCounter

    k = 21
    rng = np.random.default_rng(11)
    mesh = make_mesh(8)
    spilled = ShardedKmerCounter(k, mesh, chunk=1 << 15, spill=16)
    plain = ShardedKmerCounter(k, mesh, chunk=1 << 15)
    for _ in range(3):
        codes, lengths = _random_stream(rng, k, 300)
        words, vmask, _ = build_stream(codes, lengths, k,
                                       lane_multiple=8 * 8)
        spilled.add_stream(words, vmask, lengths)
        plain.add_stream(words, vmask, lengths)
    sk, sc = spilled.finish()
    pk, pc = plain.finish()
    assert len(spilled._levels) == 0
    assert np.array_equal(sk, pk)
    assert np.array_equal(sc, pc)


@needs_8
def test_streaming_sharded_saturation_matches():
    # one k-mer repeated far past 32767 across devices: per-device partial
    # counts saturate only after the exchange merge, exactly like the
    # reference's global table (itmo NumUtils.java:21-26)
    from metafast_jax.ops.stream_extract import build_stream
    from metafast_jax.parallel.count import ShardedKmerCounter

    k = 21
    mesh = make_mesh(8)
    n_reads = 2800
    L = 70      # 50 kmers/read over a 4-phase pattern -> 35000 per canonical
    codes = np.tile(np.tile(np.arange(4, dtype=np.uint8), 18)[:L], n_reads)
    lengths = np.full(n_reads, L, np.int32)
    counter = ShardedKmerCounter(k, mesh, chunk=1 << 14)
    words, vmask, _ = build_stream(codes, lengths, k, lane_multiple=8 * 8)
    counter.add_stream(words, vmask, lengths)
    keys, counts = counter.finish()
    ref = KmerCounter(k)
    ref.add_stream(codes, lengths)
    rk, rc = ref.finish()
    assert np.array_equal(keys, rk)
    assert np.array_equal(counts, rc)
    assert counts.max() == 32767


@needs_8
def test_split_components_mesh_path_matches_single():
    """split_components with a default mesh set must route the label
    fixed points through the sharded star contraction and produce the
    identical component multiset."""
    from metafast_jax import api
    from metafast_jax.graph.components import split_components
    from metafast_jax.utils.kmers import sequence_kmers

    rng = np.random.default_rng(5)
    k = 11
    # several disjoint-ish sequence families -> multiple components with
    # varied sizes, so the size-window logic (b1/b2 + threshold rounds)
    # is exercised through the sharded path too
    seqs = ["".join("AGCT"[i] for i in rng.integers(0, 4, n))
            for n in (400, 900, 2200, 150)]
    keys = np.unique(np.concatenate([sequence_kmers(s, k) for s in seqs]))
    counts = rng.integers(1, 5, len(keys)).astype(np.int32)

    single = split_components(keys, counts, k, b1=30, b2=800)
    api.set_default_mesh(make_mesh(8))
    try:
        sharded = split_components(keys, counts, k, b1=30, b2=800)
    finally:
        api.set_default_mesh(None)
    assert len(single) == len(sharded)
    for a, b in zip(single, sharded):
        assert np.array_equal(a.kmers, b.kmers)
        assert a.weight == b.weight
        assert a.used_freq_threshold == b.used_freq_threshold


@needs_8
def test_sharded_components_path_graph_and_memory():
    """Star contraction on a long path (the worst case for propagation)
    plus the edge-cut memory property: no replicated [M] vector — the
    device arrays the algorithm holds are [n, O(E/n)] edge pairs."""
    import jax.numpy as jnp
    import metafast_jax.core.bitpack as bp
    from metafast_jax.graph.components import adjacency, connected_labels
    from metafast_jax.parallel.components import sharded_connected_labels
    from metafast_jax.utils.kmers import sequence_kmers

    rng = np.random.default_rng(23)
    seq = "".join("AGCT"[i] for i in rng.integers(0, 4, 3000))
    k = 11
    keys = np.unique(sequence_kmers(seq, k))
    M0 = len(keys)
    M = 1 << int(np.ceil(np.log2(M0)))
    khi = np.full(M, bp.SENTINEL, np.uint32)
    klo = np.full(M, bp.SENTINEL, np.uint32)
    u = keys.astype(np.uint64)
    khi[:M0] = (u >> np.uint64(32)).astype(np.uint32)
    klo[:M0] = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    nbr = np.asarray(adjacency(jnp.asarray(khi), jnp.asarray(klo), k))
    active = np.zeros(M, bool)
    active[:M0] = True

    single = np.asarray(connected_labels(jnp.asarray(nbr),
                                         jnp.asarray(active)))
    sharded = sharded_connected_labels(nbr, active, make_mesh(8))
    assert np.array_equal(single, sharded)


def test_sharded_doubling_matches_single():
    """Sharded pointer doubling (parallel/contigs.py) == single-device
    _doubling on random chain forests with cycles — the last * stage to
    shard."""
    import jax.numpy as jnp

    from metafast_jax.graph.contigs import _doubling
    from metafast_jax.parallel.contigs import sharded_doubling

    mesh8 = make_mesh(8)
    rng = np.random.default_rng(5)
    for _ in range(3):
        n = int(rng.integers(100, 4000))
        perm = rng.permutation(n)
        succ = np.full(n, -1, dtype=np.int32)
        i = 0
        while i < n:
            L = int(rng.integers(1, 300))
            seg = perm[i:i + L]
            succ[seg[:-1]] = seg[1:]
            if rng.random() < 0.25 and len(seg) > 2:
                succ[seg[-1]] = seg[0]
            i += L
        ptr_s, dist_s, reach_s = sharded_doubling(succ, mesh8)
        ptr_d, dist_d, reach_d = [np.asarray(x)
                                  for x in _doubling(jnp.asarray(succ))]
        assert np.array_equal(ptr_s, ptr_d)
        assert np.array_equal(dist_s, dist_d)
        assert np.array_equal(reach_s, reach_d)


def test_sharded_contig_stage_in_pipeline(tmp_path):
    """With a default mesh set, build_contigs routes the ranking through
    sharded_doubling and still produces the exact single-device contigs."""
    from metafast_jax import api
    from metafast_jax.graph.contigs import build_contigs
    from metafast_jax.oracle import reference as oracle

    mesh8 = make_mesh(8)
    rng = np.random.default_rng(9)
    bases = "ACGT"
    genome = "".join(bases[i] for i in rng.integers(0, 4, 3000))
    reads = [genome[s:s + 80] for s in rng.integers(0, 2920, 600)]
    k = 15
    table = oracle.count_reads(reads, k)
    keys = np.array(sorted(table), dtype=np.int64)
    counts = np.array([table[int(x)] for x in keys], dtype=np.int32)

    single = build_contigs(keys, counts, k, 0)
    api.set_default_mesh(mesh8)
    try:
        sharded = build_contigs(keys, counts, k, 0)
    finally:
        api.set_default_mesh(None)
    assert sharded == single


def test_sharded_stream3_matches_single_device():
    """ShardedKmerCounter.add_stream3 (compact layout) == the
    single-device counter on the same reads, across consolidations."""
    import jax.numpy as jnp

    from metafast_jax.ops.count import KmerCounter
    from metafast_jax.ops.stream_extract import build_stream3
    from metafast_jax.parallel.count import ShardedKmerCounter

    mesh = make_mesh(8)
    k = 15
    rng = np.random.default_rng(3)
    sc = ShardedKmerCounter(k, mesh, chunk=1 << 14)
    ref = KmerCounter(k)
    for _ in range(3):
        lens = rng.integers(k, 90, 400).astype(np.int32)
        cs = rng.integers(0, 4, int(lens.sum()), dtype=np.uint8)
        w0, w1, w2, vm, _ = build_stream3(cs, lens, k, lane_multiple=64)
        sc.add_stream3(w0, w1, w2, vm, lens)
        ref.add_stream(cs, lens)
    sk, scnt = sc.finish()
    rk, rc = ref.finish()
    assert np.array_equal(sk, rk)
    assert np.array_equal(scnt, rc)
