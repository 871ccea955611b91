"""Core k-mer bit math vs the NumPy/python oracle."""

import numpy as np
import pytest

import jax.numpy as jnp

from metafast_jax.core import bitpack as bp
from metafast_jax.core.extract import extract_canonical
from metafast_jax.ops.count import KmerCounter, count_flat
from metafast_jax.oracle import reference as oracle


def split64(v):
    v = np.asarray(v, dtype=np.uint64)
    return (v >> np.uint64(32)).astype(np.uint32), (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def join64(hi, lo):
    return (np.asarray(hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(lo, dtype=np.uint64)


def rand_kmers(rng, n, k):
    return rng.integers(0, 1 << (2 * k), size=n, dtype=np.uint64)


@pytest.mark.parametrize("k", [1, 2, 5, 15, 16, 17, 21, 31])
def test_rc_matches_oracle(k):
    rng = np.random.default_rng(0)
    vals = rand_kmers(rng, 64, k)
    hi, lo = split64(vals)
    rhi, rlo = bp.rc(jnp.asarray(hi), jnp.asarray(lo), k)
    got = join64(np.asarray(rhi), np.asarray(rlo))
    want = np.array([oracle.rc64(int(v), k) for v in vals], dtype=np.uint64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [2, 15, 16, 17, 31])
def test_shift_and_nuc_ops(k):
    rng = np.random.default_rng(1)
    vals = rand_kmers(rng, 32, k)
    nucs = rng.integers(0, 4, size=32)
    hi, lo = split64(vals)
    hi, lo = jnp.asarray(hi), jnp.asarray(lo)

    shr_hi, shr_lo = bp.shift_right(hi, lo, jnp.asarray(nucs, dtype=jnp.uint32), k)
    want = np.array([oracle._shift_right(int(v), int(n), k) for v, n in zip(vals, nucs)],
                    dtype=np.uint64)
    np.testing.assert_array_equal(join64(np.asarray(shr_hi), np.asarray(shr_lo)), want)

    shl_hi, shl_lo = bp.shift_left(hi, lo, jnp.asarray(nucs, dtype=jnp.uint32), k)
    want = np.array([oracle._shift_left(int(v), int(n), k) for v, n in zip(vals, nucs)],
                    dtype=np.uint64)
    np.testing.assert_array_equal(join64(np.asarray(shl_hi), np.asarray(shl_lo)), want)

    fn = np.asarray(bp.first_nuc(hi, lo, k))
    want = np.array([(int(v) >> (2 * k - 2)) & 3 for v in vals])
    np.testing.assert_array_equal(fn, want)

    ln = np.asarray(bp.last_nuc(lo))
    np.testing.assert_array_equal(ln, vals.astype(np.uint64) & np.uint64(3))


@pytest.mark.parametrize("k", [3, 16, 17, 31])
def test_extract_canonical_matches_oracle(k):
    rng = np.random.default_rng(2)
    B, L = 8, 40
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    lengths = rng.integers(0, L + 1, size=B, dtype=np.int32)

    hi, lo, valid = extract_canonical(jnp.asarray(codes), jnp.asarray(lengths), k)
    hi, lo, valid = np.asarray(hi), np.asarray(lo), np.asarray(valid)

    for b in range(B):
        want = oracle.canonical_kmers(codes[b, : lengths[b]], k)
        got = join64(hi[b], lo[b])[valid[b]]
        np.testing.assert_array_equal(got, np.array(want, dtype=np.uint64))
        # invalid slots are sentinel
        assert np.all(hi[b][~valid[b]] == bp.SENTINEL)


@pytest.mark.parametrize("k", [5, 17, 31])
def test_counting_matches_oracle(k):
    rng = np.random.default_rng(3)
    reads = ["".join(rng.choice(list("AGCT"), size=rng.integers(k, 60)))
             for _ in range(50)]
    want = oracle.count_reads(reads, k)

    counter = KmerCounter(k, capacity=1 << 8)
    for chunk in (reads[:20], reads[20:]):
        L = max(len(s) for s in chunk)
        codes = np.zeros((len(chunk), L), dtype=np.uint8)
        lengths = np.zeros(len(chunk), dtype=np.int32)
        for i, s in enumerate(chunk):
            enc = oracle.encode_seq(s)
            codes[i, : len(enc)] = enc
            lengths[i] = len(enc)
        counter.add_batch(codes, lengths)

    keys, counts = counter.finish()
    got = dict(zip(keys.tolist(), counts.tolist()))
    assert got == want
    # sorted ascending unique
    assert np.all(np.diff(keys) > 0)


def test_count_flat_saturates():
    hi = jnp.zeros((40000,), dtype=jnp.uint32)
    lo = jnp.full((40000,), 7, dtype=jnp.uint32)
    uhi, ulo, cnt = count_flat(hi, lo)
    assert int(cnt[0]) == 32767
    assert int(jnp.sum(cnt > 0)) == 1


@pytest.mark.parametrize("chunk", [64, 256])
def test_counting_multi_chunk_merge(chunk):
    """Small chunk forces the consolidate + merge_counted (weighted RLE)
    path that production only hits past 2^27 raw keys."""
    k = 15
    rng = np.random.default_rng(7)
    reads = ["".join(rng.choice(list("AGCT"), size=rng.integers(k, 40)))
             for _ in range(120)]
    want = oracle.count_reads(reads, k)

    counter = KmerCounter(k, chunk=chunk)
    for s in reads:
        enc = oracle.encode_seq(s)
        counter.add_batch(enc[None, :], np.array([len(enc)], np.int32))
    keys, counts = counter.finish()
    assert dict(zip(keys.tolist(), counts.tolist())) == want
    assert np.all(np.diff(keys) > 0)
    assert counter.total_kmers_seen == sum(
        max(len(s) - k + 1, 0) for s in reads)


def test_counting_merge_saturates_across_chunks():
    """Saturating add across chunk merges (itmo NumUtils.java:21-26)."""
    k = 5
    seq = "ACGTA"
    counter = KmerCounter(k, chunk=32)
    enc = oracle.encode_seq(seq)
    batch = np.repeat(enc[None, :], 64, axis=0)
    lens = np.full(64, len(enc), np.int32)
    for _ in range(600):          # 38400 occurrences of one k-mer
        counter.add_batch(batch, lens)
    keys, counts = counter.finish()
    assert len(keys) == 1
    assert int(counts[0]) == 32767


def test_cumsum_flat_matches_numpy():
    from metafast_jax.ops.count import _cumsum_flat
    rng = np.random.default_rng(11)
    for n in (5, 1000, 8192, 8193, 1 << 14, (1 << 14) + 777):
        x = rng.integers(0, 100, n).astype(np.int32)
        got = np.asarray(_cumsum_flat(jnp.asarray(x)))
        assert np.array_equal(got, np.cumsum(x)), n


def test_bucket_size_family():
    from metafast_jax.ops.count import _bucket_size
    assert _bucket_size(1) == 16
    assert _bucket_size(16) == 16
    assert _bucket_size(17) == 24
    assert _bucket_size(25) == 32
    assert _bucket_size(3 << 20) == 3 << 20
    assert _bucket_size((3 << 20) + 1) == 1 << 22


def _hosted_oracle_check(keys64: np.ndarray):
    """Run count_flat_hosted on raw int64 keys, compare to numpy."""
    from metafast_jax.ops.count import count_flat_hosted
    u = keys64.astype(np.uint64)
    hi = jnp.asarray((u >> np.uint64(32)).astype(np.uint32))
    lo = jnp.asarray((u & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    uh, ul, cnt = count_flat_hosted(hi, lo)
    uh, ul, cnt = map(np.asarray, (uh, ul, cnt))
    live = cnt > 0
    got_keys = ((uh[live].astype(np.uint64) << np.uint64(32))
                | ul[live].astype(np.uint64)).astype(np.int64)
    want_keys, want_counts = np.unique(keys64, return_counts=True)
    assert np.array_equal(np.sort(got_keys), want_keys)
    got = dict(zip(got_keys.tolist(), cnt[live].tolist()))
    want = dict(zip(want_keys.tolist(),
                    np.minimum(want_counts, 32767).tolist()))
    assert got == want
    # table is trimmed to pow2(uniques)
    assert uh.shape[0] == max(16, 1 << int(np.ceil(np.log2(len(want_keys)))))


def test_hosted_large_sparse_path():
    """n >= _HOSTED_MIN with ~3% uniques drives the hierarchical
    row-sort compaction (mask -> levels -> finish)."""
    rng = np.random.default_rng(3)
    uniques = rng.integers(0, 1 << 60, 30000, dtype=np.int64)
    keys = rng.choice(uniques, size=1 << 20)
    _hosted_oracle_check(keys)


def test_hosted_large_dense_bail():
    """All-distinct keys trip the n_uni*8 >= n bail to the single
    compaction sort; results must be identical."""
    rng = np.random.default_rng(4)
    keys = rng.permutation((1 << 20) + np.arange(1 << 20, dtype=np.int64))
    _hosted_oracle_check(keys)


def test_hosted_pad_branch():
    """n = 3*2^18 with just under n/8 evenly spread uniques: compacted
    size (3*2^15) lands below pow2(uniques) (2^17), forcing the pad
    branch (and staying under the dense bail)."""
    n = 3 << 18
    u = n // 8 - 1
    uniques = (np.arange(u, dtype=np.int64) * 977 + 13) * (1 << 34)
    keys = np.concatenate([np.repeat(uniques, 8),
                           np.full(8, uniques[0], dtype=np.int64)])
    assert len(keys) == n
    _hosted_oracle_check(keys)


def test_hosted_saturation_large():
    """A 40000-deep run inside a large chunk saturates at 32767."""
    rng = np.random.default_rng(5)
    n = 1 << 20
    fill = rng.integers(0, 1 << 40, n - 40000, dtype=np.int64)
    keys = np.concatenate([fill, np.full(40000, 1 << 50, dtype=np.int64)])
    _hosted_oracle_check(keys)


def test_kmer_counter_spill_to_host():
    """Levels past the spill threshold move to host RAM; results are
    identical to the fully on-device path (HBM-scale guard)."""
    import numpy as np
    from metafast_jax.ops.count import KmerCounter

    rng = np.random.default_rng(3)
    batches = []
    for _ in range(6):
        codes = rng.integers(0, 4, 40_000).astype(np.uint8)
        lengths = np.full(400, 100, np.int32)
        batches.append((codes, lengths))

    def run(spill):
        c = KmerCounter(11, chunk=1 << 14, spill=spill)
        for codes, lengths in batches:
            c.add_stream(codes, lengths)
        return c.finish()

    k_ref, c_ref = run(spill=1 << 30)      # never spills
    k_sp, c_sp = run(spill=1 << 12)        # every consolidated level spills
    np.testing.assert_array_equal(k_ref, k_sp)
    np.testing.assert_array_equal(c_ref, c_sp)


def test_kmer_counter_finish_device_raises_after_spill():
    import numpy as np
    import pytest
    from metafast_jax.ops.count import KmerCounter

    rng = np.random.default_rng(4)
    c = KmerCounter(11, chunk=1 << 12, spill=1 << 10)
    codes = rng.integers(0, 4, 40_000).astype(np.uint8)
    c.add_stream(codes, np.full(400, 100, np.int32))
    with pytest.raises(RuntimeError, match="spill"):
        c.finish_device()


def test_k_bound_pinned():
    # the int64 key-order invariant in _fetch_table requires k <= 31
    # (2k-bit keys stay below 2^62); k = 32 would silently flip sign bits
    import pytest
    from metafast_jax.ops.count import KmerCounter

    for bad in (0, 32, 64):
        with pytest.raises(ValueError):
            KmerCounter(bad)
    KmerCounter(31)


def test_sharded_k_bound_pinned():
    import pytest
    import jax
    from metafast_jax.parallel.count import ShardedKmerCounter, make_mesh

    mesh = make_mesh(min(len(jax.devices()), 8))
    with pytest.raises(ValueError):
        ShardedKmerCounter(32, mesh)
