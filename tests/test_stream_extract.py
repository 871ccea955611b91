"""Parity tests for the flat-stream extraction kernel (ops/stream_extract).

The contract: the multiset of valid canonical k-mers produced by
stream_extract equals the padded
per-read oracle core.extract.extract_canonical — which is itself tested
against hand-computed values and the reference semantics (itmo
ShortKmer.java:104-150).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from metafast_jax.ops import stream_extract as SE
from metafast_jax.core.extract import extract_canonical

SENT = 0xFFFFFFFF


def _live_keys(hi, lo):
    hi = np.asarray(hi).ravel()
    lo = np.asarray(lo).ravel()
    live = ~((hi == SENT) & (lo == SENT))
    return np.sort((hi[live].astype(np.uint64) << np.uint64(32))
                   | lo[live].astype(np.uint64))


def _oracle(codes, lengths, k):
    L = int(lengths.max()) if len(lengths) else k
    L = max(L, k)
    pad = np.zeros((len(lengths), L), np.uint8)
    off = 0
    for i, ln in enumerate(lengths):
        pad[i, :ln] = codes[off:off + ln]
        off += ln
    ohi, olo, _ = extract_canonical(jnp.asarray(pad), jnp.asarray(lengths), k)
    return _live_keys(ohi, olo)


def _random_reads(rng, k, n_reads=200):
    lengths = rng.integers(max(1, k - 3), 170, n_reads).astype(np.int32)
    codes = rng.integers(0, 4, int(lengths.sum()), dtype=np.uint8)
    return codes, lengths


@pytest.mark.parametrize("k", [1, 2, 11, 15, 16, 17, 23, 31])
def test_stream_xla_matches_oracle(k):
    rng = np.random.default_rng(100 + k)
    codes, lengths = _random_reads(rng, k)
    words, vmask, n_valid = SE.build_stream(codes, lengths, k,
                                            lane_multiple=8)
    hi, lo = SE.stream_extract(jnp.asarray(words), jnp.asarray(vmask), k)
    got = _live_keys(hi, lo)
    want = _oracle(codes, lengths, k)
    assert n_valid == len(want)
    assert np.array_equal(got, want)


def test_stream_word_and_column_boundaries():
    # reads engineered so windows straddle 16-code word boundaries and the
    # 254-word column overlap rows
    k = 31
    rng = np.random.default_rng(7)
    # one long read spanning several columns: PAYLOAD*16 codes per column
    lengths = np.array([SE.PAYLOAD * 16 * 2 + 37, 31, 30, 45], np.int32)
    codes = rng.integers(0, 4, int(lengths.sum()), dtype=np.uint8)
    words, vmask, n_valid = SE.build_stream(codes, lengths, k,
                                            lane_multiple=8)
    hi, lo = SE.stream_extract(jnp.asarray(words), jnp.asarray(vmask), k)
    got = _live_keys(hi, lo)
    want = _oracle(codes, lengths, k)
    # read of length 30 < k contributes nothing; 31 contributes exactly 1
    assert n_valid == len(want) == (lengths[0] - k + 1) + 1 + 0 + (45 - k + 1)
    assert np.array_equal(got, want)


def test_stream_empty_and_all_short():
    k = 21
    words, vmask, n_valid = SE.build_stream(
        np.zeros(0, np.uint8), np.zeros(0, np.int32), k, lane_multiple=8)
    assert n_valid == 0
    hi, lo = SE.stream_extract(jnp.asarray(words), jnp.asarray(vmask), k)
    assert len(_live_keys(hi, lo)) == 0

    lengths = np.full(5, k - 1, np.int32)
    codes = np.zeros(int(lengths.sum()), np.uint8)
    words, vmask, n_valid = SE.build_stream(codes, lengths, k,
                                            lane_multiple=8)
    assert n_valid == 0


def test_counter_stream_path_matches_padded():
    from metafast_jax.ops.count import KmerCounter

    k = 21
    rng = np.random.default_rng(3)
    lengths = rng.integers(10, 90, 400).astype(np.int32)
    codes = rng.integers(0, 4, int(lengths.sum()), dtype=np.uint8)

    c1 = KmerCounter(k)
    c1.add_stream(codes, lengths)
    k1, n1 = c1.finish()

    # padded path
    L = 96
    pad = np.zeros((400, L), np.uint8)
    off = 0
    for i, ln in enumerate(lengths):
        pad[i, :ln] = codes[off:off + ln]
        off += ln
    c2 = KmerCounter(k)
    c2.add_batch(pad, lengths)
    k2, n2 = c2.finish()
    assert np.array_equal(k1, k2)
    assert np.array_equal(n1, n2)
    assert c1.total_kmers_seen == c2.total_kmers_seen


def test_stream3_multiset_matches_extract(tmp_path):
    """Compact 3-stream extraction (build_stream3 + stream3_extract)
    emits exactly the valid-window multiset — native builder, numpy
    spec, and the counter end-to-end all agree (r5: boundary windows
    never enter the sort)."""
    import collections

    import metafast_jax.native.build as nb
    from metafast_jax.core import bitpack as bp
    from metafast_jax.ops.count import KmerCounter
    from metafast_jax.ops.stream_extract import (build_stream3,
                                                 stream3_extract)
    from metafast_jax.utils.kmers import sequence_kmers

    rng = np.random.default_rng(5)
    B = "AGCT"
    for k in (11, 16, 31):
        n_reads = 200
        lengths = rng.integers(1, 180, n_reads).astype(np.int32)
        codes = rng.integers(0, 4, int(lengths.sum()), dtype=np.uint8)
        offs = np.r_[0, np.cumsum(lengths)]
        want = []
        for i in range(n_reads):
            s = "".join(B[c] for c in codes[offs[i]:offs[i + 1]])
            if len(s) >= k:
                want.extend(sequence_kmers(s, k))
        want = np.sort(np.array(want, dtype=np.int64))

        outs = []
        for use_native in (True, False):
            saved = nb._lib
            if not use_native:
                nb._lib = None
            try:
                w0, w1, w2, vm, n_valid = build_stream3(codes, lengths, k)
            finally:
                nb._lib = saved
            hi, lo = stream3_extract(
                jnp.asarray(w0), jnp.asarray(w1), jnp.asarray(w2),
                jnp.asarray(vm), k)
            hi = np.asarray(hi).ravel()
            lo = np.asarray(lo).ravel()
            live = ~((hi == bp.SENTINEL) & (lo == bp.SENTINEL))
            got = np.sort(((hi[live].astype(np.uint64) << np.uint64(32))
                           | lo[live]).astype(np.int64))
            assert n_valid == len(want)
            assert np.array_equal(got, want)
            outs.append((w0, w1, w2, vm))
        for a, b in zip(outs[0], outs[1]):
            assert np.array_equal(a, b)

        c = KmerCounter(k, capacity=1 << 12)
        c.add_stream3(codes, lengths)
        keys, cnts = c.finish()
        wc = collections.Counter(want.tolist())
        assert np.array_equal(keys, np.array(sorted(wc), np.int64))
        assert np.array_equal(
            cnts, np.array([min(wc[x], 32767) for x in sorted(wc)],
                           np.int32))
