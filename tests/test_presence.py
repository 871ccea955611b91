"""Bit-packed / chunked presence layer (stats/presence.py).

The reference backs its stats tools with ~1-bit-per-cell bitset hash maps
(src/structures/map/Long2BitShortaHashMap.java:13-120); these tests pin the
sort-native equivalents: PackedPresence parity with the dense matrix,
chunked group counts, first-present values, and the memory bound that
makes CAMI-scale stats possible (run in a subprocess so ru_maxrss measures
only this workload).
"""

import os
import subprocess
import sys

from pathlib import Path

import numpy as np
import pytest

from metafast_jax.stats import presence as pres


def _rand_tables(rng, n_samples, key_space, per_sample):
    tables = []
    for _ in range(n_samples):
        keys = np.unique(rng.integers(0, key_space, per_sample))
        counts = rng.integers(1, 100, len(keys)).astype(np.int64)
        tables.append((keys.astype(np.int64), counts))
    return tables


def test_packed_presence_matches_dense():
    rng = np.random.default_rng(0)
    tables = _rand_tables(rng, 70, 500, 60)     # S=70 -> 3 words
    keys = pres.union_keys(tables)
    dense = pres.presence_matrix(tables, keys)
    packed = pres.PackedPresence.from_tables(tables, keys)
    S = len(tables)
    assert packed.words.shape == (len(keys), (S + 31) // 32)
    for j in range(S):
        col = (packed.words[:, j >> 5] >> np.uint32(j & 31)) & np.uint32(1)
        np.testing.assert_array_equal(col.astype(bool), dense[:, j])
    # cardinality over arbitrary sample ranges == dense column sums
    for lo, hi in [(0, S), (0, 33), (10, 40), (32, 64), (5, 5)]:
        np.testing.assert_array_equal(
            packed.cardinality(lo, hi), dense[:, lo:hi].sum(axis=1))


def test_group_presence_counts_matches_dense():
    rng = np.random.default_rng(1)
    tables = _rand_tables(rng, 12, 300, 40)
    keys = pres.union_keys(tables)
    dense = pres.presence_matrix(tables, keys)
    sizes = [5, 4, 3]
    got = pres.group_presence_counts(tables, keys, sizes)
    o = np.cumsum([0] + sizes)
    for gi in range(3):
        np.testing.assert_array_equal(
            got[gi], dense[:, o[gi]:o[gi + 1]].sum(axis=1))


def test_first_present_value_matches_dense():
    rng = np.random.default_rng(2)
    tables = _rand_tables(rng, 9, 200, 30)
    keys = pres.union_keys(tables)
    cnt = np.zeros((len(keys), len(tables)), dtype=np.int64)
    for j, (sk, sc) in enumerate(tables):
        cnt[np.searchsorted(keys, sk), j] = sc
    first_idx = np.argmax(cnt > 0, axis=1)
    want = cnt[np.arange(len(keys)), first_idx]
    got = pres.first_present_value(tables, keys)
    np.testing.assert_array_equal(got, want)


def test_count_matrix_arbitrary_key_subset():
    rng = np.random.default_rng(3)
    tables = _rand_tables(rng, 6, 400, 50)
    keys = pres.union_keys(tables)
    sub = rng.permutation(keys)[: len(keys) // 2]   # unsorted subset
    got = pres.count_matrix(tables, sub)
    for j, (sk, sc) in enumerate(tables):
        for i, kv in enumerate(sub):
            p = np.searchsorted(sk, kv)
            want = sc[p] if p < len(sk) and sk[p] == kv else 0
            assert got[i, j] == want


_MEM_CHILD = r"""
import resource, sys
import numpy as np
from metafast_jax.stats import presence as pres

N_KEYS = int(sys.argv[1]); S = int(sys.argv[2])
base_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024

class GenTables:
    '''Lazy per-sample tables generated on demand — the same streaming
    contract as presence.LazyTables, without touching disk.'''
    def __init__(self, s0, s1):
        self.s0, self.s1 = s0, s1
    def __len__(self):
        return self.s1 - self.s0
    def _one(self, j):
        # overlapping contiguous blocks: adjacent samples share half
        # their keys, union ~ (S+1)/2 x per-sample size.  arange-based so
        # GENERATION cost stays negligible next to the measured library
        # passes (an rng + unique per sample dominated the whole child).
        per = N_KEYS // 2
        start = j * (per // 2)
        keys = np.arange(start, start + per, dtype=np.int64) * 7
        counts = (keys % 49 + 1).astype(np.int64)
        return keys, counts
    def __iter__(self):
        for j in range(self.s0, self.s1):
            yield self._one(j)

tables = GenTables(0, S)
keys = pres.union_keys(tables)
n1 = pres.group_presence_counts(tables, keys, [S // 2, S - S // 2])
packed = pres.PackedPresence.from_tables(tables, keys)
card = packed.cardinality(0, S)
assert np.array_equal(card, n1[0] + n1[1])
fv = pres.first_present_value(tables, keys)
assert (fv[card > 0] > 0).all()
peak_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
print(f"RESULT {len(keys)} {packed.nbytes} {peak_mb:.0f} {peak_mb - base_mb:.0f}")
"""


def _run_mem_child(n_keys, s):
    root = str(Path(__file__).resolve().parent.parent)
    env = dict(os.environ, PYTHONPATH=root + ":" +
               os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _MEM_CHILD, str(n_keys), str(s)],
        capture_output=True, text=True, env=env, timeout=2400)
    assert out.returncode == 0, out.stderr[-2000:]
    line = [l for l in out.stdout.splitlines() if l.startswith("RESULT")][0]
    _, n_union, nbytes, peak_mb, delta_mb = line.split()
    return int(n_union), int(nbytes), float(peak_mb), float(delta_mb)


def test_presence_memory_bounded_default_tier():
    """~6.4M union keys x 48 samples: packed bits + streaming sample-major
    passes keep peak RSS far below the dense [N, S] formulation (dense
    bool+int64 would be ~3.4 GB for the matrices alone, plus ~1.4 GB if
    all sample tables were resident at once)."""
    n_union, nbytes, peak_mb, delta_mb = _run_mem_child(1 << 19, 48)
    assert nbytes == n_union * 2 * 4          # [N, ceil(48/32)=2] uint32
    # delta over the child's post-import baseline is the stable signal
    # (absolute RSS wobbles with allocator behavior under host load);
    # the dense bool+int64 formulation would be ~3.4 GB of matrices
    # plus ~1.4 GB of resident sample tables
    assert delta_mb < 1500, f"RSS delta {delta_mb:.0f} MB (peak {peak_mb:.0f})"
    # the absolute peak is allocator-baseline noisy (measured 3.24 GB
    # under a full-suite run vs ~2.5 GB solo with the SAME delta); keep
    # it as a coarse backstop only — the delta bound above is the claim
    assert peak_mb < 4200, f"peak RSS {peak_mb:.0f} MB"


@pytest.mark.skipif(not os.environ.get("METAFAST_STRESS"),
                    reason="CAMI-scale tier: set METAFAST_STRESS=1")
def test_presence_memory_bounded_cami_scale():
    """~10^8 union keys x 50 samples under a few GB host RSS
    (dense int64 would be ~40 GB)."""
    n_union, nbytes, peak_mb, delta_mb = _run_mem_child(7_800_000, 50)
    assert n_union > 5e7
    assert peak_mb < 6000, f"peak RSS {peak_mb:.0f} MB"
