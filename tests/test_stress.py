"""CAMI-scale stress tier (opt-in: METAFAST_STRESS=1).

Synthetic multi-sample workload at the scale of BASELINE config #2
(tens of millions of k-mers per sample): exercises multi-chunk
consolidation, KmerCounter.finish() memory behavior, the component size
window, and the full matrix pipeline.  Golden values don't exist at this
scale; the assertions are structural invariants plus agreement between
independently computed quantities.  Runtime and peak-RSS numbers are
printed for the perf log (see PERF.md).

Run:  METAFAST_STRESS=1 python -m pytest tests/test_stress.py -s -q
"""

import os
import resource
import time

import numpy as np
import pytest

# Full CAMI-scale tests are opt-in; the default tier below (depth + spill
# at reduced scale) runs in every CI invocation.
stress_only = pytest.mark.skipif(
    not os.environ.get("METAFAST_STRESS"),
    reason="stress tier is opt-in: set METAFAST_STRESS=1")

K = 31
GENOME = 1_200_000       # per-sample genome
SHARED = 450_000         # shared backbone between samples
READ_LEN = 150
COVERAGE = 8             # ~7.7M k-mers per sample (CPU-feasible; the
                         # full-scale run is `chip_smoke.py` on a GPU)


def _make_samples(tmp_path, n_samples=3, seed=0):
    """Samples share a backbone (so the matrix is informative) plus a
    private region each; reads are error-free at fixed coverage."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    backbone = bases[rng.integers(0, 4, SHARED)]
    files = []
    for s in range(n_samples):
        private = bases[rng.integers(0, 4, GENOME - SHARED)]
        genome = np.concatenate([backbone, private])
        n_reads = GENOME * COVERAGE // READ_LEN
        starts = rng.integers(0, GENOME - READ_LEN, n_reads)
        reads = genome[starts[:, None] + np.arange(READ_LEN)[None, :]]
        fp = tmp_path / f"stress_{s}.fa"
        with open(fp, "wb") as fh:
            for i in range(n_reads):
                fh.write(b">r%d\n" % i)
                fh.write(reads[i].tobytes())
                fh.write(b"\n")
        files.append(str(fp))
    return files


@stress_only
def test_cami_scale_matrix(tmp_path):
    from metafast_jax.pipeline import matrix_pipeline

    files = _make_samples(tmp_path)
    n_kmers_per_sample = GENOME * COVERAGE // READ_LEN * (READ_LEN - K + 1)
    t0 = time.time()
    res = matrix_pipeline(files, k=K, b=1, l=100, b1=1000, b2=10000)
    dt = time.time() - t0
    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1048576

    # structural invariants
    S = len(files)
    assert res.matrix.shape == (S, S)
    assert np.allclose(res.matrix, res.matrix.T)
    assert np.all(np.diag(res.matrix) == 0)
    # shared backbone => strictly between identical (0) and disjoint (1)
    off = res.matrix[np.triu_indices(S, 1)]
    assert np.all((off > 0.05) & (off < 0.95)), off

    # counting reached CAMI scale and per-sample tables are plausible
    for keys, counts in res.sample_tables:
        assert len(keys) > 700_000              # unique k-mers > b
        assert np.all(counts > 1)               # b=1 filter applied
        assert np.all(keys[:-1] < keys[1:])     # sorted unique

    # components sit inside the size window (oversized ones were split)
    sizes = np.array([len(c.kmers) for c in res.components])
    assert len(sizes) > 0
    assert sizes.max() <= 10000

    # feature vectors are consistent with the tables they came from
    assert res.vectors.shape == (S, len(sizes))
    assert res.vectors.sum() > 0

    total = S * n_kmers_per_sample
    print(f"\n[stress] {S} samples x {n_kmers_per_sample / 1e6:.0f}M kmers, "
          f"pipeline {dt:.1f}s ({total / dt / 1e6:.1f}M kmers/s e2e), "
          f"peak RSS {peak_gb:.1f} GB, "
          f"{len(sizes)} components, "
          f"uniques/sample ~{len(res.sample_tables[0][0]) / 1e6:.1f}M")


@stress_only
def test_multichunk_consolidation_equivalence(tmp_path):
    """A counter forced through many small consolidation chunks must
    produce the identical table (finish() merge correctness at depth)."""
    from metafast_jax.io import native_reads
    from metafast_jax.ops.count import KmerCounter

    files = _make_samples(tmp_path, n_samples=1, seed=7)
    codes, lengths, _ = native_reads.parse_file(files[0])
    # cap input so this sub-test stays quick
    lengths = lengths[:200_000]
    codes = codes[: int(lengths.sum())]

    def count(chunk):
        c = KmerCounter(K, chunk=chunk)
        offs = np.concatenate([[0], np.cumsum(lengths.astype(np.int64))])
        step = 50_000
        for r0 in range(0, len(lengths), step):
            r1 = min(r0 + step, len(lengths))
            c.add_stream(codes[offs[r0]:offs[r1]], lengths[r0:r1])
        return c.finish()

    k1, c1 = count(chunk=1 << 27)      # single consolidation
    k2, c2 = count(chunk=1 << 22)      # many levels + binary merges
    np.testing.assert_array_equal(k1, k2)
    np.testing.assert_array_equal(c1, c2)


def test_default_tier_multichunk_depth_and_spill(tmp_path):
    """Default-CI depth tier (no env vars): a counter pushed through many
    consolidation chunks AND a tiny spill threshold (every level exits to
    host RAM) must reproduce the single-consolidation table bit-for-bit.
    This exercises the finish() merge depth + host-spill path that the
    full CAMI tier covers at scale."""
    from metafast_jax.io import native_reads
    from metafast_jax.ops.count import KmerCounter

    rng = np.random.default_rng(3)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = bases[rng.integers(0, 4, 400_000)]
    n_reads = 400_000 * 6 // READ_LEN                 # ~1.9M k-mers
    starts = rng.integers(0, 400_000 - READ_LEN, n_reads)
    reads = genome[starts[:, None] + np.arange(READ_LEN)[None, :]]
    lengths = np.full(n_reads, READ_LEN, np.int32)
    codes = reads.reshape(-1)

    def count(chunk, spill):
        c = KmerCounter(K, chunk=chunk, spill=spill)
        offs = np.concatenate([[0], np.cumsum(lengths.astype(np.int64))])
        step = 30_000
        for r0 in range(0, len(lengths), step):
            r1 = min(r0 + step, len(lengths))
            c.add_stream(codes[offs[r0]:offs[r1]], lengths[r0:r1])
        return c, c.finish()

    ref, (k1, c1) = count(chunk=1 << 23, spill=None)
    deep, (k2, c2) = count(chunk=1 << 18, spill=1 << 18)
    # the deep run really did exercise depth and spill
    assert deep.spill_events > 0 and ref.spill_events == 0
    assert len(k2) > 390_000
    np.testing.assert_array_equal(k1, k2)
    np.testing.assert_array_equal(c1, c2)
    assert ref.total_kmers_seen == deep.total_kmers_seen
