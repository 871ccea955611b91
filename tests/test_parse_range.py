"""Record-aligned byte-range parsing (io/native_reads.parse_file_range).

The multi-host input partitioner (api._parse_process_share) depends on
two properties pinned here: ranges PARTITION the file exactly (no read
lost or duplicated for any process count), and the snap function is
deterministic so adjacent processes agree on their shared boundary.
Reference intent: src/io/BytesDispatcher.java:39-67 (record-aligned
~16 MB ranges handed to workers).
"""

import numpy as np
import pytest

from metafast_jax.io import native_reads


def _write_fasta(path, reads, width=None):
    with open(path, "wb") as fh:
        for i, r in enumerate(reads):
            fh.write(b">read%d desc\n" % i)
            if width:
                for j in range(0, len(r), width):
                    fh.write(r[j:j + width] + b"\n")
            else:
                fh.write(r + b"\n")


def _write_fastq(path, reads):
    with open(path, "wb") as fh:
        for i, r in enumerate(reads):
            fh.write(b"@read%d\n" % i)
            fh.write(r + b"\n+\n")
            fh.write(b"I" * len(r) + b"\n")


_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _rand_reads(rng, n, lo=40, hi=220):
    return [bytes(rng.choice(_BASES, rng.integers(lo, hi)))
            for _ in range(n)]


@pytest.mark.parametrize("wrap", [None, 60])
@pytest.mark.parametrize("P", [2, 3, 7])
def test_fasta_ranges_partition_exactly(tmp_path, wrap, P):
    rng = np.random.default_rng(0)
    fp = tmp_path / "t.fa"
    _write_fasta(str(fp), _rand_reads(rng, 300), width=wrap)
    import os
    sz = os.path.getsize(fp)
    full = native_reads.parse_file(str(fp))
    assert full is not None
    assert len(full[1]) == 300 and len(full[0]) > 0
    parts = [native_reads.parse_file_range(str(fp), q * sz // P,
                                           (q + 1) * sz // P)
             for q in range(P)]
    assert all(p is not None for p in parts)
    # every process must get a non-degenerate share (boundaries land
    # strictly inside the file, not snapped to EOF)
    assert all(len(p[1]) > 0 for p in parts)
    np.testing.assert_array_equal(
        np.concatenate([p[0] for p in parts]), full[0])
    np.testing.assert_array_equal(
        np.concatenate([p[1] for p in parts]), full[1])
    assert sum(p[2] for p in parts) == full[2]


@pytest.mark.parametrize("P", [2, 4])
def test_fastq_ranges_partition_exactly(tmp_path, P):
    rng = np.random.default_rng(1)
    fp = tmp_path / "t.fastq"
    # include reads whose quality line starts with '@' (the classic
    # record-boundary ambiguity); qualities start at 34 ('"') because the
    # parser drops any read containing a phred-0 base ('!' = 33), and a
    # fully-skipped fixture would make the partition check vacuous
    reads = _rand_reads(rng, 200)
    with open(fp, "wb") as fh:
        for i, r in enumerate(reads):
            fh.write(b"@r%d\n" % i + r + b"\n+\n")
            q = bytes(rng.integers(34, 75, len(r)).astype(np.uint8))
            fh.write(q + b"\n")
    import os
    sz = os.path.getsize(fp)
    full = native_reads.parse_file(str(fp))
    assert full is not None
    assert len(full[1]) == 200 and len(full[0]) > 0
    parts = [native_reads.parse_file_range(str(fp), q * sz // P,
                                           (q + 1) * sz // P)
             for q in range(P)]
    assert all(p is not None for p in parts)
    assert all(len(p[1]) > 0 for p in parts)
    np.testing.assert_array_equal(
        np.concatenate([p[0] for p in parts]), full[0])
    np.testing.assert_array_equal(
        np.concatenate([p[1] for p in parts]), full[1])


def test_fastq_midfile_boundary_lands_inside(tmp_path):
    """A mid-file FASTQ snap must land strictly inside the file (the r4
    advisor found the header-vs-quality length check accepted nothing, so
    every mid-file boundary snapped to EOF and range splitting silently
    degenerated to process-0-parses-everything)."""
    rng = np.random.default_rng(7)
    fp = tmp_path / "mid.fastq"
    _write_fastq(str(fp), _rand_reads(rng, 400))
    import os
    sz = os.path.getsize(fp)
    for frac in (0.25, 0.5, 0.75):
        b = native_reads.record_boundary(str(fp), int(sz * frac))
        assert b is not None
        assert int(sz * frac) <= b < sz  # strictly inside, near the ask
        assert b - int(sz * frac) < 4096


def test_boundary_snap_deterministic_and_monotone(tmp_path):
    rng = np.random.default_rng(2)
    fp = tmp_path / "t.fa"
    _write_fasta(str(fp), _rand_reads(rng, 100))
    import os
    sz = os.path.getsize(fp)
    snaps = [native_reads.record_boundary(str(fp), pos)
             for pos in range(0, sz + 1, max(sz // 50, 1))]
    assert snaps[0] == 0
    assert all(b is not None for b in snaps)
    assert all(a <= b for a, b in zip(snaps, snaps[1:]))
    # snapping twice is a fixed point
    for b in snaps[:10]:
        assert native_reads.record_boundary(str(fp), b) == b


def test_compressed_files_refuse_ranges(tmp_path):
    import gzip
    rng = np.random.default_rng(3)
    fp = tmp_path / "t.fa.gz"
    raw = b"".join(b">r%d\n%s\n" % (i, r)
                   for i, r in enumerate(_rand_reads(rng, 20)))
    with gzip.open(fp, "wb") as fh:
        fh.write(raw)
    assert native_reads.record_boundary(str(fp), 10) is None
    assert native_reads.parse_file_range(str(fp), 0, 100) is None
