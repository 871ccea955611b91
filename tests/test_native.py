"""Native C++ parser vs the pure-Python reader (oracle)."""

import numpy as np
import pytest

from metafast_jax.io import native_reads
from metafast_jax.io import reads as pyreads
from metafast_jax.native import native_available

pytestmark = pytest.mark.skipif(not native_available(),
                                reason="no C++ toolchain")

LUT = {c: i for i, c in enumerate("AGCT")}


def _check_file(path):
    codes, lengths, skipped = native_reads.parse_file(str(path))
    py = list(pyreads.iter_reads(str(path)))
    assert len(py) == len(lengths)
    off = 0
    for s, L in zip(py, lengths):
        assert len(s) == L
        assert codes[off:off + L].tolist() == [LUT[c] for c in s.upper()]
        off += L
    return lengths, skipped


def test_fasta_fixture(ref_data):
    lengths, skipped = _check_file(ref_data / "meta_test_1.fa")
    assert len(lengths) == 1917 and skipped == 0


def test_fastq_fixture(ref_data):
    # tinytest_A holds 2 records, quality '#' = phred 2 (Sanger) -> kept
    lengths, skipped = _check_file(ref_data / "tinytest_A.fastq")
    assert len(lengths) == 2 and skipped == 0


def test_fastq_phred0_dropped(tmp_path):
    fq = tmp_path / "q.fastq"
    # second read has a '!' (phred 0 under Sanger) and is dropped
    fq.write_text("@r1\nACGT\n+\n####\n@r2\nACGT\n+\n#!##\n")
    codes, lengths, skipped = native_reads.parse_file(str(fq))
    assert len(lengths) == 1 and skipped == 1


def test_n_reads_dropped(tmp_path):
    fa = tmp_path / "x.fasta"
    fa.write_text(">a\nACGT\n>b\nACNGT\n>c\nTTTT\n")
    codes, lengths, skipped = native_reads.parse_file(str(fa))
    assert len(lengths) == 2 and skipped == 1
    assert lengths.tolist() == [4, 4]


def test_multiline_fasta(tmp_path):
    fa = tmp_path / "m.fasta"
    fa.write_text(">a\nACGT\nACGT\nAC\n>b\nGGG\n")
    codes, lengths, skipped = native_reads.parse_file(str(fa))
    assert lengths.tolist() == [10, 3]


def test_gz_roundtrip(tmp_path):
    import gzip
    fa = tmp_path / "z.fasta.gz"
    with gzip.open(fa, "wt") as fh:
        fh.write(">a\nACGTACGT\n")
    codes, lengths, skipped = native_reads.parse_file(str(fa))
    assert lengths.tolist() == [8]


def test_to_batches_roundtrip():
    rng = np.random.default_rng(0)
    lengths = rng.integers(5, 40, 100).astype(np.int32)
    codes = rng.integers(0, 4, int(lengths.sum()), dtype=np.uint8)
    got_codes = []
    for bcodes, blens in native_reads.to_batches(codes, lengths, 17):
        for row, L in zip(bcodes, blens):
            got_codes.append(row[:L])
    assert np.array_equal(np.concatenate(got_codes), codes)


def test_native_extract_matches_oracle(tmp_path):
    import ctypes
    from metafast_jax.native import load_library
    from metafast_jax.utils.kmers import sequence_kmers
    lib = load_library()
    seqs = ["ACGGTCAGATTCAGGACTT", "TTGACCGTAGGTA"]
    k = 7
    codes = np.concatenate([
        np.array([LUT[c] for c in s], dtype=np.uint8) for s in seqs])
    lengths = np.array([len(s) for s in seqs], dtype=np.int32)
    cap = 1000
    keys = np.empty(cap, dtype=np.int64)
    n = lib.extract_canonical(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(seqs), k,
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap)
    want = np.concatenate([sequence_kmers(s, k) for s in seqs])
    assert np.array_equal(keys[:n], want)


def test_crlf_and_double_cr_line_endings(tmp_path):
    """'\r\n' and stray '\r\r\n' endings must not poison reads (ADVICE r1)."""
    fa = tmp_path / "crlf.fa"
    fa.write_bytes(b">r1\r\nACGTACGT\r\n>r2\r\r\nTTTTGGGG\r\r\n")
    codes, lengths, skipped = native_reads.parse_file(str(fa))
    assert skipped == 0
    assert lengths.tolist() == [8, 8]
    assert codes[:8].tolist() == [0, 2, 1, 3, 0, 2, 1, 3]


def test_graph_baselines_match_oracle():
    """contig_walk_baseline / bfs_components_baseline (the bench's native
    anchors for the graph stages) agree with the
    oracle on contig count, total contig length, and component count."""
    import ctypes
    from metafast_jax.native import load_library
    from metafast_jax.oracle import reference as oracle

    lib = load_library()
    rng = np.random.default_rng(5)
    bases = "ACGT"
    genome = "".join(bases[i] for i in rng.integers(0, 4, 4000))
    reads = [genome[s:s + 80] for s in rng.integers(0, 3920, 600)]
    k = 15
    table = oracle.count_reads(reads, k)
    keys = np.array(sorted(table), dtype=np.uint64)
    counts = np.array([table[int(x)] for x in keys], dtype=np.int32)

    seqs = oracle.build_contigs(
        {int(a): int(c) for a, c in zip(keys, counts)}, k, 0)
    n_seq = ctypes.c_int64(0)
    tlen = ctypes.c_int64(0)
    lib.contig_walk_baseline(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(keys), k, 0, 16, ctypes.byref(n_seq), ctypes.byref(tlen))
    assert n_seq.value == len(seqs)
    assert tlen.value == sum(len(s[0]) for s in seqs)

    comps = oracle.split_components(
        {int(a): int(c) for a, c in zip(keys, counts)}, k, 1, 10 ** 9)
    n_comp = ctypes.c_int64(0)
    visited = lib.bfs_components_baseline(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(keys), k, 16, ctypes.byref(n_comp))
    assert n_comp.value == len(comps)
    assert visited == len(keys)


def test_build_key_tracks_source_flags_and_arch(tmp_path, monkeypatch):
    """The library's file name hashes the source, the compiler command
    and the architecture: change any one and the loader looks elsewhere."""
    import metafast_jax.native.build as nb

    base = nb.library_path()
    assert base.parent == nb.BUILD_DIR and base.suffix == ".so"
    src = tmp_path / "fastparse.cpp"
    src.write_bytes(nb._SRC.read_bytes() + b"\n// edited\n")
    monkeypatch.setattr(nb, "_SRC", src)
    edited = nb.library_path()
    monkeypatch.setattr(nb, "_SRC", nb._HERE / "fastparse.cpp")
    monkeypatch.setattr(nb, "CXX_CMD", nb.CXX_CMD + ("-march=native",))
    flagged = nb.library_path()
    monkeypatch.undo()
    monkeypatch.setattr(nb.platform, "machine", lambda: "other-arch")
    foreign = nb.library_path()
    assert len({base, edited, flagged, foreign}) == 4


def test_stale_or_foreign_library_is_rebuilt_not_loaded(tmp_path,
                                                        monkeypatch):
    """Libraries under other keys (stale sources, another host) and the
    old unkeyed file sit beside the build; the loader builds its own."""
    import metafast_jax.native.build as nb

    monkeypatch.setattr(nb, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(nb, "_lib", None)
    monkeypatch.setattr(nb, "_tried", False)
    junk = b"not a shared object"
    (tmp_path / "fastparse-0000000000000000.so").write_bytes(junk)
    (tmp_path / "_fastparse.so").write_bytes(junk)
    lib = nb.load_library()
    assert lib is not None
    built = nb.library_path()
    assert built.exists() and built.read_bytes() != junk
    assert not list(tmp_path.glob("tmp*"))          # no half-written file
