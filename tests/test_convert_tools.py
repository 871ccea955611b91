"""Converter tools: view, double-view, bin2fasta, seq2comp, comp2seq."""

import numpy as np
import pytest

from metafast_jax.cli import main
from metafast_jax.io import binfmt
from metafast_jax.oracle import reference as oracle
from metafast_jax.utils.kmers import kmer_string, kmers_strings, sequence_kmers


def test_kmer_string_matches_oracle():
    rng = np.random.default_rng(0)
    for k in (1, 5, 31):
        keys = rng.integers(0, 1 << (2 * k), 20, dtype=np.int64)
        assert kmers_strings(keys, k) == [oracle.kmer_string(int(x), k)
                                          for x in keys]


def test_sequence_kmers_matches_oracle():
    seq = "ACGTACGGTACGGATCGGATAAT"
    for k in (3, 11, 21):
        got = sequence_kmers(seq, k)
        codes = oracle.encode_seq(seq)
        want = oracle.canonical_kmers(codes, k)
        assert got.tolist() == want


@pytest.fixture()
def kmers_bin(tmp_path):
    keys = np.array([1, 5, 9, 100], dtype=np.int64)
    counts = np.array([3, 7, 2, 9], dtype=np.int32)
    fp = tmp_path / "x.kmers.bin"
    binfmt.write_kmers_bin(str(fp), keys, counts)
    return fp, keys, counts


def test_view_kmers(tmp_path, kmers_bin):
    fp, keys, counts = kmers_bin
    out = tmp_path / "view.txt"
    assert main(["-t", "view", "-k", "5", "-kf", str(fp), "-o", str(out),
                 "-w", str(tmp_path / "wd")]) == 0
    lines = out.read_text().strip().split("\n")
    assert lines[0] == "Kmer\tCount"
    assert lines[1] == f"{kmer_string(1, 5)}\t3"
    assert len(lines) == 5


def test_double_view(tmp_path, kmers_bin):
    fp, keys, counts = kmers_bin
    fp2 = tmp_path / "y.kmers.bin"
    binfmt.write_kmers_bin(str(fp2), np.array([5, 100], dtype=np.int64),
                           np.array([4, 1], dtype=np.int32))
    out = tmp_path / "dv.txt"
    assert main(["-t", "double-view", "-k", "5", "-mtx", str(fp),
                 "-mgx", str(fp2), "-o", str(out),
                 "-w", str(tmp_path / "wd")]) == 0
    lines = out.read_text().strip().split("\n")
    assert lines[0] == "Kmer\tmtx_count\tmgx_count"
    assert lines[2].endswith("\t7\t4")   # key 5 present in both


def test_bin2fasta_kmers(tmp_path, kmers_bin):
    fp, keys, counts = kmers_bin
    prefix = tmp_path / "out" / "kmers"
    assert main(["-t", "bin2fasta", "-k", "5", "-kf", str(fp),
                 "-o", str(prefix), "-w", str(tmp_path / "wd")]) == 0
    text = (tmp_path / "out" / "kmers.fasta").read_text()
    assert text.startswith(">1\n" + kmer_string(1, 5))


def test_seq2comp_and_view_components(tmp_path):
    fa = tmp_path / "seqs.fasta"
    fa.write_text(">a\nACGTACGTAG\n>b\nTTTTTTTT\n")
    wd = tmp_path / "wd"
    assert main(["-t", "seq2comp", "-k", "5", "-i", str(fa),
                 "-w", str(wd)]) == 0
    comps = binfmt.read_components_bin(str(wd / "components.bin"))
    assert len(comps) == 2
    kmers0, weight0 = comps[0]
    assert weight0 == 6           # 10 - 5 + 1 occurrences
    # poly-T: all windows canonicalize to poly-A key 0
    kmers1, weight1 = comps[1]
    assert kmers1.tolist() == [0] and weight1 == 4


def test_comp2seq_roundtrip(tmp_path):
    # a component whose k-mers form one unambiguous path
    seq = "ACGGTCAGATTCAG"
    k = 5
    keys = np.unique(sequence_kmers(seq, k))
    cf = tmp_path / "comp.bin"
    binfmt.write_components_bin(str(cf), [(keys.astype(np.int64), 10)])
    wd = tmp_path / "wd"
    assert main(["-t", "comp2seq", "-k", str(k), "-cf", str(cf),
                 "-w", str(wd)]) == 0
    fastas = list((wd / "seq-builder-many" / "sequences").glob("*.seq.fasta"))
    assert fastas
    seqs = [ln for ln in fastas[0].read_text().split("\n")
            if ln and not ln.startswith(">")]
    # the rebuilt sequence covers the same canonical k-mer set
    got = set()
    for s in seqs:
        got.update(sequence_kmers(s, k).tolist())
    assert got == set(keys.tolist())
