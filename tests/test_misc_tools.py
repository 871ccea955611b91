"""comp2graph, component-paths, antibody finder, supergraph builder."""

import numpy as np

from metafast_jax.cli import main
from metafast_jax.io import binfmt
from metafast_jax.utils.kmers import sequence_kmers

SEQ = "ACGGTCAGATTCAGGACTT"
K = 9


def _component_file(tmp_path):
    keys = np.unique(sequence_kmers(SEQ, K))
    cf = tmp_path / "comp.bin"
    binfmt.write_components_bin(str(cf), [(keys.astype(np.int64), 42)])
    return cf, keys


def test_comp2graph(tmp_path):
    cf, keys = _component_file(tmp_path)
    wd = tmp_path / "wd"
    assert main(["-t", "comp2graph", "-k", str(K), "-cf", str(cf),
                 "-w", str(wd)]) == 0
    gfa = (wd / "components-graph.gfa").read_text()
    s_lines = [l for l in gfa.splitlines() if l.startswith("S\t")]
    assert len(s_lines) == 1
    assert f"LN:i:{len(SEQ)}" in s_lines[0]


def test_component_paths(tmp_path):
    cf, keys = _component_file(tmp_path)
    fa = tmp_path / "seqs.fasta"
    # one sequence fully inside the component, one completely outside
    fa.write_text(f">a\n{SEQ}\n>b\nTTTTTTTTTTTTTTTT\n")
    wd = tmp_path / "wd"
    assert main(["-t", "component-paths", "-k", str(K), "-cf", str(cf),
                 "--seq", str(fa), "-a", "-l", "10", "-w", str(wd)]) == 0
    out = (wd / "paths" / "component-1.seq.fasta").read_text()
    body = [l for l in out.splitlines() if not l.startswith(">")]
    assert body == [SEQ]


def test_antibody_finder(tmp_path):
    frag = tmp_path / "frag.fasta"
    frag.write_text(f">frag\n{SEQ}\n")
    reads = tmp_path / "reads.fasta"
    reads.write_text(f">r1\n{SEQ}\n>r2\n{SEQ}\n>r3\n{SEQ}\n")
    wd = tmp_path / "wd"
    assert main(["-t", "antibody-sequences-finder", "-k", str(K),
                 "-d", "3", "--shift", "2", "-ff", str(frag),
                 "-i", str(reads), "-b", "1", "-w", str(wd)]) == 0
    assert (wd / "stat-b1").exists()
    assert (wd / "kmers").exists()


def test_supergraph_builder(tmp_path):
    reads = []
    for i in range(3):
        fp = tmp_path / f"s{i}.fasta"
        fp.write_text(f">r1\n{SEQ}\n>r2\n{SEQ}\n>r3\n{SEQ}\n")
        reads.append(str(fp))
    wd = tmp_path / "wd"
    assert main(["-t", "supergraph-sequence-builder", "-k", str(K),
                 "-i"] + reads + ["-sb", "2", "-l", str(K),
                 "-w", str(wd)]) == 0
    out = (wd / "sequences.fasta").read_text()
    body = [l for l in out.splitlines() if not l.startswith(">")]
    assert body and (body[0] == SEQ or
                     body[0] == SEQ.translate(str.maketrans("ACGT", "TGCA"))[::-1])


def test_comparison_script(tmp_path):
    cf, keys = _component_file(tmp_path)
    ref = tmp_path / "ref.fasta"
    ref.write_text(f">chr1\n{SEQ}\n")
    sam = tmp_path / "reads.sam"
    # samtools view format: qname flag rname pos mapq cigar ...
    sam.write_text("r1\t0\tchr1\t1\t60\t10M\t*\t0\t0\tSEQ\tQUAL\n")
    wd = tmp_path / "wd"
    assert main(["-t", "comparison-script", "-k", str(K), "-cf", str(cf),
                 "-r", str(ref), "-so", str(sam), "-w", str(wd)]) == 0
    text = (wd / "reference-to-component").read_text()
    assert text.startswith("chr1\n")
    assert (wd / "components-stat").exists()
