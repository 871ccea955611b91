"""Paired-end grouping (io/reads.sort_and_pair) and UPGMA semantics.

The _R1/_R2 pairing rules (src/tools/KmersCounterForManyFilesMain.java:
74-108) and the UPGMA leaf-order / tie-break semantics
(src/algo/FullHeatMap.java:221-308): a pairing bug would silently merge
or split samples and corrupt every downstream vector.
"""

import numpy as np
import pytest

from metafast_jax.io.reads import sample_name, sort_and_pair
from metafast_jax.viz.heatmap import upgma_order, upgma_tree


# ---------------------------------------------------------------- pairing

def test_adjacent_r1_r2_pair(tmp_path):
    a = str(tmp_path / "samp_R1.fastq")
    b = str(tmp_path / "samp_R2.fastq")
    groups = sort_and_pair([b, a])           # order-insensitive (sorted)
    assert groups == [[a, b]]
    assert sample_name(groups[0]) == "samp"


def test_lowercase_pair_and_name(tmp_path):
    a = str(tmp_path / "x_r1.fa")
    b = str(tmp_path / "x_r2.fa")
    assert sort_and_pair([a, b]) == [[a, b]]
    assert sample_name([a, b]) == "x"


def test_mixed_case_does_not_pair(tmp_path):
    # reference requires matching case: _r1+_r2 or _R1+_R2, never _r1+_R2
    a = str(tmp_path / "x_r1.fa")
    b = str(tmp_path / "x_R2.fa")
    g = sort_and_pair([a, b])
    assert g == [[b], [a]] or g == [[a], [b]]
    assert all(len(x) == 1 for x in g)


def test_unpaired_leftovers(tmp_path):
    files = [str(tmp_path / n) for n in
             ["a_R1.fq", "a_R2.fq", "b.fq", "c_R1.fq", "d_R2.fq"]]
    g = sort_and_pair(files)
    # reference quirk, preserved for parity: ANY adjacent _R1/_R2 pair,
    # prefixes are NOT compared (KmersCounterForManyFilesMain.java:82-83)
    # — so c_R1 pairs with d_R2
    assert g == [[files[0], files[1]], [files[2]], [files[3], files[4]]]
    assert sample_name(g[2]) == "c"


def test_lone_r2_then_r1_not_paired(tmp_path):
    # _R2 sorting before _R1 (different prefixes) must not pair: the rule
    # is strictly (ends _R1, next ends _R2)
    files = sorted(str(tmp_path / n) for n in ["a_R2.fq", "b_R1.fq"])
    g = sort_and_pair(files)
    assert all(len(x) == 1 for x in g)


def test_r1_only_groups_alone(tmp_path):
    a = str(tmp_path / "x_R1.fa")
    assert sort_and_pair([a]) == [[a]]
    assert sample_name([a]) == "x_R1"


def test_nonadjacent_same_prefix_not_paired(tmp_path):
    # an intervening file breaks adjacency after sorting
    files = sorted(str(tmp_path / n) for n in
                   ["s_R1.fq", "s_R15.fq", "s_R2.fq"])
    g = sort_and_pair(files)
    # sorted order: s_R1.fq < s_R15.fq < s_R2.fq — library names are
    # s_R1, s_R15, s_R2; s_R1 is not adjacent to s_R2
    assert all(len(x) == 1 for x in g)


def test_paired_end_kmer_counter_end_to_end(tmp_path):
    """kmer-counter-many on an _R1/_R2 pair produces ONE library whose
    counts equal both files counted together (seeded mates: the two
    reads of each pair come from one genome, 250 bp apart)."""
    from metafast_jax import api
    from metafast_jax.cli import main
    from metafast_jax.io import binfmt
    from metafast_jax.oracle import synth

    rng = np.random.default_rng(4)
    genome = synth.random_genome(rng, 5000)
    starts = rng.integers(0, 5000 - 400, 300)
    pos = np.arange(100)
    mate1 = genome[starts[:, None] + pos]
    mate2 = 3 - genome[starts[:, None] + 300 + pos][:, ::-1]
    r1 = tmp_path / "tiny_R1.fastq"
    r2 = tmp_path / "tiny_R2.fastq"
    synth.write_fastq(r1, mate1)
    synth.write_fastq(r2, mate2)
    wd = tmp_path / "wd"
    assert main(["-t", "kmer-counter-many", "-k", "15",
                 "-i", str(r1), str(r2), "-w", str(wd)]) == 0
    out = sorted((wd / "kmers").glob("*.kmers.bin"))
    assert [p.name for p in out] == ["tiny.kmers.bin"]
    keys, counts = binfmt.read_kmers_bin(str(out[0]))
    wkeys, wcounts, _ = api.count_reads_files([str(r1), str(r2)], 15)
    good = wcounts > 1                      # default b=1 threshold
    assert np.array_equal(keys, wkeys[good])
    assert np.array_equal(counts, wcounts[good])


# ----------------------------------------------------------------- UPGMA

def test_upgma_order_on_golden_matrix():
    """Leaf order for the bundled meta_test matrix: min pair is
    (meta_test_1, meta_test_3) at 0.2981, then the root — so the
    dendrogram (and meta_test_heatmap.png) lists 1, 3, 2."""
    d = np.array([
        [0.0000, 0.5691, 0.2981],
        [0.5691, 0.0000, 0.8448],
        [0.2981, 0.8448, 0.0000],
    ])
    assert upgma_order(d) == [0, 2, 1]


def test_upgma_tie_break_first_in_scan_order():
    """Equal minima resolve to the FIRST (i, j) in row-major scan order
    (FullHeatMap.clusterObjects uses strict '<', so the first minimum
    encountered wins): with d01 == d02, (0,1) must merge first."""
    d = np.array([
        [0.0, 0.1, 0.1],
        [0.1, 0.0, 0.9],
        [0.1, 0.9, 0.0],
    ])
    assert upgma_order(d) == [0, 1, 2]      # NOT [0, 2, 1]


def test_upgma_average_linkage_heights():
    """Group distance is the plain average over all cross pairs
    (distanceBetweenGroups :297-308) — not single/complete linkage."""
    d = np.array([
        [0.0, 0.2, 0.6, 0.8],
        [0.2, 0.0, 0.4, 0.9],
        [0.6, 0.4, 0.0, 0.3],
        [0.8, 0.9, 0.3, 0.0],
    ])
    root = upgma_tree(d)
    # merges: (0,1)@0.2, (2,3)@0.3, then root @ mean(0.6,0.8,0.4,0.9)
    assert root.distance == pytest.approx((0.6 + 0.8 + 0.4 + 0.9) / 4)
    order = upgma_order(d)
    assert order == [0, 1, 2, 3]


def test_upgma_trivial_sizes():
    assert upgma_order(np.zeros((0, 0))) == []
    assert upgma_order(np.zeros((1, 1))) == [0]
    assert upgma_order(np.array([[0.0, 0.5], [0.5, 0.0]])) == [0, 1]
