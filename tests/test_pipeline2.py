"""Pipeline 2/5 composites + colored + counter tools, driven via the CLI."""

import numpy as np
import pytest

from metafast_jax.cli import main
from metafast_jax.graph import colored as col
from metafast_jax.io import binfmt


def test_colored_ops_pack_roundtrip():
    v = np.zeros(4, dtype=np.int64)
    v = col.add_value(v, 0, [1, 2, 3, 4])
    v = col.add_value(v, 2, [10, 0, 0, 0])
    assert col.get_value(v, 0).tolist() == [1, 2, 3, 4]
    assert col.get_value(v, 2).tolist() == [10, 0, 0, 0]
    # saturation at 2^20-1
    v = col.add_value(v, 0, [col.COLOR_MAX] * 4)
    assert col.get_value(v, 0).tolist() == [col.COLOR_MAX] * 4


def test_colored_get_color():
    v = np.zeros(3, dtype=np.int64)
    v = col.add_value(v, 0, [9, 1, 5])
    v = col.add_value(v, 1, [1, 9, 5])
    c = col.get_color(v, 0.9)
    assert c.tolist() == [0, 1, -1]


def test_kmers_color_and_components(tmp_path):
    # two samples in class 0, one in class 1, sharing disjoint k-mer sets
    keyset = {
        "s0a": {100: 5, 104: 6},
        "s0b": {100: 7, 104: 2},
        "s1a": {200: 9, 204: 3},
    }
    files = []
    lines = []
    for name, kc in keyset.items():
        fp = tmp_path / f"{name}.kmers.bin"
        ks = np.array(sorted(kc), dtype=np.int64)
        binfmt.write_kmers_bin(str(fp), ks,
                               np.array([kc[x] for x in ks], dtype=np.int32))
        files.append(str(fp))
        lines.append(f"{name}\t{0 if name.startswith('s0') else 1}")
    cls = tmp_path / "classes.tsv"
    cls.write_text("\n".join(lines) + "\n")

    wd = tmp_path / "wd"
    assert main(["-t", "kmers-color", "-k", "5", "-kf"] + files
                + ["--class", str(cls), "-w", str(wd)]) == 0
    ck = wd / "colored-kmers" / "colored_kmers.kmers.bin"
    keys, vals = binfmt.read_long_kmers_bin(str(ck))
    assert set(keys.tolist()) == {100, 104, 200, 204}
    colors = col.get_color(vals, 0.9)
    by_key = dict(zip(keys.tolist(), colors.tolist()))
    assert by_key[100] == 0 and by_key[200] == 1

    wd2 = tmp_path / "wd2"
    assert main(["-t", "component-colored", "-k", "5", "-i", str(ck),
                 "-w", str(wd2)]) == 0
    assert (wd2 / "components-stat.txt").exists()


def test_kmers_samples_counter(tmp_path):
    files = []
    for i, kc in enumerate([{10: 5}, {10: 3, 20: 9}]):
        fp = tmp_path / f"x{i}.kmers.bin"
        ks = np.array(sorted(kc), dtype=np.int64)
        binfmt.write_kmers_bin(str(fp), ks,
                               np.array([kc[x] for x in ks], dtype=np.int32))
        files.append(str(fp))
    wd = tmp_path / "wd"
    assert main(["-t", "kmers-samples-counter", "-k", "5",
                 "-i"] + files + ["-w", str(wd)]) == 0
    keys, counts = binfmt.read_kmers_bin(str(wd / "kmers" / "n_samples.kmers.bin"))
    assert dict(zip(keys.tolist(), counts.tolist())) == {10: 2, 20: 1}


def test_kmers_per_sample(tmp_path):
    files = []
    for i, kc in enumerate([{10: 5, 20: 1}, {10: 3}]):
        fp = tmp_path / f"y{i}.kmers.bin"
        ks = np.array(sorted(kc), dtype=np.int64)
        binfmt.write_kmers_bin(str(fp), ks,
                               np.array([kc[x] for x in ks], dtype=np.int32))
        files.append(str(fp))
    wd = tmp_path / "wd"
    assert main(["-t", "kmers-per-sample", "-k", "5", "-i"] + files
                + ["-perc", "100", "-w", str(wd)]) == 0
    text = (wd / "kmers" / "selected_kmers_100.txt").read_text()
    rows = text.strip().split("\n")
    assert len(rows) == 3          # header + 2 samples
    assert rows[1].startswith("y0\t5")


def test_unique_features_end_to_end(tmp_path, ref_data):
    wd = tmp_path / "wd"
    rc = main(["-t", "unique-features", "-k", "31",
               "-pos", str(ref_data / "meta_test_1.fa"),
               "-neg", str(ref_data / "meta_test_2.fa"),
               "-w", str(wd)])
    assert rc == 0
    assert (wd / "component-extractor" / "components.bin").exists()
    vecs = list((wd / "features-calculator" / "vectors").glob("*.vec"))
    assert vecs


def test_stats_features_end_to_end(tmp_path, ref_data):
    wd = tmp_path / "wd"
    rc = main(["-t", "stats-features", "-k", "31",
               "-pos", str(ref_data / "meta_test_1.fa"),
                       str(ref_data / "meta_test_3.fa"),
               "-neg", str(ref_data / "meta_test_2.fa"),
               "-pmw", "0.5",
               "-w", str(wd)])
    assert rc == 0
    assert (wd / "kmer-counter-posneg" / "pos" / "kmers").exists()
    assert (wd / "stats-kmers" / "kmers" / "filtered_groupA.kmers.bin").exists()
