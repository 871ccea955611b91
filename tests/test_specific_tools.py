"""specific-kmers, top-stats-kmers, subset-specific tools."""

import numpy as np

from metafast_jax.cli import main
from metafast_jax.io import binfmt


def _write(tmp_path, name, kc):
    fp = tmp_path / f"{name}.kmers.bin"
    ks = np.array(sorted(kc), dtype=np.int64)
    binfmt.write_kmers_bin(str(fp), ks,
                           np.array([kc[x] for x in ks], dtype=np.int32))
    return str(fp)


def test_specific_kmers(tmp_path):
    # k-mer 100: high in all A, absent in B (strongly A-specific)
    # k-mer 300: equal everywhere (never significant)
    a = [_write(tmp_path, f"a{i}", {100: 30 + i, 300: 5}) for i in range(6)]
    b = [_write(tmp_path, f"b{i}", {200: 20 + i, 300: 5}) for i in range(6)]
    wd = tmp_path / "wd"
    assert main(["-t", "specific-kmers", "-w", str(wd),
                 "-A"] + a + ["-B"] + b) == 0
    ka, va = binfmt.read_kmers_bin(str(wd / "kmers" / "filtered_groupA.kmers.bin"))
    kb, vb = binfmt.read_kmers_bin(str(wd / "kmers" / "filtered_groupB.kmers.bin"))
    assert 100 in ka.tolist()
    assert 200 in kb.tolist()
    # group value is the raw mean frequency as a short
    assert va[ka.tolist().index(100)] == int(np.mean([30 + i for i in range(6)]))


def test_specific_kmers_3(tmp_path):
    a = [_write(tmp_path, f"3a{i}", {100: 30, 500: 9}) for i in range(5)]
    b = [_write(tmp_path, f"3b{i}", {200: 30, 500: 9}) for i in range(5)]
    c = [_write(tmp_path, f"3c{i}", {300: 30, 500: 9}) for i in range(5)]
    wd = tmp_path / "wd"
    assert main(["-t", "specific-kmers-3", "-w", str(wd),
                 "-A"] + a + ["-B"] + b + ["-C"] + c) == 0
    got = {}
    for g in "ABC":
        k, _ = binfmt.read_kmers_bin(
            str(wd / "kmers" / f"filtered_group{g}.kmers.bin"))
        got[g] = k.tolist()
    assert 100 in got["A"] and 200 in got["B"] and 300 in got["C"]


def test_top_stats_and_subset(tmp_path):
    # 100 perfectly A-specific (highest statistic), 150 mildly specific
    a = [_write(tmp_path, f"ta{i}",
                {100: 9, **({150: 9} if i < 5 else {}), 400: 9})
         for i in range(6)]
    b = [_write(tmp_path, f"tb{i}",
                {200: 9, **({150: 9} if i < 2 else {}), 400: 9})
         for i in range(6)]
    wd = tmp_path / "wd"
    assert main(["-t", "top-stats-kmers", "-n", "2",
                 "-w", str(wd), "-A"] + a + ["-B"] + b) == 0
    topk, _ = binfmt.read_kmers_bin(
        str(wd / "kmers" / "top_2_chi_squared_specific.kmers.bin"))
    assert len(topk) == 2
    assert 100 in topk.tolist() or 200 in topk.tolist()

    allf = wd / "kmers" / "all.kmers.bin"
    ranks = wd / "kmers" / "all_chi_squared_ranks.bin"
    wd2 = tmp_path / "wd2"
    assert main(["-t", "subset-specific", "-i", str(allf), "-rk", str(ranks),
                 "-n", "1", "-w", str(wd2)]) == 0
    outs = list((wd2 / "kmers").glob("*_top_1.kmers.bin"))
    assert outs
    k1, _ = binfmt.read_kmers_bin(str(outs[0]))
    assert len(k1) == 1
