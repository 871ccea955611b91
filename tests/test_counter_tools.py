"""kmers-grouped-counter, kmers-multiple-filters, bitset-stats-kmers-3.

Parity references: src/tools/KmersGroupedSamplesCounter.java,
src/tools/KmersMultipleFilters.java (+ IOUtils.MultipleFiltersAndPrintKmers,
src/io/IOUtils.java:125-161), src/tools/BitSetStatsKmers3GroupsFinder.java.
"""

import numpy as np

from metafast_jax.cli import main
from metafast_jax.io import binfmt
from metafast_jax.utils.kmers import kmers_strings


def _write_sample(tmp_path, name, table):
    keys = np.array(sorted(table), dtype=np.int64)
    counts = np.array([table[k] for k in sorted(table)], dtype=np.int16)
    f = tmp_path / f"{name}.kmers.bin"
    binfmt.write_kmers_bin(str(f), keys, counts)
    return f


def test_kmers_grouped_counter(tmp_path):
    k = 5
    # universe: 4 k-mers; per-group sample membership with b=1 threshold
    # (a sample only counts when its stored count is > 1)
    uni = _write_sample(tmp_path, "uni", {10: 3, 20: 3, 30: 3, 40: 3})
    cd = [_write_sample(tmp_path, "cd0", {10: 5, 20: 1}),
          _write_sample(tmp_path, "cd1", {10: 2})]
    uc = [_write_sample(tmp_path, "uc0", {20: 9, 40: 2})]
    ni = [_write_sample(tmp_path, "ni0", {99: 7})]   # outside the universe

    wd = tmp_path / "wd"
    args = (["-t", "kmers-grouped-counter", "-k", str(k), "-w", str(wd),
             "--kmers-file", str(uni),
             "--cd-kmers"] + [str(f) for f in cd]
            + ["--uc-kmers"] + [str(f) for f in uc]
            + ["--nonibd-kmers"] + [str(f) for f in ni])
    assert main(args) == 0

    out = (wd / "kmers" / "kmers.groups.txt").read_text().splitlines()
    assert out[0] == "Kmer\tcd_count\tuc_count\tnonibd_count"
    rows = {l.split("\t")[0]: tuple(map(int, l.split("\t")[1:]))
            for l in out[1:]}
    names = kmers_strings(np.array([10, 20, 30, 40], dtype=np.int64), k)
    # kmer 10: cd0 (5>1) + cd1 (2>1) -> cd=2; kmer 20: cd0 has 1 (not >1),
    # uc0 has 9 -> uc=1; kmer 40: uc0 has 2 -> uc=1; nonibd never matches
    assert rows[names[0]] == (2, 0, 0)
    assert rows[names[1]] == (0, 1, 0)
    assert rows[names[2]] == (0, 0, 0)
    assert rows[names[3]] == (0, 1, 0)
    assert len(rows) == 4


def test_kmers_multiple_filters(tmp_path):
    k = 5
    sample = _write_sample(tmp_path, "s", {10: 5, 20: 4, 30: 3, 40: 1})
    cdf = _write_sample(tmp_path, "cdf", {10: 2})
    ucf = _write_sample(tmp_path, "ucf", {10: 7, 20: 1})
    nif = _write_sample(tmp_path, "nif", {50: 3})

    wd = tmp_path / "wd"
    args = ["-t", "kmers-multiple-filters", "-k", str(k), "-w", str(wd),
            "-i", str(sample), "--cd-filter-kmers", str(cdf),
            "--uc-filter-kmers", str(ucf), "--nonibd-filter-kmers", str(nif),
            "-b", "1"]
    assert main(args) == 0

    # only k-mers with count > 1 that hit >= 1 filter survive: 10 and 20
    keys, counts = binfmt.read_kmers_bin(str(wd / "kmers" / "s.kmers.bin"))
    assert keys.tolist() == [10, 20]
    assert counts.tolist() == [5, 4]

    # stat file counts (cd, uc, nonibd) triples over all >b k-mers,
    # including the all-zero triple for k-mer 30
    st = (wd / "stats" / "s.stat.txt").read_text().splitlines()
    assert st[0].startswith("# cd k-mer samples")
    triples = {tuple(map(int, l.split("\t")[:3])): int(l.split("\t")[3])
               for l in st[1:] if l}
    assert triples == {(0, 0, 0): 1, (2, 7, 0): 1, (0, 1, 0): 1}


def test_bitset_stats_kmers_3_matches_stats_kmers_3(tmp_path):
    # the reference's BitSet-backed variant is semantically identical to
    # stats-kmers-3 (different hash-map value representation only)
    files = {}
    for g, marker in (("A", 100), ("B", 200), ("C", 300)):
        files[g] = [
            _write_sample(tmp_path, f"{g.lower()}{i}", {marker: 30 + i, 500: 4})
            for i in range(5)
        ]
    outs = {}
    for tool, wdn in (("stats-kmers-3", "wd_ref"), ("bitset-stats-kmers-3", "wd_bs")):
        wd = tmp_path / wdn
        args = (["-t", tool, "-w", str(wd)]
                + ["-A"] + [str(f) for f in files["A"]]
                + ["-B"] + [str(f) for f in files["B"]]
                + ["-C"] + [str(f) for f in files["C"]])
        assert main(args) == 0
        got = {}
        for g in ("A", "B", "C"):
            kk, vv = binfmt.read_kmers_bin(
                str(wd / "kmers" / f"filtered_group{g}.kmers.bin"))
            got[g] = (kk.tolist(), vv.tolist())
        outs[tool] = got
    assert outs["stats-kmers-3"] == outs["bitset-stats-kmers-3"]
    assert 100 in outs["bitset-stats-kmers-3"]["A"][0]
