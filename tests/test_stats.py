"""Stats layer: chi²/MW primitives and the stats-kmers tools."""

import math

import numpy as np
import pytest

from metafast_jax.cli import main
from metafast_jax.io import binfmt
from metafast_jax.stats.tests import (_rankdata_rows, chi2_invcdf_df1,
                                      chi2_invcdf_df2, chisq_reference,
                                      mannwhitney_p_rows)


def test_chi2_inv_cdf_known_values():
    assert chi2_invcdf_df1(0.95) == pytest.approx(3.841458820694124, abs=1e-9)
    assert chi2_invcdf_df1(0.99) == pytest.approx(6.6348966010212145, abs=1e-9)
    assert chi2_invcdf_df2(0.95) == pytest.approx(5.991464547107979, abs=1e-12)


def test_rankdata_ties_averaged():
    x = np.array([[10.0, 20.0, 20.0, 30.0]])
    assert _rankdata_rows(x).tolist() == [[1.0, 2.5, 2.5, 4.0]]


def test_mannwhitney_commons_math_semantics():
    # disjoint groups: U_min = 0
    a = np.array([[1.0, 2.0, 3.0]])
    b = np.array([[4.0, 5.0, 6.0]])
    z = (0 - 4.5) / math.sqrt(3 * 3 * 7 / 12.0)
    want = 2 * 0.5 * (1 + math.erf(z / math.sqrt(2)))
    assert mannwhitney_p_rows(a, b)[0] == pytest.approx(want, abs=1e-12)
    # identical groups: p = 1 exactly under this approximation? U1=U2 -> z=0 -> p=1
    c = np.array([[1.0, 2.0, 3.0]])
    assert mannwhitney_p_rows(c, c)[0] == pytest.approx(1.0, abs=1e-12)


def test_chisq_direction():
    crit = chi2_invcdf_df1(0.95)
    assert chisq_reference([10], [0], [0], [10], crit)[0]
    assert not chisq_reference([5], [5], [5], [5], crit)[0]


def _write_sample(tmp_path, name, keys_counts):
    keys = np.array(sorted(keys_counts), dtype=np.int64)
    counts = np.array([keys_counts[k] for k in keys], dtype=np.int32)
    fp = tmp_path / f"{name}.kmers.bin"
    binfmt.write_kmers_bin(str(fp), keys, counts)
    return fp


@pytest.fixture()
def two_groups(tmp_path):
    # k-mer 100 strongly A-specific, k-mer 200 strongly B-specific,
    # k-mer 300 ubiquitous, k-mer 400 scarce
    a_files, b_files = [], []
    for i in range(6):
        a_files.append(_write_sample(
            tmp_path, f"a{i}", {100: 50 + i, 300: 5, **({400: 1} if i == 0 else {})}))
    for i in range(6):
        b_files.append(_write_sample(tmp_path, f"b{i}", {200: 40 + i, 300: 5}))
    return a_files, b_files


def test_stats_kmers_tool(tmp_path, two_groups):
    a_files, b_files = two_groups
    wd = tmp_path / "wd"
    args = (["-t", "stats-kmers", "-w", str(wd),
             "-A"] + [str(f) for f in a_files]
            + ["-B"] + [str(f) for f in b_files])
    assert main(args) == 0

    ka, va = binfmt.read_kmers_bin(str(wd / "kmers" / "filtered_groupA.kmers.bin"))
    kb, vb = binfmt.read_kmers_bin(str(wd / "kmers" / "filtered_groupB.kmers.bin"))
    assert 100 in ka.tolist()
    assert 200 in kb.tolist()
    # ubiquitous 300 and scarce 400 must be dropped
    assert 300 not in ka.tolist() + kb.tolist()
    assert 400 not in ka.tolist() + kb.tolist()
    # group means recorded as short-cast values
    assert (va > 0).all() and (vb > 0).all()


def test_stats_kmers3_tool(tmp_path):
    groups = {"A": 100, "B": 200, "C": 300}
    files = {}
    for g, marker in groups.items():
        files[g] = [
            _write_sample(tmp_path, f"{g.lower()}{i}",
                          {marker: 30 + i, 500: 4})
            for i in range(5)
        ]
    wd = tmp_path / "wd3"
    args = (["-t", "stats-kmers-3", "-w", str(wd)]
            + ["-A"] + [str(f) for f in files["A"]]
            + ["-B"] + [str(f) for f in files["B"]]
            + ["-C"] + [str(f) for f in files["C"]])
    assert main(args) == 0
    got = {}
    for g in ("A", "B", "C"):
        k, _ = binfmt.read_kmers_bin(
            str(wd / "kmers" / f"filtered_group{g}.kmers.bin"))
        got[g] = k.tolist()
    assert 100 in got["A"] and 200 in got["B"] and 300 in got["C"]
    assert all(500 not in v for v in got.values())
