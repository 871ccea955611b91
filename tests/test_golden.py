"""Golden end-to-end runs on seeded in-repo data: the matrix-builder CLI
against the pure-Python oracle (oracle.reference.matrix_pipeline).

The data are three one-genome samples (a backbone common to all, a
segment two of them share, the rest their own) as 150 bp reads at ~10x,
made from a fixed seed by chip_smoke.make_small; the component window is
scaled down with the genomes.
"""

import sys

import pytest

import chip_smoke


@pytest.mark.parametrize("k", [15, 23, 31])
def test_cli_matches_oracle(tmp_path, k):
    chip_smoke.oracle_parity(tmp_path, k=k, b1=100, b2=1000,
                             parts=(2000, 1500, 2500))


def test_matrix_builder_without_matplotlib(tmp_path, monkeypatch):
    """The default pipeline, heatmap included, needs no plotting
    library."""
    import glob

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    import numpy as np

    files, _ = chip_smoke.make_small(np.random.default_rng(2), tmp_path,
                                     (2000, 1500, 2500))
    wd = tmp_path / "wd"
    chip_smoke.run_cli(files, wd, ("-b1", "100", "-b2", "1000"))
    assert glob.glob(str(wd / "matrices" / "*_heatmap.png"))
    assert glob.glob(str(wd / "matrices" / "*_heatmap.svg"))


def test_step_times_from_the_run_log(tmp_path):
    """chip_smoke reads per-step wall times back from the CLI's log:
    every step once per run of it, nested steps inside their parent."""
    log = tmp_path / "log"
    log.write_text(
        "2026-01-01 00:00:00,000 INFO  [matrix-builder] started\n"
        "2026-01-01 00:00:00,500 INFO  [kmer-counter-many] started\n"
        "2026-01-01 00:00:01,000 INFO  [kmer-counter] started\n"
        "2026-01-01 00:00:01,250 INFO  [kmer-counter] 10 k-mers found\n"
        "2026-01-01 00:00:03,000 INFO  [kmer-counter] done in 2.0s\n"
        "2026-01-01 00:00:03,000 INFO  [kmer-counter] started\n"
        "2026-01-01 00:00:03,125 INFO  [kmer-counter] done in 0.1s\n"
        "2026-01-01 00:00:04,000 INFO  [kmer-counter-many] done in 3.5s\n"
        "2026-01-01 00:00:10,000 INFO  [matrix-builder] done in 10.0s\n")
    assert chip_smoke.step_times(log) == [
        ("kmer-counter", 2.0), ("kmer-counter", 0.125),
        ("kmer-counter-many", 3.5), ("matrix-builder", 10.0)]
