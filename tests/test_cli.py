"""CLI end-to-end: matrix-builder on the golden fixtures + resume."""

import glob

import pytest

from metafast_jax.cli import main


@pytest.fixture(scope="module")
def workdir(tmp_path_factory, ref_data):
    wd = tmp_path_factory.mktemp("cli_wd")
    args = ["-k", "31",
            "-i", str(ref_data / "meta_test_1.fa"),
                  str(ref_data / "meta_test_2.fa"),
                  str(ref_data / "meta_test_3.fa"),
            "-w", str(wd)]
    assert main(args) == 0
    return wd, args


def test_matrix_golden(workdir):
    wd, _ = workdir
    (orig,) = glob.glob(str(wd / "matrices" / "*_original_order.txt"))
    text = open(orig).read()
    assert "0.5691" in text and "0.2981" in text and "0.8448" in text
    assert text.startswith("#\tmeta_test_1\tmeta_test_2\tmeta_test_3")


def test_heatmap_written(workdir):
    wd, _ = workdir
    assert glob.glob(str(wd / "matrices" / "*_heatmap.png"))
    assert glob.glob(str(wd / "matrices" / "*_heatmap.svg"))


def test_renumbered_matrix_matches_reference_order(workdir):
    wd, _ = workdir
    files = [f for f in glob.glob(str(wd / "matrices" / "*.txt"))
             if "original_order" not in f]
    assert files
    head = open(files[0]).readline().strip()
    # reference golden file (test_data/meta_test_matrix.txt) uses this order
    assert head == "#\tmeta_test_1\tmeta_test_3\tmeta_test_2"


def test_artifacts_layout(workdir):
    wd, _ = workdir
    assert (wd / "kmer-counter-many" / "kmers" / "meta_test_1.kmers.bin").exists()
    assert (wd / "kmer-counter-many" / "stats" / "meta_test_1.stat.txt").exists()
    assert (wd / "seq-builder-many" / "sequences" / "meta_test_1.seq.fasta").exists()
    assert (wd / "component-cutter" / "components.bin").exists()
    assert (wd / "features-calculator" / "vectors" / "meta_test_2.vec").exists()
    assert (wd / "output_description.txt").exists()
    assert (wd / "log").exists()


def test_continue_skips_everything(workdir, capsys, caplog):
    import logging
    wd, args = workdir
    with caplog.at_level(logging.INFO, logger="metafast"):
        assert main(args + ["--continue"]) == 0
    skipped = [r for r in caplog.records if "skipped" in r.getMessage()]
    assert len(skipped) >= 6


def test_tools_listing(capsys):
    assert main(["--tools"]) == 0
    out = capsys.readouterr().out
    for t in ("matrix-builder", "kmer-counter", "seq-builder",
              "component-cutter", "features-calculator",
              "dist-matrix-calculator", "heatmap-maker"):
        assert t in out


def test_tool_help(capsys):
    assert main(["-t", "kmer-counter", "-h"]) == 0
    out = capsys.readouterr().out
    assert "--maximal-bad-frequency" in out


def test_rerun_without_flags_refuses(workdir, caplog):
    """Parity: interactive 'rewrite workDir?' guard (Tool.java:407-433),
    flag-based: a workdir with prior state needs --continue or --force."""
    import logging
    wd, args = workdir
    with caplog.at_level(logging.ERROR, logger="metafast"):
        assert main(args) == 1
    assert any("previous run" in r.getMessage() for r in caplog.records)
    # --force overwrites; state must still be intact afterwards for the
    # other module-scoped tests, so use --continue here instead
    assert main(args + ["--continue"]) == 0


def test_unknown_option_errors(tmp_path, ref_data, caplog):
    """A typo'd option must error, not warn-and-run with defaults."""
    import logging
    args = ["-t", "kmer-counter", "-k", "31",
            "-i", str(ref_data / "meta_test_2.fa"),
            "-w", str(tmp_path / "wd"),
            "--mim-seq-len", "100"]
    with caplog.at_level(logging.ERROR, logger="metafast"):
        assert main(args) == 1
    assert any("unknown option" in r.getMessage() for r in caplog.records)


def test_oom_maps_to_advice(tmp_path, monkeypatch, caplog):
    import logging
    from metafast_jax.tools import framework as fw

    class Boom(fw.get_tool("view")):
        def run_impl(self):
            raise MemoryError

    monkeypatch.setitem(fw._REGISTRY, "view", Boom)
    with caplog.at_level(logging.ERROR, logger="metafast"):
        rc = main(["-t", "view", "-k", "5", "-kf", "/nonexistent",
                   "-w", str(tmp_path / "wd")])
    assert rc == 1
    assert any("--shards" in r.getMessage() for r in caplog.records)


def test_uncaught_exception_is_concise(tmp_path, monkeypatch, caplog):
    import logging
    from metafast_jax.tools import framework as fw

    class Boom(fw.get_tool("view")):
        def run_impl(self):
            raise RuntimeError("kaboom")

    monkeypatch.setitem(fw._REGISTRY, "view", Boom)
    with caplog.at_level(logging.ERROR, logger="metafast"):
        rc = main(["-t", "view", "-k", "5", "-kf", "/nonexistent",
                   "-w", str(tmp_path / "wd")])
    assert rc == 1
    assert any("bug" in r.getMessage() for r in caplog.records)


def test_start_implies_resume_and_reruns_named_step(workdir, caplog):
    """--start NAME alone must pass the prior-state guard (it inherently
    resumes) and must RE-RUN the named step even if its manifest is up to
    date (starting *from* a step is a request to run it)."""
    import logging
    wd, args = workdir
    with caplog.at_level(logging.INFO, logger="metafast"):
        assert main(args + ["--start", "dist-matrix-calculator"]) == 0
    msgs = [r.getMessage() for r in caplog.records]
    # earlier steps skipped as "before --start", the named one ran
    assert any("skipped (before --start)" in m for m in msgs)
    assert any(m == "started" and r.name.endswith("dist-matrix-calculator")
               for r, m in zip(caplog.records, msgs)) or \
        not any("dist-matrix-calculator] up to date" in m for m in msgs)
