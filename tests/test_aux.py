"""Aux subsystems: progress, GUI wizard, distributed helpers."""

import io

import numpy as np

from metafast_jax.gui import run_wizard
from metafast_jax.utils.progress import Progress, memory_used_str


def test_progress_line():
    buf = io.StringIO()
    p = Progress(total=100, prefix="reads", stream=buf, min_interval=0,
                 enabled=True)
    p.update(add=50)
    p.update(add=25)
    p.close("done")
    out = buf.getvalue()
    assert "50" in out and "75.0%" in out and "ETA" in out
    assert out.endswith("done\n")


def test_progress_disabled_on_non_tty():
    buf = io.StringIO()
    p = Progress(total=10, stream=buf)   # StringIO.isatty() is False
    p.update(add=5)
    p.close()
    assert buf.getvalue() == ""


def test_memory_used_str():
    s = memory_used_str()
    assert s.endswith("MB") or s.endswith("GB")


def test_wizard_builds_command_without_running():
    inputs = iter(["view", "5", "", "", "", "", "", "n"])
    outs = []
    rc = run_wizard(input_fn=lambda prompt: next(inputs),
                    print_fn=lambda *a: outs.append(" ".join(map(str, a))))
    assert rc == 0
    cmd = [o for o in outs if "Command:" in o]
    assert cmd and "-t view" in cmd[0]


def test_wizard_runs_tool(tmp_path):
    from metafast_jax.io import binfmt
    fp = tmp_path / "x.kmers.bin"
    binfmt.write_kmers_bin(str(fp), np.array([5], dtype=np.int64),
                           np.array([3], dtype=np.int32))
    out = tmp_path / "out.txt"
    # tool=view, k=5, kmers-file, components-file skip, output-file, long skip
    inputs = iter(["view", "5", str(fp), "", str(out), "",
                   str(tmp_path / "wd"), "y"])
    rc = run_wizard(input_fn=lambda prompt: next(inputs),
                    print_fn=lambda *a: None)
    assert rc == 0
    assert out.read_text().startswith("Kmer\tCount")


def test_per_host_files():
    from metafast_jax.parallel.distributed import per_host_files
    files = ["a", "b", "c", "d", "e"]
    assert per_host_files(files, 0, 2) == ["a", "c", "e"]
    assert per_host_files(files, 1, 2) == ["b", "d"]


def test_counting_progress_logs_periodically(caplog):
    import io
    import logging
    from metafast_jax.utils.progress import CountingProgress, Progress

    logger = logging.getLogger("test_counting_progress")
    line = Progress(None, stream=io.StringIO(), enabled=True)
    with caplog.at_level(logging.INFO, logger=logger.name):
        with CountingProgress(logger=logger, every_reads=100,
                              line=line) as cp:
            for r in (50, 120, 130, 310):
                cp(dict(path="x.fa", reads=r, kmers=r * 60))
    msgs = [rec.getMessage() for rec in caplog.records]
    # 120 crosses the 100 mark, 310 crosses 200/300; 130 must not re-log
    assert len(msgs) == 2
    assert "120" in msgs[0] and "310" in msgs[1]


def test_counting_progress_wired_into_counter_tool(tmp_path, ref_data, caplog):
    """The kmer-counter CLI tool reports periodic progress."""
    import logging
    from unittest import mock
    from metafast_jax.cli import main
    from metafast_jax.utils import progress as prog_mod

    calls = []
    orig = prog_mod.CountingProgress.__call__

    def spy(self, info):
        calls.append(info)
        return orig(self, info)

    with mock.patch.object(prog_mod.CountingProgress, "__call__", spy):
        assert main(["-t", "kmer-counter", "-k", "31",
                     "-i", str(ref_data / "meta_test_2.fa"),
                     "-w", str(tmp_path / "wd")]) == 0
    assert calls and calls[-1]["reads"] > 0 and calls[-1]["kmers"] > 0
