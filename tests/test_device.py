"""Where work runs: the routing helper, the GPU algorithms it selects
(run here on the CPU), the compile-cache placement, and chip_smoke.py's
refusal to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from metafast_jax.utils import device

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("platform,size,threshold,want", [
    ("gpu", 1 << 21, 1 << 21, True),
    ("gpu", (1 << 21) - 1, 1 << 21, False),
    ("gpu", 0, 0, True),
    ("cpu", 1 << 30, 1, False),
])
def test_gpu_path_choice(monkeypatch, platform, size, threshold, want):
    monkeypatch.setattr(device, "platform", lambda: platform)
    assert device.gpu_path(size, threshold) is want


def test_gpu_algorithms_match_cpu_pipeline(tmp_path, monkeypatch):
    """With every threshold at 0 and the platform reported as a GPU, the
    pipeline takes splitter-walk ranking and the device feature and pivot
    joins — and computes exactly what the CPU algorithms compute."""
    import chip_smoke
    from metafast_jax.graph import contigs, pivot
    from metafast_jax.pipeline import matrix

    files, _ = chip_smoke.make_small(np.random.default_rng(1), tmp_path,
                                     (2000, 1500, 2500))
    args = dict(k=31, b=1, l=100, b1=100, b2=1000)
    want = matrix.matrix_pipeline(files, **args)
    monkeypatch.setattr(device, "platform", lambda: "gpu")
    for mod, name in ((contigs, "_WALK_MIN"),
                      (matrix, "_FEATURE_DEVICE_MIN"),
                      (pivot, "_DEVICE_MIN")):
        monkeypatch.setattr(mod, name, 0)
    got = matrix.matrix_pipeline(files, **args)
    assert len(want.components) >= 2
    assert got.contigs_per_sample == want.contigs_per_sample
    assert [(c.kmers.tolist(), c.weight) for c in got.components] == \
        [(c.kmers.tolist(), c.weight) for c in want.components]
    assert np.array_equal(got.vectors, want.vectors)
    assert np.array_equal(got.matrix, want.matrix)


@pytest.mark.parametrize("env_dir", [None, "custom_cache"])
def test_compile_cache_placement(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache sits
    at a fixed path inside the checkout."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    code = ("import json, jax, metafast_jax; print(json.dumps([jax.config."
            "jax_compilation_cache_dir, jax.config."
            "jax_persistent_cache_min_compile_time_secs]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env={**env, "PYTHONPATH": str(REPO)},
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    cache_dir, min_secs = json.loads(out.strip().splitlines()[-1])
    want = (tmp_path / env_dir) if env_dir else REPO / ".jax_cache"
    assert Path(cache_dir) == want
    assert min_secs == 1.0


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_cpu(tmp_path, alone):
    """No GPU (or no package beside the script): non-zero exit and no
    result line."""
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if alone:
        cwd = tmp_path
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
