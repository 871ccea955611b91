"""Multi-process smoke test: jax.distributed over a 2-process CPU 'pod'.

Exercises parallel/distributed.py for real: two separate
processes initialize a jax.distributed job over a localhost coordinator,
split the sample files with per_host_files, count their own slice
(data-parallel over samples — the multi-host analog of
kmer-counter-many's per-sample loop), and allgather the per-sample
tables; process 0 checks the union equals a single-process count.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

WORKER = r"""
import json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")

pid = int(sys.argv[1]); coord = sys.argv[2]; out = sys.argv[3]
files = sys.argv[4:]

from metafast_jax.parallel import distributed as dist
dist.initialize(coordinator_address=coord, num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()

mine = dist.per_host_files(files)
# every chip in the job is visible to every process (addressable or not)
mesh = dist.global_mesh()
assert mesh.devices.size == jax.device_count() >= 2

from metafast_jax import api
import hashlib
tables = {}
for f in mine:
    keys, counts, stats = api.count_reads_files([f], 11)
    dig = hashlib.sha256(keys.tobytes() + counts.astype(np.int32).tobytes())
    tables[f] = [int(len(keys)), int(counts.sum()), dig.hexdigest()]

# cross-process exchange: allgather the per-host results over DCN
from jax.experimental import multihost_utils
blob = json.dumps(tables).encode()
pad = 1 << 12
assert len(blob) < pad
buf = np.zeros(pad, np.uint8)
buf[:len(blob)] = np.frombuffer(blob, np.uint8)
lens = multihost_utils.process_allgather(np.array([len(blob)]))
both = multihost_utils.process_allgather(buf)
if pid == 0:
    merged = {}
    for i in range(2):
        merged.update(json.loads(bytes(both[i][:int(lens[i][0])]).decode()))
    with open(out, "w") as fh:
        json.dump(merged, fh)
multihost_utils.sync_global_devices("done")
"""


SHARDED_WORKER = r"""
import json, os, sys
import numpy as np

flags = os.environ.get("XLA_FLAGS", "")
os.environ["XLA_FLAGS"] = (
    flags + " --xla_force_host_platform_device_count=4").strip()

import jax
jax.config.update("jax_platforms", "cpu")

pid = int(sys.argv[1]); coord = sys.argv[2]; out = sys.argv[3]
files = sys.argv[4:]

from metafast_jax.parallel import distributed as dist
dist.initialize(coordinator_address=coord, num_processes=2, process_id=pid)
assert jax.process_count() == 2
assert jax.device_count() == 8 and len(jax.local_devices()) == 4

# cross-host k-mer sharding: one global 8-device mesh spanning both
# processes; each process streams its local share of every slab and the
# consolidation all-to-all crosses the process boundary (DCN)
mesh = dist.global_mesh()
from metafast_jax import api

k = 21
results = {}
from metafast_jax.io import native_reads
for f in files:
    keys, counts, stats = api.count_reads_files_sharded([f], k, mesh)
    results[f] = dict(n=len(keys), total=int(counts.sum()),
                      kmers_seen=stats["kmers_seen"],
                      reads=stats["reads"], skipped=stats["skipped"],
                      keys_head=[int(x) for x in keys[:5]],
                      counts_head=[int(x) for x in counts[:5]])
    import hashlib
    results[f]["digest"] = hashlib.sha256(
        keys.tobytes() + counts.astype(np.int32).tobytes()).hexdigest()

    # multi-process spill: per-process shard spill + DCN allgather must
    # be bit-identical to the no-spill run
    skeys, scounts, _ = api.count_reads_files_sharded([f], k, mesh,
                                                      spill=16)
    assert np.array_equal(skeys, keys) and np.array_equal(scounts, counts)

# per-host input partitioning: each process must have
# parsed only its own record-aligned byte range — ~1/P of the input
# bytes — not the whole of every file
from jax.experimental import multihost_utils
total_bytes = sum(os.path.getsize(f) for f in files)
mine = np.array([native_reads.PARSED_BYTES], np.int64)
allb = np.asarray(multihost_utils.process_allgather(mine)).reshape(-1)
# spill rerun doubles each process's parse work: 2 passes over its share
results["parsed_bytes"] = [int(x) for x in allb]
results["total_bytes"] = int(total_bytes)
assert int(allb.sum()) == 2 * total_bytes, (allb, total_bytes)
assert all(b < 1.3 * total_bytes for b in allb), (allb, total_bytes)

# full golden pipeline through the multi-process sharded counter
from metafast_jax.pipeline.matrix import matrix_pipeline
api.set_default_mesh(mesh)
try:
    res = matrix_pipeline([[f] for f in files], k=31)
finally:
    api.set_default_mesh(None)
results["matrix"] = [[float(x) for x in row] for row in res.matrix]

if pid == 0:
    with open(out, "w") as fh:
        json.dump(results, fh)
from jax.experimental import multihost_utils
multihost_utils.sync_global_devices("done")
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_count(tmp_path, ref_data):
    files = [str(ref_data / f"meta_test_{i}.fa") for i in (1, 2, 3)]
    out = tmp_path / "merged.json"
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    repo = str(Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), coord, str(out)] + files,
        env=env, cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in (0, 1)]
    outs = []
    for p in procs:
        so, se = p.communicate(timeout=300)
        outs.append((p.returncode, so.decode(), se.decode()))
    assert all(rc == 0 for rc, _, _ in outs), outs

    merged = json.loads(out.read_text())
    assert set(Path(f).name for f in merged) == {
        "meta_test_1.fa", "meta_test_2.fa", "meta_test_3.fa"}

    # oracle: single-process counts must match the union of per-host work
    import hashlib
    import jax
    from metafast_jax import api
    with jax.default_device(jax.devices("cpu")[0]):
        for f in files:
            keys, counts, _ = api.count_reads_files([f], 11)
            dig = hashlib.sha256(
                keys.tobytes() + counts.astype(np.int32).tobytes())
            assert merged[f] == [len(keys), int(counts.sum()),
                                 dig.hexdigest()], f


def test_two_process_sharded_kmer_counting(tmp_path, ref_data):
    """Cross-host k-mer-space sharding: 2 processes x 4 devices, one
    global mesh; the exchange all-to-all crosses the process boundary.
    Verifies count tables against the single-process oracle and the
    golden Bray-Curtis matrix through the same path."""
    files = [str(ref_data / f"meta_test_{i}.fa") for i in (1, 2, 3)]
    out = tmp_path / "sharded.json"
    script = tmp_path / "worker.py"
    script.write_text(SHARDED_WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    repo = str(Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), coord, str(out)] + files,
        env=env, cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in (0, 1)]
    outs = []
    for p in procs:
        so, se = p.communicate(timeout=900)
        outs.append((p.returncode, so.decode(), se.decode()))
    assert all(rc == 0 for rc, _, _ in outs), outs

    res = json.loads(out.read_text())

    import hashlib
    import jax
    from metafast_jax import api
    with jax.default_device(jax.devices("cpu")[0]):
        for f in files:
            keys, counts, stats = api.count_reads_files([f], 21)
            dig = hashlib.sha256(
                keys.tobytes() + counts.astype(np.int32).tobytes())
            got = res[f]
            assert got["n"] == len(keys) and got["total"] == int(counts.sum())
            assert got["digest"] == dig.hexdigest()
            assert got["kmers_seen"] == stats["kmers_seen"]
            # partitioned-parse accounting sums to the whole-file totals
            assert got["reads"] == stats["reads"]
            assert got["skipped"] == stats["skipped"]

    # each process parsed ~half the bytes (2 count passes: plain + spill)
    pb = res["parsed_bytes"]
    assert len(pb) == 2 and sum(pb) == 2 * res["total_bytes"]

    want = np.array([[0.0, 0.5691162409506898, 0.2981399448537721],
                     [0.5691162409506898, 0.0, 0.8448331091037222],
                     [0.2981399448537721, 0.8448331091037222, 0.0]])
    assert np.allclose(np.array(res["matrix"]), want, atol=1e-9)
