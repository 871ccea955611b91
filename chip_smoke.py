#!/usr/bin/env python3
"""Run the matrix-builder pipeline once on GPUs and check what it computes.

    python3 chip_smoke.py              # one GPU: phases 0-3
    python3 chip_smoke.py --cards 4    # four GPUs: --shards 4 vs one card

Run it from the repository root.  Everything runs in this one process
(the nvidia-smi child never touches JAX), on seeded synthetic data made
in a temporary directory.

  0. Device.  JAX's default device must be a GPU and the native library
     must load; prints the card's name and power limit.
  1. Oracle parity at small size: three ~20 kbp samples through the CLI
     (`metafast_jax.cli.main`, default b/l/b1/b2), checked exactly against
     the pure-Python oracle (k-mer files, component sets) and to 1e-12
     (distance matrix).
  2. Real size: four samples, each a community of ~1.1 Mbp genomes with
     log-normal abundances at ~12x, through the same CLI call; checked
     against the native single-thread implementations and a host
     recomputation of the features.  Prints per-step times, compile time
     and peak device memory.
  3. The card-only tests (tests/test_gpu.py, marker `gpu`), in process.

With --cards 4 only the phase-2 data runs, through `--shards 4` and then
on one card in the same process; every k-mer file, the components file
and the matrix must be byte-identical.  --genomes N cuts the genomes per
sample of the phase-2 data (and says so).

The last line of standard output is one JSON object, printed only when
every phase passed; any failure exits non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import json
import re
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

from metafast_jax.oracle.synth import FULL, Scale, make_communities

ROOT = Path(__file__).resolve().parent
K, B, L, B1, B2 = 31, 1, 100, 1000, 10000     # the CLI defaults
READ_LEN = 150
SATURATE = 32767


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)
    print(f"  ok: {what}", flush=True)


# ---------------------------------------------------------------- data

def make_small(rng, td: Path, parts=(6000, 5000, 9000)):
    """Three one-genome samples as 150 bp reads at ~10x.  Each genome
    joins a backbone common to all (parts[0] bp), a segment samples 0
    and 1 share (parts[1]) and the sample's own rest (parts[2])."""
    from metafast_jax.oracle import synth

    backbone = synth.random_genome(rng, parts[0])
    pair = synth.random_genome(rng, parts[1])
    files, reads = [], []
    for s in range(3):
        g = np.concatenate([
            backbone, pair if s < 2 else synth.random_genome(rng, parts[1]),
            synth.random_genome(rng, parts[2])])
        r = synth.sample_reads(rng, [g], np.ones(1), 10.0, READ_LEN)
        f = td / f"small_{s}.fa"
        synth.write_fasta(f, r)
        files.append(str(f))
        reads.append(r)
    return files, reads


# ------------------------------------------------------------- helpers

def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def native_table(lib, codes: np.ndarray, lengths: np.ndarray):
    """(keys, counts) by the native extractor + host sort: every
    canonical k-mer, counts saturated at 32767."""
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    n = int(np.maximum(lengths.astype(np.int64) - K + 1, 0).sum())
    keys = np.empty(n, dtype=np.int64)
    got = lib.extract_canonical(_ptr(codes, ctypes.c_uint8),
                                _ptr(lengths, ctypes.c_int32),
                                len(lengths), K,
                                _ptr(keys, ctypes.c_int64), n)
    if got != n:
        raise SmokeFailure(f"native extraction returned {got} of {n}")
    keys.sort()
    starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
    counts = np.diff(np.r_[starts, n])
    return keys[starts], np.minimum(counts, SATURATE).astype(np.int32)


def _log2_slots(n: int) -> int:
    return max(12, int(np.ceil(np.log2(max(n, 2)))) + 1)


def native_contigs(lib, keys, counts):
    """(contig count, total length) of the native contig walk."""
    n_seq, tlen = ctypes.c_int64(0), ctypes.c_int64(0)
    k64 = np.ascontiguousarray(keys, dtype=np.uint64)
    c32 = np.ascontiguousarray(counts, dtype=np.int32)
    rc = lib.contig_walk_baseline(_ptr(k64, ctypes.c_uint64),
                                  _ptr(c32, ctypes.c_int32), len(k64), K, L,
                                  _log2_slots(len(k64)), ctypes.byref(n_seq),
                                  ctypes.byref(tlen))
    if rc < 0:
        raise SmokeFailure("native contig walk could not allocate")
    return n_seq.value, tlen.value


def native_components(lib, keys, counts) -> int:
    n_comp = ctypes.c_int64(0)
    k64 = np.ascontiguousarray(keys, dtype=np.uint64)
    c32 = np.ascontiguousarray(counts, dtype=np.int32)
    rc = lib.bfs_components_baseline(_ptr(k64, ctypes.c_uint64),
                                     _ptr(c32, ctypes.c_int32), len(k64), K,
                                     _log2_slots(len(k64)),
                                     ctypes.byref(n_comp))
    if rc < 0:
        raise SmokeFailure("native BFS could not allocate")
    return n_comp.value


def read_fasta_seqs(path) -> list[str]:
    with open(path) as fh:
        return [ln.strip() for ln in fh if ln.strip() and ln[0] != ">"]


def outputs(wd: Path, names: list[str]):
    """The CLI's files: per-sample k-mer tables, contigs and vectors,
    the components file and the original-order matrix."""
    (mat,) = glob.glob(str(wd / "matrices" / "*_original_order.txt"))
    return dict(
        kmers=[wd / "kmer-counter-many" / "kmers" / f"{n}.kmers.bin"
               for n in names],
        seqs=[wd / "seq-builder-many" / "sequences" / f"{n}.seq.fasta"
              for n in names],
        vecs=[wd / "features-calculator" / "vectors" / f"{n}.vec"
              for n in names],
        components=wd / "component-cutter" / "components.bin",
        matrix=Path(mat))


def step_times(log_path) -> list[tuple[str, float]]:
    """(step, seconds) of every finished pipeline step, in finishing
    order, from the run's log: the framework's "[step] started" and
    "[step] done in" lines (steps nest, so they close last-in first-out).
    """
    from datetime import datetime

    out, open_steps = [], []
    for line in Path(log_path).read_text().splitlines():
        m = re.match(r"(\S+ \S+) \S+\s+\[([^\]]+)\] (started|done in)", line)
        if not m:
            continue
        t = datetime.strptime(m[1], "%Y-%m-%d %H:%M:%S,%f").timestamp()
        if m[3] == "started":
            open_steps.append((m[2], t))
        elif open_steps:
            name, t0 = open_steps.pop()
            out.append((name, t - t0))
    return out


class CompileClock:
    """Backend compile time and count, from JAX's monitoring events."""

    def __init__(self):
        import jax.monitoring

        self.seconds, self.count = 0.0, 0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, name, secs, **_):
        if name.endswith("backend_compile_duration"):
            self.seconds += secs
            self.count += 1


def run_cli(files, wd: Path, extra=(), k: int = K):
    from metafast_jax import cli

    args = ["-k", str(k), "-i", *files, "-w", str(wd), *extra]
    t0 = time.perf_counter()
    rc = cli.main(args)
    dt = time.perf_counter() - t0
    check(rc == 0, f"cli.main({' '.join(extra) or 'one card'}) exits 0 "
          f"(ran {dt:.3f} s)")
    return dt


def oracle_parity(td: Path, k: int = K, b1: int = B1, b2: int = B2,
                  parts=(6000, 5000, 9000)):
    """Small samples through the CLI against the pure-Python oracle:
    k-mer files and component sets exactly, the matrix to 1e-12."""
    from metafast_jax.io import binfmt, textfmt
    from metafast_jax.oracle import reference as o
    from metafast_jax.oracle import synth
    from metafast_jax.pipeline.matrix import bray_curtis_matrix

    files, reads = make_small(np.random.default_rng(1), td, parts)
    wd = td / "wd_small"
    run_cli(files, wd, ("-b1", str(b1), "-b2", str(b2)), k=k)
    out = outputs(wd, [Path(f).stem for f in files])
    tables, comps, _vecs, want_mat = o.matrix_pipeline(
        [synth.read_strings(r) for r in reads], k, B, L, b1, b2)
    for s, filt in enumerate(tables):
        keys, cnts = binfmt.read_kmers_bin(str(out["kmers"][s]))
        want = np.array(sorted(filt), dtype=np.int64)
        check(np.array_equal(keys, want)
              and np.array_equal(cnts, [filt[x] for x in want]),
              f"sample {s}: {len(keys)} k-mers equal the oracle's")
    got = sorted((tuple(np.sort(km).tolist()), w)
                 for km, w in binfmt.read_components_bin(
                     str(out["components"])))
    want = sorted((tuple(sorted(c)), w) for c, w, _t in comps)
    check(len(want) >= 2 and got == want,
          f"{len(got)} components equal the oracle's")
    mat = bray_curtis_matrix(np.stack([textfmt.read_vector(str(v))
                                       for v in out["vecs"]]))
    err = float(np.abs(mat - want_mat).max())
    off = mat[np.triu_indices(3, 1)]
    print(f"  matrix (off-diagonal): {off.tolist()}")
    check(err <= 1e-12 and len(set(off.tolist())) == 3,
          f"distance matrix equals the oracle's (max error {err:.3g}); "
          f"off-diagonal distances distinct")


# -------------------------------------------------------------- phases

def phase0(cards: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SmokeFailure(f"JAX's default device is {devs[0].platform}, "
                           f"not a GPU")
    if len(devs) < cards:
        raise SmokeFailure(f"need {cards} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}")
    from metafast_jax.native import load_library

    lib = load_library()
    print(f"device: {devs[0].platform} {devs[0].device_kind} x{len(devs)}; "
          f"native library loaded: {lib is not None}")
    if lib is None:
        raise SmokeFailure("the native library did not build or load")
    return lib


def phase1(td: Path):
    print("phase 1: oracle parity, 3 samples of ~20 kbp at ~10x", flush=True)
    oracle_parity(td)


def phase2(lib, td: Path, scale: Scale = FULL):
    import jax

    from metafast_jax import api
    from metafast_jax.graph import components as comp_mod
    from metafast_jax.graph.contigs import _table_bucket
    from metafast_jax.io import binfmt, textfmt
    from metafast_jax.oracle import reference as o
    from metafast_jax.pipeline.matrix import (bray_curtis_matrix,
                                              count_contig_kmers)
    from metafast_jax.core import bitpack as bp

    print(f"phase 2: real size, scale {scale}", flush=True)
    t0 = time.perf_counter()
    files, reads0, expect = make_communities(scale, td, K, READ_LEN)
    print(f"  data: {scale.samples} samples x {scale.genomes} genomes x "
          f"{scale.genome_len} bp, {len(reads0)} reads of {READ_LEN} bp in "
          f"sample 0, written in {time.perf_counter() - t0:.3f} s; expected "
          f"distinct k-mers after b={B}: {[round(e) for e in expect]}",
          flush=True)

    compiles = CompileClock()
    wd = td / "wd_real"
    run_cli(files, wd)
    for name, secs in step_times(wd / "log"):
        print(f"  step {name}: {secs:.3f} s (cold)")
    print(f"  compile: {compiles.seconds:.3f} s in {compiles.count} "
          f"backend compiles")
    for i in range(2):
        t = time.perf_counter()
        api.count_reads_files([files[0]], K)
        print(f"  counting sample 0 again, warm run {i + 1}: "
              f"{time.perf_counter() - t:.3f} s")
    stats = jax.devices()[0].memory_stats() or {}
    print(f"  peak device memory: {stats.get('peak_bytes_in_use')} bytes")

    names = [Path(f).stem for f in files]
    out = outputs(wd, names)
    tables = [binfmt.read_kmers_bin(str(p)) for p in out["kmers"]]
    print(f"  distinct k-mers after b={B}: {[len(t[0]) for t in tables]}")
    if scale == FULL:
        check(min(len(t[0]) for t in tables) >= 25_000_000,
              "every sample holds >= 25M distinct k-mers")

    t = time.perf_counter()
    nk, nc = native_table(lib, reads0.reshape(-1),
                          np.full(len(reads0), READ_LEN, np.int32))
    keep = nc > B
    check(np.array_equal(tables[0][0], nk[keep])
          and np.array_equal(tables[0][1], nc[keep]),
          f"sample 0 k-mer table equals native extraction + sort "
          f"({len(nk)} distinct before the filter; "
          f"{time.perf_counter() - t:.3f} s)")
    del reads0, nk, nc

    n_seq, tlen = native_contigs(lib, *tables[0])
    seqs0 = read_fasta_seqs(out["seqs"][0])
    check(len(seqs0) == n_seq and sum(map(len, seqs0)) == tlen,
          f"sample 0: {n_seq} contigs of {tlen} bp, as the native walk")

    seqs = [s for p in out["seqs"] for s in read_fasta_seqs(p)
            if len(s) >= L]
    lut = np.full(256, 255, np.uint8)
    lut[np.frombuffer(b"AGCT", np.uint8)] = np.arange(4, dtype=np.uint8)
    codes = lut[np.frombuffer("".join(seqs).encode(), np.uint8)]
    gk, gc = native_table(lib, codes,
                          np.array([len(s) for s in seqs], np.int32))
    dk, dc = count_contig_kmers(seqs, K, min_len=L)
    check(np.array_equal(gk, dk) and np.array_equal(gc, dc),
          f"global contig table ({len(gk)} k-mers) equals native extraction")
    M = _table_bucket(len(gk))
    khi = np.full(M, bp.SENTINEL, np.uint32)
    klo = np.full(M, bp.SENTINEL, np.uint32)
    u = gk.astype(np.uint64)
    khi[:len(gk)] = (u >> np.uint64(32)).astype(np.uint32)
    klo[:len(gk)] = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    labels = comp_mod.table_labels(khi, klo, K)
    n_dev = len(np.unique(labels[:len(gk)]))
    n_nat = native_components(lib, gk, gc)
    check(n_dev == n_nat, f"{n_dev} level-1 components, as the native BFS")
    del codes, gk, gc, dk, dc, labels

    comps = binfmt.read_components_bin(str(out["components"]))
    sizes = np.array([len(c[0]) for c in comps], dtype=np.int64)
    check(len(comps) > 0, f"{len(comps)} components in [{B1}, {B2}] "
          f"({int(sizes.sum())} k-mers)")
    allk = np.concatenate([c[0] for c in comps])
    starts = np.r_[0, np.cumsum(sizes)[:-1]]
    host = []
    for s, (keys, counts) in enumerate(tables):
        pres = api.presence_counts(allk, keys, counts)
        vec = np.add.reduceat(np.where(pres > 0, pres, 0), starts)
        run = textfmt.read_vector(str(out["vecs"][s]))
        check(np.array_equal(vec, run),
              f"sample {s}: features equal the host recomputation")
        host.append(vec.astype(np.float64))
    mat = bray_curtis_matrix(np.stack([textfmt.read_vector(str(v))
                                       for v in out["vecs"]]))
    printed, _ = textfmt.read_dist_matrix(str(out["matrix"]))
    n = len(host)
    err = max(abs(mat[i, j] - o.bray_curtis(host[i], host[j]))
              for i in range(n) for j in range(n) if i != j)
    perr = float(np.abs(printed - mat).max())
    off = mat[np.triu_indices(n, 1)]
    print(f"  matrix (off-diagonal): {off.tolist()}")
    check(err <= 1e-12 and perr <= 5e-5 and len(set(off.tolist())) == len(off),
          f"matrix equals oracle Bray-Curtis of the recomputed features "
          f"(max error {err:.3g}; printed at 4 decimals, {perr:.2g}); "
          f"off-diagonal distances distinct")


def phase3():
    import pytest

    print("phase 3: card-only tests", flush=True)

    class Passed:
        n = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                Passed.n += 1

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      str(ROOT / "tests" / "test_gpu.py")],
                     plugins=[Passed()])
    check(rc == 0 and Passed.n > 0, f"{Passed.n} card-only tests passed")


def four_cards(td: Path, scale: Scale = FULL):
    from metafast_jax import api

    print(f"four cards: --shards 4 against one card, scale {scale}",
          flush=True)
    files, _, _ = make_communities(scale, td, K, READ_LEN,
                                   keep_reads_of=None)
    names = [Path(f).stem for f in files]
    wd4, wd1 = td / "wd_shards4", td / "wd_one"
    compiles = CompileClock()
    try:
        run_cli(files, wd4, ("--shards", "4"))
    finally:
        api.set_default_mesh(None)
    print(f"  compile: {compiles.seconds:.3f} s in {compiles.count} "
          f"backend compiles")
    for name, secs in step_times(wd4 / "log"):
        print(f"  step {name}: {secs:.3f} s (--shards 4)")
    compiles.seconds, compiles.count = 0.0, 0
    run_cli(files, wd1)
    print(f"  compile: {compiles.seconds:.3f} s in {compiles.count} "
          f"backend compiles")
    for name, secs in step_times(wd1 / "log"):
        print(f"  step {name}: {secs:.3f} s (one card)")
    a, b = outputs(wd4, names), outputs(wd1, names)
    same = lambda p, q: Path(p).read_bytes() == Path(q).read_bytes()
    for p, q in zip(a["kmers"], b["kmers"]):
        check(same(p, q), f"{Path(p).name} byte-identical")
    check(same(a["components"], b["components"]),
          "components.bin byte-identical")
    check(same(a["matrix"], b["matrix"]), "distance matrix byte-identical")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    ap.add_argument("--genomes", type=int, default=FULL.genomes,
                    help="genomes per sample of the phase-2 data")
    args = ap.parse_args(argv)
    scale = replace(FULL, genomes=args.genomes)
    try:
        import jax

        lib = phase0(args.cards)
        with tempfile.TemporaryDirectory() as tmp:
            td = Path(tmp)
            if scale != FULL:
                print(f"cut: {scale.genomes} genomes per sample instead "
                      f"of {FULL.genomes}")
            if args.cards == 4:
                four_cards(td, scale)
            else:
                phase1(td)
                phase2(lib, td, scale)
                phase3()
    except SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    dev = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": dev[0].platform, "kind": dev[0].device_kind,
        "count": len(dev)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
