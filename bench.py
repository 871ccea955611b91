"""Benchmark: canonical k-mer counting and the graph stages on one GPU.

    python bench.py              # counting + graph stages (JSON lines)
    python bench.py --stress     # S-sample matrix pipeline (one JSON line)
    python bench.py --routes     # extraction share + routing crossovers

Workload: a deterministic synthetic metagenomic sample -- reads drawn from
a 5 Mbp genome at ~20x coverage.  This is the reference's kmer-counter hot
loop (src/io/IOUtils.java:742-803).

Reported numbers:

  * value (primary) = DEVICE-ONLY k-mers/s: inputs pre-staged on the
    device, timed from the first extraction dispatch to the final counted
    table on the device (jax.block_until_ready).
  * end_to_end_kmers_per_s = file on disk -> sorted (keys, counts) on the
    host, including parse and transfers.
  * vs_baseline = device-only rate / a measured single-thread native
    counter (native/fastparse.cpp count_kmers_baseline) on this host.

Every line names the device (platform, kind, count) and the card's power
limit.  With no GPU the bench fails; any failed stage exits non-zero.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

import numpy as np

K = 31
GENOME_LEN = 5_000_000
READ_LEN = 150
COVERAGE = 20
N_READS = GENOME_LEN * COVERAGE // READ_LEN    # ~667K reads, ~80M kmers


def device_info() -> dict:
    """The device every number is measured on; exits without a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX's default device is "
                         f"{devs[0].platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs), "card": smi}


def make_fasta(path: str) -> int:
    from metafast_jax.oracle import synth

    rng = np.random.default_rng(0)
    genome = synth.random_genome(rng, GENOME_LEN)
    starts = rng.integers(0, GENOME_LEN - READ_LEN, N_READS)
    synth.write_fasta(path, genome[starts[:, None] + np.arange(READ_LEN)])
    return N_READS * (READ_LEN - K + 1)


def native_baseline(codes, lengths) -> float:
    """Measured single-thread reference-style counter: k-mers/s, median
    of 3."""
    from metafast_jax.native import load_library

    lib = load_library()
    log2 = 24                                  # 16M slots for ~5M uniques
    table = np.zeros(1 << log2, dtype=np.uint64)
    counts = np.zeros(1 << log2, dtype=np.uint16)
    uniq = ctypes.c_int64(0)

    def run():
        table[:] = 0
        counts[:] = 0
        t0 = time.perf_counter()
        total = lib.count_kmers_baseline(
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(lengths), K,
            table.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            log2, ctypes.byref(uniq))
        return total / (time.perf_counter() - t0)

    return sorted(run() for _ in range(3))[1]


def _slabs(codes, lengths, slab_codes=1 << 27):
    """Pre-staged compact 3-stream slabs on the device."""
    import jax

    from metafast_jax.ops.stream_extract import build_stream3

    offs = np.concatenate([[0], np.cumsum(lengths.astype(np.int64))])
    slabs = []
    r0 = 0
    while r0 < len(lengths):
        r1 = int(np.searchsorted(offs, offs[r0] + slab_codes,
                                 side="right")) - 1
        r1 = min(max(r1, r0 + 1), len(lengths))
        w0, w1, w2, vm, _ = build_stream3(codes[offs[r0]:offs[r1]],
                                          lengths[r0:r1], K)
        slabs.append(([jax.device_put(x) for x in (w0, w1, w2, vm)],
                      lengths[r0:r1]))
        r0 = r1
    jax.block_until_ready([b for s in slabs for b in s[0]])
    return slabs


def main():
    import jax

    from metafast_jax import api
    from metafast_jax.io import native_reads
    from metafast_jax.ops.count import KmerCounter, _sort_pair
    from metafast_jax.ops.stream_extract import stream3_extract

    info = device_info()
    with tempfile.TemporaryDirectory() as td:
        fasta = os.path.join(td, "bench.fasta")
        n_kmers = make_fasta(fasta)
        codes, lengths, _ = native_reads.parse_file(fasta)
        base_rate = native_baseline(codes, lengths)
        slabs = _slabs(codes, lengths)

        def device_only():
            counter = KmerCounter(K)
            for bufs, ls in slabs:
                counter.add_stream3_device(*bufs, ls)
            return jax.block_until_ready(counter.finish_device())

        table = device_only()                  # compile warm-up
        t_dev = _timed_median(device_only, 5)
        dev_rate = n_kmers / t_dev

        bufs0 = slabs[0][0]
        t_ext = _timed_median(
            lambda: jax.block_until_ready(stream3_extract(*bufs0, K)), 3)
        hi0, lo0 = stream3_extract(*bufs0, K)
        hi0, lo0 = jax.block_until_ready((hi0.reshape(-1), lo0.reshape(-1)))
        n_slots = hi0.shape[0]
        t_sort = _timed_median(
            lambda: jax.block_until_ready(_sort_pair(hi0, lo0)), 3)
        stages = {
            "extract_ms": t_ext * 1e3,
            "extract_keys_per_s": n_slots / t_ext,
            "sort_ms": t_sort * 1e3,
            "sort_keys_per_s": n_slots / t_sort,
            "rle_merge_rest_ms": max(t_dev - t_ext - t_sort, 0.0) * 1e3,
            "sorted_slots": int(n_slots),
        }
        stages.update(_bench_graph_stages(table))

        t_e2e = _timed_median(lambda: api.count_reads_files([fasta], K), 3)

    print(json.dumps({
        "metric": "device_kmer_count_throughput_detail",
        "value": dev_rate,
        "unit": "kmers/s",
        **info,
        "vs_baseline": dev_rate / base_rate,
        "end_to_end_kmers_per_s": n_kmers / t_e2e,
        "baseline_kmers_per_s": base_rate,
        "baseline_provenance": (
            "measured on this host: single-thread C++ rolling-canonical "
            "open-addressing counter (native/fastparse.cpp "
            "count_kmers_baseline)"),
        "host_cores": os.cpu_count(),
        "stages": stages,
    }))
    print(json.dumps({
        "metric": "device_kmer_count_throughput",
        "value": dev_rate,
        "unit": "kmers/s",
        **info,
        "vs_baseline": dev_rate / base_rate,
        "contig_chain_nodes_per_s": stages["contig_chain_nodes_per_s"],
        "components_nodes_per_s": stages["components_nodes_per_s"],
    }))


def _timed(f) -> float:
    t0 = time.perf_counter()
    f()
    return time.perf_counter() - t0


def _timed_median(f, n=3):
    f()
    return sorted(_timed(f) for _ in range(n))[n // 2]


def _graph_input(table, cap=1 << 23):
    """The live prefix of a counted device table, padded to the graph
    stages' {2^k, 3*2^(k-1)} bucket with SENTINEL rows."""
    import jax
    import jax.numpy as jnp

    from metafast_jax.core import bitpack as bp
    from metafast_jax.graph.contigs import _table_bucket

    hi, lo, cnt = table
    n_live = int(jnp.sum(cnt > 0))
    M = min(_table_bucket(n_live + 16), int(hi.shape[0]), cap)
    ghi = jax.lax.slice_in_dim(hi, 0, M)
    glo = jax.lax.slice_in_dim(lo, 0, M)
    if M < int(hi.shape[0]):
        tail = jnp.full((16,), bp.SENTINEL, jnp.uint32)
        ghi = jnp.concatenate([jax.lax.slice_in_dim(ghi, 0, M - 16), tail])
        glo = jnp.concatenate([jax.lax.slice_in_dim(glo, 0, M - 16), tail])
    return ghi, glo, M


def _bench_graph_stages(table):
    """Device times of the contig chain structure and the level-1
    component labels on the bench table, beside the native single-thread
    walks (fastparse.cpp) on the same keys."""
    import jax

    from metafast_jax.graph.components import table_labels
    from metafast_jax.graph.contigs import chain_structure
    from metafast_jax.native import load_library

    ghi, glo, M = _graph_input(table)
    out = {}
    t = _timed_median(lambda: jax.block_until_ready(
        chain_structure(ghi, glo, K)), 3)
    out["contig_chain_ms"] = t * 1e3
    out["contig_chain_nodes_per_s"] = M / t
    t = _timed_median(lambda: table_labels(ghi, glo, K), 3)
    out["components_ms"] = t * 1e3
    out["components_nodes_per_s"] = M / t
    out["graph_nodes"] = M

    hi, lo, cnt = (np.asarray(x) for x in table)
    live = cnt > 0
    keys = (hi[live].astype(np.uint64) << np.uint64(32)) | lo[live]
    cnts = cnt[live].astype(np.int32)
    lib = load_library()
    log2 = max(12, int(np.ceil(np.log2(max(len(keys), 2)))) + 1)
    pk = keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
    pc = cnts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    a, b = ctypes.c_int64(0), ctypes.c_int64(0)
    t_nw = _timed_median(lambda: lib.contig_walk_baseline(
        pk, pc, len(keys), K, 0, log2, ctypes.byref(a), ctypes.byref(b)), 2)
    t_nb = _timed_median(lambda: lib.bfs_components_baseline(
        pk, pc, len(keys), K, log2, ctypes.byref(a)), 2)
    out["native_contig_walk_ms"] = t_nw * 1e3
    out["native_bfs_components_ms"] = t_nb * 1e3
    out["contig_vs_native_x"] = t_nw * 1e3 / out["contig_chain_ms"]
    out["components_vs_native_x"] = t_nb * 1e3 / out["components_ms"]
    return out


def routes():
    """The measurements behind the device routing (PERF.md, "Routing"):
    the extraction's share of a large copy's rate at the bench slab, and
    both algorithms of every size-routed choice at the full-size
    per-sample table of chip_smoke.py (the joins also at smaller sizes).
    One JSON line."""
    import jax
    import jax.numpy as jnp

    from metafast_jax import api
    from metafast_jax.graph import contigs as ct
    from metafast_jax.graph import dbg, pivot, rank
    from metafast_jax.io import native_reads
    from metafast_jax.ops.stream_extract import stream3_extract
    from metafast_jax.oracle import synth
    from metafast_jax.pipeline import matrix

    info = device_info()
    out = {}

    # -- extraction at the bench slab against a large copy -------------
    with tempfile.TemporaryDirectory() as td:
        fasta = os.path.join(td, "bench.fasta")
        make_fasta(fasta)
        codes, lengths, _ = native_reads.parse_file(fasta)
    bufs = _slabs(codes, lengths)[0][0]
    t_ext = _timed_median(
        lambda: jax.block_until_ready(stream3_extract(*bufs, K)), 5)
    cols = int(bufs[0].shape[0])
    ext_bytes = 4 * cols * 256 * 4 + 2 * 16 * 256 * cols * 4
    blob = jnp.zeros(1 << 28, jnp.uint32)                  # 1 GiB
    copy = jax.jit(lambda x: x + jnp.uint32(1))
    t_copy = _timed_median(lambda: jax.block_until_ready(copy(blob)), 5)
    del blob
    copy_rate = 2 * 4 * (1 << 28) / t_copy
    out["extract"] = {"slab_columns": cols, "ms": t_ext * 1e3,
                      "bytes": ext_bytes, "bytes_per_s": ext_bytes / t_ext,
                      "copy_bytes_per_s": copy_rate,
                      "share_of_copy": ext_bytes / t_ext / copy_rate}

    # -- one sample of chip_smoke.py's full scale ----------------------
    one = replace(synth.FULL, samples=1)
    with tempfile.TemporaryDirectory() as td:
        files, _, _ = synth.make_communities(one, td, K, READ_LEN,
                                             keep_reads_of=None)
        keys, counts, _ = api.count_reads_files(files, K)
    keep = counts > 1
    keys, counts = keys[keep], counts[keep]
    M = ct._table_bucket(len(keys))
    khi = np.full(M, 0xFFFFFFFF, np.uint32)
    klo = np.full(M, 0xFFFFFFFF, np.uint32)
    u = keys.astype(np.uint64)
    khi[:len(keys)] = (u >> np.uint64(32)).astype(np.uint32)
    klo[:len(keys)] = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    dhi, dlo = jnp.asarray(khi), jnp.asarray(klo)
    out["table"] = {"keys": int(len(keys)), "padded": int(M)}

    t = dbg.neighbor_tables(dhi, dlo, K)
    L, R = t["left"], t["right"]
    st = ct._succ_from_tables(dhi, dlo, L["idx"], L["is_fw"], L["ext"],
                              R["idx"], R["is_fw"], R["ext"], K)
    out["contigs_rank_ms"] = {
        "doubling": 1e3 * _timed_median(
            lambda: jax.block_until_ready(ct._doubling(st["succ"]))),
        "chain_rank": 1e3 * _timed_median(
            lambda: jax.block_until_ready(
                rank.chain_rank(st["succ"], st["valid2"])))}
    del t, L, R, st, dhi, dlo

    # -- joins: device against host, at several sizes ------------------
    rng = np.random.default_rng(0)
    feats, piv = {}, {}
    saved = matrix._FEATURE_DEVICE_MIN
    matrix._FEATURE_DEVICE_MIN = 0           # time the device side always
    try:
        for n in (1 << 21, 1 << 23, len(keys)):
            sizes = rng.integers(1000, 10000, max(n // 5500, 1))
            allk = rng.choice(keys, int(sizes.sum()))
            starts = np.r_[0, np.cumsum(sizes)[:-1]]

            def host():
                pres = api.presence_counts(allk, keys, counts)
                return np.add.reduceat(pres, starts)

            feats[int(sizes.sum())] = {
                "device_ms": 1e3 * _timed_median(
                    lambda: matrix._feature_segsum_device(
                        allk, keys, counts, sizes, 0)),
                "host_ms": 1e3 * _timed_median(host)}
    finally:
        matrix._FEATURE_DEVICE_MIN = saved
    for n in (1 << 21, 1 << 22):
        g = pivot._Graph.__new__(pivot._Graph)
        g.keys = np.sort(rng.choice(keys, n, replace=False))
        q = pivot.right_neighbors_np(g.keys, K)
        piv[n] = {"device_ms": 1e3 * _timed_median(
                      lambda: g._index_device(q), 1),
                  "host_ms": 1e3 * _timed_median(lambda: g._index(q), 1)}
    out["feature_join_ms"] = feats
    out["pivot_index_ms"] = piv
    print(json.dumps({"metric": "routing_measurements", **info, **out}))


def stress(n_samples: int = 8):
    """Multi-sample matrix pipeline (count -> contigs -> components ->
    features -> Bray-Curtis) plus the presence tier, with the per-stage
    split from the pipeline's progress events.  One JSON line."""
    import resource

    from metafast_jax.oracle import synth
    from metafast_jax.pipeline import matrix_pipeline
    from metafast_jax.stats.presence import PackedPresence

    info = device_info()
    GEN, SHARE, COV = 2_500_000, 1_000_000, 12
    rng = np.random.default_rng(0)
    backbone = synth.random_genome(rng, SHARE)
    with tempfile.TemporaryDirectory() as td:
        files = []
        for s in range(n_samples):
            genome = np.concatenate(
                [backbone, synth.random_genome(rng, GEN - SHARE)])
            n_reads = GEN * COV // READ_LEN
            starts = rng.integers(0, GEN - READ_LEN, n_reads)
            fp = os.path.join(td, f"stress_{s}.fa")
            synth.write_fasta(
                fp, genome[starts[:, None] + np.arange(READ_LEN)])
            files.append(fp)
        n_kmers = n_samples * (GEN * COV // READ_LEN) * (READ_LEN - K + 1)
        t0 = time.perf_counter()
        # stages run strictly in sequence and each progress event fires
        # at its stage's end, so consecutive event times bound each stage
        marks = []

        def progress(stage, name, _info):
            marks.append((stage, name, time.perf_counter() - t0))

        res = matrix_pipeline(files, k=K, b=1, l=100, b1=1000, b2=10000,
                              progress=progress)
        dt_matrix = time.perf_counter() - t0
        t1 = time.perf_counter()
        union = np.unique(np.concatenate(
            [t[0] for t in res.sample_tables]))
        pp = PackedPresence.from_tables(res.sample_tables, union)
        card = pp.cardinality()
        dt_presence = time.perf_counter() - t1
        dt = time.perf_counter() - t0
    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1048576
    stage_s = {}
    per_sample = {"count": [], "contigs": []}
    prev = 0.0
    for stage, name, at in marks:
        stage_s[stage] = stage_s.get(stage, 0.0) + (at - prev)
        if stage in per_sample:
            per_sample[stage].append(at - prev)
        prev = at
    stage_s["features_matrix"] = dt_matrix - prev
    stage_s["presence_stats"] = dt_presence
    off = res.matrix[np.triu_indices(n_samples, 1)]
    print(json.dumps({
        "metric": "matrix_pipeline_throughput",
        "value": n_kmers / dt,
        "unit": "kmers/s",
        **info,
        "n_samples": n_samples,
        "wall_s": dt,
        "total_kmers": n_kmers,
        "peak_host_rss_gb": peak_gb,
        "n_components": len(res.components),
        "union_keys": int(len(union)),
        "cardinality_mean": float(card.mean()),
        "uniques_per_sample": [len(t[0]) for t in res.sample_tables],
        "offdiag_min_max": [float(off.min()), float(off.max())],
        "stage_seconds": stage_s,
        "per_sample_seconds": per_sample,
    }))


if __name__ == "__main__":
    if "--stress" in sys.argv:
        ns = 8
        for a in sys.argv:
            if a.startswith("--samples="):
                ns = int(a.split("=", 1)[1])
        stress(ns)
    elif "--routes" in sys.argv:
        routes()
    else:
        main()
