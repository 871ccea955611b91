"""High-level host API tying I/O, device kernels, and graph algorithms.

These are the operations the CLI tools compose; they are also the stable
programmatic surface for library users.
"""

from __future__ import annotations

import numpy as np

from .core import bitpack as bp
from .io import binfmt, reads as readsio
from .ops.count import KmerCounter


def split_keys(keys64: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    u = np.asarray(keys64, dtype=np.int64).astype(np.uint64)
    return (u >> np.uint64(32)).astype(np.uint32), (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def join_keys(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return ((np.asarray(hi, dtype=np.uint64) << np.uint64(32))
            | np.asarray(lo, dtype=np.uint64)).astype(np.int64)


# Default device mesh for counting: set by the CLI's --shards flag (or by
# callers via set_default_mesh); count_reads_files then routes through the
# streaming ShardedKmerCounter.
_default_mesh = None

# codes per device slab (~128M): bounds the [16, C, 256] key planes the
# stream kernel emits to ~1 GB while amortizing dispatch; module-level so
# tests can shrink it to force the multi-slab pipeline
SLAB_CODES = 1 << 27


def set_default_mesh(mesh) -> None:
    global _default_mesh
    _default_mesh = mesh


def get_default_mesh():
    return _default_mesh


def _parse_whole(path: str, min_len: int):
    """(codes, lengths, n_total, n_skipped) via native parse or the
    python fallback, with min_len applied."""
    from .io import native_reads

    parsed = None
    try:
        parsed = native_reads.parse_file(path)
    except Exception:
        parsed = None
    if parsed is None:
        cs, ls = [], []
        last = None
        for batch in readsio.read_batches(path, min_len=min_len):
            for i, ln in enumerate(batch.lengths):
                cs.append(batch.codes[i, :ln])
            ls.append(batch.lengths)
            last = batch
        codes = np.concatenate(cs) if cs else np.zeros(0, np.uint8)
        lengths = (np.concatenate(ls).astype(np.int32) if ls
                   else np.zeros(0, np.int32))
        n_total = last.n_total if last is not None else 0
        n_skip = last.n_skipped if last is not None else 0
        return codes, lengths, n_total, n_skip
    codes, lengths, skipped = parsed
    total = len(lengths) + skipped
    if min_len > 0 and len(lengths):
        keep = lengths >= min_len
        skipped += int((~keep).sum())
        sel = np.repeat(keep, lengths)
        codes, lengths = codes[sel], lengths[keep]
    return codes, lengths, total, skipped


def _parse_process_share(path: str, min_len: int, p: int, P: int):
    """This process's share of one input file.

    Preferred: a disjoint record-aligned byte range — each process parses
    ~1/P of the bytes (the multi-host analog of the reference's byte
    dispatcher, src/io/BytesDispatcher.java:39-67).  Formats that cannot
    be range-split (compressed, binq) fall back to a full parse with a
    contiguous read-range share (pack work still 1/P; parse duplicated).

    Returns (codes, lengths, reads_acct, skipped_acct) — the accounting
    fields sum to the global file totals across processes.
    """
    import os

    from .io import native_reads

    ok = False
    try:
        sz = os.path.getsize(path)
        # every process checks EVERY boundary snap (deterministic, reads
        # <= 512 KB each): if any snap fails — e.g. the FASTQ record
        # heuristic finds no candidate near one offset — ALL processes
        # must take the fallback together, or byte-range shares and
        # read-slice shares would overlap
        bounds = [native_reads.record_boundary(path, q * sz // P)
                  for q in range(P + 1)]
        ok = all(b is not None for b in bounds)
    except Exception:
        ok = False
    import jax

    if P > 1 and jax.process_count() > 1:
        # the snap is deterministic, but a transient per-host I/O error
        # is not: one process taking the read-slice fallback while the
        # rest split byte ranges would silently double-count — agree on
        # the path with one small DCN allgather (mirrors the slab-shape
        # lockstep in count_reads_files_sharded)
        from jax.experimental import multihost_utils
        votes = np.asarray(multihost_utils.process_allgather(
            np.array([1 if ok else 0], np.uint32)))
        ok = bool(votes.min())
    res = None
    if ok:
        try:
            res = native_reads.parse_file_range(path, p * sz // P,
                                                (p + 1) * sz // P)
        except Exception:
            res = None
        if res is None:
            raise IOError(
                f"record-aligned range parse failed on {path} after all "
                f"processes agreed the file is range-splittable; failing "
                f"loudly rather than silently double-counting")
    if res is not None:
        codes, lengths, skipped = res
        total = len(lengths) + skipped
        if min_len > 0 and len(lengths):
            keep = lengths >= min_len
            skipped += int((~keep).sum())
            sel = np.repeat(keep, lengths)
            codes, lengths = codes[sel], lengths[keep]
        return codes, lengths, total, skipped
    codes, lengths, n_total, n_skip = _parse_whole(path, min_len)
    n = len(lengths)
    offs = np.concatenate([[0], np.cumsum(lengths.astype(np.int64))])
    r0, r1 = n * p // P, n * (p + 1) // P
    share_codes = codes[offs[r0]:offs[r1]]
    share_lengths = lengths[r0:r1]
    # whole-file totals are counted once (process 0)
    return (share_codes, share_lengths,
            n_total if p == 0 else 0, n_skip if p == 0 else 0)


def count_reads_files_sharded(files: list[str], k: int, mesh,
                              min_len: int = 0, cap_factor: float = 2.0,
                              progress=None, spill: int | None = 1 << 27):
    """count_reads_files over a device mesh (parallel.ShardedKmerCounter).

    Read streams are data-parallel over the mesh; the k-mer key space is
    hash-sharded across devices (the mesh form of the reference's
    striped maps, itmo BigLong2ShortHashMap.java:40-70).  Exchange
    buckets are sized exactly per consolidation (parallel/count.py
    _consolidate_stats), so shard overflow cannot occur.

    Host pipeline: a background thread packs slab i+1 (build_stream C++)
    while the devices count slab i — the dispatcher/worker overlap of
    src/io/ReadsDispatcher.java:34-54, applied to the sharded path.  On
    multi-process meshes each process parses only its own record-aligned
    byte range of every file (_parse_process_share); slab shapes stay in
    lockstep via one small per-file allgather of column counts.
    """
    from concurrent.futures import ThreadPoolExecutor

    import jax

    from .ops.stream_extract import build_stream, stream_cols
    from .parallel.count import ShardedKmerCounter, _allgather_sum

    n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    counter = ShardedKmerCounter(k, mesh, cap_factor=cap_factor,
                                 spill=spill)
    multi = counter._multiproc
    P = jax.process_count() if multi else 1
    p = jax.process_index() if multi else 0
    local_dev = max(n_dev // P, 1)
    n_reads = 0
    n_skipped = 0
    reads_done = 0
    kmers_est = 0
    local_slab = max(SLAB_CODES // P, 1)

    def _slab_plan(lengths, offs):
        """[(r0, r1)] read ranges with <= local_slab codes each."""
        cuts = []
        r0 = 0
        while r0 < len(lengths):
            r1 = int(np.searchsorted(offs, offs[r0] + local_slab,
                                     side="right")) - 1
            r1 = min(max(r1, r0 + 1), len(lengths))
            cuts.append((r0, r1))
            r0 = r1
        return cuts

    with ThreadPoolExecutor(1) as pool:
        for path in files:
            if multi:
                codes, lengths, racct, sacct = _parse_process_share(
                    path, min_len, p, P)
                n_reads += racct
                n_skipped += sacct
            else:
                codes, lengths, racct, sacct = _parse_whole(path, min_len)
                n_reads += racct
                n_skipped += sacct
            offs = np.concatenate([[0], np.cumsum(lengths.astype(np.int64))])
            cuts = _slab_plan(lengths, offs)
            from .native import load_library
            from .ops.stream_extract import stream3_cols

            use3 = load_library() is not None
            if multi:
                # one small DCN allgather keeps slab shapes in lockstep:
                # lane unit from the GLOBAL code volume, per-slab column
                # targets = max over processes
                total_codes = _allgather_sum(int(offs[-1]))
                unit = 128 if total_codes >= (1 << 22) else 8
                lane_mult = local_dev * unit
                if use3:
                    cols = np.array(
                        [stream3_cols(lengths[r0:r1], k, lane_mult)
                         for r0, r1 in cuts], dtype=np.int32)
                else:
                    cols = np.array(
                        [stream_cols(int(offs[r1] - offs[r0]), lane_mult)
                         for r0, r1 in cuts], dtype=np.int32)
                from jax.experimental import multihost_utils
                cnt = multihost_utils.process_allgather(
                    np.array([len(cols)], np.int32))
                m = int(np.asarray(cnt).max())
                buf = np.zeros(m, np.int32)
                buf[:len(cols)] = cols
                allc = np.asarray(multihost_utils.process_allgather(buf))
                targets = allc.reshape(P, m).max(axis=0)
                cuts = cuts + [(len(lengths), len(lengths))] * (m - len(cuts))
            else:
                unit = 128 if offs[-1] >= (1 << 22) else 8
                lane_mult = n_dev * unit
                targets = [0] * len(cuts)

            def _prepare(r0, r1, min_cols):
                if use3:
                    from .ops.stream_extract import build_stream3

                    return build_stream3(codes[offs[r0]:offs[r1]],
                                         lengths[r0:r1], k,
                                         lane_multiple=lane_mult,
                                         min_cols=int(min_cols))[:4]
                return build_stream(codes[offs[r0]:offs[r1]],
                                    lengths[r0:r1], k,
                                    lane_multiple=lane_mult,
                                    min_cols=int(min_cols))[:2]

            def _feed(pr0, pr1, bufs):
                nonlocal reads_done, kmers_est
                if use3:
                    counter.add_stream3(*bufs, lengths[pr0:pr1])
                else:
                    counter.add_stream(*bufs, lengths[pr0:pr1])
                if progress is not None:
                    reads_done += pr1 - pr0
                    kmers_est += int(np.maximum(
                        lengths[pr0:pr1].astype(np.int64) - (k - 1),
                        0).sum())
                    progress(dict(path=path, reads=reads_done,
                                  kmers=kmers_est))

            pending = None
            for (r0, r1), tgt in zip(cuts, targets):
                fut = pool.submit(_prepare, r0, r1, tgt)
                if pending is not None:
                    (pr0, pr1), pfut = pending
                    _feed(pr0, pr1, pfut.result())
                pending = ((r0, r1), fut)
            if pending is not None:
                (pr0, pr1), pfut = pending
                _feed(pr0, pr1, pfut.result())
    keys, counts = counter.finish()
    if multi:
        n_reads = _allgather_sum(n_reads)
        n_skipped = _allgather_sum(n_skipped)
    stats = dict(reads=n_reads, skipped=n_skipped,
                 kmers_seen=counter.total_kmers_seen, unique=len(keys))
    return keys, counts, stats


def count_codes(counter: KmerCounter, codes: np.ndarray,
                lengths: np.ndarray, on_slab=None) -> None:
    """Feed flat read codes to `counter` in slabs of <= SLAB_CODES codes.

    Double-buffered: a background thread packs and uploads slab i+1
    (the native stream builder + device_put) while the device counts
    slab i — the analog of the reference's dispatcher/worker read pool
    (src/io/ReadsDispatcher.java:34-54).  `on_slab(lengths)` runs after
    each slab is queued.
    """
    from concurrent.futures import ThreadPoolExecutor

    import jax

    from .native import load_library
    from .ops.stream_extract import build_stream, build_stream3

    k = counter.k
    # compact 3-stream layout when the native builder exists: the sort
    # runs on ~1.07 slots/kmer instead of ~1.26
    use3 = load_library() is not None

    def _prepare(codes_s, lengths_s):
        if use3:
            w0, w1, w2, vm, _ = build_stream3(codes_s, lengths_s, k)
            return [jax.device_put(x) for x in (w0, w1, w2, vm)], lengths_s
        words, vmask, _ = build_stream(codes_s, lengths_s, k)
        return [jax.device_put(words), jax.device_put(vmask)], lengths_s

    def _slabs():
        offs = np.concatenate([[0], np.cumsum(lengths.astype(np.int64))])
        r0 = 0
        while r0 < len(lengths):
            # largest r1 with offs[r1] - offs[r0] <= SLAB_CODES
            r1 = int(np.searchsorted(offs, offs[r0] + SLAB_CODES,
                                     side="right")) - 1
            r1 = min(max(r1, r0 + 1), len(lengths))
            yield codes[offs[r0]:offs[r1]], lengths[r0:r1]
            r0 = r1

    def _consume(fut):
        bufs, ls = fut.result()
        if use3:
            counter.add_stream3_device(*bufs, ls)
        else:
            counter.add_stream_device(*bufs, ls)
        if on_slab is not None:
            on_slab(ls)

    with ThreadPoolExecutor(1) as pool:
        pending = None
        for codes_s, lengths_s in _slabs():
            fut = pool.submit(_prepare, codes_s, lengths_s)
            if pending is not None:
                _consume(pending)
            pending = fut
        if pending is not None:
            _consume(pending)


def count_reads_files(files: list[str], k: int, min_len: int = 0,
                      batch_reads: int = 1 << 19, progress=None):
    """Canonical k-mer counts over read/sequence files (one sample).

    Parity: IOUtils.loadReads (src/io/IOUtils.java:742-803) — all files
    accumulate into one table; reads shorter than min_len or containing
    invalid characters are skipped; counts saturate at 32767.

    `progress`, if given, is called per slab with ONE dict argument
    (keys: path, reads, kmers).  NOTE: this replaced the round-1
    two-argument `progress(path, batch)` shape.

    Returns (keys int64 sorted, counts int32, stats dict).
    """
    if _default_mesh is not None and _default_mesh.devices.size > 1:
        return count_reads_files_sharded(files, k, mesh=_default_mesh,
                                         min_len=min_len, progress=progress)

    counter = KmerCounter(k, capacity=1 << 16)
    n_reads = 0
    n_skipped = 0
    parsed_files = []        # (path, codes, lengths) from the native parser
    py_files = []
    for path in files:
        parsed = None
        try:
            from .io import native_reads
            parsed = native_reads.parse_file(path)
        except Exception:
            parsed = None
        if parsed is None:
            py_files.append(path)
            continue
        codes, lengths, skipped = parsed
        total = len(lengths) + skipped
        if min_len > 0 and len(lengths):
            keep = lengths >= min_len
            skipped += int((~keep).sum())
            sel = np.repeat(keep, lengths)
            codes, lengths = codes[sel], lengths[keep]
        n_reads += total
        n_skipped += skipped
        parsed_files.append((path, codes, lengths))

    reads_done = 0
    kmers_est = 0
    for path, codes, lengths in parsed_files:
        def on_slab(ls, path=path):
            nonlocal reads_done, kmers_est
            if progress is not None:
                reads_done += len(ls)
                kmers_est += int(np.maximum(
                    ls.astype(np.int64) - (k - 1), 0).sum())
                progress(dict(path=path, reads=reads_done,
                              kmers=kmers_est))

        count_codes(counter, codes, lengths, on_slab)
    for path in py_files:
        last = None
        for batch in readsio.read_batches(path, batch_reads=batch_reads,
                                          min_len=min_len):
            counter.add_batch(batch.codes, batch.lengths)
            last = batch
            if progress is not None:
                reads_done += len(batch.lengths)
                kmers_est += int(np.maximum(
                    batch.lengths.astype(np.int64) - (k - 1), 0).sum())
                progress(dict(path=path, reads=reads_done,
                              kmers=kmers_est))
        if last is not None:
            n_reads += last.n_total
            n_skipped += last.n_skipped
    keys, counts = counter.finish()
    stats = dict(reads=n_reads, skipped=n_skipped,
                 kmers_seen=counter.total_kmers_seen, unique=len(keys))
    return keys, counts, stats


def load_kmers_bin(files: list[str], threshold: int):
    """Load + merge k-mer binary files, keeping records with count > threshold.

    Parity: IOUtils.loadKmers (src/io/IOUtils.java:369-401): the per-record
    filter applies *before* merging; merged counts saturate at 32767.

    Returns (keys int64 sorted, counts int32).
    """
    tables = []
    for path in files:
        keys, counts = binfmt.read_kmers_bin(path)
        keep = counts > threshold
        tables.append((keys[keep], counts[keep]))
    if len(tables) == 1:
        keys, counts = tables[0]
        order = np.argsort(keys, kind="stable")
        return keys[order], np.minimum(counts[order], 32767).astype(np.int32)
    # saturating merge across files
    allk = np.concatenate([t[0] for t in tables])
    allc = np.concatenate([t[1] for t in tables]).astype(np.int64)
    order = np.argsort(allk, kind="stable")
    allk, allc = allk[order], allc[order]
    uniq, start = np.unique(allk, return_index=True)
    sums = np.add.reduceat(allc, start)
    return uniq, np.minimum(sums, 32767).astype(np.int32)


def presence_counts(component_keys: np.ndarray, sample_keys: np.ndarray,
                    sample_counts: np.ndarray) -> np.ndarray:
    """Per-key sample count for keys present in the sample, else 0.

    Parity: IOUtils.calculatePresenceForKmers (src/io/IOUtils.java:577-597).
    Both key arrays must be int64; sample_keys sorted.
    """
    component_keys = np.asarray(component_keys)
    if len(sample_keys) == 0:
        return np.zeros(len(component_keys), dtype=np.int64)
    # searching in ascending query order walks the table once instead of
    # missing the cache on every random probe (~10x on large tables)
    order = np.argsort(component_keys, kind="stable")
    idx = np.empty(len(component_keys), dtype=np.int64)
    idx[order] = np.searchsorted(sample_keys, component_keys[order])
    idx = np.clip(idx, 0, len(sample_keys) - 1)
    hit = sample_keys[idx] == component_keys
    return np.where(hit, sample_counts[idx], 0).astype(np.int64)
