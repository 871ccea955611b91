"""Multi-chip k-mer counting: hash-shard the key space, all-to-all merge.

The reference scales k-mer counting inside one JVM by striping its hash
table by murmur3(key) (itmo BigLong2ShortHashMap.java:40-70,
src/io/IOUtils.java:775-776).  The mesh equivalent spreads the same
idea over devices:

  1. read batches are sharded over the mesh axis (data parallel),
  2. each device extracts canonical k-mers locally and buckets them by
     hash(key) mod n_shards,
  3. one all-to-all re-shards the buckets so device s receives
     every k-mer whose hash maps to shard s,
  4. each device sort+RLE-counts its shard locally.

Identical keys always hash to the same shard, so per-shard tables are
complete and globally disjoint: no cross-device reduction is needed after
the all-to-all, and saturating adds stay order-independent.

All shapes are static.  The single-batch `sharded_count` uses a fixed
send-bucket capacity and reports dropped k-mers; the streaming
`ShardedKmerCounter` sizes its exchange buckets EXACTLY per consolidation
(one fused stats sync), so its exchange can never drop entries.

The mesh may span multiple processes (jax.distributed over DCN): every
process feeds its local share of each slab in lockstep and finish()
allgathers the per-process shard tables — the cross-host form of the
reference's striped-map key-space scaling (src/io/IOUtils.java:775-776).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..core import bitpack as bp
from ..core.extract import extract_canonical
from ..ops.count import count_flat

U32 = jnp.uint32
AXIS = "shards"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()[:n_devices] if n_devices else jax.devices()
    return Mesh(np.array(devices), (AXIS,))


def hash_shard(hi: jnp.ndarray, lo: jnp.ndarray, n_shards: int) -> jnp.ndarray:
    """Uniform shard id from a key; plays the role of the reference's
    murmurHash3 stripe selector (itmo HashFunctions — we need mixing, not
    that exact function, since shard layout is invisible in outputs)."""
    h = hi * U32(0x85EBCA6B) ^ lo * U32(0xC2B2AE35)
    h ^= h >> 15
    h = h * U32(0x27D4EB2F)
    h ^= h >> 13
    return (h % U32(n_shards)).astype(jnp.int32)


def _bucket_local(hi, lo, n_shards: int, cap: int):
    """Scatter a device's k-mers into [n_shards, cap] send buckets.

    Returns (buf_hi, buf_lo, n_dropped).  Invalid (sentinel) k-mers are
    routed to a virtual overflow slot and never stored.
    """
    flat_hi = hi.reshape(-1)
    flat_lo = lo.reshape(-1)
    valid = ~bp.is_sentinel(flat_hi, flat_lo)
    shard = jnp.where(valid, hash_shard(flat_hi, flat_lo, n_shards), n_shards)

    order = jnp.argsort(shard)
    s_sorted = shard[order]
    h_sorted = flat_hi[order]
    l_sorted = flat_lo[order]

    # position within its shard-run = index - first index of that shard
    idx = jnp.arange(s_sorted.shape[0], dtype=jnp.int32)
    first = jnp.searchsorted(s_sorted, jnp.arange(n_shards + 1, dtype=jnp.int32),
                             side="left").astype(jnp.int32)
    pos = idx - first[jnp.clip(s_sorted, 0, n_shards)]

    keep = (s_sorted < n_shards) & (pos < cap)
    dropped = jnp.sum((s_sorted < n_shards) & (pos >= cap))

    tgt_shard = jnp.where(keep, s_sorted, n_shards - 1)
    tgt_pos = jnp.where(keep, pos, cap - 1)

    buf_hi = jnp.full((n_shards, cap), U32(bp.SENTINEL))
    buf_lo = jnp.full((n_shards, cap), U32(bp.SENTINEL))
    buf_hi = buf_hi.at[tgt_shard, tgt_pos].set(
        jnp.where(keep, h_sorted, U32(bp.SENTINEL)), mode="drop")
    buf_lo = buf_lo.at[tgt_shard, tgt_pos].set(
        jnp.where(keep, l_sorted, U32(bp.SENTINEL)), mode="drop")
    # the .set with a masked value can overwrite a real k-mer at
    # (n_shards-1, cap-1) only when that very slot overflowed anyway.
    return buf_hi, buf_lo, dropped


@partial(jax.jit, static_argnames=("k", "mesh", "cap_per_shard"))
def sharded_count(codes, lengths, *, k: int, mesh: Mesh,
                  cap_per_shard: int = 0):
    """Count canonical k-mers of a global read batch over a device mesh.

    Args:
      codes: [B, L] uint8, B divisible by mesh size (global array).
      lengths: [B] int32.
      k: k-mer size.
      mesh: 1D mesh with axis "shards".
      cap_per_shard: per-(device,shard) send capacity; 0 = no-drop bound
        (local_kmer_count, safe but memory-heavy — fine for tests).

    Returns (hi, lo, counts, n_unique, n_dropped): per-device shard tables
    stacked on the leading axis, each [n_shards, n_shards*cap]; slots past
    n_unique[s] hold sentinels.
    """
    n = mesh.shape[AXIS]
    B, L = codes.shape
    per_dev = B // n
    local_kmers = per_dev * (L - k + 1)
    cap = cap_per_shard or local_kmers

    def step(codes_l, lengths_l):
        hi, lo, _ = extract_canonical(codes_l, lengths_l, k)
        buf_hi, buf_lo, dropped = _bucket_local(hi, lo, n, cap)
        # device i sends row s of its buckets to device s
        recv_hi = jax.lax.all_to_all(buf_hi, AXIS, split_axis=0, concat_axis=0,
                                     tiled=True)
        recv_lo = jax.lax.all_to_all(buf_lo, AXIS, split_axis=0, concat_axis=0,
                                     tiled=True)
        out_hi, out_lo, out_cnt = count_flat(
            recv_hi.reshape(-1), recv_lo.reshape(-1))
        n_unique = jnp.sum(out_cnt > 0).astype(jnp.int32)
        return (out_hi[None], out_lo[None], out_cnt[None], n_unique[None],
                dropped[None])

    return jax.shard_map(
        step, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS)),
        out_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
    )(codes, lengths)


def gather_counts(hi, lo, counts) -> tuple[np.ndarray, np.ndarray]:
    """Host-side: merge per-shard tables into one sorted (keys64, counts)."""
    hi = np.asarray(hi).reshape(-1).astype(np.uint64)
    lo = np.asarray(lo).reshape(-1).astype(np.uint64)
    cnt = np.asarray(counts).reshape(-1)
    keys = (hi << np.uint64(32)) | lo
    keep = cnt > 0
    keys, cnt = keys[keep].astype(np.int64), cnt[keep].astype(np.int32)
    order = np.argsort(keys)
    return keys[order], cnt[order]


# ---------------------------------------------------------------------------
# Streaming sharded counter
# ---------------------------------------------------------------------------
#
# The single-batch sharded_count above re-shards RAW k-mers on every batch,
# which pays an all-to-all (plus bucket padding) per batch.  The streaming
# design below is cheaper and matches the reference's memory story (striped
# maps shard the KEY SPACE, itmo BigLong2ShortHashMap.java:40-70):
#
#   1. read streams are data-parallel over devices; each device extracts
#      and COUNTS its own chunks locally (identical work to a single chip
#      on 1/n of the data — no communication on the hot path);
#   2. counted chunk tables (already unique-compacted, typically 5-20x
#      smaller than raw keys) are hash-bucketed and exchanged with ONE
#      all-to-all per consolidation, so every key settles on its shard
#      device; per-shard accumulators merge them with saturating adds.
#
# Saturation commutes with this split exactly: min(sum_i min(c_i, S), S)
# == min(sum_i c_i, S), so per-device partial counts merged after the
# exchange equal the reference's globally saturated counts.
#
# HBM scaling: per-device accumulator tables hold only that shard's keys
# (1/n of the unique key space), which is what makes CAMI-scale single
# samples fit (SURVEY "HBM-scale tables").

from ..ops.count import (SATURATE, _bucket_size, _bucket_size_fine, _pow2,
                         _rle_compact_weighted, _sort_triple, count_flat,
                         merge_counted)


class ShardOverflowError(RuntimeError):
    """A shard exchange dropped entries.

    With exact per-consolidation bucket sizing this is unreachable by
    construction; it survives as an invariant check."""

    def __init__(self, dropped: int):
        super().__init__(
            f"shard exchange dropped {dropped} k-mer table entries "
            "(internal invariant violated)")
        self.dropped = dropped


def _bucket_weighted(hi, lo, cnt, n_shards: int, cap: int):
    """_bucket_local for counted tables: carries counts alongside keys."""
    valid = ~bp.is_sentinel(hi, lo) & (cnt > 0)
    shard = jnp.where(valid, hash_shard(hi, lo, n_shards), n_shards)
    order = jnp.argsort(shard)
    s_sorted = shard[order]
    h_sorted = hi[order]
    l_sorted = lo[order]
    c_sorted = cnt[order]
    idx = jnp.arange(s_sorted.shape[0], dtype=jnp.int32)
    first = jnp.searchsorted(
        s_sorted, jnp.arange(n_shards + 1, dtype=jnp.int32),
        side="left").astype(jnp.int32)
    pos = idx - first[jnp.clip(s_sorted, 0, n_shards)]
    keep = (s_sorted < n_shards) & (pos < cap)
    dropped = jnp.sum((s_sorted < n_shards) & (pos >= cap))
    tgt_shard = jnp.where(keep, s_sorted, n_shards - 1)
    tgt_pos = jnp.where(keep, pos, cap - 1)
    buf_hi = jnp.full((n_shards, cap), U32(bp.SENTINEL))
    buf_lo = jnp.full((n_shards, cap), U32(bp.SENTINEL))
    buf_cnt = jnp.zeros((n_shards, cap), jnp.int32)
    buf_hi = buf_hi.at[tgt_shard, tgt_pos].set(
        jnp.where(keep, h_sorted, U32(bp.SENTINEL)), mode="drop")
    buf_lo = buf_lo.at[tgt_shard, tgt_pos].set(
        jnp.where(keep, l_sorted, U32(bp.SENTINEL)), mode="drop")
    buf_cnt = buf_cnt.at[tgt_shard, tgt_pos].set(
        jnp.where(keep, c_sorted, 0), mode="drop")
    return buf_hi, buf_lo, buf_cnt, dropped


def _wrap1(fn):
    """Lift a per-device fn over the leading (sharded) axis inside
    shard_map: local blocks arrive as [1, ...]."""
    def inner(*args):
        outs = fn(*(a[0] for a in args))
        if isinstance(outs, tuple):
            return tuple(o[None] for o in outs)
        return outs[None]
    return inner


@partial(jax.jit, static_argnames=("k", "mesh"))
def _sharded_stream_extract(words, vmask, *, k: int, mesh: Mesh):
    """[C_total, ROWS] column streams -> per-device flat keys [n, S]."""
    from ..ops.stream_extract import stream_extract

    def step(w, v):
        hi, lo = stream_extract(w, v, k)
        return hi.reshape(1, -1), lo.reshape(1, -1)

    return jax.shard_map(step, mesh=mesh, in_specs=(P(AXIS), P(AXIS)),
                         out_specs=(P(AXIS), P(AXIS)))(words, vmask)


@partial(jax.jit, static_argnames=("k", "mesh"))
def _sharded_stream3_extract(w0, w1, w2, vm, *, k: int, mesh: Mesh):
    """Compact 3-stream variant of _sharded_stream_extract."""
    from ..ops.stream_extract import stream3_extract

    def step(a, b, c, v):
        hi, lo = stream3_extract(a, b, c, v, k)
        return hi.reshape(1, -1), lo.reshape(1, -1)

    return jax.shard_map(step, mesh=mesh, in_specs=(P(AXIS),) * 4,
                         out_specs=(P(AXIS), P(AXIS)))(w0, w1, w2, vm)


@partial(jax.jit, static_argnames=("mesh",))
def _sharded_count_flat(hi, lo, *, mesh: Mesh):
    return jax.shard_map(_wrap1(count_flat), mesh=mesh,
                         in_specs=(P(AXIS), P(AXIS)),
                         out_specs=(P(AXIS),) * 3)(hi, lo)


@partial(jax.jit, static_argnames=("n_shards",))
def _consolidate_stats(hi, lo, cnt, n_shards: int):
    """[max live per device, max (device, shard) bucket occupancy].

    One fused dispatch so the host syncs a single [2] vector per
    consolidation: the first drives the level trim, the second sizes the
    exchange buckets EXACTLY (no drops, no overflow retries).
    """
    live = cnt > 0
    max_live = jnp.max(jnp.sum(live, axis=1))
    shard = jnp.where(live, hash_shard(hi, lo, n_shards), n_shards)
    occ = jnp.stack([jnp.sum(shard == s, axis=1)
                     for s in range(n_shards)])
    return jnp.stack([max_live.astype(jnp.int32),
                      jnp.max(occ).astype(jnp.int32)])


@partial(jax.jit, static_argnames=("mesh",))
def _sharded_merge_counted(ha, la, ca, hb, lb, cb, *, mesh: Mesh):
    return jax.shard_map(_wrap1(merge_counted), mesh=mesh,
                         in_specs=(P(AXIS),) * 6,
                         out_specs=(P(AXIS),) * 3)(ha, la, ca, hb, lb, cb)


@partial(jax.jit, static_argnames=("mesh", "cap"))
def _sharded_exchange(hi, lo, cnt, *, mesh: Mesh, cap: int):
    """All-to-all counted tables onto their hash shards; RLE-merge the
    received rows (keys may repeat across source devices)."""
    n = mesh.shape[AXIS]

    def step(h, l, c):
        bh, bl, bc, dropped = _bucket_weighted(h[0], l[0], c[0], n, cap)
        rh = jax.lax.all_to_all(bh, AXIS, split_axis=0, concat_axis=0,
                                tiled=True)
        rl = jax.lax.all_to_all(bl, AXIS, split_axis=0, concat_axis=0,
                                tiled=True)
        rc = jax.lax.all_to_all(bc, AXIS, split_axis=0, concat_axis=0,
                                tiled=True)
        h2, l2, c2 = _sort_triple(rh.reshape(-1), rl.reshape(-1),
                                  rc.reshape(-1))
        out = _rle_compact_weighted(h2, l2, c2)
        return out[0][None], out[1][None], out[2][None], dropped[None]

    return jax.shard_map(step, mesh=mesh, in_specs=(P(AXIS),) * 3,
                         out_specs=(P(AXIS),) * 4)(hi, lo, cnt)


def _trim_sharded(table, n_dev: int):
    """Slice a [n, m] counted table to pow2(max live across devices)."""
    hi, lo, cnt = table
    live = int(jnp.max(jnp.sum(cnt > 0, axis=1)))
    return _trim_to(table, _pow2(max(live, 1)))


def _trim_to(table, m: int):
    hi, lo, cnt = table
    if m >= hi.shape[1]:
        return table
    return (jax.lax.slice_in_dim(hi, 0, m, axis=1),
            jax.lax.slice_in_dim(lo, 0, m, axis=1),
            jax.lax.slice_in_dim(cnt, 0, m, axis=1))


def _pad_sharded(table, size: int, filler=None):
    hi, lo, cnt = table
    n, m = hi.shape
    if m == size:
        return table
    pad = size - m
    mk = filler if filler is not None else (
        lambda cols, fill, dtype: jnp.full((n, cols), fill, dtype))
    return (jnp.concatenate([hi, mk(pad, bp.SENTINEL, U32)], axis=1),
            jnp.concatenate([lo, mk(pad, bp.SENTINEL, U32)], axis=1),
            jnp.concatenate([cnt, mk(pad, 0, jnp.int32)], axis=1))


from functools import lru_cache


@lru_cache(maxsize=None)
def _sharded_full(rows: int, cols: int, fill: int, dtype: str, mesh: Mesh):
    """Cached jitted constructor of a row-sharded [rows, cols] constant
    (valid on multi-process meshes, where plain jnp.full is local-only)."""
    sh = jax.NamedSharding(mesh, P(AXIS))
    return jax.jit(lambda: jnp.full((rows, cols), fill, jnp.dtype(dtype)),
                   out_shardings=sh)


def _allgather_table(keys: np.ndarray, cnt: np.ndarray):
    """Union of per-process (keys, counts) tables over DCN.

    Shards are disjoint hash ranges, so the union is exact; padding to
    the max per-process length keeps process_allgather shapes equal.
    64-bit keys travel as uint32 pairs — with x64 disabled, JAX silently
    narrows int64 arrays to int32, which would corrupt key high words."""
    from jax.experimental import multihost_utils

    lens = multihost_utils.process_allgather(
        np.array([len(keys)], np.int32))
    m = int(lens.max())
    pk = np.zeros(m, np.int64)
    pc = np.zeros(m, np.int32)
    pk[:len(keys)] = keys
    pc[:len(keys)] = cnt
    allk = multihost_utils.process_allgather(
        np.ascontiguousarray(pk).view(np.uint32))
    allc = multihost_utils.process_allgather(pc)
    lens = lens.reshape(-1)
    keys = np.concatenate([
        np.ascontiguousarray(allk[i]).view(np.int64)[:lens[i]]
        for i in range(len(lens))])
    cnt = np.concatenate([allc[i][:lens[i]] for i in range(len(lens))])
    order = np.argsort(keys)
    return keys[order], cnt[order]


def _allgather_sum(x: int) -> int:
    from jax.experimental import multihost_utils

    # x64-safe: ship the 64-bit value as two uint32 halves
    halves = multihost_utils.process_allgather(np.array(
        [(x >> 32) & 0xFFFFFFFF, x & 0xFFFFFFFF], np.uint32))
    return sum((int(h[0]) << 32) | int(h[1]) for h in np.asarray(halves))


class ShardedKmerCounter:
    """Streaming canonical k-mer counter over a device mesh.

    The multi-chip equivalent of ops.count.KmerCounter (same binary-
    counter level discipline, same saturating semantics, same host-spill
    guard); see the module comment above for the communication plan.
    Feed it column streams built by ops.stream_extract.build_stream with
    lane_multiple = 128 * mesh size (the local share on multi-process
    meshes).  `cap_factor` is accepted for backward compatibility and
    ignored — exchange buckets are sized exactly.
    """

    def __init__(self, k: int, mesh: Mesh, chunk: int = 1 << 27,
                 cap_factor: float = 2.0, spill: int | None = 1 << 27):
        # same k bound as ops.count.KmerCounter (int64 key-order invariant)
        if not (1 <= k <= 31):
            raise ValueError(f"k must be in [1, 31], got {k}")
        self.k = k
        self.mesh = mesh
        self.n = mesh.shape[AXIS]
        self._chunk = chunk                 # local raw slots per device
        self._cap_factor = cap_factor
        self._pending: list = []            # [n, S] raw key arrays
        self._pending_n = 0                 # per-device slot count
        self._levels: dict = {}             # size -> [n, size] tables
        self._dropped: list = []            # deferred device scalars
        # per-device counted level width (slots) beyond which the level
        # moves to host RAM (mirrors ops.count.KmerCounter._spill); None
        # disables spilling
        self._spill = spill
        self._spilled: list = []            # host (keys, counts) tables
        self._total_host = 0
        self._sharding = jax.NamedSharding(mesh, P(AXIS))
        # does the mesh span multiple processes (cross-host DCN case)?
        self._multiproc = jax.process_count() > 1 and any(
            d.process_index != jax.process_index()
            for d in mesh.devices.flat)

    @property
    def total_kmers_seen(self) -> int:
        return self._total_host

    def add_stream(self, words, vmask, lengths) -> None:
        """Feed one column-stream slab.

        Single-process mesh: words/vmask are the GLOBAL [C_total, ROWS]
        u32 arrays with C_total % (n*128) == 0.

        Multi-process mesh (jax.distributed): every process calls
        add_stream in lockstep with its LOCAL share [C_total/P, ROWS]
        (equal on every process; the global array is assembled with
        jax.make_array_from_process_local_data).  `lengths` is whatever
        read set this process accounts for — pass the global slab
        lengths on process 0 and empty arrays elsewhere, or per-host
        lengths; finish() sums accounting over processes.
        """
        self._total_host += int(np.maximum(
            np.asarray(lengths).astype(np.int64) - self.k + 1, 0).sum())
        if self._multiproc:
            nproc = jax.process_count()
            words = np.asarray(words)
            vmask = np.asarray(vmask)
            gshape = (words.shape[0] * nproc, words.shape[1])
            words = jax.make_array_from_process_local_data(
                self._sharding, words, gshape)
            vmask = jax.make_array_from_process_local_data(
                self._sharding, vmask, gshape)
        else:
            words = jax.device_put(words, self._sharding)
            vmask = jax.device_put(vmask, self._sharding)
        hi, lo = _sharded_stream_extract(words, vmask, k=self.k,
                                         mesh=self.mesh)
        self._pending.append((hi, lo))
        self._pending_n += hi.shape[1]
        if self._pending_n >= self._chunk:
            self._consolidate()

    def add_stream3(self, w0, w1, w2, vm, lengths) -> None:
        """add_stream over the compact 3-stream layout (build_stream3):
        same lockstep contract, ~1.07 sorted slots per k-mer instead of
        ~1.26 (the per-shard count sorts dominate)."""
        self._total_host += int(np.maximum(
            np.asarray(lengths).astype(np.int64) - self.k + 1, 0).sum())
        bufs = [w0, w1, w2, vm]
        if self._multiproc:
            nproc = jax.process_count()
            out = []
            for b in bufs:
                b = np.asarray(b)
                gshape = (b.shape[0] * nproc, b.shape[1])
                out.append(jax.make_array_from_process_local_data(
                    self._sharding, b, gshape))
            bufs = out
        else:
            bufs = [jax.device_put(b, self._sharding) for b in bufs]
        hi, lo = _sharded_stream3_extract(*bufs, k=self.k,
                                          mesh=self.mesh)
        self._pending.append((hi, lo))
        self._pending_n += hi.shape[1]
        if self._pending_n >= self._chunk:
            self._consolidate()

    def _full(self, cols: int, fill, dtype):
        """A [n, cols] constant with the mesh's row sharding (works on
        multi-process meshes, where plain jnp.full would be local)."""
        return _sharded_full(self.n, cols, int(fill), np.dtype(dtype).name,
                             self.mesh)()

    def _consolidate(self) -> None:
        if not self._pending:
            return
        size = _bucket_size_fine(self._pending_n)
        his = [p[0] for p in self._pending]
        los = [p[1] for p in self._pending]
        if size > self._pending_n:
            pad = size - self._pending_n
            his.append(self._full(pad, bp.SENTINEL, U32))
            los.append(self._full(pad, bp.SENTINEL, U32))
        hi = jnp.concatenate(his, axis=1)
        lo = jnp.concatenate(los, axis=1)
        self._pending = []
        self._pending_n = 0
        table = _sharded_count_flat(hi, lo, mesh=self.mesh)
        # ONE host sync per consolidation sizes both the trim and the
        # exchange buckets exactly — no bucket can overflow, so the
        # cap_factor retry loop of earlier rounds is structurally dead
        stats = np.asarray(_consolidate_stats(*table, self.n))
        max_live, max_bucket = int(stats[0]), int(stats[1])
        table = _trim_to(table, _pow2(max(max_live, 1)))
        cap = max(16, _bucket_size(max_bucket))
        h, l, c, dropped = _sharded_exchange(*table, mesh=self.mesh,
                                             cap=cap)
        self._dropped.append(dropped)
        self._insert(_trim_sharded((h, l, c), self.n))

    def _insert(self, table) -> None:
        size = table[0].shape[1]
        while size in self._levels:
            other = self._levels.pop(size)
            table = _sharded_merge_counted(*table, *other, mesh=self.mesh)
            table = _trim_sharded(table, self.n)
            size = table[0].shape[1]
        if self._spill is not None and size >= self._spill:
            # HBM guard: levels past `spill` per-device slots move to
            # host RAM (each process keeps its own shards); finish()
            # folds them back with the streaming numpy merge
            self._spilled.append(self._fetch_local(table))
        else:
            self._levels[size] = table

    def _fetch_local(self, table):
        """Device table -> host (keys int64, counts int32), this
        process's shards only (all shards on a single-process mesh)."""
        hi, lo, cnt = table
        if self._multiproc:
            # order shards by their global row so hi/lo/cnt stay paired
            cat = lambda a: np.concatenate(
                [np.asarray(s.data).reshape(-1)
                 for s in sorted(a.addressable_shards,
                                 key=lambda s: s.index[0].start or 0)])
            hi, lo, cnt = cat(hi), cat(lo), cat(cnt)
        else:
            hi = np.asarray(hi).reshape(-1)
            lo = np.asarray(lo).reshape(-1)
            cnt = np.asarray(cnt).reshape(-1)
        keep = cnt > 0
        keys = ((hi[keep].astype(np.uint64) << np.uint64(32))
                | lo[keep].astype(np.uint64)).astype(np.int64)
        return keys, cnt[keep].astype(np.int32)

    def finish(self):
        """(keys int64 sorted ascending, counts int32) on the host.

        On a multi-process mesh every process returns the same complete
        table (per-process shards are allgathered over DCN).  Raises
        ShardOverflowError only if an exchange dropped entries, which the
        exact bucket sizing in _consolidate rules out by construction —
        the check is a cheap invariant, not a control path."""
        self._consolidate()
        dropped = sum(int(jnp.sum(jnp.asarray(d))) for d in self._dropped)
        if dropped:
            raise ShardOverflowError(dropped)
        while len(self._levels) > 1:
            sizes = sorted(self._levels)
            small = self._levels.pop(sizes[0])
            self._insert(_pad_sharded(small, sizes[1],
                                      filler=self._full))
        tables = list(self._spilled)
        self._spilled = []
        if self._levels:
            ((_, table),) = self._levels.items()
            self._levels = {}
            tables.append(self._fetch_local(table))
        if not tables:
            keys = np.empty(0, dtype=np.int64)
            cnt = np.empty(0, dtype=np.int32)
        elif len(tables) == 1:
            keys, cnt = tables[0]
            order = np.argsort(keys)    # shards are disjoint hash ranges
            keys, cnt = keys[order], cnt[order]
        else:
            from ..ops.count import merge_host_tables
            # spilled levels + the final level may share keys within this
            # process's shards; counts saturate on merge (reference
            # parity, itmo NumUtils.java:21-26)
            keys, cnt = merge_host_tables(tables)
        if self._multiproc:
            keys, cnt = _allgather_table(keys, cnt)
            self._total_host = int(_allgather_sum(self._total_host))
        return keys, cnt
