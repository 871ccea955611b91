"""Device k-mer counting: lexicographic sort + run-length segment reduce.

The reference counts k-mers with a striped concurrent hash table
(itmo BigLong2ShortHashMap, src/io/IOUtils.java:742-803).  The data-parallel
formulation here is sort-based instead:

    extract -> sort (hi, lo) pairs -> run-length-encode -> merge runs

All arrays are fixed-shape; invalid slots carry the SENTINEL key which sorts
to the end and is dropped on the host.  Counts saturate at 32767 to match
the reference (itmo NumUtils.java:21-26) — since saturation is a monotone
cap, merging partial counts with saturating adds is order-independent.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import bitpack as bp

U32 = jnp.uint32
SATURATE = 32767


# NOTE on jit granularity: extract, sort and RLE are jitted separately,
# which keeps each compile small; large-sort compiles are also written to
# the persistent compilation cache (metafast_jax/__init__).

def _pad1(x, out: int, fill):
    n = x.shape[0]
    if out == n:
        return x
    return jnp.concatenate([x, jnp.full((out - n,), fill, x.dtype)])


@partial(jax.jit, static_argnames=("k", "out"))
def _extract_flat(codes, lengths, k: int, out: int = 0):
    from ..core.extract import extract_canonical

    hi, lo, _valid = extract_canonical(codes, lengths, k)
    hi, lo = hi.ravel(), lo.ravel()
    if out:
        hi = _pad1(hi, out, bp.SENTINEL)
        lo = _pad1(lo, out, bp.SENTINEL)
    return hi, lo


@jax.jit
def _sort_pair(hi, lo):
    return jax.lax.sort((hi, lo), num_keys=2, is_stable=False)


def count_batch(codes, lengths, k: int):
    """Count canonical k-mers of one read batch.

    Returns (uhi, ulo, counts) of the same flat length N = B*P: unique keys
    compacted to the front (sorted ascending), SENTINEL-padded tail,
    counts int32 (0 on padding).
    """
    hi, lo = _extract_flat(codes, lengths, k)
    return count_flat(hi, lo)


@partial(jax.jit, static_argnames=("k", "L", "out"))
def _extract_flat_packed(packed, lengths, k: int, L: int, out: int = 0):
    from ..core.extract import extract_canonical_packed

    hi, lo, _valid = extract_canonical_packed(packed, lengths, k, L)
    hi, lo = hi.ravel(), lo.ravel()
    if out:
        hi = _pad1(hi, out, bp.SENTINEL)
        lo = _pad1(lo, out, bp.SENTINEL)
    return hi, lo


def count_batch_packed(packed, lengths, k: int, L: int):
    """count_batch over 2-bit packed codes ([B, L//4] bytes)."""
    hi, lo = _extract_flat_packed(jnp.asarray(packed), jnp.asarray(lengths),
                                  k, L)
    return count_flat(hi, lo)


def count_flat(hi, lo):
    """Sort + RLE a flat array of (hi, lo) keys (SENTINEL = ignore)."""
    hi, lo = _sort_pair(hi, lo)
    return _rle_compact_ones(hi, lo)


@jax.jit
def _sort_triple(hi, lo, cnt):
    return jax.lax.sort((hi, lo, cnt), num_keys=2, is_stable=False)


def merge_counted(hi_a, lo_a, cnt_a, hi_b, lo_b, cnt_b):
    """Merge two counted (sorted, sentinel-padded) arrays with saturating add.

    Output length = len(a) + len(b), unique keys front-compacted, sorted.
    """
    hi = jnp.concatenate([hi_a, hi_b])
    lo = jnp.concatenate([lo_a, lo_b])
    cnt = jnp.concatenate([cnt_a, cnt_b]).astype(jnp.int32)
    hi, lo, cnt = _sort_triple(hi, lo, cnt)
    return _rle_compact_weighted(hi, lo, cnt)


@jax.jit
def _rle_compact_ones(hi, lo):
    """Run-length reduce SORTED keys with unit weights.

    With unit weights every run total is pure index arithmetic — the run
    of the r-th unique key spans [oidx[r], nxt[r]) in the sorted input
    (nxt = the (r+1)-th key's start, clipped to the live prefix length,
    since sentinels sort to the end) — so the only work beyond the
    compaction sort is elementwise.
    """
    n = hi.shape[0]
    sent = bp.is_sentinel(hi, lo)
    n_live = jnp.sum(~sent).astype(jnp.int32)
    prev_hi = jnp.concatenate([jnp.zeros((1,), dtype=U32), hi[:-1]])
    prev_lo = jnp.concatenate([jnp.zeros((1,), dtype=U32), lo[:-1]])
    is_new = (hi != prev_hi) | (lo != prev_lo)
    is_new = is_new.at[0].set(True)
    live = is_new & ~sent
    s_hi = jnp.where(live, hi, U32(bp.SENTINEL))
    s_lo = jnp.where(live, lo, U32(bp.SENTINEL))
    oidx = jnp.where(live, jnp.arange(n, dtype=jnp.int32), n)
    # compaction sorts by the START INDEX alone (1-key comparator): the
    # input is key-sorted, so ascending start position == ascending key,
    # masked entries (idx = n) land behind every live one, and the key
    # arrays ride as payload at half the comparator cost
    oidx, s_hi, s_lo = jax.lax.sort((oidx, s_hi, s_lo), num_keys=1,
                                    is_stable=False)
    nxt = jnp.concatenate([oidx[1:], jnp.full((1,), n, jnp.int32)])
    totals = jnp.minimum(nxt, n_live) - oidx
    counts = jnp.where(bp.is_sentinel(s_hi, s_lo), 0,
                       jnp.minimum(totals, SATURATE)).astype(jnp.int32)
    return s_hi, s_lo, counts


@jax.jit
def _rle_compact_weighted(hi, lo, cnt):
    return _rle_compact(hi, lo, cnt)


def _cumsum_flat(x):
    """Inclusive cumsum of a flat pow2 int32 array, compile-time bounded.

    A row-wise cumsum's compile cost is independent of the row count,
    where a 1D cumsum's can grow with its length.  Decompose: cumsum rows
    of a [n/C, C] view, then recursively prefix-sum the row totals.
    """
    n = x.shape[0]
    C = 1024
    if n <= 8 * C:
        return jnp.cumsum(x)
    if n % C:
        r = C - n % C
        return _cumsum_flat(jnp.concatenate(
            [x, jnp.zeros((r,), x.dtype)]))[:n]
    x2 = x.reshape(n // C, C)
    s = jnp.cumsum(x2, axis=1)
    row_tot = s[:, -1]
    off = _cumsum_flat(row_tot) - row_tot          # exclusive row offsets
    return (s + off[:, None]).reshape(n)


def _rle_compact(hi, lo, weights):
    """Run-length reduce SORTED keys, summing `weights` (saturating).

    Output: unique keys compacted to the front in ascending order,
    SENTINEL-padded tail, int32 counts (0 on padding).

    Built only from sorts, elementwise work and gathers (no scatters,
    no 1D scans, see _cumsum_flat): run totals are differences of the
    weight prefix-sum between a run's last element and the element
    before its first.  Run starts carry
    (base = cw - w, original index) through one 4-array compaction sort;
    the "cw at run end" term is then a gather at (next start's original
    index - 1), which for the last run lands on cw[n-1] (trailing
    sentinels have zero weight, so the prefix sum is flat there).

    int32 wraparound is harmless: each run's TRUE total is < 2^31 (ones
    weights: <= n <= 2^30; merge weights: two saturated tables sum to
    <= 2*32767), and differences of wrapped prefix sums are exact mod
    2^32 for any true difference < 2^31.
    """
    n = hi.shape[0]
    sent = bp.is_sentinel(hi, lo)
    prev_hi = jnp.concatenate([jnp.zeros((1,), dtype=U32), hi[:-1]])
    prev_lo = jnp.concatenate([jnp.zeros((1,), dtype=U32), lo[:-1]])
    is_new = (hi != prev_hi) | (lo != prev_lo)
    is_new = is_new.at[0].set(True)

    if weights is None:
        w = jnp.where(sent, 0, 1).astype(jnp.int32)
    else:
        w = jnp.where(sent, 0, weights).astype(jnp.int32)
    cw = _cumsum_flat(w)                                   # inclusive
    live = is_new & ~sent
    s_hi = jnp.where(live, hi, U32(bp.SENTINEL))
    s_lo = jnp.where(live, lo, U32(bp.SENTINEL))
    base = jnp.where(live, cw - w, 0)
    oidx = jnp.where(live, jnp.arange(n, dtype=jnp.int32), n)
    # 1-key compaction by start index (== key order; see _rle_compact_ones)
    oidx, s_hi, s_lo, base = jax.lax.sort((oidx, s_hi, s_lo, base),
                                          num_keys=1, is_stable=False)
    nxt = jnp.concatenate([oidx[1:], jnp.full((1,), n, jnp.int32)])
    run_end = cw[jnp.clip(nxt - 1, 0, n - 1)]
    totals = run_end - base
    out_sent = bp.is_sentinel(s_hi, s_lo)
    counts = jnp.where(out_sent, 0,
                       jnp.minimum(totals, SATURATE)).astype(jnp.int32)
    return s_hi, s_lo, counts


# ---------------------------------------------------------------------------
# Host-orchestrated RLE: hierarchical sparse compaction (large raw chunks)
# ---------------------------------------------------------------------------
#
# _rle_compact's compaction is a second FULL-length sort of four arrays.
# But on raw counting chunks the run starts are a small fraction of the
# input (high-coverage duplication), and they are already in ascending key
# order, so compaction only has to squeeze out sentinels:
#
#   1. mark run STARTS as one masked (key_hi, key_lo, idx) triple;
#   2. row-sort [n/256, 256] tiles (36 bitonic stages vs ~378 for a
#      global sort) — each row's live entries move to its front;
#   3. slice every row to a blind column width (validated against the
#      max row occupancy from ONE stats fetch; a miss falls back to the
#      exact stats-driven hierarchy);
#   4. one small global sort compacts the rest; with starts FULLY
#      compacted, run lengths are adjacent differences of the start
#      indices (the r-th run ends where run r+1 begins, the last at
#      n_live) — pure elementwise arithmetic, no prefix sums, no big
#      gathers, and no second (run-END) triple through the hierarchy.
#
# The output is exactly the _trim()-ed table the binary counter stores.
# Not usable under shard_map (host syncs): the pure count_flat /
# merge_counted above remain for traced contexts.  Dense inputs (merges
# of counted tables, low-coverage samples) fall back to the single
# compaction sort, which is optimal when most entries are live.

_ROWC = 256        # rowsort tile width; not measured on the H100
_HOSTED_MIN = 1 << 20
_GLOBAL_MAX = 1 << 22
_L1_COLS = 32      # blind level-1 slice width (validated against maxl1)


@jax.jit
def _mask_starts(hi, lo):
    """Masked run-start triple of a SORTED key array.

    Returns ((key_hi, key_lo, index), n_unique, n_live): the triple is
    sentinel-masked off-start (masked index = n, so masked entries sort
    behind every live index too)."""
    n = hi.shape[0]
    sent = bp.is_sentinel(hi, lo)
    prev_hi = jnp.concatenate([jnp.zeros((1,), dtype=U32), hi[:-1]])
    prev_lo = jnp.concatenate([jnp.zeros((1,), dtype=U32), lo[:-1]])
    is_new = ((hi != prev_hi) | (lo != prev_lo)).at[0].set(True)
    start = is_new & ~sent
    idx = jnp.arange(n, dtype=jnp.int32)
    s = (jnp.where(start, hi, U32(bp.SENTINEL)),
         jnp.where(start, lo, U32(bp.SENTINEL)),
         jnp.where(start, idx, n))
    return (s, jnp.sum(start).astype(jnp.int32),
            jnp.sum(~sent).astype(jnp.int32))


@jax.jit
def _rowsort_level(s1, s2, s3):
    """Row-sort the masked triple in [n/_ROWC, _ROWC] tiles; live
    entries move to row fronts.  Returns tiled arrays + max row
    occupancy.

    Comparator = the start INDEX (s3) alone: the base array is
    key-sorted, so ascending index == ascending key and masked entries
    (index = n > every live index) sink to row tails — a 1-u32
    comparator instead of the 2-u32 key pair, with the keys as payload.
    """
    rs = lambda a: a.reshape(-1, _ROWC)
    s3, s1, s2 = jax.lax.sort((rs(s3), rs(s1), rs(s2)), dimension=1,
                              num_keys=1, is_stable=False)
    live = jnp.sum(~bp.is_sentinel(s1, s2), axis=1)
    return s1, s2, s3, jnp.max(live).astype(jnp.int32)


def _compact_levels(s):
    """Shrink the masked triple while row-sorting keeps helping."""
    size = s[0].shape[0]
    while size > _GLOBAL_MAX and size % _ROWC == 0:
        s1, s2, s3, maxl_dev = _rowsort_level(*s)
        m_cols = _pow2(int(maxl_dev))
        if m_cols >= _ROWC:          # dense rows: no further reduction
            flat = lambda a: a.reshape(size)
            return (flat(s1), flat(s2), flat(s3))
        take = lambda a: a[:, :m_cols].reshape(-1)
        s = (take(s1), take(s2), take(s3))
        size = s[0].shape[0]
    return s


@jax.jit
def _sort_and_starts(hi, lo):
    """Fused primary sort + mask-starts + level-1 rowsort + stats.

    One dispatch replaces sort_pair -> mask_starts -> rowsort: XLA fuses
    the boundary masking into the sort epilogue / rowsort prologue.  The
    stats vector [n_uni, n_live, maxl1] lets the host sync once per
    chunk.
    """
    hi, lo = jax.lax.sort((hi, lo), num_keys=2, is_stable=False)
    s, n_uni, n_live = _mask_starts(hi, lo)
    t1, t2, t3, maxl = _rowsort_level(*s)
    return hi, lo, t1, t2, t3, jnp.stack([n_uni, n_live, maxl])





@partial(jax.jit, static_argnames=("m_cols",))
def _slice_flatten(t1, t2, t3, m_cols: int):
    take = lambda a: a[:, :m_cols].reshape(-1)
    return take(t1), take(t2), take(t3)


@jax.jit
def _sort_starts(s1, s2, si):
    # 1-key sort by start index (== key order; see _rowsort_level)
    si, s1, s2 = jax.lax.sort((si, s1, s2), num_keys=1, is_stable=False)
    return s1, s2, si


@partial(jax.jit, static_argnames=("m",))
def _counts_from_sorted_starts(s1, s2, si, stats, m: int):
    """_finish_starts on an ALREADY globally sorted start triple."""
    n_uni, n_live = stats[0], stats[1]
    valid = jnp.arange(m, dtype=jnp.int32) < n_uni
    cut = lambda a: jax.lax.slice_in_dim(a, 0, m)
    uh = jnp.where(valid, cut(s1), U32(bp.SENTINEL))
    ul = jnp.where(valid, cut(s2), U32(bp.SENTINEL))
    si = cut(si)
    nxt = jnp.concatenate([si[1:], jnp.full((1,), jnp.iinfo(jnp.int32).max,
                                            jnp.int32)])
    runlen = jnp.minimum(nxt, n_live) - si
    counts = jnp.where(valid, jnp.minimum(runlen, SATURATE),
                       0).astype(jnp.int32)
    return uh, ul, counts


def count_flat_hosted(hi, lo):
    """count_flat + trim-to-pow2(uniques), host-orchestrated.

    Dispatch discipline: the fused sort+starts+rowsort, the blind
    _L1_COLS slice, and the global start sort are all enqueued before
    the SINGLE stats fetch, so the device pipeline never idles on the
    host round trip.  The blind slice width is validated against the
    fetched max row occupancy; a miss (dense or nearly-duplicate-free
    chunk) falls back to the exact hierarchy.  One rowsort level: at
    the bench slab (85M live, 5M uniques) level-2 start density is
    already ~0.3, so a second level compacts < 2x, and its blind slice
    width sits at the occupancy tail (maxl2 132 vs 128).
    """
    n = hi.shape[0]
    if n < _HOSTED_MIN or n % (_ROWC * 8):
        hi, lo = _sort_pair(hi, lo)
        return _trim_table(_rle_compact_ones(hi, lo))
    shi, slo, t1, t2, t3, stats_dev = _sort_and_starts(hi, lo)
    final = _sort_starts(*_slice_flatten(t1, t2, t3, _L1_COLS))
    stats = np.asarray(stats_dev)              # the one host round trip
    n_uni, maxl1 = int(stats[0]), int(stats[2])
    if n_uni * 8 >= n:
        # dense: a single compaction sort beats the hierarchy
        return _trim_table(_rle_compact_ones(shi, slo))
    m = _pow2(max(n_uni, 1))
    if maxl1 <= _L1_COLS and m <= final[0].shape[0]:
        return _counts_from_sorted_starts(*final, stats_dev, m)
    # exact path: shrink levels while row-sorting keeps helping
    s = _compact_levels_from(t1, t2, t3, maxl1)
    if m > s[0].shape[0]:
        padk = lambda a: jnp.concatenate(
            [a, jnp.full((m - a.shape[0],), bp.SENTINEL, a.dtype)])
        padi = lambda a: jnp.concatenate(
            [a, jnp.full((m - a.shape[0],), jnp.iinfo(jnp.int32).max,
                         a.dtype)])
        s = (padk(s[0]), padk(s[1]), padi(s[2]))
    return _counts_from_sorted_starts(*_sort_starts(*s), stats_dev, m)


def _compact_levels_from(t1, t2, t3, maxl: int):
    """_compact_levels starting from already-rowsorted level-1 tiles."""
    size = t1.shape[0] * t1.shape[1]
    m_cols = _pow2(int(maxl))
    if m_cols >= _ROWC:
        flat = lambda a: a.reshape(size)
        return (flat(t1), flat(t2), flat(t3))
    s = _slice_flatten(t1, t2, t3, m_cols)
    return _compact_levels(s)


def merge_counted_hosted(hi_a, lo_a, cnt_a, hi_b, lo_b, cnt_b):
    """merge_counted + trim-to-pow2(uniques).

    Merge inputs are counted tables (mostly live), so the dense single
    compaction sort is the right algorithm; hosted only for the trim."""
    return _trim_table(merge_counted(hi_a, lo_a, cnt_a, hi_b, lo_b, cnt_b))


def _trim_table(table):
    """Slice a compacted table down to pow2(live uniques)."""
    hi, lo, cnt = table
    live = int(jnp.sum(cnt > 0))
    size = _pow2(max(live, 1))
    if size >= hi.shape[0]:
        return table
    return (jax.lax.slice_in_dim(hi, 0, size),
            jax.lax.slice_in_dim(lo, 0, size),
            jax.lax.slice_in_dim(cnt, 0, size))


def _pow2(n: int) -> int:
    size = 16
    while size < n:
        size *= 2
    return size


def _bucket_size(n: int) -> int:
    """Smallest s >= n with s in {2^k, 3*2^(k-1)}: <= 33% padding at twice
    the shape-signature count of pure powers of two."""
    p = _pow2(n)
    if n <= 3 * (p // 4) and 3 * (p // 4) >= 16:
        return 3 * (p // 4)
    return p


def _bucket_size_fine(n: int) -> int:
    """Smallest s >= n on an 8-per-octave grid (32 above 2^26): <= 12.5%
    (3.1%) padding.

    Used for the big consolidation sorts, where a pow2 bucket's padding
    is sorted at full cost; a bounded signature count per octave keeps
    compiles rare (and they persist in the compilation cache).  The top
    octaves get the finest grid because that is where padding costs the
    most sort time."""
    if n < (1 << 20):
        return _bucket_size(n)
    p = _pow2(n)
    step = p // (32 if n >= (1 << 26) else 8)
    return -(-n // step) * step


def _pad_pow2(hi, lo, cnt):
    """Pad a counted table with sentinels up to the next power of two."""
    return _pad_to((hi, lo, cnt), _pow2(hi.shape[0]))


def _pad_to(table, size):
    hi, lo, cnt = table
    n = hi.shape[0]
    if n == size:
        return table
    pad = size - n
    return (jnp.concatenate([hi, jnp.full((pad,), bp.SENTINEL, dtype=U32)]),
            jnp.concatenate([lo, jnp.full((pad,), bp.SENTINEL, dtype=U32)]),
            jnp.concatenate([cnt, jnp.zeros((pad,), dtype=jnp.int32)]))


def _empty(n=16):
    return (jnp.full((n,), 0xFFFFFFFF, dtype=U32),
            jnp.full((n,), 0xFFFFFFFF, dtype=U32),
            jnp.zeros((n,), dtype=jnp.int32))


def _parallel_fetch(arrays):
    """Device->host fetch: one stream per whole array."""
    from concurrent.futures import ThreadPoolExecutor

    if not arrays:
        return []
    with ThreadPoolExecutor(len(arrays)) as ex:
        return list(ex.map(np.asarray, arrays))


def _fetch_table(table) -> tuple[np.ndarray, np.ndarray]:
    """Counted device table -> host (keys int64 ascending, counts int32).

    Slices the fetch to a fine-grained bucket of the live count, ships
    counts as int16 (the saturation bound fits), and pulls the three
    arrays on parallel streams.
    """
    hi, lo, cnt = table
    n_live = int(jnp.sum(cnt > 0))
    g = 1 << 20
    m = _pow2(n_live) if n_live < g else -(-n_live // g) * g
    m = min(hi.shape[0], m)
    hi16 = jax.lax.slice_in_dim(hi, 0, m)
    lo16 = jax.lax.slice_in_dim(lo, 0, m)
    cnt16 = jax.lax.slice_in_dim(cnt, 0, m).astype(jnp.int16)
    hi, lo, cnt = _parallel_fetch((hi16, lo16, cnt16))
    cnt = cnt.astype(np.int32)          # saturation bound fits int16
    live = cnt > 0
    keys = ((hi[live].astype(np.uint64) << np.uint64(32))
            | lo[live].astype(np.uint64)).astype(np.int64)
    cnt = cnt[live]
    # the device table is compacted in ascending (hi, lo) order, which
    # int64 keys preserve for k <= 31 (keys < 2^62); the sort below is
    # a guarded no-op kept for safety
    if len(keys) > 1 and not np.all(keys[:-1] < keys[1:]):
        order = np.argsort(keys)
        keys, cnt = keys[order], cnt[order]
    return keys, cnt


def merge_host_tables(tables) -> tuple[np.ndarray, np.ndarray]:
    """Saturating merge of host (keys, counts) tables (all sorted unique).

    Matches the reference's addAndBound semantics (saturate at 32767,
    itmo NumUtils.java:21-26); used when levels spill past the device
    memory budget."""
    allk = np.concatenate([t[0] for t in tables])
    allc = np.concatenate([t[1] for t in tables]).astype(np.int64)
    order = np.argsort(allk, kind="stable")
    allk, allc = allk[order], allc[order]
    uniq, start = np.unique(allk, return_index=True)
    sums = np.add.reduceat(allc, start) if len(allk) else allc[:0]
    return uniq, np.minimum(sums, SATURATE).astype(np.int32)


# ---------------------------------------------------------------------------
# Host-side accumulator
# ---------------------------------------------------------------------------

class SpilledError(RuntimeError):
    """finish_device() was called but levels already spilled to host."""


class KmerCounter:
    """Streaming canonical k-mer counter over read batches.

    All state lives ON DEVICE and the per-batch path is fully
    asynchronous — extracted keys accumulate in a concat-only binary
    counter over power-of-two sizes (every concatenate pairs two arrays of
    the same size, so XLA sees a bounded set of shape signatures).  Only
    when a raw level reaches ``chunk`` keys is it counted: one large sort
    + run-length reduce (large sorts amortize dispatch latency ~100x
    better than per-batch sorts), followed by a single host sync to trim
    the counted table down to pow2(live uniques).  Counted tables merge by
    the same binary-counter discipline via `merge_counted`.  Compiles are
    amortized by the persistent compilation cache (metafast_jax/__init__).
    Counts saturate at 32767 (reference parity, itmo NumUtils.java:21-26).
    """

    def __init__(self, k: int, capacity: int = 1 << 16,
                 chunk: int = 1 << 27, spill: int | None = 1 << 27):
        # k <= 31 is load-bearing beyond reference parity
        # (KmersCounterMain.java:66-73): _fetch_table relies on 2k-bit
        # keys staying below 2^62 so that ascending (hi, lo) uint32 order
        # survives the int64 reinterpretation; k = 32 would flip sign bits
        if not (1 <= k <= 31):
            raise ValueError(f"k must be in [1, 31], got {k}")
        self.k = k
        self._levels: dict = {}     # pow2 size -> counted (hi, lo, cnt)
        self._pending: list = []    # raw (hi, lo) key arrays, uncounted
        self._pending_n = 0
        self._chunk = chunk         # raw keys per sort+RLE consolidation
        # counted level TABLE SIZE (pow2-padded slots) that moves to host
        # RAM; None disables spilling for callers that need finish_device
        # on arbitrarily large inputs and accept the HBM risk
        self._spill = spill
        self._spilled: list = []    # host (keys int64, counts int32) tables
        self._spill_futures: list = []   # in-flight background fetches
        self._spill_pool = None
        self.spill_events = 0       # observability: levels moved to host
        self._total_host = 0
        self._total_dev: list = []  # deferred device scalars

    @property
    def total_kmers_seen(self) -> int:
        """Total k-mers seen (realizes the deferred device sums)."""
        if self._total_dev:
            self._total_host += sum(int(x) for x in self._total_dev)
            self._total_dev = []
        return self._total_host

    def _add_total_from_lengths(self, lengths) -> None:
        # k-mers per read = max(len - k + 1, 0); for host arrays this
        # costs nothing, for device arrays defer the scalar fetch
        if isinstance(lengths, np.ndarray):
            self._total_host += int(
                np.maximum(lengths.astype(np.int64) - self.k + 1, 0).sum())
        else:
            self._total_dev.append(jnp.sum(jnp.maximum(
                lengths.astype(jnp.int64) - self.k + 1, 0)))

    def add_batch(self, codes, lengths):
        """codes [B, L] uint8, lengths [B] int32 (numpy or jnp)."""
        self._add_total_from_lengths(lengths)
        bhi, blo = _extract_flat(jnp.asarray(codes), jnp.asarray(lengths),
                                 self.k)
        self._pending_insert(bhi, blo)

    def add_packed_batch(self, packed, lengths, L: int):
        """packed [B, L//4] uint8 (2-bit codes), lengths [B] int32."""
        self._add_total_from_lengths(lengths)
        bhi, blo = _extract_flat_packed(jnp.asarray(packed),
                                        jnp.asarray(lengths), self.k, L)
        self._pending_insert(bhi, blo)

    def add_stream(self, codes_flat, lengths):
        """Flat concatenated codes (the native parser's output layout).

        Routes through the flat-stream extraction
        (ops/stream_extract.py) — no per-read padding, 16 codes per u32
        word on the wire.
        """
        from .stream_extract import build_stream

        words, vmask, _n_valid = build_stream(np.asarray(codes_flat),
                                              np.asarray(lengths), self.k)
        self.add_stream_device(jnp.asarray(words), jnp.asarray(vmask),
                               lengths)

    def add_stream_device(self, words_dev, vmask_dev, lengths):
        """add_stream over device-resident (words, vmask) column arrays."""
        from .stream_extract import stream_extract

        self._add_total_from_lengths(np.asarray(lengths))
        hi, lo = stream_extract(words_dev, vmask_dev, self.k)
        self._pending_insert(hi.reshape(-1), lo.reshape(-1))

    def add_stream3(self, codes_flat, lengths):
        """add_stream via the compact 3-stream layout: boundary windows
        never enter the sort (~6% padding instead of ~21% at 150 bp
        reads)."""
        from .stream_extract import build_stream3

        w0, w1, w2, vm, _n = build_stream3(np.asarray(codes_flat),
                                           np.asarray(lengths), self.k)
        self.add_stream3_device(jnp.asarray(w0), jnp.asarray(w1),
                                jnp.asarray(w2), jnp.asarray(vm), lengths)

    def add_stream3_device(self, w0, w1, w2, vm, lengths):
        """add_stream3 over device-resident compact columns."""
        from .stream_extract import stream3_extract

        self._add_total_from_lengths(np.asarray(lengths))
        hi, lo = stream3_extract(w0, w1, w2, vm, self.k)
        self._pending_insert(hi.reshape(-1), lo.reshape(-1))

    # -- raw (uncounted) key accumulation ----------------------------------

    def _pending_insert(self, hi, lo) -> None:
        # batches queue asynchronously; keys are copied exactly once, by
        # the single concatenate in _consolidate_pending (a binary
        # counter over raw levels would copy each key log-many times,
        # and device copies are not free)
        self._pending.append((hi, lo))
        self._pending_n += hi.shape[0]
        # consolidate at EXACTLY `chunk` keys: the tail of the batch that
        # crosses the boundary carries over, so every mid-stream sort runs
        # at one padding-free shape signature (only the final flush pads)
        while self._pending_n >= self._chunk:
            over = self._pending_n - self._chunk
            rest = None
            if over:
                bhi, blo = self._pending.pop()
                cut = bhi.shape[0] - over
                if cut > 0:
                    self._pending.append(
                        (jax.lax.slice_in_dim(bhi, 0, cut),
                         jax.lax.slice_in_dim(blo, 0, cut)))
                rest = (jax.lax.slice_in_dim(bhi, cut, bhi.shape[0]),
                        jax.lax.slice_in_dim(blo, cut, blo.shape[0]))
                self._pending_n -= rest[0].shape[0]
            self._consolidate_pending()
            if rest is not None:
                self._pending.append(rest)
                self._pending_n = rest[0].shape[0]

    def _consolidate_pending(self) -> None:
        if not self._pending:
            return
        size = _bucket_size_fine(self._pending_n)
        pad = size - self._pending_n
        his = [p[0] for p in self._pending]
        los = [p[1] for p in self._pending]
        if pad:
            his.append(jnp.full((pad,), bp.SENTINEL, U32))
            los.append(jnp.full((pad,), bp.SENTINEL, U32))
        hi = jnp.concatenate(his)
        lo = jnp.concatenate(los)
        self._pending = []
        self._pending_n = 0
        self._insert(count_flat_hosted(hi, lo))

    def add_counted(self, hi, lo, cnt):
        """Fold an already-counted table in (uint32 pair + count arrays)."""
        hi = jnp.asarray(hi, dtype=U32)
        lo = jnp.asarray(lo, dtype=U32)
        cnt = jnp.asarray(cnt, dtype=jnp.int32)
        hi, lo, cnt = _pad_pow2(hi, lo, cnt)
        n = hi.shape[0]
        self._insert(merge_counted_hosted(hi, lo, cnt, *_empty(n)))

    def add_keys(self, keys, counts):
        """Fold a host-side (int64 keys, counts) table in."""
        keys = np.asarray(keys, dtype=np.int64).astype(np.uint64)
        self.add_counted((keys >> np.uint64(32)).astype(np.uint32),
                         (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                         np.asarray(counts))

    def _insert(self, table) -> None:
        # tables arriving here are already trimmed to pow2(uniques)
        size = table[0].shape[0]
        while size in self._levels:
            other = self._levels.pop(size)
            table = merge_counted_hosted(*table, *other)
            size = table[0].shape[0]
        if self._spill is not None and size >= self._spill:
            # HBM-scale guard: merging two tables of size S transiently
            # allocates ~70*S bytes (concat + sort buffers), so levels
            # beyond `spill` slots move to host RAM; finish() folds them
            # back with a streaming numpy merge.  On real hosts the fetch
            # rides PCIe DMA; device memory stays bounded by 2*spill.
            # The fetch runs on a background thread so the streaming add
            # loop stays asynchronous (the device table is dropped when
            # the transfer completes).
            from concurrent.futures import ThreadPoolExecutor

            if self._spill_pool is None:
                self._spill_pool = ThreadPoolExecutor(1)
            self.spill_events += 1
            self._spill_futures.append(
                self._spill_pool.submit(_fetch_table, table))
        else:
            self._levels[size] = table

    # -- results ----------------------------------------------------------

    def finish_device(self):
        """Merge all state into ONE counted device table (hi, lo, cnt).

        Unique keys sit compacted at the front in ascending order with a
        sentinel-padded tail; no host transfer happens beyond the trim
        syncs.  Returns None when nothing was added.  Raises SpilledError
        when levels spilled to host (table no longer fits the device
        budget): use finish() there, or construct with spill=None to keep
        everything on device.
        """
        self._merge_levels()
        if self._spilled or self._spill_futures:
            raise SpilledError(
                "k-mer table exceeded the device spill threshold "
                f"({self._spill} table slots); the merged result lives "
                "on host — use finish(), or pass spill=None to keep the "
                "table on device")
        if not self._levels:
            return None
        ((_, table),) = self._levels.items()
        return table

    def _merge_levels(self) -> None:
        self._consolidate_pending()
        while len(self._levels) > 1:
            sizes = sorted(self._levels)
            small = self._levels.pop(sizes[0])
            self._insert(_pad_to(small, sizes[1]))

    def finish(self):
        """Return (keys int64 sorted ascending, counts int32) as numpy."""
        self._merge_levels()
        tables = [_fetch_table(t) for t in self._levels.values()]
        self._levels = {}
        tables += self._spilled
        tables += [f.result() for f in self._spill_futures]
        self._spilled = []
        self._spill_futures = []
        if not tables:
            return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int32)
        if len(tables) == 1:
            return tables[0]
        return merge_host_tables(tables)
