"""Vectorized lookups over sorted (hi, lo) uint32 key tables.

The de Bruijn graph is represented as a sorted canonical k-mer table;
membership and neighbor resolution replace the reference's
open-addressing hash probes (itmo Long2ShortHashMap.java:153-165) with
two XLA-native strategies, chosen by query volume:

  * binary search (`lower_bound`): ~32 rounds of gather + compare.
    Right for SMALL query sets — at bulk sizes it pays 32 random
    gathers per query;
  * sort-merge join (`_find_merge`): tag table and query keys, ONE
    3-key sort brings equal keys adjacent (table entry first), a
    forward-fill carries each table entry's index+key to the queries
    behind it, and a second 2-array sort restores query order: a few
    sorts instead of 32 gather rounds, with no per-round latency.

Both paths are pure XLA (jit- and shard_map-safe) and bit-identical.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core import bitpack as bp

U32 = jnp.uint32
I32 = jnp.int32


@jax.jit
def lower_bound(table_hi, table_lo, qhi, qlo):
    """Index of first table key >= query, per query element.

    Table must be sorted ascending with SENTINEL padding at the tail
    (SENTINEL sorts above every valid key).
    """
    n = table_hi.shape[0]
    # search interval is [0, n] (n+1 states) -> n.bit_length() halvings
    steps = max(1, n.bit_length())
    lo = jnp.zeros(qhi.shape, dtype=I32)
    hi = jnp.full(qhi.shape, n, dtype=I32)

    def body(_, carry):
        lo, hi = carry
        mid = (lo + hi) >> 1
        mhi = table_hi[mid]
        mlo = table_lo[mid]
        lt = bp.less(mhi, mlo, qhi, qlo)  # table[mid] < q
        lo = jnp.where(lt, mid + 1, lo)
        hi = jnp.where(lt, hi, mid)
        return lo, hi

    lo, hi = jax.lax.fori_loop(0, steps, body, (lo, hi))
    return lo


# query count above which the sort-merge join beats gather-round search
MERGE_MIN = 1 << 20


@jax.jit
def _merge_rank(table_hi, table_lo, qh, ql):
    """Tagged 3-key sort + rank prefix sum + restore sort.

    Because the table's keys are unique and sorted, the r-th table entry
    in the merged sorted order is exactly row r of the original table —
    so the classic forward fill of (index, key) collapses to a plain
    prefix sum rank = cumsum(is_table) - 1 (ops.count._cumsum_flat, the
    compile-bounded decomposition the counting core uses at 2^27).
    """
    from ..ops.count import _cumsum_flat

    T = table_hi.shape[0]
    Q = qh.shape[0]
    chi = jnp.concatenate([table_hi, qh])
    clo = jnp.concatenate([table_lo, ql])
    src = jnp.concatenate([jnp.arange(T, dtype=I32),
                           jnp.arange(Q, dtype=I32) + T])
    # src as third key: a table entry sorts BEFORE equal-key queries
    _shi, _slo, ssrc = jax.lax.sort((chi, clo, src), num_keys=3,
                                    is_stable=False)
    is_tab = ssrc < T
    rank = _cumsum_flat(is_tab.astype(I32)) - 1   # last table row <= pos
    # restore original order: src is unique, one 1-key sort
    _, rres = jax.lax.sort((ssrc, rank), num_keys=1, is_stable=False)
    return jax.lax.slice_in_dim(rres, T, T + Q)


@jax.jit
def _merge_verify(table_hi, table_lo, qh, ql, qrank):
    """found iff the candidate table row holds the query key (2 gathers)."""
    T = table_hi.shape[0]
    safe = jnp.clip(qrank, 0, T - 1)
    found = ((qrank >= 0) & (table_hi[safe] == qh) & (table_lo[safe] == ql)
             & ~bp.is_sentinel(qh, ql))
    return safe, found


def _find_merge(table_hi, table_lo, qhi, qlo):
    """Bulk (index, found) via sort-merge join.

    Two jit stages (rank, verify) — kept separate so each compile stays
    small (see graph/dbg.py for the same discipline)."""
    shape = qhi.shape
    qh = qhi.reshape(-1)
    ql = qlo.reshape(-1)
    qrank = _merge_rank(table_hi, table_lo, qh, ql)
    safe, found = _merge_verify(table_hi, table_lo, qh, ql, qrank)
    return safe.reshape(shape), found.reshape(shape)


@partial(jax.jit, static_argnames=("max_dup",))
def _merge_bounded(table_hi, table_lo, qh, ql, max_dup: int):
    """Sort-merge join with the verify step computed IN SORTED SPACE.

    The generic verify costs 2 random gathers per query (the single
    most expensive part of a bulk find).  When the caller can
    bound the duplicate multiplicity of its query keys, the table hit is
    decidable locally: every table entry heads its equal-key run (unique
    sorted table keys + src tie-break), so a query matches iff one of
    the `max_dup` sorted positions before it is a table entry with the
    same key — a handful of shifted elementwise compares, no gathers.

    Returns (idx, found, overflow): `overflow` is nonzero iff some
    non-sentinel run is long enough that a query COULD sit further than
    max_dup behind its head — results are only trustworthy when it is
    zero (callers fall back to the gather verify then).
    """
    from ..ops.count import _cumsum_flat

    T = table_hi.shape[0]
    Q = qh.shape[0]
    chi = jnp.concatenate([table_hi, qh])
    clo = jnp.concatenate([table_lo, ql])
    src = jnp.concatenate([jnp.arange(T, dtype=I32),
                           jnp.arange(Q, dtype=I32) + T])
    shi, slo, ssrc = jax.lax.sort((chi, clo, src), num_keys=3,
                                  is_stable=False)
    is_tab = ssrc < T
    sent = bp.is_sentinel(shi, slo)
    rank = _cumsum_flat(is_tab.astype(I32)) - 1

    def shifted(a, j, fill):
        return jnp.concatenate([jnp.full((j,), fill, a.dtype), a[:-j]])

    # shift fill = an impossible key pair: real keys have hi < 2^30
    # (k <= 31 => 62-bit values) and the sentinel pair is all-ones, so
    # (0xFFFFFFFE, 0) can never equal a sorted entry
    FILL = U32(0xFFFFFFFE)
    hit = jnp.zeros(shi.shape, dtype=bool)
    for j in range(1, max_dup + 1):
        eq = ((shi == shifted(shi, j, FILL))
              & (slo == shifted(slo, j, U32(0))))
        hit = hit | (eq & shifted(is_tab, j, False))
    hit = hit & ~is_tab & ~sent
    # a run of > max_dup + 1 equal non-sentinel keys could hide a hit
    jo = max_dup + 1
    overflow = jnp.sum(
        (shi == shifted(shi, jo, FILL))
        & (slo == shifted(slo, jo, U32(0))) & ~sent).astype(I32)

    res = jnp.where(hit, rank, -1)
    _, rres = jax.lax.sort((ssrc, res), num_keys=1, is_stable=False)
    qres = jax.lax.slice_in_dim(rres, T, T + Q)
    return jnp.clip(qres, 0, T - 1), qres >= 0, overflow


def find_bounded(table_hi, table_lo, qhi, qlo, max_dup: int = 16):
    """(idx, found, overflow) — `find` without verify gathers, valid
    when no query key repeats more than ~max_dup times (overflow == 0
    certifies it; see _merge_bounded).  Small inputs route to the plain
    find (overflow 0)."""
    shape = qhi.shape
    q = 1
    for d in qhi.shape:
        q *= d
    if q < MERGE_MIN:
        idx, found = find(table_hi, table_lo, qhi, qlo)
        return idx, found, jnp.zeros((), I32)
    idx, found, overflow = _merge_bounded(
        table_hi, table_lo, qhi.reshape(-1), qlo.reshape(-1), max_dup)
    return idx.reshape(shape), found.reshape(shape), overflow


def find(table_hi, table_lo, qhi, qlo):
    """(index, found) per query; index clipped into range, found bool.

    Where found is False the index is arbitrary (but in range) — callers
    mask by `found` before use.  Bulk queries route to the sort-merge
    join; small ones to binary search (lower dispatch+sort overhead).
    NOT itself @jax.jit: the merge path runs as separately-jitted stages
    so each compile stays small; calling `find` under an outer jit would
    fuse them back into one compile.
    """
    n = table_hi.shape[0]
    q = 1
    for d in qhi.shape:
        q *= d
    if q >= MERGE_MIN:
        return _find_merge(table_hi, table_lo, qhi, qlo)
    idx = lower_bound(table_hi, table_lo, qhi, qlo)
    safe = jnp.minimum(idx, n - 1)
    found = (table_hi[safe] == qhi) & (table_lo[safe] == qlo) & (idx < n)
    # never match sentinel padding
    found = found & ~bp.is_sentinel(qhi, qlo)
    return safe, found
