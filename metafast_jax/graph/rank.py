"""List ranking over de Bruijn chain successors — splitter walks.

Wyllie pointer doubling ranks chains in ~log2(L) rounds of full-width
[2, n] gathers, total gather volume n*log2(L) — at 2^23 keys ~23x the
table size.  This module is the alternative: a splitter-walk ranking
(the Helman-JaJa decomposition, in lockstep while_loops):

  1. mark ~n/B walk starts: every succ-graph head (indegree 0) plus a
     deterministic 1/B hash sample of all nodes;
  2. walk ALL starts forward in lockstep inside jitted while_loops —
     one enc gather + walkid/off scatters per active walk per step.
     Every node is visited exactly once, so total random-access volume
     is O(n), not O(n log L); walks that stop (next node is a start, or
     chain end) drop out, and the live set is compacted to power-of-two
     width buckets between fixed-round segments (bounded compile count);
  3. rank the walk graph (~n/B nodes) by pointer doubling — now cheap;
  4. one multi-payload gather maps (terminal, dist, reached) back to all
     n nodes.

Cycles (no head, possibly no sampled splitter) are covered by an
analytic second pass: every still-unvisited node becomes a zero-length
walk linked to its successor's walk — no loop needed.  Cycle walks never
reach a terminal, so their nodes come out reached=False, exactly the
pointer-doubling semantics (reference walks would not terminate on such
input; see graph/contigs.py spec notes).  The same pass covers the rare
walk that outgrows the packed step field: it stops there, and the rest
of its segment becomes zero-length walks.

Reference parity anchor: the sequential walk this replaces is
src/algo/AddSequencesShiftingRightTask.java:74-99.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

I32 = jnp.int32

# stop bit: the next node is a walk start (node ids stay < 2^30)
_START_BIT = np.int32(1 << 30)

# splitter sampling rate 1/B: mean gap B, max gap ~B*ln(n/B) rounds
_B = 32

# steps per while_loop segment (early exit on all-done inside)
_SEG_ROUNDS = 2 * _B


@jax.jit
def _start_mask(succ):
    """Heads (indegree 0 in the succ graph) + 1/B hash sample."""
    n = succ.shape[0]
    has_pred = jnp.zeros(n, jnp.uint8)
    has_pred = has_pred.at[jnp.where(succ >= 0, succ, n)].set(
        1, mode="drop")
    idx = jnp.arange(n, dtype=jnp.uint32)
    h = idx * jnp.uint32(0x9E3779B9)
    h = h ^ (h >> 16)
    sampled = (h & jnp.uint32(_B - 1)) == 0
    return (has_pred == 0) | sampled


@jax.jit
def _encode(succ):
    """succ with the next-is-start stop bit folded in (-1 = terminal).

    Gather-free: a successor always has a predecessor, so it can never
    be an indegree-0 HEAD — the only way succ[v] is a walk start is the
    hash sample, which is pure elementwise math on the successor id
    (saves a full [n] gather vs is_start[succ])."""
    h = succ.astype(jnp.uint32) * jnp.uint32(0x9E3779B9)
    h = h ^ (h >> 16)
    stop = ((h & jnp.uint32(_B - 1)) == 0) & (succ >= 0)
    return jnp.where(succ < 0, I32(-1),
                     jnp.where(stop, succ | _START_BIT, succ))


@partial(jax.jit, static_argnames=("w",))
def _compact_starts(is_start, w: int):
    """Start node ids compacted to the front of a width-w buffer
    (n = sentinel padding), via one 2-key sort."""
    n = is_start.shape[0]
    key = jnp.where(is_start, jnp.uint32(0), jnp.uint32(1))
    ids = jnp.arange(n, dtype=I32)
    k2, sids = jax.lax.sort((key, ids), num_keys=1, is_stable=True)
    out = jnp.where(k2 == 0, sids, n)
    if w <= n:
        return jax.lax.slice_in_dim(out, 0, w)
    return jnp.concatenate([out, jnp.full(w - n, n, I32)])


@partial(jax.jit, static_argnames=("rounds", "off_bits"))
def _walk_segment(enc, cur, wid, t, done, walkrec,
                  res_stop, res_t, res_term, rounds: int, off_bits: int):
    """Walk up to `rounds` steps (early exit when all walks are done).

    Per round and active walk: one enc gather and ONE packed
    (walkid << off_bits | off) scatter.  A walk whose off field is full
    stops as if its next node were a start.  After the loop, freshly
    finished walks flush their (stop node / steps / terminal?) into the
    [s] result arrays with masked scatters.
    """
    n = enc.shape[0]
    off_mask = I32((1 << off_bits) - 1)
    t_max = I32((1 << off_bits) - 2)      # largest off ever written

    def cond(c):
        done = c[3]
        i = c[5]
        return (~jnp.all(done)) & (i < rounds)

    def body(c):
        cur, wid, t, done, walkrec, i = c
        g = enc[jnp.clip(cur, 0, n - 1)]
        is_term = (g < 0) & ~done
        is_stop = ((g & _START_BIT) != 0) & ~done
        is_full = (t >= t_max) & ~done
        nxt = g & ~_START_BIT
        adv = ~done & ~is_term & ~is_stop & ~is_full
        ncur = jnp.where(adv, nxt, cur)
        tgt = jnp.where(adv, ncur, n)
        walkrec = walkrec.at[tgt].set((wid << off_bits) | (t + 1),
                                      mode="drop")
        return (ncur, wid, t + adv.astype(I32),
                done | is_term | is_stop | is_full, walkrec, i + 1)

    cur, wid, t, done, walkrec, _ = jax.lax.while_loop(
        cond, body, (cur, wid, t, done, walkrec, jnp.int32(0)))

    # flush finished walks into the per-walk result arrays
    s = res_stop.shape[0]
    g = enc[jnp.clip(cur, 0, n - 1)]
    is_term = g < 0
    tgt = jnp.where(done, wid, s)
    res_stop = res_stop.at[tgt].set(
        jnp.where(is_term, cur, g & ~_START_BIT), mode="drop")
    res_t = res_t.at[tgt].set(t, mode="drop")
    res_term = res_term.at[tgt].set(is_term, mode="drop")
    return cur, wid, t, done, walkrec, res_stop, res_t, res_term


@partial(jax.jit, static_argnames=("w_in", "w_out"))
def _compact_walks(cur, wid, t, done, w_in: int, w_out: int):
    """Live walks to the front of a narrower buffer, via one sort."""
    key = jnp.where(done, jnp.uint32(1), jnp.uint32(0))
    skey, cur, wid, t = jax.lax.sort((key, cur, wid, t), num_keys=1,
                                     is_stable=False)
    return (jax.lax.slice_in_dim(cur, 0, w_out),
            jax.lax.slice_in_dim(wid, 0, w_out),
            jax.lax.slice_in_dim(t, 0, w_out),
            jax.lax.slice_in_dim(skey, 0, w_out) == 1)


def _pow2(n: int) -> int:
    """Width bucket from the {2^k, 3*2^(k-1)} family (bounds both the
    pow2 overshoot — 1.5x worst case instead of 2x — and the number of
    distinct compiled shapes)."""
    w = 64
    while w < n:
        w *= 2
    if n <= 3 * (w // 4) and 3 * (w // 4) >= 64:
        return 3 * (w // 4)
    return w


@jax.jit
def _count_unvisited(walkrec, valid):
    return jnp.sum((walkrec < 0) & valid)


@partial(jax.jit, static_argnames=("w",))
def _compact_unvisited(walkrec, valid, w: int):
    n = walkrec.shape[0]
    miss = (walkrec < 0) & valid
    key = jnp.where(miss, jnp.uint32(0), jnp.uint32(1))
    ids = jnp.arange(n, dtype=I32)
    k2, sids = jax.lax.sort((key, ids), num_keys=1, is_stable=True)
    return (jnp.where(jax.lax.slice_in_dim(k2, 0, w) == 0,
                      jax.lax.slice_in_dim(sids, 0, w), n),
            jnp.sum(miss))


@jax.jit
def _cycle_pass(succ, walkrec, res_stop, res_t, res_term,
                nodes, first_wid):
    """Analytic pass 2: every still-unvisited node becomes a zero-step
    walk linked to succ(node).  Covers pure cycles without any loop.

    Cycle walks are recorded in walkrec's NEGATIVE range (-(cid)-2, off
    always 0), so their count is not limited by the packed off field."""
    n = succ.shape[0]
    w = nodes.shape[0]
    ok = nodes < n
    cid = jnp.arange(w, dtype=I32)
    wid = jnp.where(ok, first_wid + cid, -1)
    tgt = jnp.where(ok, nodes, n)
    walkrec = walkrec.at[tgt].set(-cid - 2, mode="drop")
    nx = succ[jnp.clip(nodes, 0, n - 1)]
    s = res_stop.shape[0]
    rtgt = jnp.where(ok, wid, s)
    res_stop = res_stop.at[rtgt].set(jnp.where(nx >= 0, nx, nodes),
                                     mode="drop")
    res_t = res_t.at[rtgt].set(0, mode="drop")
    res_term = res_term.at[rtgt].set(nx < 0, mode="drop")
    return walkrec, res_stop, res_t, res_term


@partial(jax.jit, static_argnames=("rounds",))
def _rank_walks(nxtw, gap, stop_node, term, rounds: int):
    """(D, term_node, reached) per walk by (ptr, dist) doubling on the
    walk graph — [3, s] column gathers, log2(s) + margin rounds."""
    s = nxtw.shape[0]
    ids = jnp.arange(s, dtype=I32)
    # invariant: dist[w] = steps from start(w) to start(ptr[w]); the
    # terminal walk self-loops with dist 0, so converged sums never
    # over-accumulate; its own gap is added once at the end
    ptr = jnp.where(term, ids, nxtw)
    dist = jnp.where(term, 0, gap + 1)

    def cond(c):
        ptr, dist, i, changed = c
        return changed & (i < rounds)

    def body(c):
        ptr, dist, i, _ = c
        safe = jnp.clip(ptr, 0, s - 1)
        g = jnp.stack([ptr, dist])[:, safe]
        nptr = g[0]
        ndist = dist + g[1]
        return nptr, ndist, i + 1, jnp.any(nptr != ptr)

    ptr, dist, _, _ = jax.lax.while_loop(
        cond, body, (ptr, dist, jnp.int32(0), jnp.bool_(True)))
    safe = jnp.clip(ptr, 0, s - 1)
    reached = term[safe]
    D = dist + gap[safe]            # + the terminal walk's own steps
    tn = stop_node[safe]            # terminal walk stores the chain end
    return D, tn, reached


@partial(jax.jit, static_argnames=("off_bits", "s_cap"))
def _map_back(walkrec, D, tn, reachedw, off_bits: int, s_cap: int):
    """Per-node (term, dist, reached) from the walk tables — one [3, s]
    column gather."""
    s = D.shape[0]
    wid = _unpack_walkid(walkrec, off_bits, s_cap)
    visited = wid >= 0
    off = jnp.where(walkrec >= 0, walkrec & I32((1 << off_bits) - 1), 0)
    w = jnp.clip(wid, 0, s - 1)
    tbl = jnp.stack([D, tn, reachedw.astype(I32)])
    g = tbl[:, w]
    dist = jnp.where(visited, g[0] - off, 0)
    term = jnp.where(visited, g[1], -1)
    reached = visited & (g[2] != 0) & (term >= 0)
    return term, dist, reached


@partial(jax.jit, static_argnames=("off_bits", "s_cap"))
def _unpack_walkid(walkrec, off_bits: int, s_cap: int):
    """walkid from the packed record: non-negative = pass-1 pack, -1 =
    unvisited, <= -2 = cycle walk (id s_cap + (-rec - 2))."""
    return jnp.where(walkrec >= 0, walkrec >> off_bits,
                     jnp.where(walkrec <= -2, s_cap - walkrec - 2, -1))


@partial(jax.jit, static_argnames=("n", "s_cap", "off_bits"))
def _init_walks(starts, n: int, s_cap: int, off_bits: int):
    wid0 = jnp.where(starts < n, jnp.arange(s_cap, dtype=I32), -1)
    walkrec = jnp.full(n, -1, I32)
    walkrec = walkrec.at[jnp.where(starts < n, starts, n)].set(
        wid0 << off_bits, mode="drop")
    return walkrec, wid0


def chain_rank(succ, valid, max_off_bits: int = 31):
    """List ranking of the successor forest.

    Args:
      succ:  [n] int32 device array; succ[v] = next oriented node or -1.
      valid: [n] bool; nodes that exist (sentinel rows False).
      max_off_bits: cap on the packed record's step field (below).

    Returns dict with walkid, term, dist and reached [n], matching the
    pointer-doubling contract on valid rows; invalid rows come out
    reached=False / walkid=-1.
    """
    succ = jnp.asarray(succ)
    valid = jnp.asarray(valid)
    n = int(succ.shape[0])

    is_start = _start_mask(succ) & valid
    enc = _encode(succ)
    s_count = int(jnp.sum(is_start))
    s_cap = _pow2(s_count + 1)
    starts = _compact_starts(is_start, s_cap)

    # (walkid, off) pack into one int32: pass-1 walk ids in the high
    # bits, the rest of the 31 bits hold off.  The longest gap between
    # splitters grows like B*ln(n/B), so at ~2^26 nodes it can outgrow
    # the field: a walk stops one step before its off would saturate
    # (so every walk ends within max_segments), and pass 2 ranks the
    # rest.  Cycle walks (pass 2) live in the negative range and have no
    # off limit.
    wid_bits = max((s_cap + 1).bit_length(), 8)
    off_bits = min(31 - wid_bits, max_off_bits)
    if off_bits < 7:
        raise ValueError("walk count too large for the packed record")
    max_segments = -(-(1 << off_bits) // _SEG_ROUNDS) + 1

    walkrec, wid0 = _init_walks(starts, n, s_cap, off_bits)

    # result arrays sized to all potential walks (pass-1 + cycle pass)
    s_total = s_cap + 64            # cycle-walk head-room grown on demand
    res_stop = jnp.full(s_total, -1, I32)
    res_t = jnp.zeros(s_total, I32)
    res_term = jnp.zeros(s_total, bool)

    cur = starts
    wid = wid0
    t = jnp.zeros(s_cap, I32)
    done = starts >= n

    width = s_cap
    guard = 0
    while True:
        (cur, wid, t, done, walkrec,
         res_stop, res_t, res_term) = _walk_segment(
            enc, cur, wid, t, done, walkrec,
            res_stop, res_t, res_term, _SEG_ROUNDS, off_bits)
        alive = int(jnp.sum(~done))
        if alive == 0:
            break
        w2 = _pow2(alive)
        if w2 < width:
            cur, wid, t, done = _compact_walks(cur, wid, t, done,
                                               width, w2)
            width = w2
        guard += 1
        if guard >= max_segments:
            raise RuntimeError("chain walk did not converge")

    # pass 2: cycles (nodes no walk reached)
    n_missing = int(_count_unvisited(walkrec, valid))
    if n_missing:
        w = _pow2(n_missing)
        nodes, _ = _compact_unvisited(walkrec, valid, w)
        need = s_cap + n_missing + 1
        if need > s_total:
            grow = _pow2(need) - s_total
            res_stop = jnp.concatenate([res_stop, jnp.full(grow, -1, I32)])
            res_t = jnp.concatenate([res_t, jnp.zeros(grow, I32)])
            res_term = jnp.concatenate([res_term, jnp.zeros(grow, bool)])
            s_total = int(res_stop.shape[0])
        walkrec, res_stop, res_t, res_term = _cycle_pass(
            succ, walkrec, res_stop, res_t, res_term,
            nodes, jnp.int32(s_cap))

    walkid = _unpack_walkid(walkrec, off_bits, s_cap)

    # walk-graph ranking
    nxt_wid = jnp.where(res_term, -1, walkid[jnp.clip(res_stop, 0, n - 1)])
    rounds = int(np.ceil(np.log2(max(s_total, 2)))) + 2
    D, tn, reachedw = _rank_walks(nxt_wid, res_t, res_stop, res_term,
                                  rounds)
    term, dist, reached = _map_back(walkrec, D, tn, reachedw, off_bits,
                                    s_cap)
    return {"walkid": walkid, "term": term, "dist": dist, "reached": reached}
