"""Sharded connected components: two-phase star contraction over a mesh.

The reference partitions the graph by sequential BFS in one JVM
(src/algo/ComponentsBuilder.java:58-99).  Round 2's multi-chip
formulation replicated the full [M] label vector on every device and
all-gathered it each round — O(M) memory and traffic per device,
which defeats sharding at HBM scale.  This version is edge-cut for real:

  * edges are hash-sharded by their source vertex; per-device state is
    O(E/n) edge pairs — labels are never replicated anywhere;
  * each round applies the LARGE-STAR / SMALL-STAR contraction
    (Kiveris et al., "Connected Components in MapReduce and Beyond",
    SoCC 2014): group edges by source, point larger/smaller neighbors at
    the group minimum, exchange the rewritten edges with ONE all-to-all;
  * the primitives are exactly the sharded k-mer counter's (pair sort,
    run detection, segment fill, exact-capacity hash exchange, RLE
    dedup), so everything stays static-shaped and XLA-friendly;
  * converges in O(log^2 V) rounds to a forest of stars
    (child -> component minimum), which is the label assignment.

Why not halo exchange: de Bruijn neighbor indices are bit-shifted keys,
so any contiguous partition has near-total boundaries (left neighbors
land at index/4, right neighbors scatter uniformly) — the halo IS the
graph.  And a row-sharded min-propagation without the replicated
vector's global pointer jumping would need O(diameter) rounds; star
contraction needs neither global state nor global jumps.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .count import AXIS, _sharded_full

I32 = jnp.int32
U32 = jnp.uint32
VSENT = 0xFFFFFFFF          # sentinel vertex (no edge)


def _hash_vert(u):
    h = u * U32(0x9E3779B9)
    h = h ^ (h >> 16)
    h = h * U32(0x85EBCA6B)
    return h ^ (h >> 13)


def _ffill_last_valid(x):
    """Per element, the last value >= 0 at or before it (int32).

    lax.cummax of the masked POSITION + one gather back into x; a
    row-decomposed associative_scan compiled far slower.  lax.cummax
    lowers natively like cumsum and compiles in seconds."""
    n = x.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)
    last = jax.lax.cummax(jnp.where(x >= 0, pos, -1))
    return jnp.where(last >= 0, x[jnp.clip(last, 0, n - 1)], -1)


def _star_emit(u, v, large: bool):
    """One device's star rewrite: edges sorted by (u, v); per source-run
    minimum m = min(u, first v); emit (v, m) for the large (v > u) or
    small (v < u) side — plus (u, m) at run starts for small-star, which
    keeps every vertex attached to its current minimum."""
    u, v = jax.lax.sort((u, v), num_keys=2, is_stable=False)
    valid = u != U32(VSENT)
    prev = jnp.concatenate([jnp.full((1,), VSENT, U32), u[:-1]])
    start = (u != prev) & valid
    vf = _ffill_last_valid(
        jnp.where(start, v.astype(I32), I32(-1)))       # first v of run
    m = jnp.minimum(u.astype(I32), vf)                   # run minimum
    m = jnp.where(valid, m, I32(-1)).astype(U32)

    side = (v > u) if large else (v < u)
    emit_a = valid & side & (v != m)
    nu_a = jnp.where(emit_a, v, U32(VSENT))
    nv_a = jnp.where(emit_a, m, U32(VSENT))
    if large:
        return nu_a, nv_a
    emit_b = start & (m != u)
    nu_b = jnp.where(emit_b, u, U32(VSENT))
    nv_b = jnp.where(emit_b, m, U32(VSENT))
    return (jnp.concatenate([nu_a, nu_b]),
            jnp.concatenate([nv_a, nv_b]))


def _bucket_pairs(u, v, n_shards: int, cap: int):
    """Route (u, v) pairs into [n_shards, cap] buckets by hash(u)."""
    valid = u != U32(VSENT)
    shard = jnp.where(valid,
                      (_hash_vert(u) % U32(n_shards)).astype(I32), n_shards)
    order = jnp.argsort(shard)
    s_sorted = shard[order]
    u_sorted = u[order]
    v_sorted = v[order]
    idx = jnp.arange(s_sorted.shape[0], dtype=I32)
    first = jnp.searchsorted(
        s_sorted, jnp.arange(n_shards + 1, dtype=I32),
        side="left").astype(I32)
    pos = idx - first[jnp.clip(s_sorted, 0, n_shards)]
    keep = (s_sorted < n_shards) & (pos < cap)
    dropped = jnp.sum((s_sorted < n_shards) & (pos >= cap))
    tgt_shard = jnp.where(keep, s_sorted, n_shards - 1)
    tgt_pos = jnp.where(keep, pos, cap - 1)
    buf_u = jnp.full((n_shards, cap), U32(VSENT))
    buf_v = jnp.full((n_shards, cap), U32(VSENT))
    buf_u = buf_u.at[tgt_shard, tgt_pos].set(
        jnp.where(keep, u_sorted, U32(VSENT)), mode="drop")
    buf_v = buf_v.at[tgt_shard, tgt_pos].set(
        jnp.where(keep, v_sorted, U32(VSENT)), mode="drop")
    return buf_u, buf_v, dropped


@partial(jax.jit, static_argnames=("mesh", "large"))
def _round_stats(eu, ev, *, mesh: Mesh, large: bool):
    """Emit + per-(device,shard) bucket histogram; one [2] stats sync
    sizes the exchange exactly (no drops) before _round_exchange runs."""
    n = mesh.shape[AXIS]

    def step(u, v):
        nu, nv = _star_emit(u[0], v[0], large)
        valid = nu != U32(VSENT)
        # the exchange mirrors each emission, so count both orientations
        shard_a = jnp.where(valid, (_hash_vert(nu) % U32(n)).astype(I32), n)
        shard_b = jnp.where(valid, (_hash_vert(nv) % U32(n)).astype(I32), n)
        occ = jnp.stack([jnp.sum(shard_a == s) + jnp.sum(shard_b == s)
                         for s in range(n)])
        return nu[None], nv[None], occ[None]

    nu, nv, occ = jax.shard_map(
        step, mesh=mesh, in_specs=(P(AXIS), P(AXIS)),
        out_specs=(P(AXIS), P(AXIS), P(AXIS)))(eu, ev)
    return nu, nv, jnp.max(occ)


@partial(jax.jit, static_argnames=("mesh", "cap"))
def _round_exchange(nu, nv, *, mesh: Mesh, cap: int):
    """Exchange emitted edges onto their hash shards; dedup locally.

    Returns (eu, ev, [edge_count, checksum]) — the count/checksum pair is
    a multiset fingerprint (psum over shards) for convergence detection.
    """
    n = mesh.shape[AXIS]

    def step(u, v):
        # keep both orientations: star rewrites read the full undirected
        # neighborhood of each source run (a one-sided list starves the
        # next round's runs)
        um = jnp.concatenate([u[0], v[0]])
        vm = jnp.concatenate([v[0], u[0]])
        bu, bv, _ = _bucket_pairs(um, vm, n, cap)
        ru = jax.lax.all_to_all(bu, AXIS, split_axis=0, concat_axis=0,
                                tiled=True).reshape(-1)
        rv = jax.lax.all_to_all(bv, AXIS, split_axis=0, concat_axis=0,
                                tiled=True).reshape(-1)
        ru, rv = jax.lax.sort((ru, rv), num_keys=2, is_stable=False)
        pu = jnp.concatenate([jnp.full((1,), VSENT, U32), ru[:-1]])
        pv = jnp.concatenate([jnp.full((1,), VSENT, U32), rv[:-1]])
        fresh = ((ru != pu) | (rv != pv)) & (ru != U32(VSENT))
        fresh = fresh.at[0].set(ru[0] != U32(VSENT))
        eu = jnp.where(fresh, ru, U32(VSENT))
        ev = jnp.where(fresh, rv, U32(VSENT))
        chk = jnp.sum(jnp.where(
            fresh, eu * U32(0x85EBCA6B) ^ ev * U32(0xC2B2AE35),
            U32(0)), dtype=U32)
        # compact uniques to the front (the width-trim below slices rows)
        eu, ev = jax.lax.sort((eu, ev), num_keys=2, is_stable=False)
        cnt = jnp.sum(fresh).astype(jnp.uint32)
        # max live per device sizes the trim: star centers concentrate
        # mirrored (center, child) edges on one shard, so the per-device
        # distribution is structurally skewed — a mean-based width drops
        # real edges
        maxl = jax.lax.pmax(cnt, AXIS)
        stats = jnp.concatenate([jax.lax.psum(jnp.stack([cnt, chk]), AXIS),
                                 jnp.stack([maxl])])
        return eu[None], ev[None], stats[None]

    eu, ev, stats = jax.shard_map(
        step, mesh=mesh, in_specs=(P(AXIS), P(AXIS)),
        out_specs=(P(AXIS), P(AXIS), P(AXIS)))(nu, nv)
    return eu, ev, stats


def _pad_cols(x, cols: int, mesh: Mesh, n: int):
    have = x.shape[1]
    if have == cols:
        return x
    filler = _sharded_full(n, cols - have, VSENT, "uint32", mesh)()
    return jnp.concatenate([x, filler], axis=1)


def _pow2(n: int) -> int:
    s = 16
    while s < n:
        s *= 2
    return s


def sharded_connected_labels(nbr: np.ndarray, active: np.ndarray,
                             mesh: Mesh) -> np.ndarray:
    """Min-label per vertex over the active subgraph; inactive rows get M.

    Matches graph.components.connected_labels exactly.  Per-device state
    is O(E/n) edges (E <= 8M); no replicated [M] vector exists at any
    point.

    nbr: [8, M] int32 neighbor indices (-1 absent), host array.
    """
    M = nbr.shape[1]
    n = mesh.shape[AXIS]
    active = np.asarray(active, dtype=bool)

    # --- host setup: oriented edge list (u, v), hash-sharded by u -------
    src = np.tile(np.arange(M, dtype=np.int64), nbr.shape[0])
    dst = np.asarray(nbr, dtype=np.int64).reshape(-1)
    keep = (dst >= 0) & (src != dst)
    keep &= active[src] & active[np.clip(dst, 0, M - 1)]
    src, dst = src[keep], dst[keep]
    eu = src.astype(np.uint32)
    ev = dst.astype(np.uint32)

    # distribute by hash(u) so every source's run is device-local
    h = (eu.astype(np.uint64) * np.uint64(0x9E3779B9)) & np.uint64(0xFFFFFFFF)
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(0x85EBCA6B)) & np.uint64(0xFFFFFFFF)
    shard = ((h ^ (h >> np.uint64(13))) % np.uint64(n)).astype(np.int64)
    counts = np.bincount(shard, minlength=n)
    cap0 = _pow2(max(int(counts.max()), 1))
    loc_u = np.full((n, cap0), VSENT, np.uint32)
    loc_v = np.full((n, cap0), VSENT, np.uint32)
    for s in range(n):
        sel = shard == s
        loc_u[s, : counts[s]] = eu[sel]
        loc_v[s, : counts[s]] = ev[sel]

    sharding = jax.NamedSharding(mesh, P(AXIS))
    # does the mesh span processes (cross-host DCN)?  inputs are
    # replicated on every process (each built the same edge list), so
    # feed each process its addressable row block and gather results
    # back with a DCN allgather at the end
    multiproc = jax.process_count() > 1 and any(
        d.process_index != jax.process_index() for d in mesh.devices.flat)
    if multiproc:
        pidx = np.array([d.process_index for d in mesh.devices.flat])
        assert (np.diff(pidx) >= 0).all(), (
            "sharded_connected_labels expects process-contiguous mesh rows")
        mine = np.nonzero(pidx == jax.process_index())[0]
        deu = jax.make_array_from_process_local_data(
            sharding, loc_u[mine], (n, cap0))
        dev = jax.make_array_from_process_local_data(
            sharding, loc_v[mine], (n, cap0))
    else:
        deu = jax.device_put(loc_u, sharding)
        dev = jax.device_put(loc_v, sharding)

    # --- star-contraction rounds ---------------------------------------
    prev_fp = None
    max_rounds = 4 * (int(np.ceil(np.log2(max(M, 2)))) + 2) ** 2 + 8
    for rnd in range(max_rounds):
        large = rnd % 2 == 0
        nu, nv, maxb = _round_stats(deu, dev, mesh=mesh, large=large)
        cap = max(16, _pow2(int(maxb)))
        deu, dev, stats = _round_exchange(nu, nv, mesh=mesh, cap=cap)
        # trim to the live edge bound (keeps round shapes from growing);
        # stats rows are replicated (psum/pmax) — read a LOCAL shard, the
        # global row 0 may live on another process
        stats0 = np.asarray(stats.addressable_shards[0].data)[0]
        fp = (int(stats0[0]), int(stats0[1]))
        width = _pow2(max(int(stats0[2]), 16))
        if width < deu.shape[1]:
            # edges are dedup-compacted to row fronts by the round sort
            deu = jax.lax.slice_in_dim(deu, 0, width, axis=1)
            dev = jax.lax.slice_in_dim(dev, 0, width, axis=1)
        elif width > deu.shape[1]:
            deu = _pad_cols(deu, width, mesh, n)
            dev = _pad_cols(dev, width, mesh, n)
        if not large and fp == prev_fp:
            break
        if not large:
            prev_fp = fp
    else:
        raise RuntimeError("star contraction did not converge")

    # --- labels from the final star forest ------------------------------
    if multiproc:
        from jax.experimental import multihost_utils

        def _gather(a):
            loc = np.concatenate(
                [np.asarray(s.data).reshape(-1)
                 for s in sorted(a.addressable_shards,
                                 key=lambda s: s.index[0].start or 0)])
            return np.asarray(
                multihost_utils.process_allgather(loc)).reshape(-1)

        fu = _gather(deu)
        fv = _gather(dev)
    else:
        fu = np.asarray(deu).reshape(-1)
        fv = np.asarray(dev).reshape(-1)
    live = fu != VSENT
    labels = np.where(active, np.arange(M, dtype=np.int64), M)
    np.minimum.at(labels, fu[live].astype(np.int64),
                  fv[live].astype(np.int64))
    return labels.astype(np.int32)
