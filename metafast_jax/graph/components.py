"""Connected components with size-window splitting — label propagation.

Reference semantics (src/algo/ComponentsBuilder.java): at threshold t the
graph over surviving k-mers is BFS-partitioned; components smaller than b1
are dropped, those within [b1, b2] are emitted with weight = sum of counts
and usedFreqThreshold = t, and oversized ones are re-processed at t+1
restricted to k-mers with count >= t+1.

Data-parallel reformulation: sequential BFS becomes min-label propagation with
pointer shortcutting (FastSV-style), converging in O(log n) gather rounds;
all components of one threshold level are found in a single pass, and all
oversized components advance to the next level together (they stay disjoint
automatically).  The final component multiset is identical — BFS order
never affects membership.

Emitted components are sorted by (usedFreqThreshold asc, weight desc,
size desc), matching ConnectedComponent.compareTo (ties broken
deterministically by smallest member key — the reference's tie order is
thread-scheduling-dependent).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..core import bitpack as bp
from . import dbg

I32 = jnp.int32


@dataclass
class Component:
    kmers: np.ndarray          # sorted int64 canonical keys
    weight: int
    used_freq_threshold: int

    @property
    def size(self) -> int:
        return len(self.kmers)


@jax.jit
def _mask_adjacency(idx_l, idx_r, pres_l, pres_r):
    idx = jnp.concatenate([idx_l, idx_r], axis=0)
    present = jnp.concatenate([pres_l, pres_r], axis=0)
    return jnp.where(present, idx, -1)


def adjacency(khi, klo, k: int):
    """[8, M] neighbor table indices (-1 = absent), canonical 8-neighborhood.

    Parity: KmerOperations.possibleNeighbours (src/algo/KmerOperations.java:9-27).
    Neighbor-major layout ([8, M]).  Not one @jax.jit: see
    dbg.neighbor_tables.
    """
    t = dbg.neighbor_tables(khi, klo, k)
    return _mask_adjacency(t["left"]["idx"], t["right"]["idx"],
                           t["left"]["present"], t["right"]["present"])


@jax.jit
def _label_round(labels, nbr, active):
    """One hooking round: hash-min + scatter-min onto roots + compression.

    Pure hash-min (label = min over neighbor labels) converges in
    O(diameter) rounds — ~0.4*n rounds on a path with random vertex ids
    (measured: 9,534 rounds at 2^14; pointer shortcutting does NOT fix
    it, because compression only shallows the label tree, it never moves
    information across graph edges).  The Shiloach-Vishkin move that
    restores O(log n) is HOOKING: scatter-min each vertex's neighborhood
    minimum onto its current ROOT, so label trees merge across edges and
    compression then collapses them (measured: 15 rounds at 2^20 on the
    same path).  Cost per round: one [8, M] scatter-min, one [M]
    scatter-min (the hook), two compression gathers.
    """
    M = labels.shape[0]
    old = jnp.where(active, labels, M)

    # push: relax every edge with ONE [8, M] scatter-min instead of an
    # [8, M] neighbor-label gather — min-scatter is order-independent,
    # so the result is deterministic
    safe = jnp.clip(nbr, 0, M - 1)
    tgt = jnp.where((nbr >= 0) & active[None, :], safe, M)
    vals = jnp.broadcast_to(old[None, :], tgt.shape)
    labels = old.at[tgt].min(vals, mode="drop")

    # hook: each vertex's freshly-pushed knowledge onto its OLD root —
    # this merges label trees across edges, which is what turns
    # O(diameter) hash-min into O(log n) (index M = dropped)
    labels = labels.at[old].min(labels, mode="drop")

    # compress: 2 hops suffice alongside hooking (measured)
    for _ in range(2):
        labels = jnp.minimum(labels, labels[jnp.clip(labels, 0, M - 1)])
    # inactive rows must stay M: the clip above can otherwise read row
    # M-1's label into them (latent in the pre-hooking version too)
    return jnp.where(active, labels, M)


@jax.jit
def _connected_labels_device(nbr, active):
    """Fixed-point min-label propagation, fully on device.

    The convergence check runs inside lax.while_loop, so no host
    round-trip per round."""
    M = nbr.shape[1]
    labels0 = jnp.where(active, jnp.arange(M, dtype=I32), M)

    def cond(state):
        prev, cur = state
        return jnp.any(prev != cur)

    def body(state):
        _, cur = state
        return cur, _label_round(cur, nbr, active)

    _, labels = jax.lax.while_loop(
        cond, body, (labels0, _label_round(labels0, nbr, active)))
    return labels


def connected_labels(nbr: jnp.ndarray, active: jnp.ndarray) -> np.ndarray:
    """Min-label per vertex over the active subgraph; inactive rows get M."""
    return np.asarray(_connected_labels_device(jnp.asarray(nbr),
                                               jnp.asarray(active)))


def table_labels(khi, klo, k: int) -> np.ndarray:
    """connected_labels of a padded table whose every live row is active
    (the first threshold level)."""
    khi = jnp.asarray(khi)
    klo = jnp.asarray(klo)
    return connected_labels(adjacency(khi, klo, k), ~bp.is_sentinel(khi, klo))


def split_components(keys64: np.ndarray, counts: np.ndarray, k: int,
                     b1: int, b2: int) -> list[Component]:
    """Full size-window component splitting over a counted k-mer table.

    With a default mesh set (api.set_default_mesh, >1 devices) the label
    fixed points route through the edge-cut sharded star contraction
    (parallel/components.py) — the whole-pipeline scaling the reference
    gets from striped maps (itmo BigLong2ShortHashMap.java:40-70); the
    single-device path is unchanged otherwise.
    """
    M0 = len(keys64)
    if M0 == 0:
        return []
    from .. import api

    mesh = api.get_default_mesh()
    if mesh is not None and mesh.devices.size > 1:
        from ..parallel.components import sharded_connected_labels

        labels_fn = lambda nbr, active: sharded_connected_labels(
            np.asarray(nbr), np.asarray(active), mesh)
        return _split_components_impl(keys64, counts, k, b1, b2, labels_fn)
    return _split_components_impl(keys64, counts, k, b1, b2)


def _split_components_impl(keys64, counts, k, b1, b2,
                           labels_fn=connected_labels):
    M0 = len(keys64)
    M = _table_bucket(M0)
    khi = np.full(M, bp.SENTINEL, dtype=np.uint32)
    klo = np.full(M, bp.SENTINEL, dtype=np.uint32)
    u = keys64.astype(np.uint64)
    khi[:M0] = (u >> np.uint64(32)).astype(np.uint32)
    klo[:M0] = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    nbr = None
    counts_full = np.zeros(M, dtype=np.int64)
    counts_full[:M0] = counts

    active = np.zeros(M, dtype=bool)
    active[:M0] = True
    thr = 1
    out: list[Component] = []

    while active.any():
        # the active set shrinks sharply per threshold level (only
        # oversized components' high-count k-mers survive), but the
        # label rounds always cost O(table size): when occupancy drops
        # below 1/4, rebuild a compacted sub-table + adjacency so later
        # levels run at their own scale, not the level-1 table's.
        # Component membership is by KEY VALUE, so compaction cannot
        # change any emitted component; edges within the active subset
        # are preserved because both endpoints' keys remain present.
        n_act = int(active.sum())
        if n_act and n_act * 4 <= M and M > 16:
            sel = np.nonzero(active)[0]     # always < len(keys64): only
            keys64 = keys64[sel]            # real rows ever activate
            counts = counts_full[sel]
            M0 = len(keys64)
            M = _table_bucket(max(M0, 1))
            khi = np.full(M, bp.SENTINEL, dtype=np.uint32)
            klo = np.full(M, bp.SENTINEL, dtype=np.uint32)
            u = keys64.astype(np.uint64)
            khi[:M0] = (u >> np.uint64(32)).astype(np.uint32)
            klo[:M0] = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            nbr = None
            counts_full = np.zeros(M, dtype=np.int64)
            counts_full[:M0] = counts
            active = np.zeros(M, dtype=bool)
            active[:M0] = True
        if nbr is None:
            nbr = adjacency(jnp.asarray(khi), jnp.asarray(klo), k)
        labels = labels_fn(nbr, jnp.asarray(active))
        act_idx = np.nonzero(active)[0]
        roots = labels[act_idx]
        order = np.argsort(roots, kind="stable")
        act_sorted = act_idx[order]
        roots_sorted = roots[order]
        # component boundaries
        starts = np.nonzero(np.r_[True, roots_sorted[1:] != roots_sorted[:-1]])[0]
        ends = np.r_[starts[1:], len(roots_sorted)]

        next_active = np.zeros(M, dtype=bool)
        for s, e in zip(starts, ends):
            members = act_sorted[s:e]
            size = e - s
            if size < b1:
                continue
            if size <= b2:
                w = int(counts_full[members].sum())
                out.append(Component(
                    kmers=np.sort(keys64[members]), weight=w,
                    used_freq_threshold=thr))
            else:
                survive = members[counts_full[members] >= thr + 1]
                next_active[survive] = True
        active = next_active
        thr += 1
        if thr > 32768:
            break

    out.sort(key=lambda c: (c.used_freq_threshold, -c.weight, -c.size,
                            int(c.kmers[0]) if c.size else 0))
    return out


def _table_bucket(n: int) -> int:
    """Graph-table padding from the {2^k, 3*2^(k-1)} family: 1.5x worst
    case instead of 2x — every graph stage scales with the PADDED size."""
    from ..ops.count import _bucket_size

    return max(16, _bucket_size(n))
