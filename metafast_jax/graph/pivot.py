"""Pivot-anchored component extraction.

Parity: src/algo/ComponentsBuilderAroundPivot.java (depth == 1) and
DeepComponentsBuilderAroundPivot.java (depth > 1): BFS from each
unprocessed pivot k-mer; unique continuations extend freely, forks are
entered only via a path probe that reaches another pivot (within `depth`
k-mers for the deep variant, choosing the pivot-richest path).

Determinism spec (the reference iterates hash maps, so its component
membership depends on hash layout; ours is fixed): pivots are processed
in ascending canonical-key order, fork branches in neighbor-nucleotide
order, and deep probes prefer the first-found best path.  Failed probe
paths stay consumed (marked visited) exactly like the reference's dfs
(ComponentsBuilderAroundPivot.java:360-428).

Deviations from reference bugs (documented, not replicated):
  - DeepComponentsBuilderAroundPivot.bfs adds a path k-mer's *pivot map
    value* to the component weight (:169-175) and bumps n_pivot once per
    path k-mer (:182); we add the graph value and bump once per path.

Scale envelope (MEASURED, tests/test_bfs_envelope.py): neighbor tables
are precomputed vectorized (one searchsorted over all 8 neighbor sets)
and materialized as Python lists; the traversal is queue-chasing Python
at ~5 us/node plus ~4 us/node of table build — a 2M-node chain
traverses in ~20 s.  That matches the tool's niche use (pivot sets are
statistically filtered k-mers, not whole samples).  The bulk pipeline
path (graph/components.py) is the device label-propagation instead.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.device import gpu_path

_MASKS = [
    (0x3333333333333333, 0xCCCCCCCCCCCCCCCC, 2),
    (0x0F0F0F0F0F0F0F0F, 0xF0F0F0F0F0F0F0F0, 4),
    (0x00FF00FF00FF00FF, 0xFF00FF00FF00FF00, 8),
    (0x0000FFFF0000FFFF, 0xFFFF0000FFFF0000, 16),
    (0x00000000FFFFFFFF, 0xFFFFFFFF00000000, 32),
]


def rc_np(keys: np.ndarray, k: int) -> np.ndarray:
    """Vectorized reverse complement (KmerOperations.rc)."""
    x = np.asarray(keys, dtype=np.uint64)
    for lo, hi, s in _MASKS:
        x = ((x & np.uint64(lo)) << np.uint64(s)) \
            | ((x & np.uint64(hi)) >> np.uint64(s))
    x = ~x
    return (x >> np.uint64(64 - 2 * k)).astype(np.int64)


def canonical_np(keys: np.ndarray, k: int) -> np.ndarray:
    r = rc_np(keys, k)
    return np.minimum(np.asarray(keys, dtype=np.int64), r)


def right_neighbors_np(keys: np.ndarray, k: int) -> np.ndarray:
    """[N, 4] canonical right neighbors (KmerOperations.rightNeighbours)."""
    mask = np.uint64((1 << (2 * k)) - 1)
    base = (np.asarray(keys, dtype=np.uint64) << np.uint64(2)) & mask
    cols = [canonical_np((base | np.uint64(nuc)).astype(np.int64), k)
            for nuc in range(4)]
    return np.stack(cols, axis=1)


def left_neighbors_np(keys: np.ndarray, k: int) -> np.ndarray:
    """[N, 4] canonical left neighbors (KmerOperations.leftNeighbours)."""
    base = np.asarray(keys, dtype=np.uint64) >> np.uint64(2)
    cols = [canonical_np(
        (base | (np.uint64(nuc) << np.uint64(2 * (k - 1)))).astype(np.int64), k)
        for nuc in range(4)]
    return np.stack(cols, axis=1)


@dataclass
class PivotComponent:
    kmers: np.ndarray          # sorted int64 canonical keys
    weight: int
    n_pivot: int
    used_freq_threshold: int = 1

    @property
    def size(self) -> int:
        return len(self.kmers)


# from this table size up, a GPU builds the neighbor index with the
# device sort-merge join instead of host searchsorted (8 queries per key;
# see utils/device.gpu_path); on the H100 the device won at 2^21 keys
# (213 vs 2037 ms for one side); smaller sizes are not measured
_DEVICE_MIN = 1 << 21

# list-materialization memory bound (~8 ints/key: two [N, 4] tables)
_LIST_MAX = 1 << 23


class _Graph:
    """Index-space view: neighbor indices (or -1) per key.

    Small tables: numpy searchsorted + plain Python lists (one-element
    access costs ~5 us/node on lists vs 20.6 on numpy scalars, measured
    in tests/test_bfs_envelope.py).  Large tables: device merge-join
    build (see _DEVICE_MIN), numpy rows accessed lazily past _LIST_MAX:
    the traversal only touches pivot-component nodes, so per-node numpy
    indexing is paid on the visited set, not the table."""

    def __init__(self, keys: np.ndarray, counts: np.ndarray, k: int):
        self.keys = keys
        self.counts = counts
        self.k = k
        if gpu_path(len(keys), _DEVICE_MIN):
            right = self._index_device(right_neighbors_np(keys, k))
            left = self._index_device(left_neighbors_np(keys, k))
        else:
            right = self._index(right_neighbors_np(keys, k))
            left = self._index(left_neighbors_np(keys, k))
        if len(keys) <= _LIST_MAX:
            # list rows: ~4x faster per visited node; fine up to ~2 GB
            self.right = right.tolist()
            self.left = left.tolist()
            self.counts_l = counts.tolist()
        else:
            # numpy rows, converted lazily per visited node — the
            # traversal only touches pivot components, so table-sized
            # list materialization would be all memory and no speed
            self.right = right
            self.left = left
            self.counts_l = counts
        self.visited = bytearray(len(keys))

    def _index(self, nbr_keys: np.ndarray) -> np.ndarray:
        idx = np.searchsorted(self.keys, nbr_keys)
        idx = np.clip(idx, 0, max(len(self.keys) - 1, 0))
        found = (self.keys[idx] == nbr_keys) if len(self.keys) else \
            np.zeros_like(idx, dtype=bool)
        return np.where(found, idx, -1).astype(np.int64)

    def _index_device(self, nbr_keys: np.ndarray) -> np.ndarray:
        """Same contract as _index, via the device sort-merge join."""
        import jax.numpy as jnp

        from . import lookup

        u = self.keys.astype(np.uint64)
        thi = jnp.asarray((u >> np.uint64(32)).astype(np.uint32))
        tlo = jnp.asarray((u & np.uint64(0xFFFFFFFF)).astype(np.uint32))
        q = nbr_keys.astype(np.uint64)
        qhi = jnp.asarray((q >> np.uint64(32)).astype(np.uint32))
        qlo = jnp.asarray((q & np.uint64(0xFFFFFFFF)).astype(np.uint32))
        idx, found = lookup.find(thi, tlo, qhi, qlo)
        return np.where(np.asarray(found), np.asarray(idx), -1) \
            .astype(np.int64)

    def live(self, side, i: int) -> list[int]:
        """Unvisited neighbor indices on one side (with multiplicity)."""
        v = self.visited
        row = side[i]
        if not isinstance(row, list):
            row = row.tolist()
        return [j for j in row if j >= 0 and not v[j]]

    def away_side(self, i: int, prev: int):
        """Continuation side given the predecessor's INDEX.

        Mirrors the reference's two scans (left match -> go right, right
        match -> go left; the later scan wins,
        ComponentsBuilderAroundPivot.java:283-296).  The predecessor is
        always a graph node, so index membership in the neighbor-index
        rows is equivalent to the reference's key-membership scans."""
        side = None
        if prev in self.left[i]:
            side = self.right
        if prev in self.right[i]:
            side = self.left
        return side


def split_around_pivot(keys: np.ndarray, counts: np.ndarray, k: int,
                       pivot_keys: np.ndarray, depth: int = 1,
                       force_python: bool = False
                       ) -> list[PivotComponent]:
    """All pivot components of a counted graph (sorted keys required).

    depth == 1 (the dominant mode) routes the traversal through the
    native BFS (fastparse.cpp pivot_bfs_depth1, an exact mirror of the
    Python loop below): the traversal is inherently sequential — probe
    order and the visited set ARE the semantics — and per-node Python
    costs ~20 us where the native loop does ~50M nodes/s, which is what
    makes the 10^7-key chain-heavy worst case tractable.
    Equality between the two is pinned by tests/test_pivot.py.
    """
    keys = np.asarray(keys, dtype=np.int64)
    counts = np.asarray(counts, dtype=np.int64)
    if depth == 1 and not force_python:
        out = _split_around_pivot_native(keys, counts, k, pivot_keys)
        if out is not None:
            return out
    g = _Graph(keys, counts, k)

    piv_np = np.zeros(len(keys), dtype=bool)
    pidx = np.searchsorted(keys, np.asarray(pivot_keys, dtype=np.int64))
    pidx = np.clip(pidx, 0, max(len(keys) - 1, 0))
    if len(keys):
        ok = keys[pidx] == np.asarray(pivot_keys, dtype=np.int64)
        piv_np[pidx[ok]] = True
    piv = bytearray(piv_np.tobytes())
    pivot_done = bytearray(len(keys))

    out = []
    for start in np.nonzero(piv_np)[0]:
        if pivot_done[start] or g.visited[start]:
            continue
        out.append(_bfs(g, int(start), piv, pivot_done, depth))
    out.sort(key=lambda c: (c.used_freq_threshold, -c.weight, -c.size,
                            int(c.kmers[0]) if c.size else 0))
    return out


def _split_around_pivot_native(keys, counts, k, pivot_keys
                               ) -> list[PivotComponent] | None:
    """Depth-1 extraction via the native traversal; None if the native
    library is unavailable (caller falls back to Python)."""
    import ctypes

    from ..native import load_library

    lib = load_library()
    if lib is None:
        return None
    n = len(keys)
    if n == 0:
        return []
    # neighbor index tables in one native pass (hash build + 8 probes
    # per key, same nucleotide order as right/left_neighbors_np —
    # probe order is semantics): ~8s at 10^7 keys vs ~50s for the
    # numpy canonical build + searchsorted
    log2 = max(10, int(np.ceil(np.log2(max(n, 2)))) + 1)
    left = np.empty((n, 4), dtype=np.int32)
    right = np.empty((n, 4), dtype=np.int32)
    keys_c = np.ascontiguousarray(keys, dtype=np.int64)
    rc = lib.build_neighbor_index(
        keys_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, k, log2,
        left.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        right.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        return None

    piv_np = np.zeros(n, dtype=np.uint8)
    pidx = np.searchsorted(keys, np.asarray(pivot_keys, dtype=np.int64))
    pidx = np.clip(pidx, 0, n - 1)
    ok = keys[pidx] == np.asarray(pivot_keys, dtype=np.int64)
    piv_np[pidx[ok]] = 1
    starts = np.nonzero(piv_np)[0].astype(np.int64)
    if len(starts) == 0:
        return []

    counts64 = np.ascontiguousarray(counts, dtype=np.int64)
    members_cap = 2 * n + 64
    members = np.empty(members_cap, dtype=np.int32)
    max_comps = len(starts) + 1
    comp_off = np.empty(max_comps + 1, dtype=np.int64)
    comp_w = np.empty(max_comps, dtype=np.int64)
    comp_p = np.empty(max_comps, dtype=np.int64)
    p32 = ctypes.POINTER(ctypes.c_int32)
    p64 = ctypes.POINTER(ctypes.c_int64)
    p8 = ctypes.POINTER(ctypes.c_uint8)
    n_comp = lib.pivot_bfs_depth1(
        left.ctypes.data_as(p32), right.ctypes.data_as(p32),
        counts64.ctypes.data_as(p64), piv_np.ctypes.data_as(p8),
        n, starts.ctypes.data_as(p64), len(starts),
        members.ctypes.data_as(p32), members_cap,
        comp_off.ctypes.data_as(p64), comp_w.ctypes.data_as(p64),
        comp_p.ctypes.data_as(p64), max_comps)
    if n_comp < 0:
        return None                      # overflow: python fallback
    out = []
    for c in range(n_comp):
        m = members[comp_off[c]:comp_off[c + 1]]
        out.append(PivotComponent(
            kmers=np.sort(keys[np.unique(m.astype(np.int64))]),
            weight=int(comp_w[c]), n_pivot=int(comp_p[c])))
    out.sort(key=lambda c: (c.used_freq_threshold, -c.weight, -c.size,
                            int(c.kmers[0]) if c.size else 0))
    return out


def _bfs(g: _Graph, start: int, piv: np.ndarray, pivot_done: np.ndarray,
         depth: int) -> PivotComponent:
    from collections import deque

    members: list[int] = []
    weight = 0
    n_pivot = 0
    queue: deque[tuple[int, int]] = deque()   # (index, parent index)

    def visit(i: int) -> None:
        nonlocal weight, n_pivot
        g.visited[i] = True
        members.append(i)
        weight += g.counts_l[i]
        if piv[i] and not pivot_done[i]:
            pivot_done[i] = True
            n_pivot += 1

    def probe(j: int, cur: int) -> tuple[int, list[int]]:
        """Walk the unique continuation from fork branch j; mark the path
        visited; return (#pivots on path, path indices)."""
        if depth == 1:
            return _probe_line(g, j, cur, piv, pivot_done)
        return _probe_deep(g, j, cur, piv, depth)

    def expand(i: int, side) -> None:
        """One side of the start k-mer, or the away side in the main loop."""
        nonlocal n_pivot
        nbrs = [j for j in side[i] if j >= 0 and not g.visited[j]]
        if not nbrs:
            return
        if len(nbrs) == 1:
            j = nbrs[0]
            visit(j)
            queue.append((j, i))
        else:
            for j in nbrs:
                if g.visited[j]:
                    continue
                n_piv, path = probe(j, i)
                if n_piv > 0:
                    visit(j)
                    n_pivot += n_piv
                    for p in path:
                        _add_path_member(p)
                    if len(path) >= 2:
                        queue.append((path[-1], path[-2]))
                    elif len(path) == 1:
                        queue.append((path[0], j))
                    else:
                        queue.append((j, i))

    def _add_path_member(p: int) -> None:
        nonlocal weight
        members.append(p)
        weight += g.counts_l[p]

    visit(start)
    expand(start, g.right)
    expand(start, g.left)

    while queue:
        i, prev = queue.popleft()
        side = g.away_side(i, prev)
        if side is None:
            continue
        expand(i, side)

    kmers = np.sort(g.keys[np.unique(
        np.fromiter(members, dtype=np.int64, count=len(members)))])
    return PivotComponent(kmers=kmers, weight=weight, n_pivot=n_pivot)


def _probe_line(g: _Graph, j: int, parent: int, piv: np.ndarray,
                pivot_done: np.ndarray) -> tuple[int, list[int]]:
    """depth==1 probe: follow unique continuations, consuming the path
    (ComponentsBuilderAroundPivot.dfs).  Marks pivots found as done."""
    path: list[int] = []
    n_pivot = 0
    cur = j
    prev = parent
    # the branch head itself is NOT consumed by a failed probe
    # (the reference dfs never marks `neighbour`, only path k-mers);
    # mark it temporarily so a cycle cannot re-enter it, restore below
    g.visited[j] = True
    while True:
        side = g.away_side(cur, prev)
        if side is None:
            break
        nbrs = [x for x in side[cur] if x >= 0 and not g.visited[x]]
        if len(nbrs) != 1:
            break
        nxt = nbrs[0]
        path.append(nxt)
        g.visited[nxt] = True
        if piv[nxt] and not pivot_done[nxt]:
            pivot_done[nxt] = True
            n_pivot += 1
        prev = cur
        cur = nxt
    if n_pivot == 0:
        g.visited[j] = False
    return n_pivot, path


def _probe_deep(g: _Graph, j: int, parent: int, piv: np.ndarray,
                depth: int) -> tuple[int, list[int]]:
    """depth>1 probe: exhaustive DFS up to `depth` k-mers, keep the
    pivot-richest path (DeepComponentsBuilderAroundPivot.dfs)."""
    best = {"n": 0, "path": []}

    def rec(cur: int, prev: int, path: list[int], n_piv: int,
            avail: int) -> None:
        if avail == 0:
            if n_piv > best["n"]:
                best["n"] = n_piv
                best["path"] = list(path)
            return
        side = g.away_side(cur, prev)
        nbrs = [] if side is None else \
            [x for x in side[cur] if x >= 0 and not g.visited[x]
             and x not in path and x != j]
        if not nbrs:
            if n_piv > best["n"]:
                best["n"] = n_piv
                best["path"] = list(path)
            return
        for x in nbrs:
            rec(x, cur, path + [x],
                n_piv + (1 if piv[x] else 0), avail - 1)

    g.visited[j] = True
    rec(j, parent, [], 0, depth)
    if best["n"] == 0:
        # deep probes are read-only on failure (the reference's deep dfs
        # never mutates hm; only the chosen best path is consumed)
        g.visited[j] = False
        return 0, []
    for p in best["path"]:
        g.visited[p] = True
    return best["n"], best["path"]
