"""Measured scale envelope for the host-Python BFS graph tools.

graph/pivot.py and graph/colored.py document a measured ~5-10 us/node
end-to-end cost ("fine to a few million k-mers").  These tests back the
docstrings with a measurement at million-node scale: a single long
random sequence yields one chain-shaped de Bruijn component whose
traversal must visit every node.  The assertion bound (15 us/node) is
~1.5x the measured rate to stay robust on loaded CI hosts; the measured
rate is printed for the perf log (PERF.md).
"""

import time

import numpy as np
import pytest

from metafast_jax.utils.kmers import sequence_kmers

K = 25
BASES = "AGCT"


def _chain_keys(n_nodes: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    seq = "".join(BASES[i] for i in rng.integers(0, 4, n_nodes + K - 1))
    return np.unique(sequence_kmers(seq, K))


@pytest.mark.parametrize("n_nodes", [2_000_000])
def test_pivot_bfs_envelope(n_nodes):
    from metafast_jax.graph.pivot import split_around_pivot

    keys = _chain_keys(n_nodes, seed=1)
    counts = np.ones(len(keys), dtype=np.int64)
    pivots = keys[:: len(keys) // 64]       # 64 pivots spread over the chain

    t0 = time.perf_counter()
    comps = split_around_pivot(keys, counts, K, pivots, depth=1)
    dt = time.perf_counter() - t0

    visited = sum(c.size for c in comps)
    assert visited >= 0.9 * len(keys), (visited, len(keys))
    per_node = dt / visited
    print(f"\npivot BFS: {visited} nodes in {dt:.2f}s "
          f"({per_node*1e6:.2f} us/node)")
    assert per_node < 15e-6, f"{per_node*1e6:.2f} us/node exceeds envelope"


@pytest.mark.parametrize("n_nodes", [1_000_000])
def test_colored_bfs_envelope(n_nodes):
    from metafast_jax.graph.colored import split_colored

    keys = _chain_keys(n_nodes, seed=2)
    # all nodes colored group 0 with a dominant share
    values = np.full(len(keys), 100, dtype=np.int64)

    t0 = time.perf_counter()
    ans = split_colored(keys, values, K, n_groups=3)
    dt = time.perf_counter() - t0

    visited = sum(c.weight for comps in ans.values() for c in comps)
    assert visited >= 0.9 * len(keys), (visited, len(keys))
    per_node = dt / visited
    print(f"\ncolored BFS: {visited} nodes in {dt:.2f}s "
          f"({per_node*1e6:.2f} us/node)")
    assert per_node < 15e-6, f"{per_node*1e6:.2f} us/node exceeds envelope"
