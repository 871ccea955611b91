"""Card-only tests: the device stages compiled for the GPU, at real widths.

Each test runs both algorithms of a size-routed choice (utils/device.
gpu_path) on the card, or a device stage against a native reference,
and requires exact equality.  They carry the `gpu` marker and take the
`gpu` fixture, which skips them where the default device is not a GPU.
On a GPU host:

    JAX_PLATFORMS=cuda python -m pytest tests -m gpu
"""

import ctypes

import numpy as np
import pytest

from metafast_jax.core import bitpack as bp
from metafast_jax.native import load_library
from metafast_jax.oracle import synth

pytestmark = pytest.mark.gpu

K = 31


def _native_keys(codes, lengths):
    lib = load_library()
    codes = np.ascontiguousarray(codes, np.uint8)
    lengths = np.ascontiguousarray(lengths, np.int32)
    n = int(np.maximum(lengths.astype(np.int64) - K + 1, 0).sum())
    keys = np.empty(n, np.int64)
    got = lib.extract_canonical(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(lengths), K, keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n)
    assert got == n
    return keys


def _graph_table(n_bases: int, seed: int):
    """Padded (khi, klo) of a de Bruijn table: random genome pieces of
    0.5-50 kbp (chains), some carrying a copy of another's segment
    (forks)."""
    from metafast_jax.graph.contigs import _table_bucket

    rng = np.random.default_rng(seed)
    pieces, total = [], 0
    while total < n_bases:
        p = synth.random_genome(rng, int(rng.integers(500, 50_000)))
        if pieces and rng.random() < 0.2:
            src = pieces[int(rng.integers(len(pieces)))]
            a = int(rng.integers(0, max(len(src) - 2000, 1)))
            p = np.concatenate([p, src[a:a + 2000]])
        pieces.append(p)
        total += len(p)
    keys = np.unique(_native_keys(np.concatenate(pieces),
                                  [len(p) for p in pieces]))
    M = _table_bucket(len(keys))
    khi = np.full(M, bp.SENTINEL, np.uint32)
    klo = np.full(M, bp.SENTINEL, np.uint32)
    u = keys.astype(np.uint64)
    khi[:len(keys)] = (u >> np.uint64(32)).astype(np.uint32)
    klo[:len(keys)] = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return keys, khi, klo


@pytest.fixture(scope="module")
def table():
    return _graph_table(1 << 22, seed=0)


def test_default_device_routes_to_gpu(gpu):
    from metafast_jax.utils import device

    assert device.platform() == "gpu"
    assert device.gpu_path(1 << 30, 1)
    assert not device.gpu_path(1, 1 << 30)


def test_counting_matches_native(gpu):
    """Stream extraction + sort/RLE counting on the card equals native
    extraction + host sort, at a 2^25-code slab with duplicates."""
    from metafast_jax.ops.count import KmerCounter

    rng = np.random.default_rng(1)
    genome = synth.random_genome(rng, 2_000_000)
    reads = synth.sample_reads(rng, [genome], np.ones(1), 16.0, 150)
    lengths = np.full(len(reads), 150, np.int32)
    c = KmerCounter(K)
    c.add_stream3(reads.reshape(-1), lengths)
    keys, counts = c.finish()
    want = np.sort(_native_keys(reads.reshape(-1), lengths))
    uniq, n = np.unique(want, return_counts=True)
    assert np.array_equal(keys, uniq)
    assert np.array_equal(counts, np.minimum(n, 32767))


def test_chain_rank_matches_doubling(gpu, table):
    import jax.numpy as jnp

    from metafast_jax.graph import contigs as ct, dbg, rank

    _, khi, klo = table
    khi, klo = jnp.asarray(khi), jnp.asarray(klo)
    t = dbg.neighbor_tables(khi, klo, K)
    L, R = t["left"], t["right"]
    st = ct._succ_from_tables(khi, klo, L["idx"], L["is_fw"], L["ext"],
                              R["idx"], R["is_fw"], R["ext"], K)
    term, dist, reached = (np.asarray(x) for x in ct._doubling(st["succ"]))
    r = rank.chain_rank(st["succ"], st["valid2"])
    m = np.asarray(st["valid2"]) & reached
    assert np.array_equal(np.asarray(r["reached"])[m], reached[m])
    assert np.array_equal(np.asarray(r["term"])[m], term[m])
    assert np.array_equal(np.asarray(r["dist"])[m], dist[m])


def test_component_labels_match_native(gpu, table):
    """Level-1 component labels on the card give exactly the native
    BFS's component count."""
    from metafast_jax.graph import components as C

    keys, khi, klo = table
    labels = C.table_labels(khi, klo, K)
    n_dev = len(np.unique(labels[:len(keys)]))
    lib = load_library()
    k64 = np.ascontiguousarray(keys, np.uint64)
    ones = np.ones(len(keys), np.int32)
    n_comp = ctypes.c_int64(0)
    log2 = max(12, int(np.ceil(np.log2(len(keys)))) + 1)
    assert lib.bfs_components_baseline(
        k64.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ones.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(keys), K,
        log2, ctypes.byref(n_comp)) >= 0
    assert n_dev == n_comp.value


def test_feature_join_matches_host(gpu, table, monkeypatch):
    from metafast_jax import api
    from metafast_jax.pipeline import matrix

    keys, _, _ = table
    rng = np.random.default_rng(2)
    counts = rng.integers(1, 32768, len(keys)).astype(np.int32)
    sample = np.sort(rng.choice(keys, len(keys) // 2, replace=False))
    scounts = counts[:len(sample)]
    sizes = rng.integers(1000, 10000, 400)
    allk = rng.choice(keys, int(sizes.sum()))
    monkeypatch.setattr(matrix, "_FEATURE_DEVICE_MIN", 0)
    vs, hs = matrix._feature_segsum_device(allk, sample, scounts, sizes, 0)
    pres = api.presence_counts(allk, sample, scounts)
    starts = np.r_[0, np.cumsum(sizes)[:-1]]
    assert np.array_equal(vs, np.add.reduceat(pres, starts))
    assert np.array_equal(hs, np.add.reduceat((pres > 0).astype(np.int64),
                                              starts))


def test_pivot_index_matches_host(gpu, table):
    from metafast_jax.graph import pivot

    keys, _, _ = table
    g = pivot._Graph.__new__(pivot._Graph)
    g.keys = keys
    q = pivot.right_neighbors_np(keys[: 1 << 20], K)
    assert np.array_equal(g._index_device(q), g._index(q))
