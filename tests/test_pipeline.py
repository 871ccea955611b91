"""Golden end-to-end test: full default pipeline vs the reference's
published matrix (test_data/meta_test_matrix.txt, README.md:88-99)."""

import numpy as np
import pytest

from metafast_jax.pipeline import matrix_pipeline

GOLDEN = {
    (0, 1): 0.5691162409506898,
    (0, 2): 0.2981399448537721,
    (1, 2): 0.8448331091037222,
}


@pytest.fixture(scope="module")
def result(ref_data):
    files = [str(ref_data / f"meta_test_{i}.fa") for i in (1, 2, 3)]
    return matrix_pipeline(files, k=31, b=1, l=100, b1=1000, b2=10000)


def test_golden_matrix(result):
    for (i, j), v in GOLDEN.items():
        assert result.matrix[i, j] == pytest.approx(v, abs=1e-12)
        assert result.matrix[j, i] == pytest.approx(v, abs=1e-12)
    assert np.all(np.diag(result.matrix) == 0.0)


def test_components_shape(result):
    # locked-in intermediate state for the fixture (validated against the
    # golden matrix end to end; sizes are order-free facts of the graph)
    assert sorted(c.size for c in result.components) == [2088, 3020, 5713, 6240]


def test_sample_names(result):
    assert result.names == ["meta_test_1", "meta_test_2", "meta_test_3"]


def test_vectors_positive(result):
    assert result.vectors.shape == (3, 4)
    assert (result.vectors.sum(axis=1) > 0).all()
    assert (result.breadth >= 0).all() and (result.breadth <= 1).all()


def test_oracle_agrees(ref_data):
    """The slow NumPy oracle and the JAX path produce identical matrices."""
    from metafast_jax.oracle import reference as o

    files = [str(ref_data / f"meta_test_{i}.fa") for i in (1, 2, 3)]
    K, B, L, B1, B2 = 31, 1, 100, 1000, 10000

    def read_fasta(path):
        reads, cur = [], []
        for line in open(path):
            line = line.strip()
            if line.startswith(">"):
                if cur:
                    reads.append("".join(cur))
                    cur = []
            else:
                cur.append(line)
        if cur:
            reads.append("".join(cur))
        return reads

    _, _, _, mat = o.matrix_pipeline([read_fasta(f) for f in files],
                                     K, B, L, B1, B2)
    for (i, j), v in GOLDEN.items():
        assert mat[i, j] == pytest.approx(v, abs=1e-12)


class _FakeComp:
    def __init__(self, kmers):
        self.kmers = np.asarray(kmers, dtype=np.int64)


def _feature_vectors_loop(components, keys, counts, threshold=0):
    """Brute-force per-component oracle (the pre-segment-sum semantics)."""
    from metafast_jax import api
    vec = np.zeros(len(components), dtype=np.int64)
    brd = np.zeros(len(components), dtype=np.float64)
    for i, c in enumerate(components):
        ck = np.asarray(c.kmers, dtype=np.int64)
        if len(ck) == 0:
            continue
        pres = api.presence_counts(ck, keys, counts)
        hit = pres > threshold
        vec[i] = int(pres[hit].sum())
        brd[i] = hit.sum() / len(ck)
    return vec, brd


def test_feature_vectors_segment_sum_parity():
    from metafast_jax.pipeline.matrix import feature_vectors
    rng = np.random.default_rng(7)
    universe = rng.choice(10_000, 3_000, replace=False).astype(np.int64)
    keys = np.sort(universe[:2_000])
    counts = rng.integers(1, 100, len(keys)).astype(np.int64)
    comps = []
    for size in [1, 3, 0, 17, 256, 0, 5]:
        comps.append(_FakeComp(rng.choice(universe, size, replace=False)
                               if size else []))
    for thr in (0, 5):
        v1, b1 = feature_vectors(comps, keys, counts, thr)
        v2, b2 = _feature_vectors_loop(comps, keys, counts, thr)
        np.testing.assert_array_equal(v1, v2)
        np.testing.assert_allclose(b1, b2)


def test_feature_vectors_5k_components_fast():
    """5k components x ~100 k-mers each must finish in seconds (SURVEY §7-6)."""
    import time
    from metafast_jax.pipeline.matrix import feature_vectors
    rng = np.random.default_rng(11)
    keys = np.sort(rng.choice(1 << 40, 400_000, replace=False).astype(np.int64))
    counts = rng.integers(1, 1000, len(keys)).astype(np.int64)
    comps = [_FakeComp(rng.choice(keys, rng.integers(50, 150)))
             for _ in range(5_000)]
    t0 = time.perf_counter()
    vec, brd = feature_vectors(comps, keys, counts)
    dt = time.perf_counter() - t0
    assert dt < 10.0, f"feature_vectors took {dt:.1f}s for 5k components"
    assert (vec > 0).all() and (brd == 1.0).all()


def test_feature_segsum_device_matches_host():
    """The device feature segment-sum (pipeline/matrix.py
    _feature_segsum_jit) agrees with the host searchsorted+reduceat path
   ; the routing gate is perf-only."""
    import jax.numpy as jnp

    from metafast_jax import api
    from metafast_jax.pipeline import matrix as M

    rng = np.random.default_rng(3)
    skeys = np.unique(rng.integers(0, 1 << 40, 20000).astype(np.int64))
    scnt = rng.integers(1, 100, len(skeys)).astype(np.int64)
    sizes = rng.integers(1, 60, 150).astype(np.int64)
    pool = np.concatenate(
        [skeys, rng.integers(0, 1 << 40, 4000).astype(np.int64)])
    allk = rng.choice(pool, int(sizes.sum())).astype(np.int64)
    seg = np.repeat(np.arange(len(sizes), dtype=np.int32), sizes)
    u = allk.astype(np.uint64)
    t = skeys.astype(np.uint64)
    vs, hs = M._feature_segsum_jit(
        jnp.asarray((t >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((t & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
        jnp.asarray(scnt.astype(np.int32)),
        jnp.asarray((u >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((u & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
        jnp.asarray(seg), len(sizes), jnp.int32(0))
    pres = api.presence_counts(allk, skeys, scnt)
    hit = pres > 0
    starts = np.zeros(len(sizes), np.int64)
    np.cumsum(sizes[:-1], out=starts[1:])
    assert np.array_equal(np.asarray(vs),
                          np.add.reduceat(np.where(hit, pres, 0), starts))
    assert np.array_equal(np.asarray(hs),
                          np.add.reduceat(hit.astype(np.int64), starts))
