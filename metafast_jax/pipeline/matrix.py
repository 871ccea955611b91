"""The default distance-matrix pipeline, end to end.

Parity: DistanceMatrixBuilderMain (src/tools/DistanceMatrixBuilderMain.java:152-176)
chains kmer-counter-many -> seq-builder-many -> component-cutter ->
features-calculator -> dist-matrix-calculator.  This module is the library
form of that chain; the CLI tools wrap these functions with per-step
workdirs and checkpoint manifests.

Semantics locked by the golden fixture (test_data/meta_test_matrix.txt):

  1. per sample: count canonical k-mers of all its read files
     (IOUtils.loadReads, src/io/IOUtils.java:742-803)
  2. write/keep only k-mers with count > b  (printKmers threshold,
     src/tools/KmersCounterMain.java:99) — downstream steps see ONLY these
  3. per sample: contigs = simple paths over the filtered table, emitted
     at length >= l  (SequencesFinders.thresholdStrategy)
  4. all samples' contigs >= l are recounted into ONE graph
     (ComponentCutterMain.runImpl, src/tools/ComponentCutterMain.java:78-86)
  5. split into components with size window [b1, b2]
     (ComponentsBuilder.splitStrategy)
  6. per sample: vector[i] = sum of the sample's *filtered* counts over
     component i's k-mers where count > threshold(=0)
     (FeaturesCalculatorMain.buildAndPrintVector:169-230 reading the
     .kmers.bin files produced in step 2 — NOT the raw reads)
  7. Bray-Curtis on raw vectors
     (DistanceMatrixCalculatorMain.java:140-153)
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import partial

import numpy as np

from .. import api
from ..graph import contigs as contigs_mod
from ..graph import components as comp_mod
from ..ops.count import KmerCounter
from ..utils.device import gpu_path

_LUT = np.full(256, 255, dtype=np.uint8)
for _ch, _code in (("A", 0), ("G", 1), ("C", 2), ("T", 3)):
    _LUT[ord(_ch)] = _code
    _LUT[ord(_ch.lower())] = _code


@dataclass
class MatrixResult:
    names: list[str]
    matrix: np.ndarray                      # [S, S] float64 Bray-Curtis
    vectors: np.ndarray                     # [S, C] int64 feature vectors
    breadth: np.ndarray                     # [S, C] float64 fraction present
    components: list                        # graph.components.Component list
    contigs_per_sample: list[list[tuple]]   # (seq, av_w, min_w, max_w)
    sample_tables: list[tuple[np.ndarray, np.ndarray]]  # filtered (keys, counts)


def count_contig_kmers(contig_seqs: list[str], k: int, min_len: int = 0):
    """Canonical k-mer counts of a list of sequence strings (one graph).

    Parity: IOUtils.loadReads over contig FASTA with minLen filter
    (src/tools/ComponentCutterMain.java:84).
    """
    counter = KmerCounter(k, capacity=1 << 16)
    kept = [s for s in contig_seqs if len(s) >= min_len]
    if not kept:
        return counter.finish()
    lengths = np.array([len(s) for s in kept], dtype=np.int32)
    codes = _LUT[np.frombuffer("".join(kept).encode(), dtype=np.uint8)]
    # the reads' flat stream layout: no per-contig padding, whatever the
    # contig lengths
    api.count_codes(counter, codes, lengths)
    return counter.finish()


def feature_vectors(components, keys: np.ndarray, counts: np.ndarray,
                    threshold: int = 0):
    """vector[i], breadth[i] over components for one sample table.

    Parity: FeaturesCalculatorMain.buildAndPrintVector
    (src/tools/FeaturesCalculatorMain.java:169-230): value > threshold.
    """
    C = len(components)
    vec = np.zeros(C, dtype=np.int64)
    brd = np.zeros(C, dtype=np.float64)
    if C == 0:
        return vec, brd
    # One searchsorted over the concatenated component keys, then a
    # segment-sum over component boundaries (SURVEY §7-6) — replaces the
    # per-component probe loop of FeaturesCalculatorMain.java:169-230 at
    # vector speed.  Empty components (possible under --selected-kmers
    # filtering) contribute vector 0 / breadth 0.
    sizes = np.array([len(c.kmers) for c in components], dtype=np.int64)
    nonempty = sizes > 0
    if not nonempty.any():
        return vec, brd
    allk = np.concatenate([np.asarray(c.kmers, dtype=np.int64)
                           for c in components if len(c.kmers)])
    ne_sizes = sizes[nonempty]
    dev = _feature_segsum_device(allk, keys, counts, ne_sizes, threshold)
    if dev is not None:
        vsum, hsum = dev
        vec[nonempty] = vsum
        brd[nonempty] = hsum / ne_sizes
        return vec, brd
    pres = api.presence_counts(allk, keys, counts)
    hit = pres > threshold
    starts = np.zeros(len(ne_sizes), dtype=np.int64)
    np.cumsum(ne_sizes[:-1], out=starts[1:])
    vec[nonempty] = np.add.reduceat(np.where(hit, pres, 0), starts)
    brd[nonempty] = np.add.reduceat(hit.astype(np.int64), starts) / ne_sizes
    return vec, brd


# from this total component-k-mer count up, a GPU joins features on the
# device (sort-merge join + segment scatter-add) instead of the host's
# searchsorted + reduceat (see utils/device.gpu_path); the device won at
# every size measured on the H100, the smallest being 2^21 (PERF.md)
_FEATURE_DEVICE_MIN = 1 << 21


def _feature_segsum_device(allk, keys, counts, ne_sizes, threshold):
    """(vector sums, hit counts) per nonempty component, on device.

    Sort-merge join for presence + one segment scatter-add — replaces
    the host searchsorted (~0.5 us/key) for bulk component sets
    (FeaturesCalculatorMain.java:169-230).  None routes the caller to
    the host path (gpu_path says no, or a component-size x saturation
    product that could overflow the int32 device sums).
    """
    if not gpu_path(len(allk), _FEATURE_DEVICE_MIN) or len(keys) == 0:
        return None
    if int(ne_sizes.max()) * 32767 >= (1 << 31):
        return None
    import jax.numpy as jnp

    from ..graph import lookup

    u = np.asarray(allk, dtype=np.uint64)
    qhi = jnp.asarray((u >> np.uint64(32)).astype(np.uint32))
    qlo = jnp.asarray((u & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    t = np.asarray(keys, dtype=np.uint64)
    thi = jnp.asarray((t >> np.uint64(32)).astype(np.uint32))
    tlo = jnp.asarray((t & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    seg = np.repeat(np.arange(len(ne_sizes), dtype=np.int32), ne_sizes)
    vs, hs = _feature_segsum_jit(
        thi, tlo, jnp.asarray(np.asarray(counts, dtype=np.int32)),
        qhi, qlo, jnp.asarray(seg), len(ne_sizes),
        jnp.int32(threshold))
    return np.asarray(vs).astype(np.int64), np.asarray(hs).astype(np.int64)


def _feature_segsum_jit(thi, tlo, counts, qhi, qlo, seg, n_seg, thr):
    """Join (separately-jitted stages, see graph/lookup) + one jitted
    gather/segment-scatter tail."""
    from ..graph import lookup

    idx, found = lookup.find(thi, tlo, qhi, qlo)
    return _feature_segsum_tail(idx, found, counts, seg, thr, int(n_seg))


_tail_cache = {}


def _feature_segsum_tail(idx, found, counts, seg, thr, n_seg: int):
    import jax

    if "fn" not in _tail_cache:
        import jax.numpy as jnp

        @partial(jax.jit, static_argnames=("n_seg",))
        def tail(idx, found, counts, seg, thr, n_seg: int):
            pres = jnp.where(found, counts[idx], 0)
            hit = pres > thr
            val = jnp.where(hit, pres, 0)
            vs = jnp.zeros(n_seg, jnp.int32).at[seg].add(val)
            hs = jnp.zeros(n_seg, jnp.int32).at[seg].add(
                hit.astype(jnp.int32))
            return vs, hs

        _tail_cache["fn"] = tail
    return _tail_cache["fn"](idx, found, counts, seg, thr, n_seg)


def bray_curtis_matrix(vectors: np.ndarray) -> np.ndarray:
    """Pairwise Bray-Curtis (DistanceMatrixCalculatorMain.java:140-153)."""
    v = np.asarray(vectors, dtype=np.float64)
    num = np.abs(v[:, None, :] - v[None, :, :]).sum(-1)
    den = np.abs(v)[:, None, :].sum(-1) + np.abs(v)[None, :, :].sum(-1)
    with np.errstate(invalid="ignore", divide="ignore"):
        d = np.where(den > 0, num / den, 0.0)
    np.fill_diagonal(d, 0.0)
    return d


def sample_name(files: list[str]) -> str:
    """Library name for a sample's file group (KmersCounterMain.java:122-137)."""
    from ..io.reads import sample_name as _sn
    return _sn([str(f) for f in files])


def matrix_pipeline(sample_files: list[list[str]] | list[str],
                    k: int = 31, b: int = 1, l: int = 100,
                    b1: int = 1000, b2: int = 10000,
                    feature_threshold: int = 0,
                    progress=None) -> MatrixResult:
    """Run the full default pipeline on S samples.

    sample_files: either a flat list of paths (one file per sample) or a
    list of per-sample file groups (paired-end reads).
    """
    groups = [[f] if isinstance(f, (str, os.PathLike)) else list(f)
              for f in sample_files]
    names = [sample_name(g) for g in groups]

    sample_tables = []
    contigs_per_sample = []
    all_seqs: list[str] = []
    for gi, g in enumerate(groups):
        keys, counts, stats = api.count_reads_files([str(p) for p in g], k)
        keep = counts > b
        keys, counts = keys[keep], counts[keep]
        sample_tables.append((keys, counts))
        if progress is not None:
            progress("count", names[gi], stats)
        seqs = contigs_mod.build_contigs(keys, counts, k, l)
        contigs_per_sample.append(seqs)
        all_seqs.extend(s[0] for s in seqs)
        if progress is not None:
            progress("contigs", names[gi], {"n": len(seqs)})

    gkeys, gcounts = count_contig_kmers(all_seqs, k, min_len=l)
    components = comp_mod.split_components(gkeys, gcounts, k, b1, b2)
    if progress is not None:
        progress("components", "", {"n": len(components)})

    S, C = len(groups), len(components)
    vectors = np.zeros((S, C), dtype=np.int64)
    breadth = np.zeros((S, C), dtype=np.float64)
    for si, (keys, counts) in enumerate(sample_tables):
        vectors[si], breadth[si] = feature_vectors(
            components, keys, counts, feature_threshold)

    matrix = bray_curtis_matrix(vectors)
    return MatrixResult(names=names, matrix=matrix, vectors=vectors,
                        breadth=breadth, components=components,
                        contigs_per_sample=contigs_per_sample,
                        sample_tables=sample_tables)
