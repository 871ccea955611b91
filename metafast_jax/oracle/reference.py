"""Slow, obviously-correct NumPy/pure-Python oracle of the pipeline semantics.

This module is the executable specification that the device code is tested
against.  It is a direct transcription of the *behavior* documented from the
reference toolkit (ctlab/metafast), written in the most straightforward way
possible; it is never used on the production path.

Behavior parity notes (reference citations):
  - encoding A=0,G=1,C=2,T=3, complement 3-x     (itmo DnaTools.java:31-64)
  - canonical key = min(fw, rc) as int64          (itmo ShortKmer.java:55-57)
  - counts saturate at 32767                      (itmo NumUtils.java:21-26)
  - kmers.bin keeps entries with count > b        (src/io/IOUtils.java:45-71)
  - contig rules                                  (src/algo/AddSequencesShiftingRightTask.java)
  - component size-window split                   (src/algo/ComponentsBuilder.java)
"""

from __future__ import annotations

from collections import deque

import numpy as np

CODE = {"A": 0, "G": 1, "C": 2, "T": 3, "a": 0, "g": 1, "c": 2, "t": 3}
CHAR = "AGCT"
SATURATE = 32767


def encode_seq(s: str) -> np.ndarray | None:
    """2-bit codes for a read; None if it contains any non-ACGT character."""
    try:
        return np.array([CODE[ch] for ch in s], dtype=np.uint8)
    except KeyError:
        return None


def rc64(kmer: int, k: int) -> int:
    """Reverse complement of a 2k-bit kmer value (itmo KmerUtils.java:12-22)."""
    out = 0
    for i in range(k):
        nuc = (kmer >> (2 * i)) & 3
        out = (out << 2) | (3 - nuc)
    return out


def kmer_string(kmer: int, k: int) -> str:
    return "".join(CHAR[(kmer >> (2 * (k - 1 - i))) & 3] for i in range(k))


def canonical_kmers(codes: np.ndarray, k: int) -> list[int]:
    """Canonical k-mer keys of one read, in order."""
    n = len(codes)
    out = []
    for p in range(n - k + 1):
        fw = 0
        for t in range(k):
            fw = (fw << 2) | int(codes[p + t])
        out.append(min(fw, rc64(fw, k)))
    return out


def count_reads(reads: list[str], k: int, min_len: int = 0) -> dict[int, int]:
    """Canonical k-mer counts over reads (saturating at 32767).

    Reads with non-ACGT chars are skipped entirely (FastaReader.java:55-66);
    reads shorter than min_len are skipped (IOUtils.loadReads).
    """
    counts: dict[int, int] = {}
    for s in reads:
        codes = encode_seq(s)
        if codes is None or len(codes) < min_len:
            continue
        for key in canonical_kmers(codes, k):
            counts[key] = min(counts.get(key, 0) + 1, SATURATE)
    return counts


def filter_counts(counts: dict[int, int], b: int) -> dict[int, int]:
    """Keep k-mers with count strictly greater than b (IOUtils.printKmers)."""
    return {key: c for key, c in counts.items() if c > b}


# ---------------------------------------------------------------------------
# de Bruijn graph ops (oriented kmers as 2k-bit ints)
# ---------------------------------------------------------------------------

def _shift_right(v: int, nuc: int, k: int) -> int:
    return ((v << 2) | nuc) & ((1 << (2 * k)) - 1)


def _shift_left(v: int, nuc: int, k: int) -> int:
    return (v >> 2) | (nuc << (2 * k - 2))


def _ext_right(v: int, k: int, present) -> int:
    """Unique right extension: nuc, or -1 (none) / -2 (fork).

    Parity: src/algo/HashMapOperations.java:32-47.
    """
    ans = -1
    for nuc in range(4):
        n = _shift_right(v, nuc, k)
        if min(n, rc64(n, k)) in present:
            if ans > -1:
                return -2
            ans = nuc
    return ans


def _ext_left(v: int, k: int, present) -> int:
    """Unique left extension (HashMapOperations.java:13-30)."""
    ans = -1
    for nuc in range(4):
        n = _shift_left(v, nuc, k)
        if min(n, rc64(n, k)) in present:
            if ans > -1:
                return -2
            ans = nuc
    return ans


def build_contigs(counts: dict[int, int], k: int, len_threshold: int):
    """Simple-path contigs (parity: AddSequencesShiftingRightTask.java).

    `counts` must already be filtered to count > b k-mers.  Returns a list of
    (seq_string, avg_weight, min_weight, max_weight) tuples.
    """
    present = set(counts)
    out = []
    used = set()

    for key in sorted(present):
        for orient in (key, rc64(key, k)):
            v = orient
            is_left = False
            nuc = _ext_left(v, k, present)
            if nuc < 0:
                is_left = True
            else:
                pred = _shift_left(v, nuc, k)
                if _ext_right(pred, k, present) < 0:
                    is_left = True
            if not is_left:
                continue

            # walk right (AddSequencesShiftingRightTask.processSequence)
            value = counts[min(v, rc64(v, k))]
            seq = kmer_string(v, k)
            weight, wmin, wmax = value, value, value
            cur = v
            while True:
                rn = _ext_right(cur, k, present)
                if rn < 0:
                    break
                nxt = _shift_right(cur, rn, k)
                if nxt == cur:
                    break  # self-loop guard (would not terminate in reference)
                if _ext_left(nxt, k, present) == -2:
                    break
                cur = nxt
                seq += CHAR[rn]
                value = counts[min(cur, rc64(cur, k))]
                weight += value
                wmin = min(wmin, value)
                wmax = max(wmax, value)

            if len(seq) < len_threshold:
                continue
            st = min(v, rc64(v, k))
            en = min(cur, rc64(cur, k))
            if st > en:
                continue
            if st == en:
                if st in used:
                    continue
                used.add(st)
            out.append((seq, weight // (len(seq) - k + 1), wmin, wmax))
    return out


def neighbors8(key: int, k: int) -> list[int]:
    """8 canonical neighbor keys (src/algo/KmerOperations.java:9-27)."""
    res = []
    for nuc in range(4):
        n = _shift_right(key, nuc, k)
        res.append(min(n, rc64(n, k)))
        m = _shift_left(key, nuc, k)
        res.append(min(m, rc64(m, k)))
    return res


def split_components(counts: dict[int, int], k: int, b1: int, b2: int):
    """Size-window component splitting (ComponentsBuilder.splitStrategy).

    Returns list of (kmer_set, weight, used_freq_threshold), sorted by
    (threshold asc, weight desc, size desc).
    """
    result = []
    active = dict(counts)
    thr = 1
    while active:
        comps = _connected_components(set(active), k)
        next_active: dict[int, int] = {}
        for comp in comps:
            size = len(comp)
            if size < b1:
                continue
            if size <= b2:
                weight = sum(counts[key] for key in comp)
                result.append((comp, weight, thr))
            else:
                for key in comp:
                    if counts[key] >= thr + 1:
                        next_active[key] = counts[key]
        active = next_active
        thr += 1
        if thr > SATURATE + 1:
            break
    result.sort(key=lambda t: (t[2], -t[1], -len(t[0])))
    return result


def _connected_components(present: set[int], k: int) -> list[set[int]]:
    seen: set[int] = set()
    comps = []
    for start in present:
        if start in seen:
            continue
        comp = {start}
        seen.add(start)
        q = deque([start])
        while q:
            cur = q.popleft()
            for nb in neighbors8(cur, k):
                if nb in present and nb not in seen:
                    seen.add(nb)
                    comp.add(nb)
                    q.append(nb)
        comps.append(comp)
    return comps


def feature_vector(components, sample_counts: dict[int, int], threshold: int = 0):
    """Per-component coverage vector + breadth (FeaturesCalculatorMain:169-230)."""
    vec = []
    breadth = []
    for comp, _w, _t in components:
        total = 0
        found = 0
        for key in comp:
            value = sample_counts.get(key, 0)
            if value > threshold:
                total += value
                found += 1
        vec.append(total)
        breadth.append(found / len(comp))
    return np.array(vec, dtype=np.int64), np.array(breadth)


def bray_curtis(x: np.ndarray, y: np.ndarray) -> float:
    """(DistanceMatrixCalculatorMain.java:140-153)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    return float(np.abs(x - y).sum() / (np.abs(x) + np.abs(y)).sum())


def matrix_pipeline(samples: list[list[str]], k: int, b: int = 1,
                    l: int = 100, b1: int = 1000, b2: int = 10000):
    """The default pipeline end to end, one list of reads per sample.

    Returns (filtered per-sample counts, components, feature vectors
    [S, C], Bray-Curtis matrix [S, S]) — the semantics of
    pipeline.matrix.matrix_pipeline and of the matrix-builder tool.
    """
    tables = [filter_counts(count_reads(reads, k), b) for reads in samples]
    contigs = [c[0] for t in tables for c in build_contigs(t, k, l)]
    comps = split_components(count_reads(contigs, k, min_len=l), k, b1, b2)
    vecs = np.array([feature_vector(comps, t)[0] for t in tables],
                    dtype=np.float64).reshape(len(tables), len(comps))
    n = len(tables)
    mat = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if i != j:
                mat[i, j] = bray_curtis(vecs[i], vecs[j])
    return tables, comps, vecs, mat
