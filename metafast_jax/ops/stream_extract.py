"""Flat-stream canonical k-mer extraction.

Replaces the reference's per-read rolling ShortKmer loop (itmo
ShortKmer.java:104-150 driven from src/io/IOUtils.java:756-769)
on the counting hot path.  Instead of padding reads into [B, L] batches, the
read set is treated as ONE flat 2-bit code stream (the native parser already
produces concatenated codes):

  * 16 codes pack into each u32 word, little-end (code j at bits 2j);
  * words lay out in overlapping columns [256, C]: rows 0..253 are payload,
    rows 254-255 duplicate the next column's first two words so every
    window's 3-word span stays inside one column;
  * a validity bitmask (bit r of vmask word w <=> position 16w+r starts a
    window that lies inside a single read) carries the read-boundary and
    padding information -- the kernel never sees ragged shapes.

Per word the kernel evaluates all 16 window phases with static u32 shift/or
math.  Two identities make this cheap:

  * the FORWARD value (codes MSB-first) is a 62-bit window of the
    bit-pair-REVERSED stream, so each word is pair-reversed once (8 ops)
    and every phase is 2 shifts + 1 or per output half;
  * the REVERSE COMPLEMENT reads the complemented codes in reversed order,
    which is exactly a window of the complemented LITTLE-endian stream --
    the packing order itself performs the reversal.

Output k-mers come out phase-major ([16, C, 256] planes); downstream
counting sorts the flat keys, so position order is irrelevant -- only the
multiset of valid windows matters, and tests assert it matches
core.extract.extract_canonical exactly.

The window math is pure elementwise u32 work with no reuse across
elements, so it is plain jitted XLA: the compiler fuses it into one loop
that reads each input word and writes each output key once (PERF.md,
"Extraction").
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import bitpack as bp

U32 = jnp.uint32
ROWS = 256          # column height
PAYLOAD = ROWS - 2  # payload words per column; 2 overlap rows
LANE_TILE = 128     # default column-count multiple


def _rev2(x):
    """Reverse the 16 2-bit fields of each u32 (codes stay intact)."""
    m2 = U32(0x33333333)
    m4 = U32(0x0F0F0F0F)
    m8 = U32(0x00FF00FF)
    x = ((x & m2) << 2) | ((x >> 2) & m2)
    x = ((x & m4) << 4) | ((x >> 4) & m4)
    x = ((x & m8) << 8) | ((x >> 8) & m8)
    return (x << 16) | (x >> 16)


def _window_math(w0, w1, w2, vm, k: int):
    """Canonical (hi, lo) for the 16 phase windows of every word.

    w0: [...] u32 stream words; w1/w2: the words one/two further along
    the stream; vm: validity bitmask words.  Returns (hi, lo), each
    [16, ...], with SENTINEL on invalid positions.
    """
    r0, r1, r2 = _rev2(w0), _rev2(w1), _rev2(w2)
    n0, n1, n2 = ~w0, ~w1, ~w2
    sent = U32(bp.SENTINEL)
    s_down = 64 - 2 * k         # right-shift aligning the 2k-bit window
    his, los = [], []
    for r in range(16):
        # forward: bits [2r, 2r+64) of the pair-reversed stream
        if r == 0:
            a_hi, a_lo = r0, r1
        else:
            a_hi = (r0 << U32(2 * r)) | (r1 >> U32(32 - 2 * r))
            a_lo = (r1 << U32(2 * r)) | (r2 >> U32(32 - 2 * r))
        # align window value (top 2k bits) to the bottom
        if s_down == 0:
            fh, fl = a_hi, a_lo
        elif s_down < 32:
            fh = a_hi >> U32(s_down)
            fl = (a_lo >> U32(s_down)) | (a_hi << U32(32 - s_down))
        elif s_down == 32:
            fh = jnp.zeros_like(a_hi)
            fl = a_hi
        else:
            fh = jnp.zeros_like(a_hi)
            fl = a_hi >> U32(s_down - 32)
        # reverse complement: bits [2r, 2r+2k) of the complemented
        # little-endian stream (packing order performs the reversal)
        if r == 0:
            c_lo, c_hi = n0, n1
        else:
            c_lo = (n0 >> U32(2 * r)) | (n1 << U32(32 - 2 * r))
            c_hi = (n1 >> U32(2 * r)) | (n2 << U32(32 - 2 * r))
        if k > 16:
            rh = c_hi & U32((1 << (2 * k - 32)) - 1)
            rl = c_lo
        elif k == 16:
            rh = jnp.zeros_like(c_lo)
            rl = c_lo
        else:
            rh = jnp.zeros_like(c_lo)
            rl = c_lo & U32((1 << (2 * k)) - 1)
        take_rc = (rh < fh) | ((rh == fh) & (rl < fl))
        h = jnp.where(take_rc, rh, fh)
        lo = jnp.where(take_rc, rl, fl)
        valid = ((vm >> U32(r)) & U32(1)) != 0
        his.append(jnp.where(valid, h, sent))
        los.append(jnp.where(valid, lo, sent))
    return jnp.stack(his), jnp.stack(los)


@partial(jax.jit, static_argnames=("k",))
def stream_extract(words_cm, vmask_cm, k: int):
    """words/vmask [C, ROWS] u32 -> canonical (hi, lo) [16, C, ROWS]."""
    w1 = jnp.roll(words_cm, -1, axis=1)    # next word of the same column
    w2 = jnp.roll(words_cm, -2, axis=1)
    return _window_math(words_cm, w1, w2, vmask_cm, k)


# ---------------------------------------------------------------------------
# Host-side layout
# ---------------------------------------------------------------------------

def stream_cols(n_codes: int, lane_multiple: int = LANE_TILE) -> int:
    """Column count build_stream will emit for n_codes codes — exposed so
    multi-process callers can agree on a common min_cols up front."""
    n_words = -(-n_codes // 16) if n_codes else 0
    n_cols = max(1, -(-n_words // PAYLOAD))
    return -(-n_cols // lane_multiple) * lane_multiple


def build_stream(codes: np.ndarray, lengths: np.ndarray, k: int,
                 lane_multiple: int = LANE_TILE, min_cols: int = 0):
    """Pack flat read codes into overlapping word columns + validity mask.

    codes: concatenated uint8 codes of all reads (the native parser's
    output); lengths: per-read int32.  Returns (col_w, col_v, n_valid):
    u32 arrays [C, ROWS] (column-major — the device transposes, host
    transposes cost real time at 100M-base scale) with C a multiple of
    `lane_multiple` and >= `min_cols` (extra columns carry zero vmask —
    multi-process feeds use this to keep per-process slab shapes in
    lockstep without parsing each other's bytes).  Uses the C++
    single-pass packer when available; the NumPy fallback below is the
    executable spec.
    """
    n = int(codes.shape[0])
    n_words = -(-n // 16) if n else 0
    n_cols = max(1, -(-n_words // PAYLOAD), min_cols)
    n_cols = -(-n_cols // lane_multiple) * lane_multiple
    n_valid = int(np.maximum(
        lengths.astype(np.int64) - (k - 1), 0).sum()) if len(lengths) else 0

    from ..native import load_library
    import ctypes
    lib = load_library()
    if lib is not None and hasattr(lib, "build_stream_cols"):
        codes = np.ascontiguousarray(codes, dtype=np.uint8)
        lengths = np.ascontiguousarray(lengths, dtype=np.int32)
        col_w = np.empty((n_cols, ROWS), dtype=np.uint32)
        col_v = np.zeros((n_cols, ROWS), dtype=np.uint32)
        lib.build_stream_cols(
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n,
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(lengths), k,
            col_w.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            col_v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), n_cols)
        return col_w, col_v, n_valid

    total_words = n_cols * PAYLOAD + 2     # +2: overlap source for last col
    pad_codes = total_words * 16 - n
    c = np.concatenate([codes, np.zeros(pad_codes, np.uint8)])
    words = _pack_words16(c)

    # validity: position p starts a window iff [p, p+k) is inside one read
    starts = np.zeros(total_words * 16 + 1, dtype=np.int32)
    offs = np.concatenate([[0], np.cumsum(lengths.astype(np.int64))])
    ok = lengths >= k
    s = offs[:-1][ok]
    e = (offs[1:][ok] - k + 1)
    np.add.at(starts, s, 1)
    np.add.at(starts, e, -1)
    valid = np.cumsum(starts[:-1]).astype(bool)
    # 16 positions per stream word -> 2 packed bytes -> one u16, widened
    vmask = np.packbits(valid, bitorder="little")
    vmask = np.pad(vmask, (0, total_words * 2 - len(vmask)))
    vmask = vmask.view(np.uint16).astype(np.uint32)

    col_w = np.zeros((n_cols, ROWS), dtype=np.uint32)
    col_v = np.zeros((n_cols, ROWS), dtype=np.uint32)
    col_w[:, :PAYLOAD] = words[: n_cols * PAYLOAD].reshape(n_cols, PAYLOAD)
    col_v[:, :PAYLOAD] = vmask[: n_cols * PAYLOAD].reshape(n_cols, PAYLOAD)
    # rows PAYLOAD, PAYLOAD+1 duplicate the next column's first two words
    # (their vmask stays 0: the duplicate positions are counted by the
    # next column's rows 0-1, and the final column's tail is padding)
    starts_idx = np.arange(n_cols, dtype=np.int64) * PAYLOAD + PAYLOAD
    col_w[:, PAYLOAD] = words[np.minimum(starts_idx, total_words - 1)]
    col_w[:, PAYLOAD + 1] = words[np.minimum(starts_idx + 1, total_words - 1)]
    assert n_valid == int(valid.sum())
    return col_w, col_v, n_valid


def _pack_words16(c: np.ndarray) -> np.ndarray:
    """uint8 codes (len % 16 == 0) -> u32 words, code j at bits 2j."""
    b = c.reshape(-1, 4).astype(np.uint16)
    by = (b[:, 0] | (b[:, 1] << 2) | (b[:, 2] << 4)
          | (b[:, 3] << 6)).astype(np.uint8)
    return np.ascontiguousarray(by).view(np.uint32)


# ---------------------------------------------------------------------------
# Compact 3-stream layout (r5): boundary windows never enter the sort
# ---------------------------------------------------------------------------
#
# The overlapping-column stream above emits one slot per code POSITION, so
# every read contributes k-1 invalid boundary slots (~20% at 150 bp) that
# the sort — the counting bound — pays for.  The compact layout starts
# each read at a fresh word boundary and emits ONLY the words containing
# valid window starts (ceil((len-k+1)/16) per read, ~6% padding at
# 150 bp); the one/two-word lookahead context rides as separate aligned
# arrays (w1, w2), so the kernel has no cross-word dependencies at all —
# no overlap rows, no rolls.  Measured effect: the 2^27-code bench slab
# drops from 101.2M to ~85.4M sorted slots.


def stream3_words(lengths: np.ndarray, k: int) -> int:
    """Total emit words for a read set (before column padding)."""
    if len(lengths) == 0:
        return 0
    nw = np.maximum(lengths.astype(np.int64) - (k - 1), 0)
    return int(((nw + 15) // 16).sum())


def stream3_cols(lengths: np.ndarray, k: int,
                 lane_multiple: int = LANE_TILE) -> int:
    """Column count build_stream3 will emit — the lockstep analog of
    stream_cols (multi-process callers allgather-max these)."""
    W = stream3_words(np.asarray(lengths, dtype=np.int64), k)
    n_cols = max(1, -(-W // ROWS))
    return -(-n_cols // lane_multiple) * lane_multiple


def build_stream3(codes: np.ndarray, lengths: np.ndarray, k: int,
                  lane_multiple: int = LANE_TILE, min_cols: int = 0):
    """Pack reads into compact (w0, w1, w2, vmask) word columns.

    Returns 4 u32 arrays [C, ROWS] (column-major like build_stream) and
    n_valid.  Uses the C++ single-pass builder when available; the NumPy
    fallback below is the executable spec (per-read loop — fine for
    tests, the native path is the production one).
    """
    lengths = np.asarray(lengths, dtype=np.int32)
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    W = stream3_words(lengths, k)
    n_cols = max(1, -(-W // ROWS), min_cols)
    n_cols = -(-n_cols // lane_multiple) * lane_multiple
    n_valid = int(np.maximum(
        lengths.astype(np.int64) - (k - 1), 0).sum()) if len(lengths) else 0

    import ctypes

    from ..native import load_library

    lib = load_library()
    shape = (n_cols, ROWS)
    if lib is not None and hasattr(lib, "build_stream3_cols"):
        w0 = np.zeros(shape, dtype=np.uint32)
        w1 = np.zeros(shape, dtype=np.uint32)
        w2 = np.zeros(shape, dtype=np.uint32)
        vm = np.zeros(shape, dtype=np.uint32)
        pu32 = ctypes.POINTER(ctypes.c_uint32)
        lib.build_stream3_cols(
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(codes),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(lengths), k,
            w0.ctypes.data_as(pu32), w1.ctypes.data_as(pu32),
            w2.ctypes.data_as(pu32), vm.ctypes.data_as(pu32),
            n_cols * ROWS)
        return w0, w1, w2, vm, n_valid

    flat0 = np.zeros(n_cols * ROWS, dtype=np.uint32)
    flat1 = np.zeros(n_cols * ROWS, dtype=np.uint32)
    flat2 = np.zeros(n_cols * ROWS, dtype=np.uint32)
    flatv = np.zeros(n_cols * ROWS, dtype=np.uint32)
    g = 0
    off = 0
    for ln in lengths:
        ln = int(ln)
        if ln < k:
            off += ln
            continue
        n_win = ln - k + 1
        e = -(-n_win // 16)
        rc = codes[off:off + ln]
        # 16(e+2) >= len - k + 33 > len for k <= 31: context always fits
        padded = np.zeros(16 * (e + 2), dtype=np.uint8)
        padded[:ln] = rc
        words = _pack_words16(padded)
        flat0[g:g + e] = words[0:e]
        flat1[g:g + e] = words[1:e + 1]
        flat2[g:g + e] = words[2:e + 2]
        rem = n_win - 16 * np.arange(e)
        flatv[g:g + e] = np.where(rem >= 16, 0xFFFF,
                                  (1 << np.maximum(rem, 0)) - 1)
        g += e
        off += ln
    return (flat0.reshape(shape), flat1.reshape(shape),
            flat2.reshape(shape), flatv.reshape(shape), n_valid)


@partial(jax.jit, static_argnames=("k",))
def stream3_extract(w0_cm, w1_cm, w2_cm, vm_cm, k: int):
    """4x [C, ROWS] u32 compact columns -> canonical (hi, lo) [16, C, ROWS]."""
    return _window_math(w0_cm, w1_cm, w2_cm, vm_cm, k)
