"""2-bit DNA k-mer arithmetic on (hi, lo) uint32 pairs.

Device representation of canonical k-mers: a k-mer (k <= 31) is a
2k-bit integer held as two uint32 words ``hi = V >> 32``, ``lo = V & 0xffffffff``.
All hot-path device code is pure 32-bit (JAX's 64-bit mode stays off), and
lexicographic two-key sorts/compares work on the uint32 pairs directly.

Encoding parity with the reference toolkit (ctlab/metafast):
  A=0, G=1, C=2, T=3; complement(x) = 3 - x  (itmo DnaTools.java:31-64)
  reverse complement = bit-reversal of 2-bit groups + bitwise not, then
  shift down to 2k bits                        (itmo KmerUtils.java:12-22)
  canonical key = min(fw, rc)                  (itmo ShortKmer.java:55-57)

All shift amounts are static Python ints (k is static), so everything
compiles to fixed shift/mask VPU ops under jit.
"""

from __future__ import annotations

import jax.numpy as jnp

U32 = jnp.uint32

# Nucleotide codes (reference parity: A=0, G=1, C=2, T=3).
A, G, C, T = 0, 1, 2, 3

#: sentinel for "no k-mer" — larger than any valid canonical key (hi of a
#: valid k<=31 kmer is < 2**30).
SENTINEL = 0xFFFFFFFF


def _u32(x) -> jnp.ndarray:
    return jnp.asarray(x, dtype=U32)


def lo_mask(k: int) -> int:
    """Mask of the low word of a 2k-bit value."""
    return (1 << min(2 * k, 32)) - 1 if 2 * k < 32 else 0xFFFFFFFF


def hi_mask(k: int) -> int:
    """Mask of the high word of a 2k-bit value."""
    return (1 << (2 * k - 32)) - 1 if 2 * k > 32 else 0


def rev2_32(w: jnp.ndarray) -> jnp.ndarray:
    """Reverse the sixteen 2-bit groups of each uint32."""
    w = ((w & U32(0x33333333)) << 2) | ((w & U32(0xCCCCCCCC)) >> 2)
    w = ((w & U32(0x0F0F0F0F)) << 4) | ((w & U32(0xF0F0F0F0)) >> 4)
    w = ((w & U32(0x00FF00FF)) << 8) | ((w & U32(0xFF00FF00)) >> 8)
    w = (w << 16) | (w >> 16)
    return w


def shr64(hi: jnp.ndarray, lo: jnp.ndarray, s: int):
    """Logical right shift of the 64-bit pair by static s in [0, 63]."""
    if s == 0:
        return hi, lo
    if s < 32:
        return hi >> s, (lo >> s) | (hi << (32 - s))
    if s == 32:
        return jnp.zeros_like(hi), hi
    return jnp.zeros_like(hi), hi >> (s - 32)


def rc(hi: jnp.ndarray, lo: jnp.ndarray, k: int):
    """Reverse complement of a k-mer pair (parity: itmo KmerUtils.java:12-22)."""
    # reverse 2-bit groups across the 64-bit value: words swap + in-word reverse
    rhi = rev2_32(lo)
    rlo = rev2_32(hi)
    # complement (~ on the full 64 bits), then shift down into 2k bits
    rhi = ~rhi
    rlo = ~rlo
    rhi, rlo = shr64(rhi, rlo, 64 - 2 * k)
    return rhi & U32(hi_mask(k)), rlo & U32(lo_mask(k))


def less(ahi, alo, bhi, blo):
    """Unsigned lexicographic (ahi, alo) < (bhi, blo)."""
    return (ahi < bhi) | ((ahi == bhi) & (alo < blo))


def canonical(hi: jnp.ndarray, lo: jnp.ndarray, k: int):
    """min(fw, rc) canonical form of each k-mer pair."""
    rhi, rlo = rc(hi, lo, k)
    take_rc = less(rhi, rlo, hi, lo)
    return jnp.where(take_rc, rhi, hi), jnp.where(take_rc, rlo, lo)


def shift_right(hi: jnp.ndarray, lo: jnp.ndarray, nuc, k: int):
    """Append nucleotide at the right end, dropping the leftmost one.

    V' = ((V << 2) | nuc) & mask(2k)   (parity: itmo ShortKmer.shiftRight)
    """
    nuc = _u32(nuc)
    if 2 * k > 32:
        nhi = ((hi << 2) | (lo >> 30)) & U32(hi_mask(k))
        nlo = (lo << 2) | nuc
        return nhi, nlo
    return jnp.zeros_like(hi), ((lo << 2) | nuc) & U32(lo_mask(k))


def shift_left(hi: jnp.ndarray, lo: jnp.ndarray, nuc, k: int):
    """Prepend nucleotide at the left end, dropping the rightmost one.

    V' = (V >> 2) | (nuc << (2k-2))    (parity: itmo ShortKmer.shiftLeft)
    """
    nuc = _u32(nuc)
    if 2 * k > 32:
        nlo = (lo >> 2) | (hi << 30)
        nhi = (hi >> 2) | (nuc << (2 * k - 34))
        return nhi, nlo
    return jnp.zeros_like(hi), (lo >> 2) | (nuc << (2 * k - 2))


def first_nuc(hi: jnp.ndarray, lo: jnp.ndarray, k: int) -> jnp.ndarray:
    """Leftmost nucleotide code: V >> (2k-2)."""
    if k >= 17:  # bit offset 2k-2 >= 32 lives in the high word
        return (hi >> (2 * k - 34)) & U32(3)
    return (lo >> (2 * k - 2)) & U32(3)


def last_nuc(lo: jnp.ndarray) -> jnp.ndarray:
    """Rightmost nucleotide code."""
    return lo & U32(3)


def is_sentinel(hi: jnp.ndarray, lo: jnp.ndarray) -> jnp.ndarray:
    return (hi == U32(SENTINEL)) & (lo == U32(SENTINEL))


def complement_nuc(nuc):
    """complement(x) = 3 - x (works for uint arrays via xor-free arithmetic)."""
    return _u32(3) - _u32(nuc)
