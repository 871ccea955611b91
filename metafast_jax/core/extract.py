"""Batched canonical k-mer extraction from 2-bit-packed read batches.

Input: a padded batch of reads as uint8 nucleotide codes ``codes[B, L]``
(A=0, G=1, C=2, T=3; padding arbitrary) plus per-read lengths.  Output:
canonical k-mer (hi, lo) uint32 pairs for every window position, with
invalid positions set to the SENTINEL key.

This replaces the reference's per-read rolling ShortKmer loop
(itmo ShortKmer.java:104-150, src/io/IOUtils.java:756-769) with a fully
vectorized window evaluation: both the forward value and the reverse
complement are built directly from the window's codes with static
shift/or chains, so there is no sequential dependence along the read —
XLA fuses the whole thing into a single elementwise pass.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import bitpack as bp

U32 = jnp.uint32


def extract_canonical(codes: jnp.ndarray, lengths: jnp.ndarray, k: int):
    """Canonical k-mers of every window of every read in a batch.

    Args:
      codes: [B, L] uint8/uint32 nucleotide codes (0..3), padded.
      lengths: [B] int32 valid read lengths.
      k: static k-mer size (1..31).

    Returns:
      (hi, lo, valid): each [B, P] with P = L - k + 1.  Invalid positions
      (window extends past the read end) have hi=lo=SENTINEL, valid=False.
    """
    B, L = codes.shape
    if k > L:
        raise ValueError(f"k={k} larger than padded read length {L}")
    P = L - k + 1
    c = codes.astype(U32)

    fw_hi = jnp.zeros((B, P), dtype=U32)
    fw_lo = jnp.zeros((B, P), dtype=U32)
    rc_hi = jnp.zeros((B, P), dtype=U32)
    rc_lo = jnp.zeros((B, P), dtype=U32)

    for t in range(k):
        ct = jax.lax.slice_in_dim(c, t, t + P, axis=1)
        # forward: code t sits at bit offset 2*(k-1-t)
        off = 2 * (k - 1 - t)
        if off >= 32:
            fw_hi = fw_hi | (ct << (off - 32))
        else:
            fw_lo = fw_lo | (ct << off)
        # reverse complement: complemented code t sits at bit offset 2*t
        cc = U32(3) - ct
        if 2 * t >= 32:
            rc_hi = rc_hi | (cc << (2 * t - 32))
        else:
            rc_lo = rc_lo | (cc << (2 * t))

    take_rc = bp.less(rc_hi, rc_lo, fw_hi, fw_lo)
    hi = jnp.where(take_rc, rc_hi, fw_hi)
    lo = jnp.where(take_rc, rc_lo, fw_lo)

    pos = jax.lax.broadcasted_iota(jnp.int32, (B, P), 1)
    valid = pos + k <= lengths[:, None].astype(jnp.int32)

    hi = jnp.where(valid, hi, U32(bp.SENTINEL))
    lo = jnp.where(valid, lo, U32(bp.SENTINEL))
    return hi, lo, valid


def unpack_2bit(packed: jnp.ndarray, L: int) -> jnp.ndarray:
    """[B, L//4] packed bytes (4 codes each, little-end first) -> [B, L]."""
    B = packed.shape[0]
    p = packed.astype(U32)
    codes = jnp.stack([(p >> (2 * j)) & U32(3) for j in range(4)], axis=-1)
    return codes.reshape(B, -1)[:, :L]


def extract_canonical_packed(packed: jnp.ndarray, lengths: jnp.ndarray,
                             k: int, L: int):
    """extract_canonical over 2-bit packed input (4 codes/byte).

    Packing shrinks the host->device transfer 4x.
    """
    return extract_canonical(unpack_2bit(packed, L), lengths, k)
