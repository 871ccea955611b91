"""De Bruijn graph neighbor/extension tables over a sorted k-mer table.

For every canonical key (interpreted in its forward orientation, i.e. the
canonical value itself — parity with `new ShortKmer(key, k)`), computes the
4 left and 4 right neighbor candidates, their canonical keys, table indices,
presence, and orientation bits.  From these, the unique-extension codes

    ext = -1 (no present neighbor) / -2 (fork) / 0..3 (the unique nucleotide)

exactly as HashMapOperations.getLeft/RightNucleotide
(src/algo/HashMapOperations.java:13-47), but evaluated for *all* k-mers at
once instead of lazily per probe.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core import bitpack as bp
from . import lookup

U32 = jnp.uint32
I32 = jnp.int32

NONE = -1
FORK = -2


@partial(jax.jit, static_argnames=("k",))
def _neighbor_keys(khi, klo, k: int):
    """Canonical keys [8, M] of the 4 left then the 4 right neighbour
    candidates, and is_fw [8, M]: the oriented neighbour value equals its
    canonical key.  The oriented values themselves never leave this jit,
    which keeps the table's device footprint down.

    Sentinel rows emit SENTINEL canonical queries (not garbage shifts of
    the all-ones pattern): lookup.find treats them identically (never
    found), and the bounded sort-merge verify depends on padded rows not
    forming giant duplicate runs of one garbage key."""
    sent = bp.is_sentinel(khi, klo)
    hs, ls, fws = [], [], []
    for shift in (bp.shift_left, bp.shift_right):
        for nuc in range(4):
            h, l = shift(khi, klo, U32(nuc), k)
            ch, cl = bp.canonical(h, l, k)
            fws.append((h == ch) & (l == cl))
            hs.append(jnp.where(sent, U32(bp.SENTINEL), ch))
            ls.append(jnp.where(sent, U32(bp.SENTINEL), cl))
    return jnp.stack(hs), jnp.stack(ls), jnp.stack(fws)


@jax.jit
def _ext_codes(present, sent):
    present = present & ~sent[None, :]
    deg = jnp.sum(present.astype(I32), axis=0)
    uniq_nuc = jnp.argmax(present, axis=0).astype(I32)
    ext = jnp.where(deg == 0, NONE, jnp.where(deg >= 2, FORK, uniq_nuc))
    return present, ext


def neighbor_tables(khi, klo, k: int):
    """All neighbor data for a sorted canonical key table.

    Args:
      khi, klo: [M] sorted canonical keys (SENTINEL-padded tail allowed).
    Returns dict with, for side in {left, right} and nuc in 0..3:
      idx [4,M] int32      table index of canonical neighbor (clipped)
      present [4,M] bool
      is_fw [4,M] bool     oriented value equals its canonical key
      ext [M] int32        unique-extension code (-1/-2/0..3)

    Layout note: the nucleotide axis LEADS ([4, M]), so every per-nucleotide
    row is contiguous.

    Deliberately NOT one @jax.jit: the sort-merge lookup
    (lookup._find_merge) plus the extension math would make one large
    compile.  Each jitted sub-piece compiles (and caches) independently;
    callers that need jit-traceable behavior still get it, since every
    sub-call is itself jitted.
    """
    sent = jnp.asarray(bp.is_sentinel(khi, klo))
    # ONE bounded sort-merge join over all 8 neighbor slots (both sides
    # stacked): vs two per-side joins this sorts T+8M elements once
    # instead of T+4M twice.  Bounded verify: neighbor query keys repeat
    # at most a handful of times (measured max 5 at k=11; each canonical
    # key has <= 8 graph neighbors), so hits resolve with shifted
    # compares instead of 2 random gathers per query — the overflow
    # flag certifies the bound and falls back to the gather verify.
    can_hi8, can_lo8, is_fw8 = _neighbor_keys(khi, klo, k)
    idx8, present8, flag = lookup.find_bounded(khi, klo, can_hi8, can_lo8)
    if int(flag):
        idx8, present8 = lookup.find(khi, klo, can_hi8, can_lo8)
    del can_hi8, can_lo8
    res = {}
    for si, side in enumerate(("left", "right")):
        rows = lambda a: jax.lax.slice_in_dim(a, 4 * si, 4 * si + 4, axis=0)
        present, ext = _ext_codes(rows(present8), sent)
        res[side] = dict(idx=rows(idx8), present=present,
                         is_fw=rows(is_fw8), ext=ext)
    return res


def ext_map_rc(ext):
    """Extension code seen from the reverse-complement orientation.

    extR(rc(c)) is derived from extL(fw(c)): -1/-2 unchanged, a unique
    nucleotide m becomes its complement 3-m.
    """
    return jnp.where(ext >= 0, 3 - ext, ext)
