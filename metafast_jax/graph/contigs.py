"""Simple-path contig extraction — list ranking on the device.

Reference semantics (src/algo/AddSequencesShiftingRightTask.java): walk right
from every "left end" oriented k-mer while the right extension is unique and
the next k-mer's left extension is unique; emit sequences >= l, deduplicated
by the canonical-key rule startKey < endKey (== handled once).

Data-parallel reformulation: the walk rules define a *successor function* on
oriented k-mers (2 orientations per canonical key).  Successors restricted
to non-null are injective, so chains are disjoint; heads of chains coincide
exactly with the reference's "left end" test.  We therefore compute

  succ[o]      via vectorized extension tables  (graph/dbg.py)
  dist/term    via list ranking (pointer doubling, or splitter walks
               on large GPU tables — graph/rank.py)
  sequences    via one scatter of per-node final nucleotides into a flat
               char buffer (host-side numpy)

instead of sequential pointer chasing per contig.

Spec notes (conscious, parity-safe):
  - a self-successor (u -> u, e.g. poly-A) is treated as null; the
    reference would not terminate on this input.
  - output order is deterministic (sorted by start key) — the reference's
    deque order is thread-scheduling-dependent; downstream recounts k-mers
    so order is irrelevant.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import bitpack as bp
from ..utils.device import gpu_path
from . import dbg

I32 = jnp.int32
U32 = jnp.uint32
CHARS = np.frombuffer(b"AGCT", dtype=np.uint8)


# from this oriented-node count up, a GPU ranks chains with splitter walks
# (graph/rank.py, O(n) random-access volume) instead of Wyllie doubling
# (O(n log L) volume; see utils/device.gpu_path).  On the H100 the walks
# won at 2^26 nodes (49 vs 83 ms); the crossover is not measured
_WALK_MIN = 1 << 21


def chain_structure(khi, klo, k: int):
    """Successor function + list ranking over oriented k-mer nodes.

    Args:
      khi, klo: [M] sorted canonical keys, SENTINEL padded.
    Returns (all [2M]; oriented node o = i for fw(key i), M + i for rc):
      term:     terminal node index of each node's chain (valid where reached)
      dist:     steps to terminal
      reached:  bool, node lies on a terminated chain (not in a cycle)
      is_start: bool, node is a chain head ("left end")
      last_nuc: [2M] final nucleotide of the oriented k-mer value

    Not one @jax.jit: the neighbor-table lookups compile separately
    (see dbg.neighbor_tables — one fused graph OOMs the compile helper).
    """
    t = dbg.neighbor_tables(khi, klo, k)
    L, R = t["left"], t["right"]
    st = _succ_from_tables(khi, klo, L["idx"], L["is_fw"], L["ext"],
                           R["idx"], R["is_fw"], R["ext"], k)
    n = 2 * int(khi.shape[0])
    from .. import api

    mesh = api.get_default_mesh()
    if mesh is not None and mesh.devices.size > 1:
        # mesh-sharded ranking: row-sharded pointer doubling with one
        # index exchange per round (parallel/contigs.py) — the last *
        # stage to shard
        from ..parallel.contigs import sharded_doubling

        term, dist, reached = sharded_doubling(np.asarray(st["succ"]),
                                               mesh)
        st.update(term=jnp.asarray(term), dist=jnp.asarray(dist),
                  reached=jnp.asarray(reached))
        st.pop("valid2")
        return st
    if gpu_path(n, _WALK_MIN):
        from . import rank
        r = rank.chain_rank(st["succ"], st["valid2"])
        st.update(term=r["term"], dist=r["dist"], reached=r["reached"])
    else:
        term, dist, reached = _doubling(st["succ"])
        st.update(term=term, dist=dist, reached=reached)
    st.pop("valid2")
    return st


@partial(jax.jit, static_argnames=("k",))
def _succ_from_tables(khi, klo, L_idx, L_isfw, extL_fw,
                      R_idx, R_isfw, extR_fw, k: int):
    M = khi.shape[0]
    L = dict(idx=L_idx, is_fw=L_isfw)
    R = dict(idx=R_idx, is_fw=R_isfw)

    rc_hi, rc_lo = bp.rc(khi, klo, k)
    pal = (rc_hi == khi) & (rc_lo == klo)
    valid = ~bp.is_sentinel(khi, klo)

    idx = jnp.arange(M, dtype=I32)

    def pick(tab, nuc):
        """Select tab[nuc[i], i] per element (clipped for nuc<0).

        Tables are nucleotide-major [4, M] (see dbg.neighbor_tables);
        select_n keeps this a pure VPU select tree, no gathers."""
        safe = jnp.clip(nuc, 0, 3)
        return jax.lax.select_n(safe, tab[0], tab[1], tab[2], tab[3])

    # Oriented node ids are block-concatenated: fw(i) = i, rc(i) = M + i.

    # One [3, M] stacked gather per index array instead of three singles:
    # a multi-payload column gather moves k payloads at per-index cost —
    # the succ derivation needs (extL, extR, pal) of four different index
    # arrays.
    lut = jnp.stack([extL_fw, extR_fw, pal.astype(I32)])

    def peek(j):
        g = lut[:, jnp.clip(j, 0, M - 1)]
        return g[0], g[1], g[2] != 0

    # --- successor of fw orientation -----------------------------------
    rn = extR_fw
    j_fw = pick(R["idx"], rn)
    eL_fw, eR_fw, pal_fw = peek(j_fw)
    arr_is_fw = pick(R["is_fw"], rn) | pal_fw
    extL_arr = jnp.where(arr_is_fw, eL_fw, dbg.ext_map_rc(eR_fw))
    succ_fw_node = j_fw + jnp.where(arr_is_fw, 0, M)
    ok_fw = (rn >= 0) & (extL_arr != dbg.FORK) & (succ_fw_node != idx) & valid
    succ_fw = jnp.where(ok_fw, succ_fw_node, -1)

    # --- successor of rc orientation -----------------------------------
    # extR(rc_i) maps from extL(fw_i); the successor is rc(left candidate m)
    m = extL_fw
    j_rc = pick(L["idx"], m)
    eL_rc, eR_rc, pal_rc = peek(j_rc)
    arr_is_fw_rc = (~pick(L["is_fw"], m)) | pal_rc
    extL_arr_rc = jnp.where(arr_is_fw_rc, eL_rc, dbg.ext_map_rc(eR_rc))
    succ_rc_node = j_rc + jnp.where(arr_is_fw_rc, 0, M)
    ok_rc = (m >= 0) & (extL_arr_rc != dbg.FORK) & (succ_rc_node != M + idx) & valid
    succ_rc = jnp.where(ok_rc, succ_rc_node, -1)

    # --- start ("left end") detection ----------------------------------
    # fw: extL < 0, or predecessor (left step) has a right fork
    pj = pick(L["idx"], extL_fw)
    eL_p, eR_p, _ = peek(pj)
    pred_is_fw = pick(L["is_fw"], extL_fw)
    extR_pred = jnp.where(pred_is_fw, eR_p, dbg.ext_map_rc(eL_p))
    start_fw = ((extL_fw < 0) | (extR_pred == dbg.FORK)) & valid

    # rc: extL(rc) maps from extR(fw); predecessor is rc(right candidate rn)
    qj = pick(R["idx"], extR_fw)
    eL_q, eR_q, pal_q = peek(qj)
    predrc_is_fw = (~pick(R["is_fw"], extR_fw)) | pal_q
    extR_predrc = jnp.where(predrc_is_fw, eR_q, dbg.ext_map_rc(eL_q))
    start_rc = ((extR_fw < 0) | (extR_predrc == dbg.FORK)) & valid

    # --- concatenate to oriented nodes (fw block, then rc block) ---------
    succ = jnp.concatenate([succ_fw, succ_rc])
    is_start = jnp.concatenate([start_fw, start_rc])

    last_fw = bp.last_nuc(klo)
    last_rc = 3 - bp.first_nuc(khi, klo, k).astype(I32)
    last_nuc = jnp.concatenate([last_fw.astype(I32), last_rc])

    return dict(succ=succ, is_start=is_start, last_nuc=last_nuc,
                valid2=jnp.concatenate([valid, valid]))


@jax.jit
def _narrow_u8(x):
    return x.astype(jnp.uint8)


@jax.jit
def _doubling(succ):
    """Wyllie pointer doubling over the successor forest (CPU and small
    tables; see _WALK_MIN for the splitter-walk alternative)."""
    n = succ.shape[0]
    nodes = jnp.arange(n, dtype=I32)
    terminal = succ < 0
    ptr = jnp.where(terminal, nodes, succ)
    dist = jnp.where(terminal, 0, 1).astype(I32)
    # (ptr, dist) ride as rows of ONE [2, n] state: both rounds' lookups
    # use the same index array, so one [2, n] column gather moves two
    # payloads at per-index cost
    state = jnp.stack([ptr, dist])

    # Adaptive doubling: chains are usually far shorter than n, so exit
    # as soon as no pointer moved (device-side check — no host syncs).
    # Cycles never reach a fixed point, so the round cap still applies;
    # their nodes end up with reached=False exactly as before.
    rounds = max(1, int(np.ceil(np.log2(max(2, int(n))))) + 1)

    def cond(carry):
        _, i, changed = carry
        return changed & (i < rounds)

    def body(carry):
        state, i, _ = carry
        ptr = state[0]
        g = state[:, ptr]
        nptr = g[0]
        ndist = state[1] + g[1]
        return (jnp.stack([nptr, ndist]), i + 1,
                jnp.any(nptr != ptr))

    state, _, _ = jax.lax.while_loop(
        cond, body, (state, jnp.int32(0), jnp.bool_(True)))
    ptr, dist = state[0], state[1]
    reached = terminal[ptr]
    return ptr, dist, reached


def build_contigs(keys64: np.ndarray, counts: np.ndarray, k: int,
                  len_threshold: int):
    """Extract contigs from a counted table (already filtered to count > b).

    Args:
      keys64: [M0] sorted canonical keys as int64 (host).
      counts: [M0] int32.
    Returns list of (seq_str, avg_weight, min_weight, max_weight), ordered
    deterministically by start key.
    """
    M0 = len(keys64)
    if M0 == 0:
        return []
    # pad to power of two for stable jit shapes
    M = _table_bucket(M0)
    khi = np.full(M, bp.SENTINEL, dtype=np.uint32)
    klo = np.full(M, bp.SENTINEL, dtype=np.uint32)
    u = keys64.astype(np.uint64)
    khi[:M0] = (u >> np.uint64(32)).astype(np.uint32)
    klo[:M0] = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    st = chain_structure(jnp.asarray(khi), jnp.asarray(klo), k)
    # fetch ONLY what the host assembly reads, with narrow dtypes and
    # async copies (succ is unused here and last_nuc fits uint8)
    fetch = {
        "term": st["term"],
        "dist": st["dist"],
        "reached": st["reached"],
        "is_start": st["is_start"],
        "last_nuc": _narrow_u8(st["last_nuc"]),
    }
    for v in fetch.values():
        v.copy_to_host_async()
    st = {k2: np.asarray(v) for k2, v in fetch.items()}
    term = st["term"]
    dist = st["dist"]
    reached = st["reached"]
    is_start = st["is_start"]
    last_nuc = st["last_nuc"]

    starts = np.nonzero(is_start & reached)[0]
    if len(starts) == 0:
        return []

    # Palindromic canonical keys (even k only) make the fw and rc oriented
    # nodes identical, yielding two copies of the same chain; keep one.
    # (The reference emits such duplicates twice — a latent quirk never hit
    # with odd k; we deduplicate instead.)
    _, first = np.unique(term[starts], return_index=True)
    starts = starts[np.sort(first)]

    seq_len = k + dist[starts]
    st_key = keys64[starts % M]
    end_key = keys64[term[starts] % M]

    emit = seq_len >= len_threshold
    emit &= (st_key < end_key) | (
        (st_key == end_key) & ((dist[starts] > 0) | (starts < M)))
    starts = starts[emit]
    if len(starts) == 0:
        return []
    seq_len = seq_len[emit]

    # deterministic output order
    order = np.argsort(keys64[starts % M], kind="stable")
    starts = starts[order]
    seq_len = seq_len[order]

    n_chain = len(starts)
    terminals = term[starts]
    row_of = np.full(2 * M, -1, dtype=np.int64)
    row_of[terminals] = np.arange(n_chain)

    # per-chain stats over member nodes
    member = reached & (row_of[term] >= 0)
    nodes = np.nonzero(member)[0]
    rows = row_of[term[nodes]]
    ncounts = counts[(nodes % M)].astype(np.int64)
    wsum = np.zeros(n_chain, dtype=np.int64)
    wmin = np.full(n_chain, np.iinfo(np.int64).max, dtype=np.int64)
    wmax = np.zeros(n_chain, dtype=np.int64)
    np.add.at(wsum, rows, ncounts)
    np.minimum.at(wmin, rows, ncounts)
    np.maximum.at(wmax, rows, ncounts)

    # char buffer assembly
    offsets = np.zeros(n_chain + 1, dtype=np.int64)
    np.cumsum(seq_len, out=offsets[1:])
    buf = np.zeros(offsets[-1], dtype=np.uint8)

    cols = dist[starts][rows] - dist[nodes]          # 0 at start .. dist at end
    buf[offsets[rows] + (k - 1) + cols] = CHARS[last_nuc[nodes]]

    # start prefixes: first k-1 chars of the oriented start k-mer value
    from ..oracle.reference import kmer_string, rc64
    out = []
    for r in range(n_chain):
        o = starts[r]
        key = int(keys64[o % M])
        val = key if o < M else rc64(key, k)
        prefix = kmer_string(val, k)[: k - 1]
        s = buf[offsets[r]: offsets[r + 1]]
        s[: k - 1] = np.frombuffer(prefix.encode(), dtype=np.uint8)
        n_kmers = int(seq_len[r]) - k + 1
        out.append((
            s.tobytes().decode("ascii"),
            int(wsum[r] // n_kmers),
            int(wmin[r]),
            int(wmax[r]),
        ))
    return out


def _table_bucket(n: int) -> int:
    """Graph-table padding from the {2^k, 3*2^(k-1)} family: 1.5x worst
    case instead of 2x — every graph stage scales with the PADDED size."""
    from ..ops.count import _bucket_size

    return max(16, _bucket_size(n))
