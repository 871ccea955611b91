"""Sharded contig chain ranking: pointer doubling over a row-sharded
(ptr, dist) table.

The reference parallelizes contig walking per hash stripe inside one JVM
(src/algo/SequencesFinders.java:13-31, hot walk
src/algo/AddSequencesShiftingRightTask.java:74-99).  The mesh-native
equivalent shards the oriented-node state [2, n] by row block across
devices and runs Wyllie doubling with ONE index exchange per round:

  1. each device buckets its block's pointer targets by owning shard
     (one local sort);
  2. one all-to-all ships the requests, each owner answers with a local
     [2, b] column gather, a second all-to-all ships the replies back;
  3. (ptr, dist) update locally; a psum'd change flag drives the
     device-side convergence loop.

Per-device state is O(n / d) plus the exchange buffers; no replicated
[n] vector exists at any point (the r2 lesson from
parallel/components.py applies here too).  Exchange buffers are sized
b = n/d per peer — the worst-case skew (every local pointer targeting
one shard) cannot drop requests; production meshes with HBM pressure
would cap the buckets and multi-round the exchange instead.

Used by graph/contigs.chain_structure when a default mesh is set, which
makes the contig stage the last ★ stage to shard; the
driver's dryrun_multichip golden-matrix run exercises it end to end.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .count import AXIS

I32 = jnp.int32


def _route_gather(state, idx, d: int, b: int):
    """state[:, idx] where idx is GLOBAL and state is this device's
    [2, b] row block — via bucket / all-to-all / local gather / reply.

    Runs inside shard_map.  Returns [2, m] gathered values (m = len(idx)).
    """
    m = idx.shape[0]
    me = jax.lax.axis_index(AXIS)
    owner = jnp.clip(idx // b, 0, d - 1).astype(I32)
    pos_in = jnp.arange(m, dtype=I32)
    owner_s, idx_s, pos_s = jax.lax.sort(
        (owner, idx, pos_in), num_keys=1, is_stable=True)
    first = jnp.searchsorted(owner_s, jnp.arange(d + 1, dtype=I32),
                             side="left").astype(I32)
    slot = jnp.arange(m, dtype=I32) - first[owner_s]
    # bucket capacity = m: slot < m always holds, nothing can drop
    buf = jnp.zeros((d, m), dtype=I32)
    buf = buf.at[owner_s, slot].set(idx_s, mode="drop")
    req = jax.lax.all_to_all(buf, AXIS, split_axis=0, concat_axis=0,
                             tiled=True)            # [d, m] asks for me
    loc = jnp.clip(req - me * b, 0, b - 1)
    rep = state[:, loc]                              # [2, d, m]
    back0 = jax.lax.all_to_all(rep[0], AXIS, split_axis=0,
                               concat_axis=0, tiled=True)
    back1 = jax.lax.all_to_all(rep[1], AXIS, split_axis=0,
                               concat_axis=0, tiled=True)
    val0 = back0[owner_s, slot]
    val1 = back1[owner_s, slot]
    out0 = jnp.zeros(m, I32).at[pos_s].set(val0)
    out1 = jnp.zeros(m, I32).at[pos_s].set(val1)
    return jnp.stack([out0, out1])


@partial(jax.jit, static_argnames=("mesh", "rounds"))
def _sharded_doubling(succ_blocks, *, mesh: Mesh, rounds: int):
    """Wyllie doubling over a [d, b] row-sharded successor table.

    Returns (ptr, dist, reached) as [d, b] sharded arrays (global index
    space).  Same semantics as graph.contigs._doubling.
    """
    d = mesh.shape[AXIS]
    b = succ_blocks.shape[1]

    def step(succ):
        succ = succ[0]
        me = jax.lax.axis_index(AXIS)
        base = me * b
        nodes = base + jnp.arange(b, dtype=I32)
        terminal = succ < 0
        ptr = jnp.where(terminal, nodes, succ)
        dist = jnp.where(terminal, 0, 1).astype(I32)

        def cond(c):
            _, _, i, changed = c
            return changed & (i < rounds)

        def body(c):
            ptr, dist, i, _ = c
            state = jnp.stack([ptr, dist])
            g = _route_gather(state, ptr, d, b)
            nptr = g[0]
            ndist = dist + g[1]
            changed = jax.lax.psum(
                jnp.any(nptr != ptr).astype(I32), AXIS) > 0
            return nptr, ndist, i + 1, changed

        ptr, dist, _, _ = jax.lax.while_loop(
            cond, body, (ptr, dist, jnp.int32(0), jnp.bool_(True)))
        # reached = terminal[ptr] — one more routed lookup of the
        # terminal flag (encoded in succ's sign on the owning shard)
        sflag = _route_gather(jnp.stack([succ, succ]), ptr, d, b)
        reached = sflag[0] < 0
        return ptr[None], dist[None], reached[None]

    return jax.shard_map(
        step, mesh=mesh, in_specs=(P(AXIS),),
        out_specs=(P(AXIS), P(AXIS), P(AXIS)))(succ_blocks)


def sharded_doubling(succ, mesh: Mesh):
    """(term, dist, reached) for a successor forest, edge-cut over the
    mesh.  Matches graph.contigs._doubling on every node.

    On multi-process meshes each process feeds its addressable row
    blocks and results come back through a DCN allgather — the same
    discipline as parallel.components.sharded_connected_labels."""
    succ = np.asarray(succ, dtype=np.int32)
    n = len(succ)
    d = mesh.shape[AXIS]
    b = -(-n // d)
    pad = d * b - n
    if pad:
        succ = np.concatenate([succ, np.full(pad, -1, np.int32)])
    blocks = succ.reshape(d, b)
    sharding = jax.NamedSharding(mesh, P(AXIS))
    multiproc = jax.process_count() > 1 and any(
        dv.process_index != jax.process_index() for dv in mesh.devices.flat)
    if multiproc:
        pidx = np.array([dv.process_index for dv in mesh.devices.flat])
        assert (np.diff(pidx) >= 0).all(), (
            "sharded_doubling expects process-contiguous mesh rows")
        mine = np.nonzero(pidx == jax.process_index())[0]
        dblocks = jax.make_array_from_process_local_data(
            sharding, blocks[mine], (d, b))
    else:
        dblocks = jax.device_put(jnp.asarray(blocks), sharding)
    rounds = max(1, int(np.ceil(np.log2(max(2, d * b)))) + 1)
    ptr, dist, reached = _sharded_doubling(dblocks, mesh=mesh,
                                           rounds=rounds)
    if multiproc:
        from jax.experimental import multihost_utils

        def _gather(a):
            loc = np.concatenate(
                [np.asarray(s.data).reshape(-1)
                 for s in sorted(a.addressable_shards,
                                 key=lambda s: s.index[0].start or 0)])
            return np.asarray(
                multihost_utils.process_allgather(loc)).reshape(-1)

        return (_gather(ptr)[:n], _gather(dist)[:n],
                _gather(reached)[:n].astype(bool))
    return (np.asarray(ptr).reshape(-1)[:n],
            np.asarray(dist).reshape(-1)[:n],
            np.asarray(reached).reshape(-1)[:n])
