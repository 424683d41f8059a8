"""Wavefront engine: batched dense gap-affine POA alignment on the device.

This is the throughput path of the framework — the accelerator redesign of
the reference's A* search (``src/aligner/astar.rs``): instead of popping
one (node, offset, state) at a time from a bucket queue, the whole
(topo-rank × query-offset) state space is filled as a masked batched scan.

Layout and mapping to the hardware:

* **Offsets are lanes.** Each rank-row update is elementwise over the
  query-offset axis (padded to a multiple of 128) and the read batch —
  elementwise min/add work.  The affine insertion chain collapses to one
  ``lax.cummin`` per row (see :mod:`poasta_tpu.ops.dp_rows`).
* **Ranks are a `lax.scan`.**  Topological order guarantees predecessor
  rows are final; the carry is a ring buffer of the last ``W`` rows where
  ``W`` covers the graph's maximum edge rank-span — POA graphs are mostly
  unbranched chains, so ``W`` stays small and the working set is
  O(B·W·L), not O(B·N·L).
* **Reads are the batch.**  Queries are padded/bucketed by length;
  per-read scores gather at each read's true length.  Data parallelism
  over devices shards this axis (see :mod:`poasta_tpu.parallel`).
* **Shapes are bucketed.**  Node count, ring size, and predecessor width
  are padded to buckets so the growing-graph fusion loop and heterogeneous
  read batches reuse cached executables instead of recompiling
  (the reference rebuilds per-alignment state each call;
  ``src/aligner/config.rs:113-134``).

Two fill variants:

* :func:`dp_fill_scores` — scores only (ring-buffer carry), the serving
  configuration.
* :func:`dp_fill_full` — additionally materializes the M/I/D tables for
  host-side backtrace (:func:`backtrace_dense`); used when alignments (not
  just scores) are needed and the state space fits in HBM.

Scores are provably equal to the host oracle's (same recurrence, full
relaxation); tests randomize graphs/queries and assert equality.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..graphs.flat import FlatGraph
from ..ops.dp_rows import INF, row_update
from .alignment import AlignedPair, Alignment
from .costs import GapAffine


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _color_ring_slots(n: int, last_use: np.ndarray) -> np.ndarray:
    """Greedy interval coloring of row lifetimes [r, last_use[r]].

    The unbranched-chain common case (``last_use == r+1``, i.e. each row
    read only by the next rank) is detected as maximal runs and colored
    by parity against the slots live across the run — vectorized.  Only
    ranks inside irregular regions run the Python-level heap.
    """
    import heapq

    slot_of = np.zeros(n, dtype=np.int32)
    if n == 0:
        return slot_of
    chain = last_use == np.arange(n, dtype=np.int64) + 1
    # a chain run [a, b] can be bulk-colored iff no earlier interval is
    # still live inside it; detect via running max of last_use
    prev_reach = np.zeros(n, dtype=np.int64)
    if n > 1:
        np.maximum.accumulate(last_use[:-1], out=prev_reach[1:])
    isolated_chain = chain & (prev_reach <= np.arange(n, dtype=np.int64))

    free: list = []
    live: list = []  # heap of (death_rank, slot)
    next_slot = 0
    r = 0
    while r < n:
        b = r
        if isolated_chain[r]:
            while b + 1 < n and isolated_chain[b + 1]:
                b += 1
        if b > r:
            # maximal chain run [r, b]: alternate two slots (each row dies
            # as the next-next is written, so 2 colors always suffice; any
            # interval overlapping the run is still in `live` here, so the
            # two slots can't collide with it)
            while live and live[0][0] < r:
                _, s = heapq.heappop(live)
                free.append(s)
            if free:
                s0 = free.pop()
            else:
                s0 = next_slot
                next_slot += 1
            # allocate the second slot only after releasing intervals that
            # die exactly at r (what the sequential greedy would see at
            # rank r+1) — allocating both up front can inflate the peak
            while live and live[0][0] < r + 1:
                _, s = heapq.heappop(live)
                free.append(s)
            if free:
                s1 = free.pop()
            else:
                s1 = next_slot
                next_slot += 1
            js = np.arange(r, b + 1)
            slot_of[js] = np.where((js - r) % 2 == 0, s0, s1)
            # only the last two rows of the run are live past it
            heapq.heappush(live, (int(last_use[b - 1]), int(slot_of[b - 1])))
            heapq.heappush(live, (int(last_use[b]), int(slot_of[b])))
            r = b + 1
            continue
        while live and live[0][0] < r:
            _, s = heapq.heappop(live)
            free.append(s)
        if free:
            s = free.pop()
        else:
            s = next_slot
            next_slot += 1
        slot_of[r] = s
        heapq.heappush(live, (int(last_use[r]), s))
        r += 1
    return slot_of


def _next_pow2(x: int) -> int:
    v = 1
    while v < x:
        v <<= 1
    return v


@dataclass(frozen=True)
class DeviceGraph:
    """Static, bucket-padded device-side view of a flat graph.

    Everything a fill needs per call is precomputed here once, so
    per-call host↔device transfers are zero.
    """

    symbols: jnp.ndarray  # (Np,) int32; padding rows are symbol -1
    pred_slots: jnp.ndarray  # (Np, P) ring slot per predecessor
    pred_valid: jnp.ndarray  # (Np, P) bool
    end_rank: jnp.ndarray  # () int32 — true end-node rank
    window: int  # ring size W = liveness-coloring peak (static)
    n_nodes_padded: int
    n_nodes: int
    pred_ranks_np: "np.ndarray" = None  # (Np, P) predecessor ranks (host)
    pred_valid_np: "np.ndarray" = None  # (Np, P) valid mask (host)
    end_rank_i: int = 0  # host copy of end_rank (no D2H sync per call)
    pred_slots_flat: jnp.ndarray = None  # (Np*P,) int32
    pred_valid_flat: jnp.ndarray = None  # (Np*P,) int32 0/1
    meta: jnp.ndarray = None  # (4,) int32 [Np, end_rank, 0, 0]

    write_slots: jnp.ndarray = None  # (Np,) int32 ring slot each rank writes

    @staticmethod
    def build(flat: FlatGraph, node_bucket: int = 64,
              place_on_device: bool = True) -> "DeviceGraph":
        """``place_on_device=False`` keeps every array host-side (numpy):
        jnp ops coerce them per call, so it trades per-call uploads for
        never touching the backend (for entry points that must not
        initialise a device)."""
        n = flat.n_nodes
        P = _next_pow2(max(1, flat.max_in_degree))
        np_nodes = _round_up(n, node_bucket)

        # Liveness-colored ring slots: a rank's row must stay resident only
        # until its last reader (max successor rank).  Greedy interval
        # coloring gives K = peak number of simultaneously-live rows —
        # typically ~4 for POA graphs vs. the 2^ceil(log2(max edge span))
        # a modulo ring would need — which is what bounds the banded
        # kernel's shared memory per read.
        counts = np.diff(flat.pred_ptr.astype(np.int64))
        readers = np.repeat(np.arange(n, dtype=np.int64), counts)
        last_use = np.arange(n, dtype=np.int64)
        np.maximum.at(last_use, flat.pred_idx.astype(np.int64), readers)

        slot_of = _color_ring_slots(n, last_use)
        window = max(int(slot_of.max()) + 1 if n else 1, 1)

        symbols = np.full((np_nodes,), -1, dtype=np.int32)
        symbols[:n] = flat.symbols.astype(np.int32)
        pred_slots = np.zeros((np_nodes, P), dtype=np.int32)
        pred_valid = np.zeros((np_nodes, P), dtype=bool)
        pred_ranks = np.zeros((np_nodes, P), dtype=np.int32)
        write_slots = np.zeros((np_nodes,), dtype=np.int32)
        write_slots[:n] = slot_of
        cols = np.arange(len(flat.pred_idx)) - np.repeat(
            flat.pred_ptr[:-1].astype(np.int64), counts
        )
        preds = flat.pred_idx.astype(np.int64)
        pred_slots[readers, cols] = slot_of[preds]
        pred_valid[readers, cols] = True
        pred_ranks[readers, cols] = preds

        put = jnp.asarray if place_on_device else np.asarray
        return DeviceGraph(
            symbols=put(symbols),
            pred_slots=put(pred_slots),
            pred_valid=put(pred_valid),
            end_rank=put(np.int32(n - 1)),
            window=window,
            n_nodes_padded=np_nodes,
            n_nodes=n,
            pred_ranks_np=pred_ranks,
            pred_valid_np=pred_valid,
            end_rank_i=n - 1,
            pred_slots_flat=put(pred_slots.reshape(-1)),
            pred_valid_flat=put(pred_valid.reshape(-1).astype(np.int32)),
            # loop bound is the true rank count: bucket padding never runs
            meta=put(np.asarray([n, n - 1, 0, 0], dtype=np.int32)),
            write_slots=put(write_slots),
        )


def pack_queries(queries, pad_to: Optional[int] = None,
                 place_on_device: bool = True
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Pack byte-string reads into a padded (B, L) batch + (B,) lengths.

    Column ``j`` holds ``q[j-1]`` (offset j consumes query char j-1);
    column 0 and the padding are 0, which matches no nucleotide symbol.
    ``L`` is rounded up to a multiple of 128 so offsets fill whole lanes.
    ``place_on_device=False`` returns numpy (see DeviceGraph.build).
    """
    maxlen = max((len(q) for q in queries), default=0)
    L = _round_up(max(pad_to or 0, maxlen) + 1, 128)
    B = len(queries)
    arr = np.zeros((B, L), dtype=np.int32)
    lengths = np.zeros((B,), dtype=np.int32)
    for b, q in enumerate(queries):
        qa = np.frombuffer(bytes(q), dtype=np.uint8).astype(np.int32)
        arr[b, 1 : len(q) + 1] = qa
        lengths[b] = len(q)
    if not place_on_device:
        return arr, lengths
    return jnp.asarray(arr), jnp.asarray(lengths)


def _make_step(window: int, o: int, e: int, x: int, free_start: bool,
               collect: str, end_rank, qshift, lengths):
    """Build the scan body; `collect` in {"at_len", "tables"}."""
    idx = lengths.astype(jnp.int32)[:, None]  # (B, 1)

    def step(carry, xs):
        M_ring, D_ring = carry
        rank, sym, slots, valid, wslot = xs

        pred_M = jnp.take(M_ring, slots, axis=1)  # (B, P, L)
        pred_D = jnp.take(D_ring, slots, axis=1)

        match_cost = jnp.where(qshift == sym, jnp.int32(0), jnp.int32(x))

        is_start = rank == 0
        is_end = rank == end_rank
        # real graph nodes only — excludes start, end, and bucket padding
        is_real = jnp.logical_and(rank > 0, rank < end_rank)

        M, I, D = row_update(
            pred_M, pred_D, valid, match_cost, o, e,
            is_start_row=is_start,
            free_start=jnp.logical_and(is_real, free_start),
        )

        # Virtual end node: zero-cost hop at the same offset from any
        # predecessor (the reference DFA's RefGraphEnd semantics,
        # ``dfa.rs:222-227``).
        mask = valid.reshape(1, -1, 1)
        min_pm_same = jnp.min(jnp.where(mask, pred_M, INF), axis=1)
        M = jnp.where(is_end, min_pm_same, M)
        I = jnp.where(is_end, INF, I)
        D = jnp.where(is_end, INF, D)

        M_ring = jax.lax.dynamic_update_index_in_dim(M_ring, M, wslot, axis=1)
        D_ring = jax.lax.dynamic_update_index_in_dim(D_ring, D, wslot, axis=1)

        if collect == "tables":
            ys = (M, I, D)
        else:  # "at_len": M at each read's final offset, (B,)
            ys = jnp.take_along_axis(M, idx, axis=1)[:, 0]
        return (M_ring, D_ring), ys

    return step


@functools.lru_cache(maxsize=None)
def _scores_exec(window: int, o: int, e: int, x: int,
                 free_start: bool, free_end: bool):
    """Cached jitted scores kernel, keyed by static config."""

    @jax.jit
    def fn(symbols, pred_slots, pred_valid, write_slots, end_rank, qshift,
           lengths):
        B, L = qshift.shape
        Np = symbols.shape[0]
        M0 = jnp.full((B, window, L), INF, dtype=jnp.int32)
        D0 = jnp.full((B, window, L), INF, dtype=jnp.int32)
        step = _make_step(window, o, e, x, free_start, "at_len",
                          end_rank, qshift, lengths)
        ranks = jnp.arange(Np, dtype=jnp.int32)
        xs = (ranks, symbols, pred_slots, pred_valid, write_slots)
        _, at_len = jax.lax.scan(step, (M0, D0), xs)  # (Np, B)
        score_global = jnp.take(at_len, end_rank, axis=0)
        if free_end:
            # best over real ranks (exclude start, end, padding)
            rank_ok = jnp.logical_and(ranks > 0, ranks < end_rank)[:, None]
            best_real = jnp.min(jnp.where(rank_ok, at_len, INF), axis=0)
            score_global = jnp.minimum(score_global, best_real)
        return score_global

    return fn


@functools.lru_cache(maxsize=None)
def _scores_exec_2p(window: int, o1: int, e1: int, e2: int, x: int,
                    free_start: bool, free_end: bool):
    """Two-piece affine scores kernel (XLA path, 5 state layers)."""
    from ..ops.dp_rows_2p import row_update_2p

    @jax.jit
    def fn(symbols, pred_slots, pred_valid, write_slots, end_rank, qshift,
           lengths):
        B, L = qshift.shape
        Np = symbols.shape[0]
        idx = lengths.astype(jnp.int32)[:, None]
        M0 = jnp.full((B, window, L), INF, dtype=jnp.int32)
        carry0 = (M0, M0, M0)  # M, D1, D2 rings

        def step(carry, xs):
            M_ring, D1_ring, D2_ring = carry
            rank, sym, slots, valid, wslot = xs
            pred_M = jnp.take(M_ring, slots, axis=1)
            pred_D1 = jnp.take(D1_ring, slots, axis=1)
            pred_D2 = jnp.take(D2_ring, slots, axis=1)
            match_cost = jnp.where(qshift == sym, jnp.int32(0), jnp.int32(x))
            is_start = rank == 0
            is_end = rank == end_rank
            is_real = jnp.logical_and(rank > 0, rank < end_rank)

            M, I1, I2, D1, D2 = row_update_2p(
                pred_M, pred_D1, pred_D2, valid, match_cost, o1, e1, e2,
                is_start_row=is_start,
                free_start=jnp.logical_and(is_real, free_start),
            )
            mask = valid.reshape(1, -1, 1)
            min_pm = jnp.min(jnp.where(mask, pred_M, INF), axis=1)
            M = jnp.where(is_end, min_pm, M)
            D1 = jnp.where(is_end, INF, D1)
            D2 = jnp.where(is_end, INF, D2)

            M_ring = jax.lax.dynamic_update_index_in_dim(M_ring, M, wslot, 1)
            D1_ring = jax.lax.dynamic_update_index_in_dim(D1_ring, D1, wslot, 1)
            D2_ring = jax.lax.dynamic_update_index_in_dim(D2_ring, D2, wslot, 1)

            at_len = jnp.take_along_axis(M, idx, axis=1)[:, 0]
            at_len = jnp.where(is_real | is_end, at_len, INF)
            return (M_ring, D1_ring, D2_ring), at_len

        ranks = jnp.arange(Np, dtype=jnp.int32)
        xs = (ranks, symbols, pred_slots, pred_valid, write_slots)
        _, at_len = jax.lax.scan(step, carry0, xs)
        score = jnp.take(at_len, end_rank, axis=0)
        if free_end:
            rank_ok = jnp.logical_and(ranks > 0, ranks < end_rank)[:, None]
            best_real = jnp.min(jnp.where(rank_ok, at_len, INF), axis=0)
            score = jnp.minimum(score, best_real)
        return score

    return fn


_END_OK_CACHE: dict = {}  # (id(flat), bound, Np) -> (flat ref, mask)


def ends_free_device_params(flat: FlatGraph, aln_type, lengths,
                            n_nodes_padded: int, two_piece: bool = False,
                            with_jlo: bool = True):
    """Lower an ``EndsFree`` span to device arrays for the bounded fills.

    Returns ``(free_start, end_ok, jlo)``:

    * ``free_start`` — graph_free_begin is Unbounded (bounded free begin
      degenerates to the start node, faithfully to the reference's
      ``initial_states``, ``gap_affine.rs:150-168``).
    * ``end_ok`` — (Np,) int32: rank may end the alignment per the
      graph_free_end bound on its min distance to the end node
      (``gap_affine.rs:219-241``); the virtual end rank always qualifies
      (distance 0).
    * ``jlo`` — (B,) int32: lowest query offset satisfying the
      qry_free_end bound on the remaining suffix (``gap_affine.rs:
      203-217``); the valid end window is ``[jlo_b, n_b]`` (empty when
      jlo > n: unsatisfiable bound -> INF scores, like the exact
      engine's drained-queue error).  The Unbounded case keeps the
      reference's offset>0 quirk.
    """
    from .costs import EndsFree

    assert isinstance(aln_type, EndsFree)
    free_start = aln_type.graph_free_begin[0] == "unbounded"

    # end_ok is cached per (flat, bound): downstream caches key device
    # tables by the mask's identity (e.g. _big_rank_table), so a fresh
    # array per call would defeat them and re-upload multi-MB tables
    ck = (id(flat), aln_type.graph_free_end, n_nodes_padded)
    ent = _END_OK_CACHE.get(ck)
    if ent is not None and ent[0] is flat:
        if not with_jlo:
            # callers with a host-side jlo mirror (the seeded corridor
            # path) skip the device jlo dispatches entirely
            return free_start, ent[1], None
        li = lengths.astype(jnp.int32)
        qkind, qval = aln_type.qry_free_end
        if qkind == "unbounded":
            jlo = li if two_piece else jnp.minimum(li, 1)
        elif qkind == "included":
            jlo = jnp.maximum(li - qval, 0)
        else:
            jlo = jnp.maximum(li - qval + 1, 0)
        return free_start, ent[1], jlo

    n = flat.n_nodes
    # Every rank's eligibility follows its own min distance to the end,
    # with NO node exclusions — the reference's is_end has none: the
    # virtual start can end an alignment (empty alignment) when its
    # distance passes, and the virtual end rank (distance 0) passes any
    # bound except excluded(0), which forbids ending anywhere.
    de = flat.min_dist_to_end.astype(np.int64)
    gkind, gval = aln_type.graph_free_end
    if gkind == "unbounded":
        ok = np.ones(n, dtype=np.int32)
    elif gkind == "included":
        ok = (de <= gval).astype(np.int32)
    else:
        ok = (de < gval).astype(np.int32)
    end_ok = np.zeros(n_nodes_padded, dtype=np.int32)
    end_ok[:n] = ok
    end_ok_dev = jnp.asarray(end_ok)
    _END_OK_CACHE[ck] = (flat, end_ok_dev)
    while len(_END_OK_CACHE) > 8:
        _END_OK_CACHE.pop(next(iter(_END_OK_CACHE)))

    li = lengths.astype(jnp.int32)
    qkind, qval = aln_type.qry_free_end
    if qkind == "unbounded":
        if two_piece:
            # the two-piece exact engine only ends at offset >= len(seq)
            # for the unbounded case (engine.py, reference parity)
            jlo = li
        else:
            jlo = jnp.minimum(li, 1)  # offset>0 quirk; empty query ends at 0
    elif qkind == "included":
        jlo = jnp.maximum(li - qval, 0)
    else:
        jlo = jnp.maximum(li - qval + 1, 0)
    return free_start, end_ok_dev, (jlo if with_jlo else None)


@functools.lru_cache(maxsize=None)
def _scores_exec_bounded(window: int, o: int, e: int, x: int,
                         free_start: bool, two_piece_params=None,
                         vary_axes: tuple = ()):
    """Bounded ends-free scores kernel (XLA body).

    Bound *values* ride in as arrays (``end_ok`` per rank, ``jlo`` per
    read), so one compiled variant serves every Included/Excluded/
    Unbounded combination.  ``two_piece_params``: (o2, e2) enables the
    5-layer recurrence.
    """

    @jax.jit
    def fn(symbols, pred_slots, pred_valid, write_slots, end_rank, end_ok,
           qshift, lengths, jlo):
        B, L = qshift.shape
        Np = symbols.shape[0]
        ring0 = jnp.full((B, window, L), INF, dtype=jnp.int32)
        best0 = jnp.full((B, L), INF, dtype=jnp.int32)
        if vary_axes:
            ring0 = jax.lax.pcast(ring0, vary_axes, to="varying")
            best0 = jax.lax.pcast(best0, vary_axes, to="varying")
        idx = lengths.astype(jnp.int32)[:, None]

        if two_piece_params is None:
            def step(carry, xs):
                M_ring, D_ring, best = carry
                rank, sym, slots, valid, wslot, ok = xs
                pred_M = jnp.take(M_ring, slots, axis=1)
                pred_D = jnp.take(D_ring, slots, axis=1)
                match_cost = jnp.where(qshift == sym, jnp.int32(0),
                                       jnp.int32(x))
                is_start = rank == 0
                is_end = rank == end_rank
                is_real = jnp.logical_and(rank > 0, rank < end_rank)
                M, I, D = row_update(
                    pred_M, pred_D, valid, match_cost, o, e,
                    is_start_row=is_start,
                    free_start=jnp.logical_and(is_real, free_start),
                )
                mask = valid.reshape(1, -1, 1)
                min_pm = jnp.min(jnp.where(mask, pred_M, INF), axis=1)
                M = jnp.where(is_end, min_pm, M)
                I = jnp.where(is_end, INF, I)
                D = jnp.where(is_end, INF, D)
                M_ring = jax.lax.dynamic_update_index_in_dim(
                    M_ring, M, wslot, axis=1)
                D_ring = jax.lax.dynamic_update_index_in_dim(
                    D_ring, D, wslot, axis=1)
                permitted = ok == 1
                best = jnp.where(permitted, jnp.minimum(best, M), best)
                return (M_ring, D_ring, best), None

            carry0 = (ring0, ring0, best0)
        else:
            from ..ops.dp_rows_2p import row_update_2p

            o2, e2 = two_piece_params

            def step(carry, xs):
                M_ring, D1_ring, D2_ring, best = carry
                rank, sym, slots, valid, wslot, ok = xs
                pred_M = jnp.take(M_ring, slots, axis=1)
                pred_D1 = jnp.take(D1_ring, slots, axis=1)
                pred_D2 = jnp.take(D2_ring, slots, axis=1)
                match_cost = jnp.where(qshift == sym, jnp.int32(0),
                                       jnp.int32(x))
                is_start = rank == 0
                is_end = rank == end_rank
                is_real = jnp.logical_and(rank > 0, rank < end_rank)
                M, I1, I2, D1, D2 = row_update_2p(
                    pred_M, pred_D1, pred_D2, valid, match_cost, o, e, e2,
                    is_start_row=is_start,
                    free_start=jnp.logical_and(is_real, free_start),
                )
                mask = valid.reshape(1, -1, 1)
                min_pm = jnp.min(jnp.where(mask, pred_M, INF), axis=1)
                M = jnp.where(is_end, min_pm, M)
                D1 = jnp.where(is_end, INF, D1)
                D2 = jnp.where(is_end, INF, D2)
                M_ring = jax.lax.dynamic_update_index_in_dim(
                    M_ring, M, wslot, 1)
                D1_ring = jax.lax.dynamic_update_index_in_dim(
                    D1_ring, D1, wslot, 1)
                D2_ring = jax.lax.dynamic_update_index_in_dim(
                    D2_ring, D2, wslot, 1)
                permitted = ok == 1
                best = jnp.where(permitted, jnp.minimum(best, M), best)
                return (M_ring, D1_ring, D2_ring, best), None

            carry0 = (ring0, ring0, ring0, best0)

        ranks = jnp.arange(Np, dtype=jnp.int32)
        xs = (ranks, symbols, pred_slots, pred_valid, write_slots, end_ok)
        out_carry, _ = jax.lax.scan(step, carry0, xs)
        best = out_carry[-1]
        col = jnp.arange(L, dtype=jnp.int32)[None, :]
        win = jnp.logical_and(col >= jlo[:, None], col <= idx)
        return jnp.min(jnp.where(win, best, INF), axis=1)

    return fn


@functools.lru_cache(maxsize=None)
def _scores_exec_bounded_ends(window: int, o: int, e: int, x: int,
                              free_start: bool, vary_axes: tuple = (),
                              two_piece_params=None):
    """Bounded ends-free scores + best end state (XLA body).

    Like :func:`_scores_exec_bounded` but also tracks, per (read,
    offset), the first rank achieving the best permitted M value, so the
    caller learns each read's optimal end state (rank, offset) without
    materializing tables — the anchor for the native corridor backtrace.
    ``two_piece_params``: (o2, e2) switches to the 5-layer recurrence.
    """

    @jax.jit
    def fn(symbols, pred_slots, pred_valid, write_slots, end_rank, end_ok,
           qshift, lengths, jlo):
        B, L = qshift.shape
        Np = symbols.shape[0]
        ring0 = jnp.full((B, window, L), INF, dtype=jnp.int32)
        best0 = jnp.full((B, L), INF, dtype=jnp.int32)
        bestr0 = jnp.zeros((B, L), dtype=jnp.int32)
        if vary_axes:
            ring0 = jax.lax.pcast(ring0, vary_axes, to="varying")
            best0 = jax.lax.pcast(best0, vary_axes, to="varying")
            bestr0 = jax.lax.pcast(bestr0, vary_axes, to="varying")
        idx = lengths.astype(jnp.int32)[:, None]

        if two_piece_params is not None:
            from ..ops.dp_rows_2p import row_update_2p

            _, e2 = two_piece_params

            def step2(carry, xs):
                M_ring, D1_ring, D2_ring, best, bestr = carry
                rank, sym, slots, valid, wslot, ok = xs
                pred_M = jnp.take(M_ring, slots, axis=1)
                pred_D1 = jnp.take(D1_ring, slots, axis=1)
                pred_D2 = jnp.take(D2_ring, slots, axis=1)
                match_cost = jnp.where(qshift == sym, jnp.int32(0),
                                       jnp.int32(x))
                is_start = rank == 0
                is_end = rank == end_rank
                is_real = jnp.logical_and(rank > 0, rank < end_rank)
                M, I1, I2, D1, D2 = row_update_2p(
                    pred_M, pred_D1, pred_D2, valid, match_cost, o, e, e2,
                    is_start_row=is_start,
                    free_start=jnp.logical_and(is_real, free_start),
                )
                mask = valid.reshape(1, -1, 1)
                min_pm = jnp.min(jnp.where(mask, pred_M, INF), axis=1)
                M = jnp.where(is_end, min_pm, M)
                D1 = jnp.where(is_end, INF, D1)
                D2 = jnp.where(is_end, INF, D2)
                M_ring = jax.lax.dynamic_update_index_in_dim(
                    M_ring, M, wslot, 1)
                D1_ring = jax.lax.dynamic_update_index_in_dim(
                    D1_ring, D1, wslot, 1)
                D2_ring = jax.lax.dynamic_update_index_in_dim(
                    D2_ring, D2, wslot, 1)
                improved = jnp.logical_and(ok == 1, M < best)
                best = jnp.where(improved, M, best)
                bestr = jnp.where(improved, rank, bestr)
                return (M_ring, D1_ring, D2_ring, best, bestr), None

            ranks = jnp.arange(Np, dtype=jnp.int32)
            xs = (ranks, symbols, pred_slots, pred_valid, write_slots,
                  end_ok)
            (_, _, _, best, bestr), _ = jax.lax.scan(
                step2, (ring0, ring0, ring0, best0, bestr0), xs)
            col = jnp.arange(L, dtype=jnp.int32)[None, :]
            win = jnp.logical_and(col >= jlo[:, None], col <= idx)
            masked = jnp.where(win, best, INF)
            score = jnp.min(masked, axis=1)
            # ties resolve to the LARGEST offset, then the lowest rank
            end_j = (L - 1 - jnp.argmin(masked[:, ::-1], axis=1)).astype(
                jnp.int32)
            end_r = jnp.take_along_axis(bestr, end_j[:, None], axis=1)[:, 0]
            return score, end_r, end_j

        def step(carry, xs):
            M_ring, D_ring, best, bestr = carry
            rank, sym, slots, valid, wslot, ok = xs
            pred_M = jnp.take(M_ring, slots, axis=1)
            pred_D = jnp.take(D_ring, slots, axis=1)
            match_cost = jnp.where(qshift == sym, jnp.int32(0),
                                   jnp.int32(x))
            is_start = rank == 0
            is_end = rank == end_rank
            is_real = jnp.logical_and(rank > 0, rank < end_rank)
            M, I, D = row_update(
                pred_M, pred_D, valid, match_cost, o, e,
                is_start_row=is_start,
                free_start=jnp.logical_and(is_real, free_start),
            )
            mask = valid.reshape(1, -1, 1)
            min_pm = jnp.min(jnp.where(mask, pred_M, INF), axis=1)
            M = jnp.where(is_end, min_pm, M)
            I = jnp.where(is_end, INF, I)
            D = jnp.where(is_end, INF, D)
            M_ring = jax.lax.dynamic_update_index_in_dim(
                M_ring, M, wslot, axis=1)
            D_ring = jax.lax.dynamic_update_index_in_dim(
                D_ring, D, wslot, axis=1)
            improved = jnp.logical_and(ok == 1, M < best)
            best = jnp.where(improved, M, best)
            bestr = jnp.where(improved, rank, bestr)
            return (M_ring, D_ring, best, bestr), None

        ranks = jnp.arange(Np, dtype=jnp.int32)
        xs = (ranks, symbols, pred_slots, pred_valid, write_slots, end_ok)
        (_, _, best, bestr), _ = jax.lax.scan(
            step, (ring0, ring0, best0, bestr0), xs)
        col = jnp.arange(L, dtype=jnp.int32)[None, :]
        win = jnp.logical_and(col >= jlo[:, None], col <= idx)
        masked = jnp.where(win, best, INF)
        score = jnp.min(masked, axis=1)
        # ties resolve to the LARGEST offset (the dense backtrace's
        # convention), then the lowest rank
        end_j = (L - 1 - jnp.argmin(masked[:, ::-1], axis=1)).astype(
            jnp.int32)
        end_r = jnp.take_along_axis(bestr, end_j[:, None], axis=1)[:, 0]
        return score, end_r, end_j

    return fn


@functools.lru_cache(maxsize=None)
def _sharded_bounded_scores(window, o, e, x, free_start, mesh,
                            two_piece_params=None):
    """shard_map of the bounded (scores-only) body over dp — the serving
    scorer path; no end-anchor tracking overhead."""
    from jax.sharding import PartitionSpec as PS

    body = _scores_exec_bounded(window, o, e, x, free_start,
                                two_piece_params, vary_axes=("dp",))
    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(PS(),) * 6 + (PS("dp", None), PS("dp"), PS("dp")),
        out_specs=PS("dp"),
    ))


@functools.lru_cache(maxsize=None)
def _sharded_bounded_ends(window, o, e, x, free_start, mesh,
                          two_piece_params=None):
    """shard_map of the bounded-ends body over the mesh's dp axis.

    Graph arrays + end_ok replicate; the batch (qshift/lengths/jlo)
    shards over dp.
    """
    from jax.sharding import PartitionSpec as PS

    body = _scores_exec_bounded_ends(window, o, e, x, free_start,
                                     vary_axes=("dp",),
                                     two_piece_params=two_piece_params)
    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(PS(),) * 6 + (PS("dp", None), PS("dp"), PS("dp")),
        out_specs=(PS("dp"), PS("dp"), PS("dp")),
    ))


def _dp_divides(mesh, qshift) -> bool:
    return (mesh is not None
            and int(qshift.shape[0]) % mesh.shape.get("dp", 1) == 0)


def dp_fill_ends_free_with_ends(dg: DeviceGraph, flat: FlatGraph, qshift,
                                lengths, costs, aln_type, mesh=None):
    """(scores, end_ranks, end_offsets) for an ends-free span.

    The end state is each read's optimal permitted (rank, offset) — the
    anchor for the native corridor backtrace
    (``NativeAligner.align_anchored``); ties resolve to the LARGEST
    offset, then the lowest rank (the same convention as
    ``backtrace_dense_ends_free``).  Two-piece costs run the 5-layer
    recurrence.  With a ``mesh`` whose dp axis divides the batch, the
    batch shards over dp.
    """
    two_piece = getattr(costs, "is_two_piece", False)
    tp_params = ((costs.gap_open2, costs.gap_extend2) if two_piece
                 else None)
    free_start, end_ok, jlo = ends_free_device_params(
        flat, aln_type, lengths, dg.n_nodes_padded, two_piece=two_piece)
    if _dp_divides(mesh, qshift):
        fn = _sharded_bounded_ends(
            dg.window, costs.gap_open, costs.gap_extend, costs.mismatch,
            free_start, mesh, two_piece_params=tp_params)
    else:
        fn = _scores_exec_bounded_ends(dg.window, costs.gap_open,
                                       costs.gap_extend, costs.mismatch,
                                       free_start, two_piece_params=tp_params)
    return fn(dg.symbols, dg.pred_slots, dg.pred_valid, dg.write_slots,
              dg.end_rank, end_ok, qshift, lengths, jlo)


def dp_fill_scores_ends_free(dg: DeviceGraph, flat: FlatGraph, qshift,
                             lengths, costs, aln_type,
                             mesh=None) -> jnp.ndarray:
    """(B,) optimal ends-free scores with Included/Excluded/Unbounded
    bounds on the graph/query free ends (reference:
    ``gap_affine.rs:150-248``).  ``qry_free_begin`` is parsed-but-ignored,
    faithfully to the reference.
    """
    two_piece = getattr(costs, "is_two_piece", False)
    tp_params = ((costs.gap_open2, costs.gap_extend2) if two_piece
                 else None)
    free_start, end_ok, jlo = ends_free_device_params(
        flat, aln_type, lengths, dg.n_nodes_padded, two_piece=two_piece)
    if _dp_divides(mesh, qshift):
        fn = _sharded_bounded_scores(
            dg.window, costs.gap_open, costs.gap_extend, costs.mismatch,
            free_start, mesh, two_piece_params=tp_params)
    else:
        fn = _scores_exec_bounded(dg.window, costs.gap_open,
                                  costs.gap_extend, costs.mismatch,
                                  free_start, tp_params)
    return fn(dg.symbols, dg.pred_slots, dg.pred_valid, dg.write_slots,
              dg.end_rank, end_ok, qshift, lengths, jlo)


def dp_fill_scores(dg: DeviceGraph, qshift: jnp.ndarray, lengths: jnp.ndarray,
                   costs, free_start: bool = False,
                   free_end: bool = False) -> jnp.ndarray:
    """(B,) optimal alignment scores for a packed read batch: the full
    (unbanded) fill as one ``lax.scan`` over ranks.  Two-piece cost
    models run the 5-layer recurrence."""
    if getattr(costs, "is_two_piece", False):
        fn = _scores_exec_2p(dg.window, costs.gap_open, costs.gap_extend,
                             costs.gap_extend2, costs.mismatch,
                             free_start, free_end)
    else:
        fn = _scores_exec(dg.window, costs.gap_open, costs.gap_extend,
                          costs.mismatch, free_start, free_end)
    return fn(dg.symbols, dg.pred_slots, dg.pred_valid, dg.write_slots,
              dg.end_rank, qshift, lengths)


@functools.lru_cache(maxsize=None)
def _full_exec(window: int, o: int, e: int, x: int, free_start: bool):
    @jax.jit
    def fn(symbols, pred_slots, pred_valid, write_slots, end_rank, qshift,
           lengths):
        B, L = qshift.shape
        Np = symbols.shape[0]
        M0 = jnp.full((B, window, L), INF, dtype=jnp.int32)
        D0 = jnp.full((B, window, L), INF, dtype=jnp.int32)
        step = _make_step(window, o, e, x, free_start, "tables",
                          end_rank, qshift, lengths)
        ranks = jnp.arange(Np, dtype=jnp.int32)
        xs = (ranks, symbols, pred_slots, pred_valid, write_slots)
        _, (M, I, D) = jax.lax.scan(step, (M0, D0), xs)
        end_row = jnp.take(M, end_rank, axis=0)  # (B, L)
        idx = lengths.astype(jnp.int32)[:, None]
        scores = jnp.take_along_axis(end_row, idx, axis=1)[:, 0]
        return scores, M, I, D

    return fn


def dp_fill_full(dg: DeviceGraph, qshift: jnp.ndarray, lengths: jnp.ndarray,
                 costs: GapAffine, free_start: bool = False):
    """Full fill: (scores (B,), M, I, D each (Np, B, L)) for host backtrace.

    One-piece gap-affine only: the dense-table recurrence here has a
    single insertion/deletion layer, so silently accepting a two-piece
    cost model would return wrong scores.  Two-piece alignment goes
    through the banded fill + native backtrace instead (see
    ``BatchMapper.align_batch``).
    """
    if getattr(costs, "is_two_piece", False):
        raise NotImplementedError(
            "dp_fill_full implements the one-piece recurrence; use "
            "BatchMapper.align_batch / the banded path for two-piece costs"
        )
    fn = _full_exec(dg.window, costs.gap_open, costs.gap_extend,
                    costs.mismatch, free_start)
    return fn(dg.symbols, dg.pred_slots, dg.pred_valid, dg.write_slots,
              dg.end_rank, qshift, lengths)


# ---------------------------------------------------------------------------
# Host backtrace over dense tables
# ---------------------------------------------------------------------------


def backtrace_dense(flat: FlatGraph, M: np.ndarray, I: np.ndarray, D: np.ndarray,
                    query: bytes, costs: GapAffine) -> Alignment:
    """Reconstruct one optimal alignment from converged dense score tables.

    Same priority rules as the exact engine's backtrace (diagonal first,
    predecessors scanned oldest-edge-first, then deletion closure, then
    insertion closure).  Tables are rank-major: ``M[rank, offset]``.

    Convention (shared with the exact engines and the reference,
    ``gap_affine.rs`` backtrace): a query prefix that aligns as a leading
    insertion run against the virtual start node is NOT emitted as pairs —
    the alignment starts at the first real-node visit.  Consumers that
    need full query coverage (GAF emission, MSA insertion) recover the
    unaligned prefix from the first emitted ``qpos``.
    """
    o, e, x = costs.gap_open, costs.gap_extend, costs.mismatch
    n = len(query)
    end_rank = flat.n_nodes - 1

    def preds(r):
        # CSR stores newest-edge-first; the backtrace scans oldest-first.
        lst = flat.pred_idx[flat.pred_ptr[r] : flat.pred_ptr[r + 1]]
        return list(lst[::-1])

    alignment: Alignment = []
    j = n
    cur = int(M[end_rank, j])
    r = None
    for p in preds(end_rank):
        if int(M[p, j]) == cur:
            r = int(p)
            break
    if r is None:
        raise RuntimeError("dense backtrace: no predecessor for end state")
    state = "M"

    while True:
        cur = int(M[r, j]) if state == "M" else (
            int(D[r, j]) if state == "D" else int(I[r, j])
        )
        step = None
        if state == "M":
            if j > 0:
                sym_match = int(flat.symbols[r]) == query[j - 1]
                want = cur if sym_match else cur - x
                for p in preds(r):
                    if int(M[p, j - 1]) == want:
                        step = (int(p), j - 1, "M")
                        break
            if step is None and int(D[r, j]) == cur:
                step = (r, j, "D")
            if step is None and int(I[r, j]) == cur:
                step = (r, j, "I")
        elif state == "D":
            for p in preds(r):
                if int(M[p, j]) == cur - o - e:
                    step = (int(p), j, "M")
                    break
            if step is None:
                for p in preds(r):
                    if int(D[p, j]) == cur - e:
                        step = (int(p), j, "D")
                        break
        else:  # insertion
            if j > 0:
                if int(M[r, j - 1]) == cur - o - e:
                    step = (r, j - 1, "M")
                elif int(I[r, j - 1]) == cur - e:
                    step = (r, j - 1, "I")

        if step is None:
            break

        bt_r, bt_j, bt_state = step
        if state == "M" and bt_state in ("D", "I"):
            r, j, state = bt_r, bt_j, bt_state
            continue

        node = int(flat.node_of_rank[r])
        if state == "M":
            alignment.append(AlignedPair(node, j - 1))
        elif state == "I":
            alignment.append(AlignedPair(None, j - 1))
        else:
            alignment.append(AlignedPair(node, None))

        if bt_r == 0:  # virtual start node
            break
        r, j, state = bt_r, bt_j, bt_state

    alignment.reverse()
    return alignment


def backtrace_dense_ends_free(flat: FlatGraph, M: np.ndarray, I: np.ndarray,
                              D: np.ndarray, query: bytes, costs: GapAffine,
                              end_ok: np.ndarray, jlo: int,
                              free_start: bool) -> Tuple[int, Alignment]:
    """Ends-free backtrace over converged dense tables.

    Picks the best permitted end state (graph-end mask ``end_ok`` per
    rank, query offsets ``[jlo, n]``; ties prefer the largest offset,
    then the lowest rank — deterministic), walks with the same priority
    rules as :func:`backtrace_dense`, and stops at any origin (the
    global origin, or any zero-score j=0 seed under a free graph
    begin).  The unaligned free suffix/prefix of the query is not
    emitted as pairs (reference convention, ``gap_affine.rs`` ends-free
    backtrace); consumers recover them from the first/last qpos.

    Returns (score, alignment).
    """
    n = len(query)
    end_rank = flat.n_nodes - 1
    # tables may carry bucket-padded rows; the mask's padding entries are 0
    eo = np.asarray(end_ok)[: M.shape[0]].astype(bool)
    lo = max(int(jlo), 0)
    if lo > n or not eo.any():
        raise RuntimeError("ends-free backtrace: unsatisfiable bounds")
    sub = M[eo, :, ][:, lo:n + 1]
    score = int(sub.min())
    if score >= INF:
        raise RuntimeError("ends-free backtrace: no finite end state")
    # best offset (prefer largest), then lowest rank
    ranks_eo = np.flatnonzero(eo)
    best = None
    for j in range(n, lo - 1, -1):
        col = M[eo, j]
        hit = np.flatnonzero(col == score)
        if hit.size:
            best = (int(ranks_eo[hit[0]]), j)
            break
    assert best is not None
    r, j = best

    def preds(r_):
        lst = flat.pred_idx[flat.pred_ptr[r_]: flat.pred_ptr[r_ + 1]]
        return list(lst[::-1])

    alignment: Alignment = []
    if r == end_rank:
        # virtual end: hop to the real predecessor carrying the score
        nr = None
        for p in preds(end_rank):
            if int(M[p, j]) == score:
                nr = int(p)
                break
        if nr is None:
            raise RuntimeError("ends-free backtrace: no pred for end state")
        r = nr
    state = "M"
    o, e, x = costs.gap_open, costs.gap_extend, costs.mismatch

    while True:
        cur = int(M[r, j]) if state == "M" else (
            int(D[r, j]) if state == "D" else int(I[r, j])
        )
        # origin: a zero-score M cell at offset 0 ends the walk — the
        # global origin, or (under a free graph begin) any real rank's
        # j=0 seed.  The entry cell consumes no query char, so nothing
        # more is emitted.
        if state == "M" and j == 0 and cur == 0 and (free_start or r == 0):
            break
        step = None
        if state == "M":
            if j > 0:
                sym_match = int(flat.symbols[r]) == query[j - 1]
                want = cur if sym_match else cur - x
                for p in preds(r):
                    if int(M[p, j - 1]) == want:
                        step = (int(p), j - 1, "M")
                        break
            if step is None and int(D[r, j]) == cur:
                step = (r, j, "D")
            if step is None and int(I[r, j]) == cur:
                step = (r, j, "I")
        elif state == "D":
            for p in preds(r):
                if int(M[p, j]) == cur - o - e:
                    step = (int(p), j, "M")
                    break
            if step is None:
                for p in preds(r):
                    if int(D[p, j]) == cur - e:
                        step = (int(p), j, "D")
                        break
        else:  # insertion
            if j > 0:
                if int(M[r, j - 1]) == cur - o - e:
                    step = (r, j - 1, "M")
                elif int(I[r, j - 1]) == cur - e:
                    step = (r, j - 1, "I")

        if step is None:
            break

        bt_r, bt_j, bt_state = step
        if state == "M" and bt_state in ("D", "I"):
            r, j, state = bt_r, bt_j, bt_state
            continue

        node = int(flat.node_of_rank[r])
        if state == "M":
            alignment.append(AlignedPair(node, j - 1))
        elif state == "I":
            alignment.append(AlignedPair(None, j - 1))
        else:
            alignment.append(AlignedPair(node, None))

        if bt_r == 0:  # virtual start node
            break
        r, j, state = bt_r, bt_j, bt_state

    alignment.reverse()
    return score, alignment


def alignment_cost(graph, query: bytes, alignment: Alignment, costs: GapAffine) -> int:
    """Recompute an alignment's gap-affine cost (validation helper).

    Two-piece models follow the engines' state machine (I->I2 / D->D2 at
    ``gap_extend2``, reference ``gap_affine_2piece.rs:362-408``): a run's
    first char costs open+extend, each further char the cheaper of the
    two extends.
    """
    o, e = costs.gap_open, costs.gap_extend
    cont = e
    if getattr(costs, "is_two_piece", False):
        cont = min(e, costs.gap_extend2)
    total = 0
    prev_state = "M"
    for pair in alignment:
        if pair.is_aligned():
            total += 0 if graph.is_symbol_equal(pair.rpos, query[pair.qpos]) else costs.mismatch
            prev_state = "M"
        elif pair.is_insertion():  # graph node skipped: deletion state
            total += (o + e) if prev_state != "D" else cont
            prev_state = "D"
        else:  # query char unaligned: insertion state
            total += (o + e) if prev_state != "I" else cont
            prev_state = "I"
    return total
