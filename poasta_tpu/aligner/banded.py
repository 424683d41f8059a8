"""Banded wavefront fill: heuristic-bounded offset windows per rank.

The reference's A* touches only states near the optimal path; a dense fill
touches all N·L cells.  This module recovers most of that work-efficiency
on the device while staying vectorized: every rank fills only a fixed-width
window of offsets chosen so that **all states whose completion-cost lower
bound is ≤ UB lie inside the window**.  The lower bound combines
min/max graph distance from the start and to the end (the same bubble
bounds that power the reference's mingap heuristic,
``src/aligner/heuristic.rs:50-103`` / ``src/bubbles/index.rs:133-148``):

    insertions_before ≥ j − ds_max(r)        deletions_before ≥ ds_min(r) − j
    insertions_after  ≥ (n−j) − (de_max(r)−1) deletions_after ≥ (de_min(r)−1) − (n−j)
    bound(r, j) = Σ gap_cost(·)   with gap_cost(k) = o + k·e for k ≥ 1

Exactness: if the computed score S satisfies S ≤ UB, no excluded cell can
lie on a ≤S path (its bound exceeds UB ≥ S), so S is the true optimum.
Otherwise the fill retries with UB doubled (and finally falls back to the
full fill).  Windows are shared across a read batch via the batch's
min/max lengths, so bucketing reads by length keeps bands tight.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as PS

from ..graphs.flat import FlatGraph
from ..ops.banded_fill import (
    banded_scores,
    cuda_banded_exec,
    cuda_fits,
    cuda_width,
    prepare_banded,
    xla_banded_exec,
)
from ..ops.dp_rows import INF
from ..utils import backend
from .costs import GapAffine
from .wavefront import DeviceGraph, dp_fill_scores


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def _free_allowances(aln_type) -> Tuple[bool, int, int]:
    """(free_start, qv, gv): max free query suffix / graph-end distance
    implied by an alignment span (0/0 for Global)."""
    from .costs import EndsFree

    BIG = 1 << 30
    if not isinstance(aln_type, EndsFree):
        return False, 0, 0
    free_start = aln_type.graph_free_begin[0] == "unbounded"
    qk, qval = aln_type.qry_free_end
    qv = BIG if qk == "unbounded" else (
        qval if qk == "included" else max(qval - 1, 0))
    gk, gval = aln_type.graph_free_end
    gv = BIG if gk == "unbounded" else (
        gval if gk == "included" else max(gval - 1, 0))
    return free_start, qv, gv


def band_windows(flat: FlatGraph, n_min: int, n_max: int, costs: GapAffine,
                 ub: int, aln_type=None
                 ) -> Tuple[np.ndarray, int, np.ndarray, np.ndarray]:
    """Per-rank window starts + width covering all bound≤ub cells.

    ``aln_type``: None/Global for the global corridor; an ``EndsFree``
    span relaxes the bound terms — free graph begin drops the
    deletions-before requirement, a free query suffix of qv lowers the
    insertions-after requirement (n -> n - qv), and a free graph end
    within distance gv lowers the deletions-after requirement
    (de_min -> de_min - gv).  Relaxed terms only widen the window toward
    the corners, so exactness (cover all bound<=ub cells) is preserved.

    Returns (wstart (N,), width, lo, hi).
    """
    o, e = costs.gap_open, costs.gap_extend
    if getattr(costs, "is_two_piece", False):
        # cheapest long gap opens piece 1 then extends on piece 2; using
        # e2 throughout over-covers the window (safe: more work, never
        # less exactness)
        e = costs.gap_extend2
    K = max((ub - o) // e, 0) if ub >= o + e else 0
    free_start, qv, gv = _free_allowances(aln_type)

    ds_min = flat.min_dist_from_start.astype(np.int64)
    ds_max = flat.max_dist_from_start.astype(np.int64)
    de_min = flat.min_dist_to_end.astype(np.int64)
    de_max = flat.max_dist_to_end.astype(np.int64)

    lo_terms = [
        np.zeros_like(ds_min),
        (n_min - qv - de_max + 1) - K,
    ]
    if not free_start:
        # with a free graph begin a path may enter at any node, so there
        # is no deletions-before requirement
        lo_terms.append(ds_min - K)
    lo = np.maximum.reduce(lo_terms)
    hi = np.minimum.reduce([
        np.full_like(ds_min, n_max),
        ds_max + K,
        (n_max - np.maximum(de_min - gv, 0) + 1) + K,
    ])
    hi = np.maximum(hi, lo)  # degenerate ranks keep a 1-wide window

    # Widen every window one column left: the device kernels substitute
    # INF for the diagonal predecessor of local column 0 (it lives one
    # column left of the aligned window reads), which is only sound if
    # that column is infeasible.  With lo shifted down by one, every
    # feasible cell sits at local column >= 1 — except global j = 0,
    # which has no diagonal predecessor at all.
    lo = np.maximum(lo - 1, 0)

    width = int((hi - lo + 1).max())
    width = _round_up(max(width, 128), 128)

    wstart = np.minimum(lo, np.maximum(hi - width + 1, 0)).astype(np.int32)
    return wstart, width, lo, hi


def drift_steps_for(n_min: int, n_max: int) -> int:
    """Number of 128-lane drift steps for a batch's length spread,
    quantized to powers of two so the kernel variant count stays bounded."""
    S = (max(n_max - n_min, 0) + 127) // 128
    if S <= 0:
        return 0
    p = 1
    while p < S:
        p <<= 1
    return p


def band_windows_drift(flat: FlatGraph, n_min: int, n_max: int,
                       costs: GapAffine, ub: int, S: int, aln_type=None):
    """Per-rank window starts + width + step schedule for drifted windows.

    Each read's window is the shared per-rank layout shifted right by its
    own drift sigma_b(r) = 128 * floor(nbs_b * s_r / S), where
    nbs_b = round((n_b - n_min)/128) and s_r is the cumulative step count
    at rank r (0 at rank 0, S at the end rank).  The drift absorbs the
    batch's length spread, so the shared width no longer pays
    (n_max - n_min) — the "reads at different diagonals pay each other's
    band width" cost of batch-shared windows.

    Soundness: the per-read drifted corridor [lo_b - sigma_b, hi_b -
    sigma_b] is evaluated exactly at the two length extremes; for
    intermediate lengths every n-dependent term is within +-128 of the
    linear interpolant between the extremes (sigma is a 128-quantized
    linear ramp), so padding the union by 128 on each side covers every
    read.  Windows, width, and the schedule depend only on
    (n_min, n_max, ub) — the prep stays cacheable.

    ``aln_type``: an ``EndsFree`` span relaxes the same bound terms as in
    :func:`band_windows` (free query suffix qv, free graph-end distance
    gv).  Free graph *begin* is not supported here: drift's savings
    mechanism needs diagonal-anchored corridors, and a free begin makes
    them corner-anchored (measured in scripts/drift_endsfree_probe.py) —
    callers route those spans through the shared-window kernels.

    Returns (wstart (N,) int32 multiples of 128, width multiple of 128,
    s_ranks (N,) int32).
    """
    o, e = costs.gap_open, costs.gap_extend
    if getattr(costs, "is_two_piece", False):
        e = costs.gap_extend2
    K = max((ub - o) // e, 0) if ub >= o + e else 0
    free_start, qv, gv = _free_allowances(aln_type)
    assert not free_start, \
        "drift windows do not support free graph begin (corner-anchored)"
    N = flat.n_nodes

    ds_min = flat.min_dist_from_start.astype(np.int64)
    ds_max = flat.max_dist_from_start.astype(np.int64)
    de_min = flat.min_dist_to_end.astype(np.int64)
    de_max = flat.max_dist_to_end.astype(np.int64)

    ranks = np.arange(N, dtype=np.int64)
    s_ranks = (S * ranks) // max(N - 1, 1)
    s_ranks[-1] = S  # end rank carries the full drift
    nbs_max = (n_max - n_min + 64) // 128

    # Evaluate the drifted corridor at every 128-length level — exactly
    # the kernel's drift quantization levels, so there is no cross-level
    # interpolation error.  Within a level all reads share sigma; their
    # lengths vary by <=64 and every lo/hi term has slope in [0, 1] in n,
    # so a +-160 pad covers the level (and near-infeasible boundary reads;
    # levels infeasible by > 192 are excluded — a clamped "phantom"
    # corridor for reads that cannot productively visit a rank would
    # otherwise drag the union wide, re-paying the length spread).
    levels = np.arange(nbs_max + 1, dtype=np.int64)  # (G,)
    n_rep = n_min + 128 * levels  # representative length per level
    sig = 128 * ((levels[:, None] * s_ranks[None, :]) // max(S, 1))  # (G, N)

    lo_g = np.maximum.reduce([
        -sig,
        ds_min[None, :] - K - sig,
        (n_rep[:, None] - qv - de_max[None, :] + 1) - K - sig,
    ])
    hi_g = np.minimum.reduce([
        n_rep[:, None] - sig,
        ds_max[None, :] + K - sig,
        (n_rep[:, None] - np.maximum(de_min[None, :] - gv, 0) + 1) + K - sig,
    ])
    valid = (lo_g - hi_g) <= 192
    BIG = 1 << 40
    lo = np.where(valid, np.minimum(lo_g, hi_g) - 160, BIG).min(axis=0)
    hi = np.where(valid, np.maximum(lo_g, hi_g) + 160, -BIG).max(axis=0)
    # ranks on no level's corridor (unreachable within ub for every
    # length): any 1-wide window is fine — they never carry finite scores
    none_valid = ~valid.any(axis=0)
    fallback = np.clip(ds_min - K, 0, None)
    lo = np.where(none_valid, fallback, lo)
    hi = np.where(none_valid, fallback, hi)
    lo -= 1  # local column 0's INF diagonal substitute (see band_windows)
    hi = np.maximum(hi, lo)

    # NB: wstart is a FRAME coordinate and may go negative (a read's
    # global window is wstart + sigma_b >= lo_b >= 0); cells at global
    # j < 0 stay INF by induction — the origin seed at j == 0 is the only
    # source — so no masking is needed.  Query reads use a static left
    # pad of -min(wstart) zero symbols.
    width = int((hi - lo + 1).max())
    # +128 absorbs the floor-to-128 of wstart below, so wstart+width-1
    # still clears hi at every rank
    width = _round_up(max(width, 128), 128) + 128
    wstart = np.floor_divide(lo, 128) * 128
    return wstart.astype(np.int32), width, s_ranks.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _banded_exec_drift_2p(window: int, Wb: int, P: int, o1: int, e1: int,
                          e2: int, x: int, S: int, vary_axes: tuple = ()):
    """Two-piece drifting-window banded scores kernel (XLA body).

    Same frame mechanics as the one-piece drift body
    (``ops.banded_fill.xla_banded_exec`` with ``S > 0``) with the 5-state
    recurrence; the coupled (I1, I2) min-plus scan is offset-independent,
    so the drift needs no sigma term inside the insertion math.
    """
    from ..ops.dp_rows_2p import insertion_rows_2p

    @jax.jit
    def fn(symbols, pred_slots_ranks, pred_valid, wstarts, write_slots,
           end_rank, s_ranks, qpad, lengths, n_min_s, mq):
        B = qpad.shape[0]
        Np = symbols.shape[0]
        lengths_i = lengths.astype(jnp.int32)
        nbs_i = jnp.maximum(lengths_i - n_min_s + 64, 0) // 128

        ring0 = jnp.full((B, window, Wb), INF, dtype=jnp.int32)
        if vary_axes:
            ring0 = jax.lax.pcast(ring0, vary_axes, to="varying")

        jloc = jnp.arange(Wb, dtype=jnp.int32)

        def window_rows(ring, pred_ranks, w_r, p):
            pr = pred_ranks[p]
            slot = jnp.take(write_slots, pr)
            w_p = jnp.take(wstarts, pr)
            delta = w_r - w_p
            row = jax.lax.dynamic_index_in_dim(ring, slot, 1,
                                               keepdims=False)
            pad = jnp.concatenate(
                [jnp.full((B, Wb), INF, jnp.int32), row,
                 jnp.full((B, Wb), INF, jnp.int32)], axis=1)
            start = jnp.clip(delta + Wb, 0, 2 * Wb)
            return jax.lax.dynamic_slice_in_dim(pad, start, Wb, axis=1)

        def step(carry, xs):
            M_ring, D1_ring, D2_ring, qcur = carry
            rank, sym, pred_ranks, valid, w_r, wslot, s_r, s_p = xs
            sig_now = 128 * ((nbs_i * s_r) // S)
            sig_prev = 128 * ((nbs_i * s_p) // S)
            stepped = sig_now > sig_prev

            def roll128(t):
                return jnp.concatenate(
                    [t[..., 128:],
                     jnp.full(t.shape[:-1] + (128,), INF, jnp.int32)],
                    axis=-1)

            qroll = jnp.concatenate(
                [qcur[:, 128:], jnp.zeros((B, 128), qcur.dtype)], axis=1)
            qcur = jnp.where(stepped[:, None], qroll, qcur)
            M_ring = jnp.where(stepped[:, None, None], roll128(M_ring),
                               M_ring)
            D1_ring = jnp.where(stepped[:, None, None], roll128(D1_ring),
                                D1_ring)
            D2_ring = jnp.where(stepped[:, None, None], roll128(D2_ring),
                                D2_ring)

            min_pm = jnp.full((B, Wb), INF, dtype=jnp.int32)
            min_pd1 = jnp.full((B, Wb), INF, dtype=jnp.int32)
            min_pd2 = jnp.full((B, Wb), INF, dtype=jnp.int32)
            for p in range(P):
                keep = valid[p]
                am = window_rows(M_ring, pred_ranks, w_r, p)
                ad1 = window_rows(D1_ring, pred_ranks, w_r, p)
                ad2 = window_rows(D2_ring, pred_ranks, w_r, p)
                min_pm = jnp.minimum(min_pm, jnp.where(keep, am, INF))
                min_pd1 = jnp.minimum(min_pd1, jnp.where(keep, ad1, INF))
                min_pd2 = jnp.minimum(min_pd2, jnp.where(keep, ad2, INF))

            D1 = jnp.minimum(jnp.minimum(min_pm + o1 + e1, min_pd1 + e1),
                             INF)
            D2 = jnp.minimum(jnp.minimum(min_pd1, min_pd2) + e2, INF)

            diag_src = jnp.concatenate(
                [jnp.full((B, 1), INF, jnp.int32), min_pm[:, :-1]], axis=1)
            qwin = jax.lax.dynamic_slice_in_dim(qcur, w_r + mq, Wb, axis=1)
            match_cost = jnp.where(qwin == sym, jnp.int32(0), jnp.int32(x))
            diag = jnp.minimum(diag_src + match_cost, INF)

            A = jnp.minimum(diag, jnp.minimum(D1, D2))
            j32 = w_r + jloc[None, :] + sig_now[:, None]
            is_start = rank == 0
            origin = jnp.logical_and(is_start, j32 == 0)
            A = jnp.minimum(A, jnp.where(origin, jnp.int32(0), INF))

            I1, I2 = insertion_rows_2p(A, o1, e1, 0, e2)
            M = jnp.minimum(A, jnp.minimum(I1, I2))

            is_end = rank == end_rank
            M = jnp.where(is_end, min_pm, M)
            D1 = jnp.where(is_end, INF, D1)
            D2 = jnp.where(is_end, INF, D2)

            M_ring = jax.lax.dynamic_update_index_in_dim(M_ring, M,
                                                         wslot, 1)
            D1_ring = jax.lax.dynamic_update_index_in_dim(D1_ring, D1,
                                                          wslot, 1)
            D2_ring = jax.lax.dynamic_update_index_in_dim(D2_ring, D2,
                                                          wslot, 1)

            idx_loc = lengths_i - w_r - sig_now
            in_range = jnp.logical_and(idx_loc >= 0, idx_loc < Wb)
            idx_c = jnp.clip(idx_loc, 0, Wb - 1)[:, None]
            at_len = jnp.take_along_axis(M, idx_c, axis=1)[:, 0]
            at_len = jnp.where(in_range, at_len, INF)
            at_len = jnp.where(is_end, at_len, INF)
            return (M_ring, D1_ring, D2_ring, qcur), at_len

        ranks = jnp.arange(Np, dtype=jnp.int32)
        s_prev_ranks = jnp.concatenate([jnp.zeros((1,), s_ranks.dtype),
                                        s_ranks[:-1]])
        xs = (ranks, symbols, pred_slots_ranks, pred_valid, wstarts,
              write_slots, s_ranks, s_prev_ranks)
        _, at_len = jax.lax.scan(step, (ring0, ring0, ring0, qpad), xs)
        return jnp.min(at_len, axis=0)

    return fn


@functools.lru_cache(maxsize=None)
def _banded_exec_2p(window: int, Wb: int, P: int, o1: int, e1: int, e2: int,
                    x: int, vary_axes: tuple = ()):
    """Two-piece banded scores kernel: rings hold (B, W, Wb) windows for
    M, D1, D2; the coupled (I1, I2) window chains run via the min-plus
    associative scan (maps are j-independent, so they work on any
    contiguous window — chains truncate at the window's left edge, which
    matches band exactness: every cell of a <=ub path is in-band)."""
    from ..ops.dp_rows_2p import insertion_rows_2p

    @jax.jit
    def fn(symbols, pred_slots_ranks, pred_valid, wstarts, write_slots,
           end_rank, qshift, lengths):
        B, L = qshift.shape
        Np = symbols.shape[0]
        lengths_i = lengths.astype(jnp.int32)

        ring0 = jnp.full((B, window, Wb), INF, dtype=jnp.int32)
        if vary_axes:
            ring0 = jax.lax.pcast(ring0, vary_axes, to="varying")
        carry0 = (ring0, ring0, ring0)

        jloc = jnp.arange(Wb, dtype=jnp.int32)

        def window_rows(ring, pred_ranks, valid, w_r, p):
            pr = pred_ranks[p]
            slot = jnp.take(write_slots, pr)
            w_p = jnp.take(wstarts, pr)
            delta = w_r - w_p
            row = jax.lax.dynamic_index_in_dim(ring, slot, 1, keepdims=False)
            pad = jnp.concatenate(
                [jnp.full((B, Wb), INF, jnp.int32), row,
                 jnp.full((B, Wb), INF, jnp.int32)], axis=1)
            start = jnp.clip(delta + Wb, 0, 2 * Wb)
            return jax.lax.dynamic_slice_in_dim(pad, start, Wb, axis=1)

        def step(carry, xs):
            M_ring, D1_ring, D2_ring = carry
            rank, sym, pred_ranks, valid, w_r, wslot = xs
            j_global = w_r + jloc

            min_pm = jnp.full((B, Wb), INF, dtype=jnp.int32)
            min_pd1 = jnp.full((B, Wb), INF, dtype=jnp.int32)
            min_pd2 = jnp.full((B, Wb), INF, dtype=jnp.int32)
            for p in range(P):
                keep = valid[p]
                am = window_rows(M_ring, pred_ranks, valid, w_r, p)
                ad1 = window_rows(D1_ring, pred_ranks, valid, w_r, p)
                ad2 = window_rows(D2_ring, pred_ranks, valid, w_r, p)
                min_pm = jnp.minimum(min_pm, jnp.where(keep, am, INF))
                min_pd1 = jnp.minimum(min_pd1, jnp.where(keep, ad1, INF))
                min_pd2 = jnp.minimum(min_pd2, jnp.where(keep, ad2, INF))

            D1 = jnp.minimum(jnp.minimum(min_pm + o1 + e1, min_pd1 + e1), INF)
            D2 = jnp.minimum(jnp.minimum(min_pd1, min_pd2) + e2, INF)

            diag_src = jnp.concatenate(
                [jnp.full((B, 1), INF, jnp.int32), min_pm[:, :-1]], axis=1)
            qwin = jax.lax.dynamic_slice_in_dim(qshift, w_r, Wb, axis=1)
            match_cost = jnp.where(qwin == sym, jnp.int32(0), jnp.int32(x))
            diag = jnp.minimum(diag_src + match_cost, INF)

            A = jnp.minimum(diag, jnp.minimum(D1, D2))
            is_start = rank == 0
            origin = jnp.logical_and(is_start, j_global[None, :] == 0)
            A = jnp.minimum(A, jnp.where(origin, jnp.int32(0), INF))

            I1, I2 = insertion_rows_2p(A, o1, e1, 0, e2)
            M = jnp.minimum(A, jnp.minimum(I1, I2))

            is_end = rank == end_rank
            M = jnp.where(is_end, min_pm, M)
            D1 = jnp.where(is_end, INF, D1)
            D2 = jnp.where(is_end, INF, D2)

            M_ring = jax.lax.dynamic_update_index_in_dim(M_ring, M, wslot, 1)
            D1_ring = jax.lax.dynamic_update_index_in_dim(D1_ring, D1, wslot, 1)
            D2_ring = jax.lax.dynamic_update_index_in_dim(D2_ring, D2, wslot, 1)

            idx_loc = lengths_i - w_r
            in_range = jnp.logical_and(idx_loc >= 0, idx_loc < Wb)
            idx_c = jnp.clip(idx_loc, 0, Wb - 1)[:, None]
            at_len = jnp.take_along_axis(M, idx_c, axis=1)[:, 0]
            at_len = jnp.where(in_range, at_len, INF)
            at_len = jnp.where(is_end, at_len, INF)
            return (M_ring, D1_ring, D2_ring), at_len

        ranks = jnp.arange(Np, dtype=jnp.int32)
        xs = (ranks, symbols, pred_slots_ranks, pred_valid, wstarts,
              write_slots)
        _, at_len = jax.lax.scan(step, carry0, xs)
        return jnp.min(at_len, axis=0)

    return fn


class BandedScorer:
    """Exact banded scorer with verify-and-retry.

    Usage: ``BandedScorer(flat, costs).scores(qshift, lengths)``.
    """

    def __init__(self, flat: FlatGraph, costs: GapAffine,
                 node_bucket: int = 64, mesh=None, dg=None, aln_type=None):
        """``mesh``: optional jax.sharding.Mesh with a ``dp`` axis — the
        read batch shards over it (graph/window arrays replicate; the
        banded fill has no cross-read dependence, so dp needs no
        collectives).  ``dg``: an existing DeviceGraph for the same flat
        graph, to skip the rebuild/upload.  ``aln_type``: None/Global for
        global alignment; an ``EndsFree`` span routes through the
        ends-free banded fills (bounded or unbounded free ends; reference
        ``gap_affine.rs:150-248``).  Ends-free does not shard over a
        mesh.
        """
        from .costs import EndsFree

        self.flat = flat
        self.costs = costs
        self.mesh = mesh
        self.aln_type = aln_type
        self.ends_free = isinstance(aln_type, EndsFree)
        if self.ends_free and mesh is not None:
            raise NotImplementedError(
                "ends-free banded scoring does not shard over a mesh yet; "
                "use mesh=None (or dp_fill_scores_ends_free for full "
                "fills)"
            )
        self.executor = backend.fill_executor()
        self.dg = dg if dg is not None \
            else DeviceGraph.build(flat, node_bucket=node_bucket)
        # predecessor RANK table for the two-piece bodies (they re-derive
        # ring slots and window starts from it)
        self._pred_ranks = jnp.asarray(self.dg.pred_ranks_np)
        # window layouts and their device tables, keyed by
        # (kind, n_min, n_max, ub, mesh, L): re-uploading them per call
        # would put a host->device copy on the dispatch path
        self._prep_cache: dict = {}
        # last ub that verified, per (n_min, n_max): starting each call at
        # the default guess would re-pay every failed attempt of the
        # verify-and-retry loop on every call
        self._ub_hint: dict = {}
        # (id -> (array ref, (n_min, n_max))): see scores() for why the
        # array reference is pinned
        self._lenstats: dict = {}
        # ((id, mq, padded_L) -> (array ref, padded array)): same pinning
        self._qpad: dict = {}
        # observability counters (the wavefront analogue of the exact
        # engines' num_queued/visited/pruned; SURVEY §5): cumulative
        # across calls, reset with reset_stats().  xla_fills: banded
        # fills a GPU served with the XLA body (two-piece costs, layouts
        # past the CUDA kernel's shared-memory budget).
        self.stats = {"fills": 0, "cells_filled": 0, "tiers": 0,
                      "fullfill_fallbacks": 0, "xla_fills": 0}
        # dp-sharded full-fill score fn, built lazily on first mesh-mode
        # fallback to the full fill
        self._mesh_fullfill_fn = None
        # (id -> (lengths ref, jlo)) per-batch ends-free query windows
        self._ef_jlo: dict = {}

    # modeled fixed cost per device fill (dispatch + gathers), in cells.
    # Biases the tier choice toward fewer fills unless the band savings
    # are substantial.  Not yet re-measured on the GPU.
    TIER_OVERHEAD_CELLS = 1_000_000_000

    def reset_stats(self) -> None:
        for k in self.stats:
            self.stats[k] = 0

    def _ef_params(self, lengths):
        """(free_start, end_ok (device), jlo (device)) for the scorer's
        EndsFree span; end_ok is static per scorer, jlo per lengths
        array (cached by identity like the length stats)."""
        from .wavefront import ends_free_device_params

        cached = self._prep_cache.get(("ef_static",))
        if cached is None:
            fs, end_ok, _ = ends_free_device_params(
                self.flat, self.aln_type, jnp.zeros(1, jnp.int32),
                self.dg.n_nodes_padded,
                two_piece=getattr(self.costs, "is_two_piece", False))
            cached = (fs, end_ok)
            self._prep_cache[("ef_static",)] = cached
        fs, end_ok = cached
        ent = self._ef_jlo.get(id(lengths))
        if ent is None or ent[0] is not lengths:
            _, _, jlo = ends_free_device_params(
                self.flat, self.aln_type, lengths, self.dg.n_nodes_padded,
                two_piece=getattr(self.costs, "is_two_piece", False))
            self._ef_jlo[id(lengths)] = (lengths, jlo)
            while len(self._ef_jlo) > 8:  # LRU-bounded like _lenstats
                self._ef_jlo.pop(next(iter(self._ef_jlo)))
        else:
            jlo = ent[1]
        return fs, end_ok, jlo

    def _executor(self, width: int, two_piece: bool) -> str:
        """Executor of one banded fill, chosen from the shapes alone: the
        CUDA kernel where it serves, else the XLA body (counted in
        ``stats["xla_fills"]`` on a GPU)."""
        if self.executor != "cuda":
            return "xla"
        if not two_piece and cuda_fits(self.dg.window, width):
            return "cuda"
        self.stats["xla_fills"] += 1
        return "xla"

    def _clamps(self, L: int, two_piece: bool) -> bool:
        """Whether a band as wide as the row runs clamped to full width
        (exact, every offset in-window) instead of the full fill: only
        where the CUDA kernel serves it; elsewhere the full fill is
        cheaper."""
        return (self.executor == "cuda" and not two_piece
                and cuda_fits(self.dg.window, cuda_width(L)))

    @staticmethod
    def _pad_rows(n: int) -> int:
        """Rows a retry tail of ``n`` reads is padded to: the next power of
        two, so tails of varying sizes reuse a bounded set of compiled
        fills."""
        if n <= 0:
            return n
        v = 1
        while v < n:
            v <<= 1
        return v

    def _padded_query(self, q_in_key, qshift, mq: int, req: int):
        """``qshift`` with ``mq`` zero lanes on the left and zero lanes on
        the right up to ``req`` columns, cached by the source array's
        identity (entries pin it, so a recycled id() can never surface
        another batch's padding)."""
        L = int(qshift.shape[1])
        if not mq and req <= L:
            return qshift
        key = (id(q_in_key), mq, req) if q_in_key is not None else None
        entry = self._qpad.get(key) if key else None
        if entry is not None and entry[0] is q_in_key:
            return entry[1]
        B = int(qshift.shape[0])
        parts = [qshift]
        if mq:
            parts.insert(0, jnp.zeros((B, mq), qshift.dtype))
        if req > L:
            parts.append(jnp.zeros((B, req - L), qshift.dtype))
        q_in = jnp.concatenate(parts, axis=1)
        if key:
            self._qpad[key] = (q_in_key, q_in)
            while len(self._qpad) > 8:
                self._qpad.pop(next(iter(self._qpad)))
        return q_in

    def _tables(self, key, wstart, width, s_ranks=None, S=0):
        tkey = key + ("tables",)
        tables = self._prep_cache.get(tkey)
        if tables is None:
            tables = prepare_banded(self.dg, wstart, width, s_ranks, S)
            self._prep_cache[tkey] = tables
        return tables

    def _sharded(self, fn, key, in_specs):
        """shard_map a banded body over the mesh's dp axis.

        Graph and window tables replicate; each shard fills its own reads
        independently (lasagna's data parallelism, ``lasagna.rs:214-273``,
        as a mesh axis) — no collectives run inside the fill.
        """
        skey = key + ("sharded",)
        sfn = self._prep_cache.get(skey)
        if sfn is None:
            sfn = jax.jit(jax.shard_map(fn, mesh=self.mesh,
                                        in_specs=in_specs,
                                        out_specs=PS("dp")))
            self._prep_cache[skey] = sfn
        return sfn

    def _one_piece_fill(self, key, tables, q_in, lengths, use_mesh, n_min=0,
                        mq=0):
        costs = self.costs
        ex = self._executor(tables.width, False)
        if not use_mesh:
            ends = self._ef_params(lengths) if self.ends_free else None
            return np.asarray(banded_scores(
                ex, self.dg, tables, q_in, lengths, costs, ends=ends,
                n_min=n_min, mq=mq))
        # each shard fills its own reads with the executor chosen above
        # (global spans only: ends-free scorers take no mesh)
        s_ranks = tables.s_ranks if tables.S else tables.wstarts
        head = (self.dg.symbols, self.dg.pred_slots, tables.pred_valid,
                tables.pred_wstarts, tables.wstarts, self.dg.write_slots)
        if ex == "cuda":
            fn = cuda_banded_exec(self.dg.n_nodes, self.dg.window,
                                  tables.width, costs.gap_open,
                                  costs.gap_extend, costs.mismatch,
                                  tables.S, int(mq), int(n_min), False,
                                  False)
            sfn = self._sharded(fn, key, (PS(),) * 8 + (
                PS("dp", None), PS("dp"), PS("dp")))
            return np.asarray(sfn(*head, tables.wstarts, s_ranks, q_in,
                                  lengths, lengths))
        fn = xla_banded_exec(self.dg.window, tables.width,
                             int(self.dg.pred_slots.shape[1]),
                             costs.gap_open, costs.gap_extend,
                             costs.mismatch, tables.S, vary_axes=("dp",))
        sfn = self._sharded(fn, key, (PS(),) * 9 + (
            PS("dp", None), PS("dp"), PS("dp"), PS(), PS()))
        return np.asarray(sfn(
            *head, self.dg.end_rank, tables.wstarts, s_ranks, q_in, lengths,
            lengths, jnp.asarray(n_min, jnp.int32),
            jnp.asarray(mq, jnp.int32)))

    def _full_scores(self, qshift, lengths) -> np.ndarray:
        """Full (unbanded) fill scores; dp-sharded over the mesh when the
        batch divides — the full-fill fallback is the common path for
        short-read profiles and parallelizes exactly like the banded fill
        (no collectives)."""
        if self.ends_free:
            from .wavefront import dp_fill_scores_ends_free

            return np.asarray(dp_fill_scores_ends_free(
                self.dg, self.flat, qshift, lengths, self.costs,
                self.aln_type))
        if (self.mesh is not None
                and int(qshift.shape[0]) % self.mesh.shape.get("dp", 1) == 0
                and not getattr(self.costs, "is_two_piece", False)):
            if self._mesh_fullfill_fn is None:
                from ..parallel.mapper import make_sharded_score_fn

                self._mesh_fullfill_fn = make_sharded_score_fn(
                    self.dg, self.costs, self.mesh)
            return np.asarray(self._mesh_fullfill_fn(qshift, lengths))
        return np.asarray(dp_fill_scores(self.dg, qshift, lengths, self.costs))

    # minimum batch length spread before drifting windows pay: the drift
    # layout carries ~384 lanes of soundness padding over the shared one
    DRIFT_MIN_SPREAD = 512

    def _fill_once_drift(self, q_in_key, qshift, lengths, ub, n_min, n_max,
                         use_mesh):
        """One banded fill with per-read drifting windows.

        Returns banded scores, or None when drift doesn't apply (spread
        too small, band as wide as the full fill, or width not better
        than the shared layout would be).
        """
        costs = self.costs
        two_piece = getattr(costs, "is_two_piece", False)
        S = drift_steps_for(n_min, n_max)
        # the bodies roll frames exactly 128 lanes per stepped rank, so
        # the schedule must increment at most once per rank: S <= N-1
        # (graphs shorter than the length spread fall back to shared
        # windows)
        if S == 0 or S > self.flat.n_nodes - 1:
            return None
        if self.ends_free and (two_piece
                               or _free_allowances(self.aln_type)[0]):
            # no two-piece drift-ef body; a free graph begin makes the
            # corridors corner-anchored, which drift cannot narrow
            # (measured: scripts/drift_endsfree_probe.py)
            return None
        L = int(qshift.shape[1])
        key = ("drift", n_min, n_max, ub, use_mesh, L)
        cached = self._prep_cache.get(key)
        if cached is None:
            wstart, width, s_ranks = band_windows_drift(
                self.flat, n_min, n_max, costs, ub, S,
                aln_type=self.aln_type)
            # the shared layout runs the same bodies at the same per-cell
            # speed; drift only pays when it is genuinely narrower
            shared_width = band_windows(self.flat, n_min, n_max, costs,
                                        ub, aln_type=self.aln_type)[1]
            if self.executor == "cuda":
                width = cuda_width(width)
            if width >= shared_width or width >= L:
                cached = (None,)
            else:
                mq = int(_round_up(max(0, -int(wstart.min())), 128))
                cached = (width, mq, wstart, s_ranks)
            self._prep_cache[key] = cached
        if cached[0] is None:
            return None
        width, mq, wstart, s_ranks = cached
        self._last_fill_width = width
        req = _round_up(int(wstart.max()) + width, 128)
        q_in = self._padded_query(q_in_key, qshift, mq, max(req, L))
        tables = self._tables(key, wstart, width, s_ranks, S)
        if not two_piece:
            return self._one_piece_fill(key, tables, q_in, lengths,
                                        use_mesh, n_min=n_min, mq=mq)
        self._executor(width, True)
        fn = _banded_exec_drift_2p(self.dg.window, width,
                                   int(self._pred_ranks.shape[1]),
                                   costs.gap_open, costs.gap_extend,
                                   costs.gap_extend2, costs.mismatch, S,
                                   vary_axes=("dp",) if use_mesh else ())
        if use_mesh:
            fn = self._sharded(fn, key, (PS(),) * 7 + (
                PS("dp", None), PS("dp"), PS(), PS()))
        return np.asarray(
            fn(self.dg.symbols, self._pred_ranks, self.dg.pred_valid,
               tables.wstarts, self.dg.write_slots, self.dg.end_rank,
               tables.s_ranks, q_in, lengths,
               jnp.asarray(n_min, dtype=jnp.int32),
               jnp.asarray(mq, dtype=jnp.int32)))

    def _fill_once(self, q_in_key, qshift, lengths, ub, n_min, n_max,
                   use_mesh, two_piece):
        """One banded fill of the given batch at the given ub.

        Returns the (possibly over-estimated) banded scores as a numpy
        array, or None when the band would be as wide as the full fill
        and is not clamped (see :meth:`_clamps`).  ``q_in_key``: the
        original batch array (pins the padding-cache entry), or None to
        skip caching (sub-batches).
        """
        costs = self.costs
        L = int(qshift.shape[1])
        key = ("band", n_min, n_max, ub, use_mesh, L)
        cached = self._prep_cache.get(key)
        if cached is None:
            wstart, width, _, _ = band_windows(self.flat, n_min, n_max,
                                               costs, ub,
                                               aln_type=self.aln_type)
            if self.executor == "cuda":
                width = cuda_width(width)
            if width >= L:
                if self._clamps(L, two_piece):
                    # "band as wide as the full fill": degenerate but
                    # EXACT with zeroed window starts (every offset is
                    # in-window)
                    wstart, width = np.zeros_like(wstart), cuda_width(L)
                else:
                    wstart = None
            cached = (wstart, width)
            self._prep_cache[key] = cached
        wstart, width = cached
        if wstart is None:
            return None
        self._last_fill_width = width  # for the cells-filled counter
        # full-width windows compute every cell: callers may accept the
        # scores as exact without the <=ub verification
        self._last_fill_exact = width >= L and int(wstart.max()) == 0
        req = _round_up(int(wstart.max()) + width, 128)
        q_in = self._padded_query(q_in_key, qshift, 0, req)
        tables = self._tables(key, wstart, width)
        if not two_piece:
            return self._one_piece_fill(key, tables, q_in, lengths,
                                        use_mesh)
        self._executor(width, True)
        fn = _banded_exec_2p(self.dg.window, width,
                             int(self._pred_ranks.shape[1]),
                             costs.gap_open, costs.gap_extend,
                             costs.gap_extend2, costs.mismatch,
                             vary_axes=("dp",) if use_mesh else ())
        if use_mesh:
            fn = self._sharded(fn, key, (PS(),) * 6 + (PS("dp", None),
                                                       PS("dp")))
        return np.asarray(
            fn(self.dg.symbols, self._pred_ranks, self.dg.pred_valid,
               tables.wstarts, self.dg.write_slots, self.dg.end_rank,
               q_in, lengths))

    def scores(self, qshift, lengths, ub: Optional[int] = None,
               max_retries: int = 4) -> np.ndarray:
        """Exact scores with tiered verify-and-retry.

        Reads whose banded score verifies at the current ub are done (the
        band provably contains their optimal path); only the unresolved
        reads re-fill at a wider band — so per-read work scales with that
        read's own score, the batch analogue of the reference A*'s
        work-proportional-to-score property.
        """
        costs = self.costs
        # lengths is usually a device array; np.asarray would put a
        # device->host round trip on every call, so cache min/max by array
        # identity.  The cache entry holds a strong reference to the array
        # so its id() cannot be recycled while cached (a stale hit would
        # give wrong length bounds and silently void the band-exactness
        # argument); a small LRU bounds the pinned memory.
        entry = self._lenstats.get(id(lengths))
        if entry is None or entry[0] is not lengths:
            lengths_np = np.asarray(lengths)
            entry = (lengths, (int(lengths_np.min()), int(lengths_np.max())),
                     lengths_np)
            self._lenstats[id(lengths)] = entry
            while len(self._lenstats) > 8:
                self._lenstats.pop(next(iter(self._lenstats)))
        n_min, n_max = entry[1]
        lengths_np = entry[2]
        two_piece = getattr(costs, "is_two_piece", False)
        # drift applies to global spans and to bounded ends-free spans
        # (diagonal-anchored); free graph begins are corner-anchored and
        # two-piece ends-free has no drift kernel — both fall to shared
        # windows / the bounded full fill
        drift_ok = not (self.ends_free and (
            two_piece or _free_allowances(self.aln_type)[0]))
        drift_eligible = (
            drift_ok
            and n_max - n_min >= self.DRIFT_MIN_SPREAD
        )
        if ub is None:
            guess = ((costs.gap_open + costs.gap_extend) * 4
                     + costs.mismatch * max(n_max // 16, 4))
            if not drift_eligible and not self.ends_free:
                # shared windows must absorb the length spread in the
                # band, so the score guess carries it; drifted windows
                # don't (each read rides its own diagonal), and free
                # ends absorb length mismatch at no cost
                guess += costs.gap_extend * (n_max - n_min)
            ub = self._ub_hint.get((n_min, n_max)) or guess

        # with a mesh, the read batch shards over dp via shard_map around
        # the banded fill (one fill per shard; no collectives);
        # subset gathers would break dp divisibility, so mesh mode retries
        # the whole batch instead of tiering
        use_mesh = (
            self.mesh is not None
            and int(qshift.shape[0]) % self.mesh.shape.get("dp", 1) == 0
        )

        if two_piece and self.ends_free:
            # no two-piece ends-free banded kernel yet: bounded full fill
            # (XLA 5-layer recurrence) keeps the capability complete
            self.stats["fills"] += 1
            self.stats["cells_filled"] += (
                self.flat.n_nodes * int(qshift.shape[1])
                * int(qshift.shape[0])
            )
            return self._full_scores(qshift, lengths)

        if self._prep_cache.get(("fullfill", n_min, n_max)):
            # banding already proved unprofitable for this length profile
            self.stats["fills"] += 1
            self.stats["cells_filled"] += (
                self.flat.n_nodes * int(qshift.shape[1]) * int(qshift.shape[0])
            )
            return self._full_scores(qshift, lengths)

        B = int(qshift.shape[0])
        out = np.empty(B, dtype=np.int32)
        resolved = np.zeros(B, dtype=bool)
        map_idx = np.arange(B)  # out positions of the current sub-batch
        q_cur, l_cur = qshift, lengths
        q_cur_key = qshift
        tiers = []  # (ub, newly_resolved) per attempt
        self.last_attempts = 0

        # sub-batch length stats: retry tails re-derive their own
        # (n_min, n_max) so the tail's windows don't pay the full batch's
        # length spread
        cur_n_min, cur_n_max = n_min, n_max
        for attempt in range(max_retries):
            sub = None
            self._last_fill_exact = False  # set only by _fill_once
            if (drift_ok
                    and cur_n_max - cur_n_min >= self.DRIFT_MIN_SPREAD):
                # per-read drifting windows: width stops paying the
                # batch's length spread; engages
                # only when genuinely narrower than the shared layout
                sub = self._fill_once_drift(q_cur_key, q_cur, l_cur, ub,
                                            cur_n_min, cur_n_max, use_mesh)
            if sub is None:
                sub = self._fill_once(q_cur_key, q_cur, l_cur, ub,
                                      cur_n_min, cur_n_max, use_mesh,
                                      two_piece)
            if sub is None:
                break  # no applicable banded engine for this shape
            self.last_attempts += 1
            self.stats["fills"] += 1
            self.stats["tiers"] += 1
            self.stats["cells_filled"] += (
                self.flat.n_nodes * self._last_fill_width
                * int(q_cur.shape[0])
            )
            if getattr(self, "_last_fill_exact", False):
                # full-width windows: scores are exact regardless of ub
                done = np.ones_like(sub, dtype=bool)
            else:
                done = sub <= ub
            out[map_idx[done]] = sub[done]
            # count only newly-resolved reads: mesh mode retries the whole
            # batch, so earlier tiers' reads verify again at later tiers
            new_mask = np.zeros(B, dtype=bool)
            new_mask[map_idx[done]] = True
            tiers.append((ub, int((new_mask & ~resolved).sum())))
            resolved |= new_mask
            if done.all():
                # Pick the starting tier for future calls by modeled cost:
                # first-fill work is width(tier) x B, plus the unresolved
                # tail refilled at the final tier's width (padded as
                # _pad_rows pads retry tails).  Clustered score
                # distributions choose the final tier (one fill);
                # heavy-tailed ones keep the bulk in narrow bands.
                def _width_of(u):
                    return band_windows(self.flat, n_min, n_max, costs, u,
                                        aln_type=self.aln_type)[1]

                _pad = self._pad_rows

                # Model the cost of starting future calls at tier i as the
                # observed remainder of the ladder: the tier-i fill runs
                # the whole batch, each later observed tier refills its
                # (padded) unresolved tail.  Per-fill overhead (dispatch +
                # gathers ~ TIER_OVERHEAD_CELLS) biases toward fewer fills.
                ov = self.TIER_OVERHEAD_CELLS / max(self.flat.n_nodes, 1)
                widths = [_width_of(t) for t, _ in tiers]
                counts = [c for _, c in tiers]
                best_ub, best_cost = tiers[-1][0], None
                for i in range(len(tiers)):
                    cum = sum(counts[: i + 1])
                    cost = widths[i] * B + ov
                    for j in range(i + 1, len(tiers)):
                        cost += widths[j] * _pad(B - cum) + ov
                        cum += counts[j]
                    if best_cost is None or cost < best_cost:
                        best_ub, best_cost = tiers[i][0], cost
                self._ub_hint[(n_min, n_max)] = best_ub
                return out
            rem = map_idx[~done]
            # Banded scores are upper bounds (the band only removes
            # paths): ub = max remaining banded score is guaranteed to
            # verify those reads next attempt — but a too-narrow band can
            # over-estimate wildly, so grow geometrically, capped by it.
            finite = sub[~done][sub[~done] < INF]
            grown = max(ub * 2, ub + 256)
            ub = min(int(finite.max()), grown) if finite.size else grown * 2
            # Per-read ub seeds: each unresolved read's own banded score
            # is a valid ub for it (bands only remove paths, so a wider
            # band can only lower its score below the seed and verify).
            # When the tail's score spread is wide, refilling everyone at
            # max-score width wastes the narrow reads' cells — model the
            # cost of stopping this tier at a score quantile (narrow bulk
            # verifies now, wide residue pays one more fill) vs one
            # max-width fill, including per-fill dispatch overhead, and
            # take the cheaper ladder.  Needs >=2 attempts of headroom so
            # the residue still verifies inside the retry budget.
            if (finite.size >= 4 and attempt + 3 <= max_retries
                    and not use_mesh):
                fs = np.sort(finite.astype(np.int64))
                cand_q = int(fs[int(len(fs) * 0.75)])
                top = int(fs[-1])
                if cand_q > ub // 2 and cand_q < top:
                    def _w(u):
                        return band_windows(self.flat, cur_n_min, cur_n_max,
                                            costs, u,
                                            aln_type=self.aln_type)[1]

                    n_above = int((fs > cand_q).sum())
                    t_all = self._pad_rows(len(rem))
                    t_abv = self._pad_rows(n_above)
                    nn = max(self.flat.n_nodes, 1)
                    ov = self.TIER_OVERHEAD_CELLS / nn
                    cost_max = _w(min(top, grown)) * t_all + ov
                    cost_q = (_w(cand_q) * t_all + ov
                              + _w(min(top, grown * 2)) * t_abv + ov)
                    if cost_q < cost_max:
                        ub = cand_q
            if use_mesh:
                # whole-batch retry (no subset gathers under the mesh)
                continue
            # gather the unresolved reads into a padded sub-batch (see
            # _pad_rows)
            idx = np.resize(rem, self._pad_rows(len(rem)))
            idx_dev = jnp.asarray(idx)
            q_cur = jnp.take(qshift, idx_dev, axis=0)
            l_cur = jnp.take(lengths, idx_dev, axis=0)
            q_cur_key = None  # don't cache padded copies of sub-batches
            map_idx = idx
            cur_n_min = int(lengths_np[idx].min())
            cur_n_max = int(lengths_np[idx].max())

        self.stats["fullfill_fallbacks"] += 1
        # NB: map_idx may be pow2-padded with duplicates; count the
        # distinct unresolved reads, not the padded length (a 33-read
        # tail padded to 64 must still take the tail-only path at B=64)
        if self.last_attempts > 0 and len(np.unique(map_idx)) < B:
            # the band resolved most of the batch; full-fill only the
            # unresolved tail (banding stays enabled for this profile),
            # and future calls start at the tier that did the BULK work
            # — by newly-resolved count, NOT tiers[0] via setdefault:
            # that pinned the hint to this call's own starting guess
            # forever, and on the mixed-divergence bench the first tier
            # sat just below the low-divergence bulk's scores and
            # resolved ~nothing, so every batch repaid a dead
            # whole-batch fill (measured: 1752 -> 0 resolved, 1924 ->
            # 768 of 1024; scripts/mixed_div_profile.py round 5)
            self._ub_hint[(n_min, n_max)] = max(tiers,
                                                key=lambda t: t[1])[0]
            self.stats["cells_filled"] += (
                self.flat.n_nodes * int(q_cur.shape[1]) * int(q_cur.shape[0])
            )
            sub = self._full_scores(q_cur, l_cur)
            out[map_idx] = sub
            return out

        self._prep_cache[("fullfill", n_min, n_max)] = True
        self.stats["cells_filled"] += (
            self.flat.n_nodes * int(qshift.shape[1]) * B
        )
        scores = self._full_scores(qshift, lengths)
        # The default ub guess can be so loose that the band is wider than
        # the full fill before the retry loop ever runs.  Now that the true
        # max score is known, re-enable banding for future calls if a band
        # built from it would actually be narrower.
        finite = scores[scores < INF]
        if finite.size:
            tight = int(finite.max())
            _, width, _, _ = band_windows(self.flat, n_min, n_max, costs,
                                          tight, aln_type=self.aln_type)
            if drift_eligible:
                S = drift_steps_for(n_min, n_max)
                if 0 < S <= self.flat.n_nodes - 1:
                    _, dwidth, _ = band_windows_drift(
                        self.flat, n_min, n_max, costs, tight, S,
                        aln_type=self.aln_type)
                    width = min(width, dwidth)
            if width + 128 < int(qshift.shape[1]):
                self._ub_hint[(n_min, n_max)] = tight
                del self._prep_cache[("fullfill", n_min, n_max)]
        return scores
