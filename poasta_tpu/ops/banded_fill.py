"""One-piece banded fill: prepared tables and the two executors.

:func:`prepare_banded` lowers a window layout (per-rank window starts, a
shared width, and for drifting windows the per-rank step schedule) to
device tables.  Both executors consume exactly those tables:

* :func:`xla_banded_exec` — a ``lax.scan`` over ranks, the plain
  reference and the CPU path;
* the CUDA kernel (``ops/cuda/banded_fill.cu`` through
  :mod:`poasta_tpu.ops.cuda_fill`), one thread block per read with the
  rings in shared memory.

:func:`banded_scores` runs either one; :func:`cuda_fits` is the
shared-memory rule that decides, from the shapes alone, whether the CUDA
kernel can take a layout.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .dp_rows import INF

# Hopper: a block may use 227 KB of the SM's 256 KB shared memory
SHARED_MEM_PER_BLOCK = 232448
# widest band one 1024-thread block covers (8 lanes per thread)
MAX_CUDA_WIDTH = 8192


def lanes_per_thread(Wb: int) -> int:
    """Lanes each CUDA thread owns: 4 up to 4096-lane bands (Wb/4
    threads), then as many as keep the block at 1024 threads."""
    lpt = 4
    while Wb // lpt > 1024:
        lpt *= 2
    return lpt


def cuda_width(Wb: int) -> int:
    """``Wb`` rounded up to a width the CUDA kernel's block divides
    (whole warps of ``lanes_per_thread`` lanes).  Widening a window only
    covers more cells, so every band's exactness argument still holds."""
    step = 32 * lanes_per_thread(Wb)
    return -(-Wb // step) * step


def cuda_shared_bytes(W: int, Wb: int) -> int:
    """Shared memory of one block: M and D rings, warp minima, drift
    frame per ring slot."""
    return (2 * W * Wb + 32 + W) * 4


def cuda_fits(W: int, Wb: int) -> bool:
    """Whether the CUDA kernel can take a ``W``-slot ring of ``Wb``
    lanes; layouts that fail go to the XLA body."""
    return (Wb % (32 * lanes_per_thread(Wb)) == 0 and Wb <= MAX_CUDA_WIDTH
            and cuda_shared_bytes(W, Wb) <= SHARED_MEM_PER_BLOCK)


class BandedTables(NamedTuple):
    width: int
    wstarts: jnp.ndarray        # (Np,) window start per rank
    pred_wstarts: jnp.ndarray   # (Np, P) window start of each predecessor
    pred_valid: jnp.ndarray     # (Np, P) int32 0/1
    s_ranks: Optional[jnp.ndarray]  # (Np,) drift step count, or None
    S: int                      # drift steps (0: shared windows)


def prepare_banded(dg, wstarts_np, width: int, s_ranks_np=None,
                   S: int = 0) -> BandedTables:
    """Upload a window layout.  Callers cache the result: the tables are
    keyed by the layout, not by the batch."""
    Np = dg.n_nodes_padded
    P = int(dg.pred_slots.shape[1])
    ws = np.zeros(Np, dtype=np.int32)
    ws[: wstarts_np.shape[0]] = wstarts_np
    pw = np.take(ws, dg.pred_ranks_np, axis=0).astype(np.int32)
    sr = None
    if S:
        s = np.zeros(Np, dtype=np.int32)
        s[: s_ranks_np.shape[0]] = s_ranks_np
        sr = jnp.asarray(s)
    return BandedTables(
        width=int(width),
        wstarts=jnp.asarray(ws),
        pred_wstarts=jnp.asarray(pw),
        pred_valid=jnp.asarray(
            dg.pred_valid_np.astype(np.int32).reshape(Np, P)),
        s_ranks=sr,
        S=int(S),
    )


@functools.lru_cache(maxsize=None)
def xla_banded_exec(window: int, Wb: int, P: int, o: int, e: int, x: int,
                    S: int = 0, ef: bool = False, free_start: bool = False,
                    vary_axes: tuple = ()):
    """Banded scores as a ``lax.scan`` over ranks (rings (B, W, Wb)).

    ``S > 0``: drifting windows — each read's frame is the shared layout
    shifted right by sigma_b(r) = 128*floor(nbs_b*s_r/S); at ranks where
    a read's sigma advances, its query row and ring rows roll left 128
    lanes (see ``aligner.banded.band_windows_drift``).  ``ef``: ends-free
    end rules — a running min of M over ranks with ``end_ok`` and offsets
    in ``[jlo, len]``; ``free_start`` seeds j = 0 at every real rank
    (shared windows only).  ``vary_axes``: mesh axes this body runs under
    via shard_map.
    """
    drift = S > 0

    def roll128(t):
        return jnp.concatenate(
            [t[..., 128:], jnp.full(t.shape[:-1] + (128,), INF, t.dtype)],
            axis=-1)

    @jax.jit
    def fn(symbols, pred_slots, pred_valid, pred_wstarts, wstarts,
           write_slots, end_rank, end_ok, s_ranks, q, lengths, jlo, n_min,
           mq):
        B = q.shape[0]
        Np = symbols.shape[0]
        li = lengths.astype(jnp.int32)
        jlo_i = jlo.astype(jnp.int32)
        nbs = jnp.maximum(li - n_min + 64, 0) // 128
        ring0 = jnp.full((B, window, Wb), INF, dtype=jnp.int32)
        best0 = jnp.full((B,), INF, dtype=jnp.int32)
        if vary_axes:
            ring0 = jax.lax.pcast(ring0, vary_axes, to="varying")
            best0 = jax.lax.pcast(best0, vary_axes, to="varying")
        jloc = jnp.arange(Wb, dtype=jnp.int32)
        s_prev = jnp.concatenate([jnp.zeros((1,), s_ranks.dtype),
                                  s_ranks[:-1]])
        inf_col = jnp.full((B, 1), INF, jnp.int32)
        pad = jnp.full((B, Wb), INF, jnp.int32)

        def step(carry, xs):
            M_ring, D_ring, qcur, best = carry
            rank, sym, slots, valid, pws, w_r, wslot, ok, s_r, s_p = xs
            if drift:
                sig = 128 * ((nbs * s_r) // S)
                stepped = sig > 128 * ((nbs * s_p) // S)
                qcur = jnp.where(stepped[:, None], jnp.concatenate(
                    [qcur[:, 128:], jnp.zeros((B, 128), qcur.dtype)],
                    axis=1), qcur)
                M_ring = jnp.where(stepped[:, None, None], roll128(M_ring),
                                   M_ring)
                D_ring = jnp.where(stepped[:, None, None], roll128(D_ring),
                                   D_ring)
            else:
                sig = jnp.zeros((B,), jnp.int32)
            j = w_r + jloc[None, :] + sig[:, None]  # (B, Wb) global offsets

            min_pm = jnp.full((B, Wb), INF, dtype=jnp.int32)
            min_pd = jnp.full((B, Wb), INF, dtype=jnp.int32)
            for p in range(P):
                start = jnp.clip(w_r - pws[p] + Wb, 0, 2 * Wb)
                rowM = jax.lax.dynamic_index_in_dim(M_ring, slots[p], 1,
                                                    keepdims=False)
                rowD = jax.lax.dynamic_index_in_dim(D_ring, slots[p], 1,
                                                    keepdims=False)
                am = jax.lax.dynamic_slice_in_dim(
                    jnp.concatenate([pad, rowM, pad], axis=1), start, Wb,
                    axis=1)
                ad = jax.lax.dynamic_slice_in_dim(
                    jnp.concatenate([pad, rowD, pad], axis=1), start, Wb,
                    axis=1)
                keep = valid[p] == 1
                min_pm = jnp.minimum(min_pm, jnp.where(keep, am, INF))
                min_pd = jnp.minimum(min_pd, jnp.where(keep, ad, INF))

            D = jnp.minimum(jnp.minimum(min_pm + o + e, min_pd + e), INF)
            # window lane 0's diagonal source lies left of the window: the
            # band guarantees that cell is off every <=ub path, so INF
            diag_src = jnp.concatenate([inf_col, min_pm[:, :-1]], axis=1)
            qwin = jax.lax.dynamic_slice_in_dim(qcur, w_r + mq, Wb, axis=1)
            match_cost = jnp.where(qwin == sym, jnp.int32(0), jnp.int32(x))
            diag = jnp.minimum(diag_src + match_cost, INF)
            A = jnp.minimum(diag, D)

            is_end = rank == end_rank
            origin_rank = rank == 0
            if ef and free_start and not drift:
                origin_rank = jnp.logical_or(origin_rank,
                                             jnp.logical_not(is_end))
            origin = jnp.logical_and(origin_rank, j == 0)
            A = jnp.minimum(A, jnp.where(origin, jnp.int32(0), INF))

            pref = jax.lax.cummin(A - e * j, axis=1)
            pref_m1 = jnp.concatenate([inf_col, pref[:, :-1]], axis=1)
            I = jnp.minimum(pref_m1 + o + e * j, INF)
            M = jnp.minimum(A, I)
            M = jnp.where(is_end, min_pm, M)
            D = jnp.where(is_end, INF, D)

            M_ring = jax.lax.dynamic_update_index_in_dim(M_ring, M, wslot, 1)
            D_ring = jax.lax.dynamic_update_index_in_dim(D_ring, D, wslot, 1)

            if ef:
                allowed = jnp.logical_and(
                    jnp.logical_and(j >= jlo_i[:, None], j <= li[:, None]),
                    ok == 1)
                best = jnp.minimum(
                    best, jnp.min(jnp.where(allowed, M, INF), axis=1))
            else:
                idx = li - w_r - sig
                in_range = jnp.logical_and(idx >= 0, idx < Wb)
                at = jnp.take_along_axis(
                    M, jnp.clip(idx, 0, Wb - 1)[:, None], axis=1)[:, 0]
                best = jnp.minimum(best, jnp.where(
                    jnp.logical_and(in_range, is_end), at, INF))
            return (M_ring, D_ring, qcur, best), None

        ranks = jnp.arange(Np, dtype=jnp.int32)
        xs = (ranks, symbols, pred_slots, pred_valid, pred_wstarts, wstarts,
              write_slots, end_ok, s_ranks, s_prev)
        (_, _, _, best), _ = jax.lax.scan(step, (ring0, ring0, q, best0), xs)
        return best

    return fn


@functools.lru_cache(maxsize=None)
def cuda_banded_exec(n_nodes: int, W: int, Wb: int, o: int, e: int, x: int,
               S: int, mq: int, n_min: int, free_start: bool, ef: bool):
    """The CUDA kernel as a jitted fn of (symbols, pred_slots, pred_valid,
    pred_wstarts, wstarts, write_slots, end_ok, s_ranks, q, lengths, jlo);
    the batch size is read from ``q``, so it also runs per shard under
    ``shard_map``."""
    from .cuda_fill import cuda_banded_scores

    @jax.jit
    def fn(symbols, pred_slots, pred_valid, pred_wstarts, wstarts,
           write_slots, end_ok, s_ranks, q, lengths, jlo):
        return cuda_banded_scores(
            symbols, pred_slots, pred_valid, pred_wstarts, wstarts,
            write_slots, end_ok, s_ranks, q.astype(jnp.int32),
            lengths.astype(jnp.int32), jlo.astype(jnp.int32),
            n_nodes=n_nodes, W=W, Wb=Wb, o=o, e=e, x=x, S=S, mq=mq,
            n_min=n_min, free_start=free_start, ef=ef)

    return fn


def banded_scores(executor: str, dg, tables: BandedTables, q, lengths,
                  costs, *, ends=None, n_min: int = 0, mq: int = 0):
    """(B,) banded scores of ``q`` (B, LQ) from ``executor``.

    ``ends``: ``(free_start, end_ok, jlo)`` for an ends-free span, else
    None.  ``n_min``/``mq``: the batch's minimum length and the query's
    left pad (drifting windows)."""
    free_start, end_ok, jlo = ends if ends is not None else (
        False, tables.wstarts, lengths)
    s_ranks = tables.s_ranks if tables.S else tables.wstarts
    P = int(dg.pred_slots.shape[1])
    args = (dg.symbols, dg.pred_slots, tables.pred_valid,
            tables.pred_wstarts, tables.wstarts, dg.write_slots)
    if executor == "cuda":
        fn = cuda_banded_exec(dg.n_nodes, dg.window, tables.width,
                        costs.gap_open, costs.gap_extend, costs.mismatch,
                        tables.S, int(mq), int(n_min), bool(free_start),
                        ends is not None)
        return fn(*args, end_ok, s_ranks, q, lengths, jlo)
    if executor != "xla":
        raise ValueError(f"unknown fill executor {executor!r}")
    fn = xla_banded_exec(dg.window, tables.width, P, costs.gap_open,
                         costs.gap_extend, costs.mismatch, tables.S,
                         ends is not None, bool(free_start))
    return fn(*args, dg.end_rank, end_ok, s_ranks, q, lengths, jlo,
              jnp.asarray(n_min, jnp.int32), jnp.asarray(mq, jnp.int32))
