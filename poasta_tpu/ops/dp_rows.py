"""Row-update primitives for the gap-affine POA wavefront fill.

The dense recurrence (minimizing cost; per query in the batch, per topo
rank ``r`` over query offsets ``j``):

    D[r, j] = min_p min(M[p, j] + o + e,  D[p, j] + e)
    diag[r, j] = min_p M[p, j-1] + (0 if sym(r) == q[j-1] else x)
    A[r, j] = min(diag[r, j], D[r, j])
    I[r, j] = min_{k < j} A[r, k] + o + e * (j - k)        (affine chain)
    M[r, j] = min(A[r, j], I[r, j])

``I`` is evaluated in closed form with a running prefix-min:
``I[j] = o + e*j + cummin_k(A[k] - e*k)[j-1]`` — one ``lax.cummin`` per row
instead of a sequential scan, which keeps the row update fully vectorized
on the VPU (offsets are the 128-wide lane dimension).

This reformulates the reference's A*-with-bucket-queue (which processes
states in f-order one at a time; ``src/aligner/astar.rs:108-226``) as a
masked batched fill: matches cost zero, so a whole row converges in a
single pass once all predecessor rows are final — topological order
guarantees that.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Large sentinel standing in for the reference's Score::Unvisited
# (``scoring/mod.rs:64-70``); int32 with enough headroom that adding
# costs never overflows.  Deliberately a plain Python int, NOT
# ``jnp.int32(...)``: a module-level device scalar forces backend init
# at import, and any ``numpy_value >= INF`` comparison on the host side
# would build a lazy jax array whose truth test is a device round-trip
# on the serving path.  As a weak-typed int it still promotes to int32
# inside jitted code.
INF = 1 << 28


def insertion_row(A: jnp.ndarray, gap_open: int, gap_extend: int) -> jnp.ndarray:
    """Closed-form affine insertion row from the A = min(diag, D) row.

    A: (..., L) int32. Returns I with I[..., 0] = INF.
    """
    L = A.shape[-1]
    j = jnp.arange(L, dtype=jnp.int32)
    t = A + (-gap_extend) * j  # A[k] - e*k
    p = jax.lax.cummin(t, axis=t.ndim - 1)
    # shift right by one: I[j] uses prefix over k <= j-1
    p_shifted = jnp.concatenate(
        [jnp.full(A.shape[:-1] + (1,), INF, dtype=A.dtype), p[..., :-1]], axis=-1
    )
    I = p_shifted + gap_open + gap_extend * j
    return jnp.minimum(I, INF)


def row_update(
    pred_M: jnp.ndarray,
    pred_D: jnp.ndarray,
    pred_mask: jnp.ndarray,
    match_cost: jnp.ndarray,
    gap_open: int,
    gap_extend: int,
    is_start_row: jnp.ndarray,
    free_start: jnp.ndarray,
):
    """One rank-row update.

    pred_M, pred_D: (..., P, L) gathered predecessor rows (INF-padded).
    pred_mask: (P,) or broadcastable bool — valid predecessor lanes.
    match_cost: (..., L) substitution cost per offset (cost of aligning
        q[j-1] to this node's symbol; position 0 unused).
    is_start_row: scalar bool — this is the virtual start node row.
    free_start: scalar bool — ends-free graph beginning (row origin is
        free at offset 0 for every node).

    Returns (M, I, D) rows of shape (..., L).
    """
    mask = pred_mask.reshape((1,) * (pred_M.ndim - 2) + (-1, 1))
    pm = jnp.where(mask, pred_M, INF)
    pd = jnp.where(mask, pred_D, INF)

    min_pm_same = jnp.min(pm, axis=-2)  # min_p M[p, j]
    min_pd_same = jnp.min(pd, axis=-2)
    D = jnp.minimum(min_pm_same + gap_open + gap_extend, min_pd_same + gap_extend)
    D = jnp.minimum(D, INF)

    # diagonal: shift predecessor M right by one offset
    diag_src = jnp.concatenate(
        [jnp.full(min_pm_same.shape[:-1] + (1,), INF, dtype=pm.dtype), min_pm_same[..., :-1]],
        axis=-1,
    )
    diag = jnp.minimum(diag_src + match_cost, INF)

    A = jnp.minimum(diag, D)

    # Row origins: the global-alignment start (rank 0, offset 0) or, in
    # ends-free mode, every real node at offset 0.
    L = A.shape[-1]
    origin = jnp.logical_or(is_start_row, free_start)
    zero_at_0 = jnp.where(
        jnp.logical_and(origin, jnp.arange(L) == 0), jnp.int32(0), INF
    )
    A = jnp.minimum(A, zero_at_0)

    I = insertion_row(A, gap_open, gap_extend)
    M = jnp.minimum(A, I)
    return M, I, D
