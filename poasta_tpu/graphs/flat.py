"""Flat SoA lowering of a POA graph for device kernels.

The device wavefront engine never touches the mutable host graph: it consumes a
rank-ordered structure-of-arrays view.  Nodes are laid out by topological
rank; adjacency is CSR over ranks.  POA graphs are overwhelmingly unbranched
chains, so the common-case predecessor of rank ``r`` is rank ``r-1``; the CSR
gather only pays for branch nodes.

This replaces the reference's petgraph object + per-node hash storage
(reference: ``src/graphs/poa.rs:85-95``, ``src/aligner/scoring/gap_affine.rs:442-466``)
with dense arrays ready for ``lax.scan`` and kernel consumption.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, List

import numpy as np

if TYPE_CHECKING:
    from .poa import POAGraph

MAX_PREDS_DENSE = 4  # padded predecessor table width for the kernel fast path


def _dist_sweep_backward(n, succ_ptr, succ_idx):
    """(min, max) edge-count distance to the end rank, reverse topo sweep.

    Ranks whose successor set is exactly ``{r+1}`` ("trivial", the
    unbranched-chain common case) fill as vectorized ramps between branch
    nodes; only branch nodes run Python-level.
    """
    min_d = np.zeros(n, dtype=np.int64)
    max_d = np.zeros(n, dtype=np.int64)
    if n == 0:
        return min_d, max_d
    counts = np.diff(succ_ptr.astype(np.int64))
    trivial = np.zeros(n, dtype=bool)
    one = counts == 1
    trivial[one] = (
        succ_idx[succ_ptr[:-1][one]] == np.arange(n, dtype=np.int64)[one] + 1
    )
    trivial[n - 1] = False
    nontriv = np.flatnonzero(~trivial)
    for k in range(len(nontriv) - 1, -1, -1):
        r = int(nontriv[k])
        r2 = int(nontriv[k + 1]) if k + 1 < len(nontriv) else n
        if r2 - r > 1:  # trivial run (r, r2): ramp off the value at r2
            js = np.arange(r + 1, r2)
            min_d[js] = min_d[r2] + (r2 - js)
            max_d[js] = max_d[r2] + (r2 - js)
        if r == n - 1:
            continue  # end rank: distance 0
        s = succ_idx[succ_ptr[r]: succ_ptr[r + 1]]
        if len(s):
            min_d[r] = min_d[s].min() + 1
            max_d[r] = max_d[s].max() + 1
        # isolated (shouldn't happen post-process): stays 0, as before
    r2 = int(nontriv[0])
    if r2 > 0:  # trivial run below the lowest branch node
        js = np.arange(0, r2)
        min_d[js] = min_d[r2] + (r2 - js)
        max_d[js] = max_d[r2] + (r2 - js)
    return min_d, max_d


def _dist_sweep_forward(n, pred_ptr, pred_idx):
    """(min, max) edge-count distance from the start rank, forward sweep."""
    ds_min = np.zeros(n, dtype=np.int64)
    ds_max = np.zeros(n, dtype=np.int64)
    if n == 0:
        return ds_min, ds_max
    counts = np.diff(pred_ptr.astype(np.int64))
    trivial = np.zeros(n, dtype=bool)
    one = counts == 1
    trivial[one] = (
        pred_idx[pred_ptr[:-1][one]] == np.arange(n, dtype=np.int64)[one] - 1
    )
    trivial[0] = False
    nontriv = np.flatnonzero(~trivial)
    for k in range(len(nontriv)):
        r = int(nontriv[k])
        r0 = int(nontriv[k - 1]) if k > 0 else -1
        if r - r0 > 1:  # trivial run (r0, r): ramp off the value at r0
            js = np.arange(r0 + 1, r)
            ds_min[js] = ds_min[r0] + (js - r0)
            ds_max[js] = ds_max[r0] + (js - r0)
        if r == 0:
            continue
        p = pred_idx[pred_ptr[r]: pred_ptr[r + 1]]
        if len(p):
            ds_min[r] = ds_min[p].min() + 1
            ds_max[r] = ds_max[p].max() + 1
    r0 = int(nontriv[-1])
    if r0 < n - 1:  # trivial run above the highest branch node
        js = np.arange(r0 + 1, n)
        ds_min[js] = ds_min[r0] + (js - r0)
        ds_max[js] = ds_max[r0] + (js - r0)
    return ds_min, ds_max


@dataclass(frozen=True)
class FlatGraph:
    """Rank-ordered SoA view of a POA graph.

    Attributes
    ----------
    symbols:
        uint8 symbol per rank (rank 0 is the virtual start ``#``; the last
        rank is the virtual end ``$``).
    node_of_rank / rank_of_node:
        mappings between mutable-graph node indices and ranks.
    pred_ptr / pred_idx:
        CSR predecessor lists *in rank space*, predecessors listed in the
        graph's iteration order (newest edge first).
    succ_ptr / succ_idx:
        CSR successor lists in rank space.
    preds_dense / npreds:
        ``(n, MAX_PREDS_DENSE)`` padded predecessor ranks (pad = 0) plus the
        per-rank predecessor count; kernels use this when
        ``max(npreds) <= MAX_PREDS_DENSE`` to avoid ragged gathers.
    min_dist_to_end / max_dist_to_end:
        per-rank shortest/longest path length (in nodes) to the end node;
        host-precomputed heuristic bounds (reference:
        ``src/bubbles/index.rs:133-148``) shipped as dense arrays.
    """

    symbols: np.ndarray
    node_of_rank: np.ndarray
    rank_of_node: np.ndarray
    pred_ptr: np.ndarray
    pred_idx: np.ndarray
    succ_ptr: np.ndarray
    succ_idx: np.ndarray
    preds_dense: np.ndarray
    npreds: np.ndarray
    min_dist_to_end: np.ndarray
    max_dist_to_end: np.ndarray
    min_dist_from_start: np.ndarray
    max_dist_from_start: np.ndarray

    @property
    def n_nodes(self) -> int:
        return int(self.symbols.shape[0])

    @property
    def start_rank(self) -> int:
        return 0

    @property
    def end_rank(self) -> int:
        return self.n_nodes - 1

    @property
    def max_in_degree(self) -> int:
        return int(self.npreds.max()) if self.n_nodes else 0

    @staticmethod
    def from_poa_graph(graph: "POAGraph") -> "FlatGraph":
        import itertools

        order = graph.topological_sorted
        if not order:
            graph.post_process()
            order = graph.topological_sorted
        n = len(order)
        node_of_rank = np.asarray(order, dtype=np.int32)
        rank_of_node = np.zeros(n, dtype=np.int32)
        rank_of_node[node_of_rank] = np.arange(n, dtype=np.int32)

        symbols = np.fromiter(graph.symbols, dtype=np.uint8, count=n)[
            node_of_rank
        ]

        # Vectorized CSR adjacency in rank space.  Order parity: the
        # per-node lists must match graph.predecessors()/successors()
        # (edges iterated newest-first), so each node's edge-id list is
        # reversed before flattening.
        edge_src = np.fromiter(
            (e.source if e is not None else 0 for e in graph._edges),
            dtype=np.int64, count=len(graph._edges),
        )
        edge_tgt = np.fromiter(
            (e.target if e is not None else 0 for e in graph._edges),
            dtype=np.int64, count=len(graph._edges),
        )

        def csr(adj, edge_end):
            counts = np.fromiter(
                (len(adj[v]) for v in order), dtype=np.int64, count=n
            )
            total = int(counts.sum())
            ptr = np.zeros(n + 1, dtype=np.int32)
            np.cumsum(counts, out=ptr[1:])
            flat_eids = np.fromiter(
                itertools.chain.from_iterable(
                    reversed(adj[v]) for v in order
                ),
                dtype=np.int64, count=total,
            )
            idx = rank_of_node[edge_end[flat_eids]].astype(np.int32)
            return ptr, idx, counts.astype(np.int32)

        pred_ptr, pred_idx, npreds = csr(graph._in, edge_src)
        succ_ptr, succ_idx, _ = csr(graph._out, edge_tgt)

        width = max(MAX_PREDS_DENSE, int(npreds.max()) if n else 1)
        preds_dense = np.zeros((n, width), dtype=np.int32)
        rows = np.repeat(np.arange(n), npreds)
        cols = np.arange(len(pred_idx)) - np.repeat(
            pred_ptr[:-1].astype(np.int64), npreds
        )
        preds_dense[rows, cols] = pred_idx

        # Shortest/longest distance (edge count) to the end node, by reverse
        # topological sweep, and from the start node, forward sweep (used by
        # the banded fill's per-rank feasible offset windows).  POA graphs
        # are overwhelmingly unbranched chains, so both sweeps vectorize
        # over maximal "trivial" runs (succ == {r+1} / pred == {r-1}): the
        # run is a straight +1-per-rank ramp off its boundary value, and
        # only branch nodes run Python-level.
        min_d, max_d = _dist_sweep_backward(n, succ_ptr, succ_idx)
        ds_min, ds_max = _dist_sweep_forward(n, pred_ptr, pred_idx)

        return FlatGraph(
            symbols=symbols,
            node_of_rank=node_of_rank,
            rank_of_node=rank_of_node,
            pred_ptr=pred_ptr,
            pred_idx=pred_idx,
            succ_ptr=succ_ptr,
            succ_idx=succ_idx,
            preds_dense=preds_dense,
            npreds=npreds,
            min_dist_to_end=min_d.astype(np.int32),
            max_dist_to_end=max_d.astype(np.int32),
            min_dist_from_start=ds_min.astype(np.int32),
            max_dist_from_start=ds_max.astype(np.int32),
        )
