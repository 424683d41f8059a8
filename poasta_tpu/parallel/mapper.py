"""Multi-chip execution of the wavefront fill.

The reference's only parallelism is a host thread pool fanning reads out
over crossbeam channels (``src/bin/lasagna.rs:214-273``).  Here the same
work is laid out over a ``jax.sharding.Mesh`` with two axes:

* ``dp`` — data parallelism over the read batch (the outer axis; the
  direct analogue of lasagna's ``-j`` threads).  Graph arrays are
  replicated; no communication is needed until results gather.
* ``sp`` — sequence parallelism over the query-offset axis, the
  long-query analogue of context parallelism: each device owns a
  contiguous slab of offsets.  Per rank-row the fill needs
  (a) a one-column halo of the predecessor Match row for the diagonal
  term — a ``ppermute`` shift from the left neighbor, and
  (b) a global affine prefix-min for the insertion chain — computed as
  local ``cummin`` + ``all_gather`` of per-device totals + exclusive
  combine, the classic blocked-scan decomposition.

Collectives ride NVLink between the cards of a host; the dp axis can span
hosts since it never communicates inside the fill.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..aligner.costs import GapAffine
from ..aligner.wavefront import DeviceGraph
from ..ops.dp_rows import INF


def make_mesh(devices=None, dp: Optional[int] = None, sp: int = 1) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if dp is None:
        dp = n // sp
    assert dp * sp == n, f"dp({dp}) * sp({sp}) must equal device count ({n})"
    dev_array = np.asarray(devices).reshape(dp, sp)
    return Mesh(dev_array, ("dp", "sp"))


def parse_mesh_spec(spec: str) -> Optional[Mesh]:
    """CLI ``--mesh`` spec -> Mesh (or None for single-device).

    * ``auto`` — dp over every local device, sp=1; None when only one
      device exists (no mesh overhead on single-chip hosts).
    * ``off`` / ``1`` — force single-device.
    * ``DP`` or ``DP,SP`` — explicit axis sizes; DP*SP must equal the
      visible device count (the reference's ``-j N`` worker-thread
      analogue, ``lasagna.rs:73-75``).
    """
    spec = spec.strip().lower()
    if spec in ("off", "1", "none"):
        return None
    n = len(jax.devices())
    if spec == "auto":
        return make_mesh(dp=n, sp=1) if n > 1 else None
    parts = spec.split(",")
    try:
        dp = int(parts[0])
        sp = int(parts[1]) if len(parts) > 1 else 1
    except ValueError:
        raise ValueError(f"bad --mesh spec {spec!r} (use auto|off|DP[,SP])")
    if dp * sp != n:
        raise ValueError(
            f"--mesh {spec}: dp*sp = {dp * sp} but {n} devices are visible"
        )
    if dp == 1 and sp == 1:
        return None
    return make_mesh(dp=dp, sp=sp)


def _sp_scan_rows(symbols, pred_slots, pred_valid, write_slots, end_rank,
                  qshift, lengths,
                  *, window: int, o: int, e: int, x: int, free_start: bool,
                  free_end: bool):
    """Per-shard body: local offsets slab, full rank scan.

    Runs inside shard_map with axis names ("dp", "sp").
    """
    Bloc, Lloc = qshift.shape
    sp = jax.lax.axis_size("sp")
    sp_idx = jax.lax.axis_index("sp")
    j_global = sp_idx * Lloc + jnp.arange(Lloc, dtype=jnp.int32)  # (Lloc,)
    left_perm = [(i, i + 1) for i in range(sp - 1)]  # shift right along sp

    idx_local = lengths.astype(jnp.int32)[:, None] - sp_idx * Lloc  # (B, 1)
    in_range = jnp.logical_and(idx_local >= 0, idx_local < Lloc)
    idx_clamped = jnp.clip(idx_local, 0, Lloc - 1)

    M0 = jnp.full((Bloc, window, Lloc), INF, dtype=jnp.int32)
    D0 = jnp.full((Bloc, window, Lloc), INF, dtype=jnp.int32)
    # the scan carry varies across both mesh axes (halo/prefix collectives)
    M0 = jax.lax.pcast(M0, ("dp", "sp"), to="varying")
    D0 = jax.lax.pcast(D0, ("dp", "sp"), to="varying")

    def step(carry, xs):
        M_ring, D_ring = carry
        rank, sym, slots, valid, wslot = xs

        pred_M = jnp.take(M_ring, slots, axis=1)  # (B, P, Lloc)
        pred_D = jnp.take(D_ring, slots, axis=1)
        mask = valid.reshape(1, -1, 1)
        pm = jnp.where(mask, pred_M, INF)
        pd = jnp.where(mask, pred_D, INF)

        min_pm_same = jnp.min(pm, axis=1)  # (B, Lloc)
        min_pd_same = jnp.min(pd, axis=1)
        D = jnp.minimum(min_pm_same + o + e, min_pd_same + e)

        # Diagonal: shift predecessor Match row right by one global offset.
        # Column 0's source lives on the left sp-neighbor.
        halo = min_pm_same[:, -1:]
        halo_in = jax.lax.ppermute(halo, "sp", left_perm)
        halo_in = jnp.where(sp_idx == 0, INF, halo_in)
        diag_src = jnp.concatenate([halo_in, min_pm_same[:, :-1]], axis=1)
        match_cost = jnp.where(qshift == sym, jnp.int32(0), jnp.int32(x))
        diag = diag_src + match_cost

        A = jnp.minimum(diag, D)

        is_start = rank == 0
        is_end = rank == end_rank
        is_real = jnp.logical_and(rank > 0, rank < end_rank)
        origin = jnp.logical_or(is_start, jnp.logical_and(is_real, free_start))
        zero_at_0 = jnp.where(
            jnp.logical_and(origin, j_global[None, :] == 0), jnp.int32(0), INF
        )
        A = jnp.minimum(A, zero_at_0)

        # Insertion chain: global affine prefix-min across the sp axis.
        t = A - e * j_global[None, :]
        local_cum = jax.lax.cummin(t, axis=1)
        totals = local_cum[:, -1]  # (B,)
        all_totals = jax.lax.all_gather(totals, "sp", axis=1)  # (B, sp)
        dev_ids = jnp.arange(sp)
        excl = jnp.min(
            jnp.where(dev_ids[None, :] < sp_idx, all_totals, INF), axis=1
        )  # (B,)
        prefix_incl = jnp.minimum(local_cum, excl[:, None])
        prefix_m1 = jnp.concatenate([excl[:, None], prefix_incl[:, :-1]], axis=1)
        I = prefix_m1 + o + e * j_global[None, :] + e * 0
        I = jnp.minimum(I, INF)

        M = jnp.minimum(A, I)

        # Virtual end node: zero-cost same-offset hop.
        M = jnp.where(is_end, min_pm_same, M)
        I = jnp.where(is_end, INF, I)
        D = jnp.where(is_end, INF, jnp.minimum(D, INF))

        M_ring = jax.lax.dynamic_update_index_in_dim(M_ring, M, wslot, axis=1)
        D_ring = jax.lax.dynamic_update_index_in_dim(D_ring, D, wslot, axis=1)

        at_len_local = jnp.take_along_axis(M, idx_clamped, axis=1)[:, 0]
        at_len = jnp.where(in_range[:, 0], at_len_local, INF)
        return (M_ring, D_ring), at_len

    ranks = jnp.arange(symbols.shape[0], dtype=jnp.int32)
    xs = (ranks, symbols, pred_slots, pred_valid, write_slots)
    _, at_len = jax.lax.scan(step, (M0, D0), xs)  # (Np, Bloc)

    # each read's score lives on exactly one sp shard; min-reduce over sp
    at_len = jax.lax.pmin(at_len, "sp")

    score = jnp.take(at_len, end_rank, axis=0)
    if free_end:
        rank_ok = jnp.logical_and(ranks > 0, ranks < end_rank)[:, None]
        best_real = jnp.min(jnp.where(rank_ok, at_len, INF), axis=0)
        score = jnp.minimum(score, best_real)
    return score


def make_sharded_score_fn(dg: DeviceGraph, costs: GapAffine, mesh: Mesh,
                          free_start: bool = False, free_end: bool = False):
    """Jitted (qshift (B, L), lengths (B,)) -> (B,) scores over the mesh.

    The read batch shards over ``dp``; query offsets shard over ``sp``;
    graph arrays replicate.  One-piece costs only: two-piece sharded
    scoring runs through ``BandedScorer(mesh=...)``.
    """
    if getattr(costs, "is_two_piece", False):
        raise NotImplementedError(
            "two-piece sharded scoring runs through BandedScorer(mesh=...)")
    body = functools.partial(
        _sp_scan_rows,
        window=dg.window,
        o=costs.gap_open,
        e=costs.gap_extend,
        x=costs.mismatch,
        free_start=free_start,
        free_end=free_end,
    )

    mapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P("dp", "sp"), P("dp")),
        out_specs=P("dp"),
    )

    @jax.jit
    def fn(qshift, lengths):
        return mapped(dg.symbols, dg.pred_slots, dg.pred_valid,
                      dg.write_slots, dg.end_rank, qshift, lengths)

    return fn


class BatchMapper:
    """lasagna-equivalent batch read mapper.

    Static graph; reads stream in, padded/bucketed into batches, scored
    (and optionally backtraced) on the mesh.  Deterministic output order.
    """

    def __init__(self, graph, costs: GapAffine, mesh: Optional[Mesh] = None,
                 batch_size: int = 64, aln_type=None):
        """``aln_type``: None/Global for global alignment; an ``EndsFree``
        span (bounded or unbounded) scores via the ends-free device
        fills (dp-sharded over ``mesh`` when set) and aligns through the
        end-anchored native corridor path
        (:meth:`poasta_tpu.native.NativeAligner.align_anchored`), with a
        dense-table host backtrace as the small-shape fallback."""
        from ..aligner.costs import EndsFree

        self.graph = graph
        self.flat = graph.flatten()
        self.dg = DeviceGraph.build(self.flat)
        self.costs = costs
        self.mesh = mesh
        self.batch_size = batch_size
        self.aln_type = aln_type
        self.ends_free = isinstance(aln_type, EndsFree)
        self._score_fn = None

    def score_batch(self, queries) -> np.ndarray:
        from ..aligner.banded import BandedScorer
        from ..aligner.wavefront import pack_queries

        qshift, lengths = pack_queries(queries)
        if self.ends_free:
            if self.mesh is not None:
                from ..aligner.wavefront import dp_fill_scores_ends_free

                return np.asarray(dp_fill_scores_ends_free(
                    self.dg, self.flat, qshift, lengths, self.costs,
                    self.aln_type, mesh=self.mesh))
            # banded ends-free when profitable, else the bounded full fill
            if getattr(self, "_ef_scorer", None) is None:
                self._ef_scorer = BandedScorer(self.flat, self.costs,
                                               dg=self.dg,
                                               aln_type=self.aln_type)
            return np.asarray(self._ef_scorer.scores(qshift, lengths))
        if self.mesh is not None:
            if getattr(self.costs, "is_two_piece", False):
                # two-piece mesh scoring runs through the sharded banded
                # scorer (the plain sharded body is one-piece math)
                if getattr(self, "_mesh_scorer", None) is None:
                    self._mesh_scorer = BandedScorer(
                        self.flat, self.costs, mesh=self.mesh, dg=self.dg)
                return np.asarray(self._mesh_scorer.scores(qshift, lengths))
            if self._score_fn is None:
                self._score_fn = make_sharded_score_fn(self.dg, self.costs, self.mesh)
            return np.asarray(self._score_fn(qshift, lengths))
        # the banded scorer is the production path (exact via tiered
        # verify-and-retry; falls back to the full fill internally when
        # banding doesn't pay)
        if getattr(self, "_scorer", None) is None:
            self._scorer = BandedScorer(self.flat, self.costs, dg=self.dg)
        return np.asarray(self._scorer.scores(qshift, lengths))

    # dense tables cost Np*B*L*12 bytes of device memory and transfer;
    # beyond this budget align_batch switches to device scores +
    # per-read native banded backtrace
    DENSE_TABLE_BUDGET = 64 * 1024 * 1024

    def align_batch(self, queries, prescored=None):
        """Scores + alignments for a read batch.

        Small shapes: one device fill returns dense M/I/D tables and the
        host backtraces them.  Large shapes (long reads / big graphs):
        the device computes exact scores in batch (banded, verified) and
        the native engine reconstructs each alignment inside the
        score-certified band — same priority rules, so both paths emit
        identical alignments (tests/test_native.py).  Reads fan out over
        host threads (the ctypes call releases the GIL), mirroring the
        reference's ``-j`` worker threads.
        """
        from ..aligner.wavefront import backtrace_dense, dp_fill_full, pack_queries

        if not queries:
            return []
        if prescored is not None and prescored[0] is queries:
            # reuse the packed batch from prescore(): re-packing would put
            # another full host->device upload on the serving path
            qshift, lengths = prescored[2], prescored[3]
        else:
            qshift, lengths = pack_queries(queries)
        B, L = int(qshift.shape[0]), int(qshift.shape[1])
        table_bytes = self.dg.n_nodes_padded * B * L * 12
        two_piece = getattr(self.costs, "is_two_piece", False)
        # the dense-table path is one-piece only (dp_fill_full /
        # backtrace_dense); two-piece always takes the banded native path.
        # With a mesh, the banded path is preferred at every size — it is
        # the only one that actually shards the fill over dp (the dense
        # path is single-device); both paths emit identical alignments
        # (tests/test_native.py), so output bytes don't depend on this.
        if self.ends_free:
            pre_ef = None
            if prescored is not None and prescored[0] is queries:
                pre_ef = prescored[1]
            return self._align_batch_ends_free(queries, qshift, lengths,
                                               two_piece,
                                               pre_scores=pre_ef)
        pre_scores = None
        if prescored is not None and prescored[0] is queries:
            pre_scores = prescored[1]
        if (two_piece or table_bytes > self.DENSE_TABLE_BUDGET
                or self.mesh is not None):
            banded = self._align_batch_banded(queries, qshift, lengths,
                                              scores=pre_scores)
            if banded is not None:
                return banded
            if two_piece:
                raise RuntimeError(
                    "two-piece align_batch requires the native engine"
                )
        scores, M, I, D = dp_fill_full(self.dg, qshift, lengths, self.costs)
        M, I, D = np.asarray(M), np.asarray(I), np.asarray(D)
        out = []
        for b, q in enumerate(queries):
            aln = backtrace_dense(self.flat, M[:, b, :], I[:, b, :], D[:, b, :],
                                  q, self.costs)
            out.append((int(scores[b]), aln))
        return out

    def _ends_free_scores(self, qshift, lengths):
        """(scores, end_ranks, end_offsets) of an ends-free batch from the
        bounded full fill (dp-sharded over the mesh when it divides)."""
        from ..aligner.wavefront import dp_fill_ends_free_with_ends

        sc, er, ej = dp_fill_ends_free_with_ends(
            self.dg, self.flat, qshift, lengths, self.costs, self.aln_type,
            mesh=self.mesh)
        return np.asarray(sc), np.asarray(er), np.asarray(ej)

    def _align_batch_ends_free(self, queries, qshift, lengths, two_piece,
                               pre_scores=None):
        """Ends-free scores + alignments.

        Production path: the device fill returns each read's optimal
        score AND end state (rank, offset); the native engine fills only
        an end-anchored corridor around that read's own locus and
        backtraces — per-read work scales with span x score, so this
        serves pangenome-scale semi-global mapping (tables-free).  Falls
        back to dense tables + host backtrace when the native engine is
        unavailable (small shapes only)."""
        from ..aligner.wavefront import (
            backtrace_dense_ends_free,
            dp_fill_full,
            ends_free_device_params,
        )

        free_start = self.aln_type.graph_free_begin[0] == "unbounded"
        # anchored corridor needs the native engine; with a bounded graph
        # begin the origin is the global start node, which the anchored
        # fill also handles (origin only at the start node)
        try:
            from ..native import NativeAligner

            if getattr(self, "_native", None) is None:
                self._native = NativeAligner(self.graph)
            native = self._native
        except Exception:
            native = None
        if native is not None:
            import os
            import time
            from concurrent.futures import ThreadPoolExecutor

            t0 = time.perf_counter()
            if pre_scores is not None:
                sc, er, ej = pre_scores  # scored by prescore() already
            else:
                sc, er, ej = self._ends_free_scores(qshift, lengths)
            stats = self.last_ends_free_stats = {
                "device_s": time.perf_counter() - t0,
                "anchored_ok": 0, "exact_fallback": 0, "host_s": 0.0,
            }
            node_of_rank = self.flat.node_of_rank

            def one(args):
                b, q = args
                if sc[b] >= INF:
                    raise RuntimeError(
                        "ends-free alignment: unsatisfiable bounds"
                    )
                try:
                    out = native.align_anchored(
                        q, self.costs, int(node_of_rank[er[b]]),
                        int(ej[b]), int(sc[b]), free_start=free_start)
                    # counters are aggregated after the pool drains — a
                    # += here would race across worker threads
                    return "anchored_ok", out
                except RuntimeError:
                    # corridor never verified (defensive; should not
                    # happen — the window bounds are proven): per-read
                    # fallback to the exact engine rather than aborting
                    # the batch.  NB the exact engine reproduces the
                    # reference's greedy-extension quirk and may return
                    # a higher (sub-optimal) score.
                    from ..aligner.engine import PoastaAligner

                    res = PoastaAligner(self.costs, self.aln_type,
                                        heuristic="dijkstra").align(
                                            self.graph, q)
                    return "exact_fallback", (res.score, res.alignment)

            workers = max(1, min(len(queries), os.cpu_count() or 4))
            t0 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=workers) as pool:
                tagged = list(pool.map(one, enumerate(queries)))
            stats["host_s"] = time.perf_counter() - t0
            for kind, _ in tagged:
                stats[kind] += 1
            return [out for _, out in tagged]

        if two_piece:
            # the dense-table fallback below is one-piece math; without
            # the native engine, two-piece ends-free alignments run the
            # exact engine per read (correct, slow — small shapes only)
            from ..aligner.engine import PoastaAligner

            aligner = PoastaAligner(self.costs, self.aln_type,
                                    heuristic="dijkstra")
            out = []
            for q in queries:
                res = aligner.align(self.graph, q)
                out.append((res.score, res.alignment))
            return out

        table_bytes = (self.dg.n_nodes_padded * int(qshift.shape[0])
                       * int(qshift.shape[1]) * 12)
        if table_bytes > 4 * self.DENSE_TABLE_BUDGET:
            raise RuntimeError(
                "ends-free alignment needs the native engine for this "
                "shape (dense tables would need "
                f"{table_bytes >> 20} MiB)"
            )
        fs, end_ok, jlo = ends_free_device_params(
            self.flat, self.aln_type, lengths, self.dg.n_nodes_padded)
        _, M, I, D = dp_fill_full(self.dg, qshift, lengths, self.costs,
                                  free_start=fs)
        M, I, D = np.asarray(M), np.asarray(I), np.asarray(D)
        eo = np.asarray(end_ok)
        jlo_np = np.asarray(jlo)
        out = []
        for b, q in enumerate(queries):
            score, aln = backtrace_dense_ends_free(
                self.flat, M[:, b, :], I[:, b, :], D[:, b, :], q,
                self.costs, eo, int(jlo_np[b]), fs)
            out.append((score, aln))
        return out

    def _init_banded(self, two_piece) -> bool:
        """Construct the native engine (+ device scorer) once; False when
        the native library is unavailable (dense fallback)."""
        if getattr(self, "_native", None) is not None:
            return True
        from ..aligner.banded import BandedScorer

        try:
            from ..native import NativeAligner

            native = NativeAligner(self.graph)
        except Exception:
            return False  # no native engine: dense fallback
        # device scorer seeds each read's band with its exact score;
        # both cost models route through it (two-piece via the 5-state
        # XLA banded bodies)
        self._banded_scorer = BandedScorer(self.flat, self.costs,
                                           mesh=self.mesh, dg=self.dg)
        # cache only once every required object constructed — a
        # partial init would skip this block next call and crash on
        # the missing scorer instead of falling back to dense
        self._native = native
        return True

    def _device_scores(self, qshift, lengths, two_piece):
        """The scoring phase of the banded path (device-side; the
        pipelined serving loop runs it on a background thread while the
        host backtraces the previous batch).  Both cost models score
        through the banded scorer — exact via verify-and-retry."""
        return np.asarray(self._banded_scorer.scores(qshift, lengths))

    def supports_prescore(self, queries) -> bool:
        """Whether prescore() can overlap device scoring with host
        backtraces for this batch (the lasagna pipeline gate)."""
        if self.ends_free:
            # overlapping the scoring thread with the backtrace pool
            # needs a second host core
            import os

            return (os.cpu_count() or 1) > 1
        return self.takes_banded_path(queries)

    def takes_banded_path(self, queries) -> bool:
        """Whether align_batch would use the banded score+backtrace path
        for this batch (i.e. whether prescore() has anything to overlap).
        Computed from the raw reads — no packing or device upload."""
        if self.ends_free:
            return False  # ends-free alignment runs the dense path
        B = len(queries)
        maxlen = max((len(q) for q in queries), default=0)
        L = ((maxlen + 1 + 127) // 128) * 128  # pack_queries' padding rule
        table_bytes = self.dg.n_nodes_padded * B * L * 12
        two_piece = getattr(self.costs, "is_two_piece", False)
        return (two_piece or table_bytes > self.DENSE_TABLE_BUDGET
                or self.mesh is not None)

    def prescore(self, queries):
        """Run the device scoring phase for a batch ahead of time.

        Returns an opaque token for ``align_batch(prescored=...)``, or
        None when the batch would take the dense path / the native
        engine is unavailable (nothing to overlap).  Thread-safe against
        concurrent native backtraces of OTHER batches (the two phases
        touch disjoint state), not against concurrent prescore calls.
        """
        from ..aligner.wavefront import pack_queries

        two_piece = getattr(self.costs, "is_two_piece", False)
        if self.ends_free:
            # ends-free scoring phase (the bounded full fill):
            # overlapping it with the previous batch's native backtraces
            # is the same reader/aligner/writer overlap the reference's
            # lasagna gets from threads (lasagna.rs:217-273)
            if not queries:
                return None
            try:
                from ..native import NativeAligner

                if getattr(self, "_native", None) is None:
                    self._native = NativeAligner(self.graph)
            except Exception:
                return None  # dense fallback path: nothing to overlap
            qshift, lengths = pack_queries(queries)
            sc = self._ends_free_scores(qshift, lengths)
            return (queries, sc, qshift, lengths)
        if (not self.takes_banded_path(queries)
                or not self._init_banded(two_piece)):
            return None
        qshift, lengths = pack_queries(queries)
        scores = self._device_scores(qshift, lengths, two_piece)
        # the packed batch rides along so align_batch skips re-packing
        return (queries, scores, qshift, lengths)

    def _align_batch_banded(self, queries, qshift, lengths, scores=None):
        two_piece = getattr(self.costs, "is_two_piece", False)
        if not self._init_banded(two_piece):
            return None
        import os
        from concurrent.futures import ThreadPoolExecutor

        na = self._native
        if scores is None:
            scores = self._device_scores(qshift, lengths, two_piece)

        # both cost models: the device score is exact (banded
        # verify-and-retry), so it seeds the native band AND certifies
        # the backtrace
        def one(b):
            score, aln = na.align_banded(queries[b], self.costs,
                                         ub=int(scores[b]))
            assert score == int(scores[b]), (score, int(scores[b]))
            return score, aln

        self.last_banded_stats = {"host_backtraced": len(queries)}
        workers = max(1, min(len(queries), os.cpu_count() or 4))
        with ThreadPoolExecutor(max_workers=workers) as pool:
            return list(pool.map(one, range(len(queries))))
