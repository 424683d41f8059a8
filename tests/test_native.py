"""Native (C++) engine parity with the Python exact engine."""

import random

import pytest

from poasta_tpu.aligner import GapAffine, GapAffine2Piece, Global, PoastaAligner
from poasta_tpu.graphs import POAGraph

try:
    from poasta_tpu.native import NativeAligner, native_available

    HAVE_NATIVE = native_available()
except Exception:
    HAVE_NATIVE = False

pytestmark = pytest.mark.skipif(not HAVE_NATIVE, reason="native toolchain unavailable")

COSTS = GapAffine(4, 2, 6)


def _case(seed, nseq=3, length=40, nq=4):
    rng = random.Random(seed)
    base = "".join(rng.choice("ACGT") for _ in range(length))

    def mutate(s):
        out = []
        for ch in s:
            r = rng.random()
            if r < 0.06:
                continue
            out.append(rng.choice("ACGT") if r < 0.12 else ch)
            if rng.random() < 0.04:
                out.append(rng.choice("ACGT"))
        return "".join(out) or "A"

    g = POAGraph()
    py = PoastaAligner(COSTS, Global(), heuristic="mingap")
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * length)
    for i in range(1, nseq):
        s = mutate(base).encode()
        r = py.align(g, s)
        g.add_alignment_with_weights(f"s{i}", s, r.alignment, [1] * len(s))
    return g, [mutate(base).encode() for _ in range(nq)]


@pytest.mark.parametrize("seed", [1, 7, 13])
@pytest.mark.parametrize("heuristic", ["mingap", "dijkstra"])
def test_native_matches_python_exactly(seed, heuristic):
    g, queries = _case(seed)
    py = PoastaAligner(COSTS, Global(), heuristic=heuristic)
    na = NativeAligner(g)
    for q in queries:
        r = py.align(g, q)
        score, aln, stats = na.align(q, COSTS, heuristic=heuristic)
        assert score == r.score
        assert [(p.rpos, p.qpos) for p in aln] == [
            (p.rpos, p.qpos) for p in r.alignment
        ]
        assert stats == (r.num_queued, r.num_visited, r.num_pruned)


def test_native_two_piece_matches_python():
    costs2 = GapAffine2Piece(4, 2, 8, 1, 24)
    g, queries = _case(3)
    py = PoastaAligner(costs2, Global(), heuristic="mingap")
    na = NativeAligner(g)
    for q in queries:
        r = py.align(g, q)
        score, aln, _ = na.align(q, costs2)
        assert score == r.score
        assert [(p.rpos, p.qpos) for p in aln] == [
            (p.rpos, p.qpos) for p in r.alignment
        ]


@pytest.mark.parametrize("seed", [2, 11])
def test_native_banded_exact_and_matches_dense_backtrace(seed):
    import numpy as np

    from poasta_tpu.aligner.wavefront import (
        DeviceGraph,
        backtrace_dense,
        dp_fill_full,
        pack_queries,
    )

    g, queries = _case(seed)
    flat = g.flatten()
    dg = DeviceGraph.build(flat)
    na = NativeAligner(g)
    for q in queries:
        sc_exact, _, _ = na.align(q, COSTS)
        sc_b, aln_b = na.align_banded(q, COSTS)
        assert sc_b == sc_exact
        # ub hint (the production path: device score seeds the band)
        sc_h, aln_h = na.align_banded(q, COSTS, ub=sc_exact)
        assert sc_h == sc_exact
        assert [(p.rpos, p.qpos) for p in aln_h] == [
            (p.rpos, p.qpos) for p in aln_b
        ]
        qs, ln = pack_queries([q])
        _, M, I, D = dp_fill_full(dg, qs, ln, COSTS)
        aln_d = backtrace_dense(flat, np.asarray(M)[:, 0, :],
                                np.asarray(I)[:, 0, :],
                                np.asarray(D)[:, 0, :], q, COSTS)
        assert [(p.rpos, p.qpos) for p in aln_b] == [
            (p.rpos, p.qpos) for p in aln_d
        ]


def test_native_banded_int32_gate_side():
    """ub > 30000 routes the fill to the int32 table instantiation (the
    int16 saturating tables serve ub <= 30000); both sides of the gate
    must return identical scores and alignments."""
    g, queries = _case(5)
    na = NativeAligner(g)
    for q in queries[:3]:
        sc16, aln16 = na.align_banded(q, COSTS, ub=30000, max_retries=1)
        sc32, aln32 = na.align_banded(q, COSTS, ub=30001, max_retries=1)
        assert sc16 == sc32
        assert [(p.rpos, p.qpos) for p in aln16] == [
            (p.rpos, p.qpos) for p in aln32
        ]


def test_batch_mapper_banded_path():
    from poasta_tpu.parallel import BatchMapper
    from poasta_tpu.aligner.wavefront import alignment_cost

    g, queries = _case(4, nseq=3, length=80, nq=6)
    bm = BatchMapper(g, COSTS)
    bm.DENSE_TABLE_BUDGET = 0  # force the banded path regardless of size
    out = bm.align_batch(queries)
    na = NativeAligner(g)
    for q, (score, aln) in zip(queries, out):
        assert score == na.align(q, COSTS)[0]
        assert alignment_cost(g, q, aln, COSTS) == score


def test_native_banded_two_piece_optimal():
    # the banded dense fill returns the TRUE two-piece optimum (like the
    # device engine), which the exact engines' inadmissible 2p mingap may
    # miss — so the oracle here is dijkstra (admissible)
    costs2 = GapAffine2Piece(4, 2, 8, 1, 24)
    g, queries = _case(6, length=60)
    queries.append(b"".join([queries[0][:20], b"G" * 25, queries[0][20:]]))
    py = PoastaAligner(costs2, Global(), heuristic="dijkstra")
    na = NativeAligner(g)
    for q in queries:
        s_b, aln = na.align_banded(q, costs2)
        assert s_b == py.align(g, q).score
        assert aln  # non-empty alignment


def test_batch_mapper_banded_two_piece():
    from poasta_tpu.parallel import BatchMapper

    costs2 = GapAffine2Piece(4, 2, 8, 1, 24)
    g, queries = _case(8, length=60)
    bm = BatchMapper(g, costs2)
    bm.DENSE_TABLE_BUDGET = 0  # force the banded path
    out = bm.align_batch(queries)
    py = PoastaAligner(costs2, Global(), heuristic="dijkstra")
    for q, (score, aln) in zip(queries, out):
        assert score == py.align(g, q).score


def test_batch_mapper_two_piece_small_tables_routes_banded():
    # regression: small 2p batches used to fall into the one-piece dense
    # path and score with the wrong cost model
    from poasta_tpu.parallel import BatchMapper

    costs2 = GapAffine2Piece(4, 2, 8, 1, 24)
    g, queries = _case(9, length=50)
    bm = BatchMapper(g, costs2)  # default (large) dense budget
    out = bm.align_batch(queries)
    py = PoastaAligner(costs2, Global(), heuristic="dijkstra")
    for q, (score, aln) in zip(queries, out):
        assert score == py.align(g, q).score
