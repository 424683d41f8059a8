"""Randomized cross-engine consistency sweep.

Every engine must agree on the optimal score for random graphs, random
reads, and random cost models: python exact (dijkstra oracle), native
exact, native banded, the device full fill, and the banded scorer.  This is
the reference's three-heuristics invariant (tests/test_heuristics.rs)
widened across all execution paths.
"""

import random

import numpy as np
import pytest

from poasta_tpu.aligner import GapAffine, GapAffine2Piece, Global, PoastaAligner
from poasta_tpu.aligner.banded import BandedScorer
from poasta_tpu.aligner.wavefront import DeviceGraph, dp_fill_scores, pack_queries
from poasta_tpu.graphs import POAGraph
from poasta_tpu.native import NativeAligner


def _random_graph_and_reads(rng, nseq, length, nq, div):
    base = "".join(rng.choice("ACGT") for _ in range(length))

    def mutate(s):
        out = []
        for ch in s:
            r = rng.random()
            if r < div:
                continue
            out.append(rng.choice("ACGT") if r < 2 * div else ch)
            if rng.random() < div:
                out.append(rng.choice("ACGT"))
        return "".join(out) or "A"

    g = POAGraph()
    build_costs = GapAffine(4, 2, 6)
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * length)
    for i in range(1, nseq):
        s = mutate(base).encode()
        _, aln, _ = NativeAligner(g).align(s, build_costs)
        g.add_alignment_with_weights(f"s{i}", s, aln, [1] * len(s))
    return g, [mutate(base).encode() for _ in range(nq)]


@pytest.mark.parametrize("seed", [101, 202, 303])
def test_all_engines_agree_one_piece(seed):
    rng = random.Random(seed)
    costs = GapAffine(
        mismatch=rng.choice([1, 3, 4, 7]),
        gap_extend=rng.choice([1, 2, 3]),
        gap_open=rng.choice([0, 4, 6, 11]),
    )
    g, queries = _random_graph_and_reads(
        rng, nseq=rng.choice([2, 3, 4]), length=rng.choice([50, 90, 140]),
        nq=5, div=rng.choice([0.02, 0.06, 0.12]),
    )
    py = PoastaAligner(costs, Global(), heuristic="dijkstra")
    na = NativeAligner(g)
    flat = g.flatten()
    dg = DeviceGraph.build(flat)
    qshift, lengths = pack_queries(queries)
    full = list(np.asarray(dp_fill_scores(dg, qshift, lengths, costs)))
    bs = BandedScorer(flat, costs)
    banded = list(np.asarray(bs.scores(qshift, lengths)))
    for i, q in enumerate(queries):
        oracle = py.align(g, q).score
        assert na.align(q, costs)[0] == oracle
        assert na.align_banded(q, costs)[0] == oracle
        assert full[i] == oracle
        assert banded[i] == oracle


@pytest.mark.parametrize("seed", [404, 505])
def test_all_engines_agree_two_piece(seed):
    rng = random.Random(seed)
    e2 = rng.choice([1, 2])
    e1 = e2 + rng.choice([1, 2])
    costs = GapAffine2Piece(
        mismatch=rng.choice([3, 4, 6]),
        gap_extend=e1,
        gap_open=rng.choice([4, 8]),
        gap_extend2=e2,
        gap_open2=rng.choice([16, 24]),
    )
    g, queries = _random_graph_and_reads(
        rng, nseq=3, length=rng.choice([60, 110]), nq=4,
        div=rng.choice([0.03, 0.08]),
    )
    # dijkstra is the admissible oracle (the 2p mingap quirk is inadmissible)
    py = PoastaAligner(costs, Global(), heuristic="dijkstra")
    na = NativeAligner(g)
    flat = g.flatten()
    dg = DeviceGraph.build(flat)
    qshift, lengths = pack_queries(queries)
    full = list(np.asarray(dp_fill_scores(dg, qshift, lengths, costs)))
    bs = BandedScorer(flat, costs)
    banded = list(np.asarray(bs.scores(qshift, lengths)))
    banded2 = list(np.asarray(bs.scores(qshift, lengths)))
    for i, q in enumerate(queries):
        oracle = py.align(g, q).score
        assert na.align_banded(q, costs)[0] == oracle
        assert full[i] == oracle
        assert banded[i] == oracle
        assert banded2[i] == oracle
