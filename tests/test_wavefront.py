"""Device wavefront engine vs the exact host oracle."""

import random

import numpy as np
import pytest

from poasta_tpu.aligner import GapAffine, Global, PoastaAligner
from poasta_tpu.aligner.wavefront import (
    DeviceGraph,
    alignment_cost,
    backtrace_dense,
    dp_fill_full,
    dp_fill_scores,
    pack_queries,
)
from poasta_tpu.graphs import POAGraph

COSTS = GapAffine(4, 2, 6)


def _random_case(seed, nseq=3, length=24, nq=3):
    rng = random.Random(seed)
    base = "".join(rng.choice("ACGT") for _ in range(length))

    def mutate(s):
        out = []
        for ch in s:
            r = rng.random()
            if r < 0.08:
                continue
            out.append(rng.choice("ACGT") if r < 0.16 else ch)
            if rng.random() < 0.05:
                out.append(rng.choice("ACGT"))
        return "".join(out) or "A"

    g = POAGraph()
    aligner = PoastaAligner(COSTS, Global(), heuristic="mingap")
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * length)
    for i in range(1, nseq):
        s = mutate(base).encode()
        res = aligner.align(g, s)
        g.add_alignment_with_weights(f"s{i}", s, res.alignment, [1] * len(s))
    return g, [mutate(base).encode() for _ in range(nq)]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_scores_match_oracle(seed):
    g, queries = _random_case(seed)
    dg = DeviceGraph.build(g.flatten())
    qshift, lengths = pack_queries(queries)
    scores = np.asarray(dp_fill_scores(dg, qshift, lengths, COSTS))
    aligner = PoastaAligner(COSTS, Global(), heuristic="mingap")
    oracle = [aligner.align(g, q).score for q in queries]
    assert list(scores) == oracle


def test_full_fill_backtrace_optimal():
    g, queries = _random_case(5)
    flat = g.flatten()
    dg = DeviceGraph.build(flat)
    qshift, lengths = pack_queries(queries)
    scores, M, I, D = dp_fill_full(dg, qshift, lengths, COSTS)
    M, I, D = np.asarray(M), np.asarray(I), np.asarray(D)
    aligner = PoastaAligner(COSTS, Global(), heuristic="mingap")
    for b, q in enumerate(queries):
        aln = backtrace_dense(flat, M[:, b, :], I[:, b, :], D[:, b, :], q, COSTS)
        # the reconstructed alignment is a valid optimal alignment; a
        # leading query-insertion run is (by the shared engine convention)
        # not emitted as pairs, so account for its cost separately
        lead = min((p.qpos for p in aln if p.qpos is not None), default=len(q))
        cost = alignment_cost(g, q, aln, COSTS)
        if lead:
            cost += COSTS.gap_open + COSTS.gap_extend * lead
        assert cost == aligner.align(g, q).score
        qpos = [p.qpos for p in aln if p.qpos is not None]
        assert qpos == list(range(lead, len(q)))


def test_backtrace_leading_insertion_convention():
    """Leading query insertions are omitted from the emitted pairs by ALL
    engines (exact python, native, dense backtrace) — pin the convention."""
    from poasta_tpu.graphs import POAGraph

    g = POAGraph()
    g.add_alignment_with_weights("s0", b"AC", None, [1, 1])
    flat = g.flatten()
    dg = DeviceGraph.build(flat)
    q = b"TTAC"
    qshift, lengths = pack_queries([q])
    scores, M, I, D = dp_fill_full(dg, qshift, lengths, COSTS)
    M, I, D = np.asarray(M), np.asarray(I), np.asarray(D)
    aln = backtrace_dense(flat, M[:, 0, :], I[:, 0, :], D[:, 0, :], q, COSTS)
    pairs = [(p.rpos, p.qpos) for p in aln]
    aligner = PoastaAligner(COSTS, Global(), heuristic="mingap")
    res = aligner.align(g, q)
    assert pairs == [(p.rpos, p.qpos) for p in res.alignment]
    assert int(scores[0]) == res.score


def test_dp_fill_full_rejects_two_piece():
    from poasta_tpu.aligner import GapAffine2Piece

    g, _ = _random_case(3)
    dg = DeviceGraph.build(g.flatten())
    qshift, lengths = pack_queries([b"ACGT"])
    with pytest.raises(NotImplementedError):
        dp_fill_full(dg, qshift, lengths, GapAffine2Piece(4, 8, 6, 2, 24))


def test_varied_lengths_in_one_batch():
    g, _ = _random_case(9)
    dg = DeviceGraph.build(g.flatten())
    queries = [b"ACGT", b"A", b"ACGTACGTACGTACGTACGTACG"]
    qshift, lengths = pack_queries(queries)
    scores = np.asarray(dp_fill_scores(dg, qshift, lengths, COSTS))
    aligner = PoastaAligner(COSTS, Global(), heuristic="mingap")
    oracle = [aligner.align(g, q).score for q in queries]
    assert list(scores) == oracle


def test_bucketed_shapes_share_compile():
    """Graphs padding to the same bucket reuse the cached executable."""
    from poasta_tpu.aligner.wavefront import _scores_exec

    g1, q1 = _random_case(11, length=20)
    g2, q2 = _random_case(12, length=22)
    dg1 = DeviceGraph.build(g1.flatten())
    dg2 = DeviceGraph.build(g2.flatten())
    before = _scores_exec.cache_info().currsize
    for g, dg, qs in ((g1, dg1, q1), (g2, dg2, q2)):
        qshift, lengths = pack_queries(qs)
        s = np.asarray(dp_fill_scores(dg, qshift, lengths, COSTS))
        aligner = PoastaAligner(COSTS, Global(), heuristic="mingap")
        assert list(s) == [aligner.align(g, q).score for q in qs]
    after = _scores_exec.cache_info().currsize
    assert after - before <= 2  # same static config → at most per-window entries
