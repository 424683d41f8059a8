"""Two-piece affine wavefront engine vs the exact oracle.

NB the oracle is compared under the **dijkstra** heuristic: the two-piece
minimum-gap-cost heuristic inherited from the reference
(``src/aligner/config.rs:242-244`` builds it from (open2, extend2)) is
inadmissible for short gaps, so mingap A* can return inflated scores for
the two-piece model.  The dense fill computes the true optimum.
"""

import random

import numpy as np
import pytest

from poasta_tpu.aligner import GapAffine, GapAffine2Piece, Global, PoastaAligner
from poasta_tpu.aligner.wavefront import DeviceGraph, dp_fill_scores, pack_queries
from poasta_tpu.graphs import POAGraph

COSTS2 = GapAffine2Piece(4, 2, 8, 1, 24)


def _case(seed):
    rng = random.Random(seed)
    base = "".join(rng.choice("ACGT") for _ in range(36))

    def mutate(s, big_indel=False):
        out = []
        for ch in s:
            r = rng.random()
            if r < 0.06:
                continue
            out.append(rng.choice("ACGT") if r < 0.12 else ch)
        s2 = "".join(out) or "A"
        if big_indel and len(s2) > 20:
            if rng.random() < 0.5:
                s2 = s2[:8] + s2[20:]
            else:
                s2 = s2[:10] + "".join(rng.choice("ACGT") for _ in range(12)) + s2[10:]
        return s2

    g = POAGraph()
    py = PoastaAligner(GapAffine(4, 2, 6), Global(), heuristic="mingap")
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * 36)
    for i in range(1, 3):
        s = mutate(base).encode()
        r = py.align(g, s)
        g.add_alignment_with_weights(f"s{i}", s, r.alignment, [1] * len(s))
    return g, [mutate(base, big_indel=True).encode() for _ in range(4)]


@pytest.mark.parametrize("seed", [5, 11])
def test_two_piece_scores_match_dijkstra_oracle(seed):
    g, queries = _case(seed)
    dg = DeviceGraph.build(g.flatten())
    qshift, lengths = pack_queries(queries)
    dev = np.asarray(dp_fill_scores(dg, qshift, lengths, COSTS2))
    oracle = [
        PoastaAligner(COSTS2, Global(), heuristic="dijkstra").align(g, q).score
        for q in queries
    ]
    assert list(dev) == oracle


def test_two_piece_prefers_long_gap_second_piece():
    """A long gap should cost open1 + extend1 + (k-1)*extend2."""
    g = POAGraph()
    g.add_alignment_with_weights("s0", b"ACGTACGTACGTACGTACGT", None, [1] * 20)
    dg = DeviceGraph.build(g.flatten())
    # query = first 5 chars: deletion of 15 graph nodes
    q = b"ACGTA"
    qshift, lengths = pack_queries([q])
    score = int(np.asarray(dp_fill_scores(dg, qshift, lengths, COSTS2))[0])
    o1, e1, e2 = 8, 2, 1
    k = 15
    assert score == o1 + e1 + (k - 1) * e2
