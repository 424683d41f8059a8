"""Bounded ends-free on the device path.

The exact host engines have carried Included/Excluded free-end bounds
since round 1; these tests pin the new device coverage:

* ``dp_fill_scores_ends_free`` — bounded full fill (XLA body),
* ``BandedScorer(aln_type=EndsFree(...))`` — bounded ends-free banding
  with verify-and-retry exactness,

against a dense-table oracle (full M tables reduced over the permitted
(rank, offset) end set exactly as the reference's ``is_end``,
``gap_affine.rs:185-248``), and against the exact engine with the
``device <= exact`` invariant (the exact engine reproduces the
reference's greedy-extension quirk — end states reached inside a
zero-cost match run are never end-tested — so it can return a
*sub-optimal* i.e. higher score; the device fills relax fully).
"""

import random

import numpy as np
import pytest

from poasta_tpu.aligner import GapAffine, PoastaAligner
from poasta_tpu.aligner.banded import BandedScorer
from poasta_tpu.aligner.costs import (
    EndsFree,
    UNBOUNDED,
    excluded,
    included,
)
from poasta_tpu.aligner.wavefront import (
    DeviceGraph,
    dp_fill_full,
    dp_fill_scores_ends_free,
    ends_free_device_params,
    pack_queries,
)
from poasta_tpu.graphs import POAGraph

COSTS = GapAffine(4, 2, 6)
INF = 1 << 28


def _mutate(rng, s, d):
    out = []
    for ch in s:
        r = rng.random()
        if r < d:
            continue
        out.append(rng.choice("ACGT") if r < 2 * d else ch)
        if rng.random() < d:
            out.append(rng.choice("ACGT"))
    return "".join(out) or "A"


def _graph_and_reads(seed, glen=130, n_reads=4):
    from poasta_tpu.native import NativeAligner

    rng = random.Random(seed)
    base = "".join(rng.choice("ACGT") for _ in range(glen))
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * glen)
    for i in range(1, 3):
        s = _mutate(rng, base, 0.05).encode()
        _, aln, _ = NativeAligner(g).align(s, COSTS)
        g.add_alignment_with_weights(f"s{i}", s, aln, [1] * len(s))
    reads = []
    for _ in range(n_reads):
        a = rng.randrange(0, glen // 3)
        b = rng.randrange(a + 20, glen)
        reads.append(_mutate(rng, base[a:b], 0.06).encode())
    return g, reads, rng


def _random_cfg(rng):
    def bound(hi):
        k = rng.randrange(3)
        if k == 0:
            return UNBOUNDED
        v = rng.randrange(0, hi)
        return included(v) if k == 1 else excluded(v)

    return EndsFree(
        qry_free_begin=UNBOUNDED,  # parsed-but-ignored (reference quirk)
        qry_free_end=bound(40),
        graph_free_begin=UNBOUNDED if rng.random() < 0.7 else included(3),
        graph_free_end=bound(40),
    )


def _dense_oracle(dg, flat, qshift, lengths, cfg):
    free_start, end_ok, jlo = ends_free_device_params(
        flat, cfg, lengths, dg.n_nodes_padded)
    _, M, _, _ = dp_fill_full(dg, qshift, lengths, COSTS,
                              free_start=free_start)
    M = np.asarray(M)
    eo = np.asarray(end_ok).astype(bool)
    jlo_np = np.asarray(jlo)
    lengths_np = np.asarray(lengths)
    out = []
    for b in range(M.shape[1]):
        n, lo = int(lengths_np[b]), int(jlo_np[b])
        if lo > n:
            out.append(INF)
            continue
        sub = M[eo, b, lo:n + 1]
        out.append(int(sub.min()) if sub.size else INF)
    return np.asarray(out)


@pytest.mark.parametrize("seed", list(range(50, 100)))
def test_bounded_ends_free_cross_engine_fuzz(seed):
    """>=50 seeds: device bounded fill == dense oracle == banded scorer,
    and device <= exact engine (greedy-extension quirk direction)."""
    g, reads, rng = _graph_and_reads(seed)
    flat = g.flatten()
    dg = DeviceGraph.build(flat)
    qshift, lengths = pack_queries(reads)
    cfg = _random_cfg(rng)

    oracle = _dense_oracle(dg, flat, qshift, lengths, cfg)
    device = np.asarray(
        dp_fill_scores_ends_free(dg, flat, qshift, lengths, COSTS, cfg))
    assert (device == oracle).all(), (cfg, device, oracle)

    banded = np.asarray(
        BandedScorer(flat, COSTS, dg=dg, aln_type=cfg).scores(
            qshift, lengths))
    assert (banded == oracle).all(), (cfg, banded, oracle)

    aligner = PoastaAligner(COSTS, cfg, heuristic="dijkstra")
    for b, read in enumerate(reads):
        try:
            exact = aligner.align(g, read).score
        except RuntimeError:
            exact = INF  # unsatisfiable bound: device yields INF too
        assert device[b] <= exact, (cfg, b, device[b], exact)


def test_bounded_ends_free_two_piece_matches_oracle():
    """Two-piece bounded ends-free runs the 5-layer bounded recurrence."""
    from poasta_tpu.aligner import GapAffine2Piece
    from poasta_tpu.aligner.wavefront import _scores_exec_bounded

    costs2 = GapAffine2Piece(4, 2, 6, 1, 24)
    g, reads, rng = _graph_and_reads(7)
    flat = g.flatten()
    dg = DeviceGraph.build(flat)
    qshift, lengths = pack_queries(reads)
    cfg = EndsFree(UNBOUNDED, included(15), UNBOUNDED, included(20))

    device = np.asarray(dp_fill_scores_ends_free(
        dg, flat, qshift, lengths, costs2, cfg))
    # oracle: exact 2p engine with dijkstra (admissible) as upper ref
    aligner = PoastaAligner(costs2, cfg, heuristic="dijkstra")
    for b, read in enumerate(reads):
        exact = aligner.align(g, read).score
        assert device[b] <= exact
    # and the banded scorer's 2p+ef full-fill route agrees with the fill
    banded = np.asarray(
        BandedScorer(flat, costs2, dg=dg, aln_type=cfg).scores(
            qshift, lengths))
    assert (banded == device).all()


def test_unsatisfiable_bounds_yield_inf():
    g, reads, _ = _graph_and_reads(3)
    flat = g.flatten()
    dg = DeviceGraph.build(flat)
    qshift, lengths = pack_queries(reads)
    # excluded(0) on the query: no remaining-suffix length is < 0
    cfg = EndsFree(UNBOUNDED, excluded(0), UNBOUNDED, UNBOUNDED)
    device = np.asarray(
        dp_fill_scores_ends_free(dg, flat, qshift, lengths, COSTS, cfg))
    assert (device >= INF).all()
    # excluded(0) on the graph end: not even the virtual end node
    # (distance 0) passes, mirroring the exact engine's drained queue
    cfg = EndsFree(UNBOUNDED, UNBOUNDED, UNBOUNDED, excluded(0))
    device = np.asarray(
        dp_fill_scores_ends_free(dg, flat, qshift, lengths, COSTS, cfg))
    assert (device >= INF).all()


def test_two_piece_unbounded_query_end_quirk():
    """The two-piece exact engine only ends at offset >= len(seq) for
    Unbounded qry_free_end; the device lowers the same quirk (jlo = n)
    so both agree on fully-unbounded two-piece ends-free."""
    from poasta_tpu.aligner import GapAffine2Piece

    costs2 = GapAffine2Piece(4, 2, 6, 1, 24)
    g, reads, _ = _graph_and_reads(11)
    flat = g.flatten()
    dg = DeviceGraph.build(flat)
    qshift, lengths = pack_queries(reads)
    cfg = EndsFree(UNBOUNDED, UNBOUNDED, UNBOUNDED, UNBOUNDED)
    device = np.asarray(dp_fill_scores_ends_free(
        dg, flat, qshift, lengths, costs2, cfg))
    aligner = PoastaAligner(costs2, cfg, heuristic="dijkstra")
    for b, read in enumerate(reads):
        exact = aligner.align(g, read).score
        assert device[b] <= exact, (b, device[b], exact)


def test_banded_ends_free_engages_bands_on_trimmed_reads():
    """Realistic bounded ends-free (reads trimmed at both ends, small
    bounds): the banded path must actually band, not full-fill."""
    from poasta_tpu.native import NativeAligner

    rng = random.Random(5)
    base = "".join(rng.choice("ACGT") for _ in range(2500))
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * 2500)
    for i in range(1, 3):
        s = _mutate(rng, base, 0.03).encode()
        _, aln, _ = NativeAligner(g).align(s, COSTS)
        g.add_alignment_with_weights(f"s{i}", s, aln, [1] * len(s))
    flat = g.flatten()
    dg = DeviceGraph.build(flat)
    reads = []
    for _ in range(8):
        a = rng.randrange(0, 30)
        b = 2500 - rng.randrange(0, 50)
        reads.append(_mutate(rng, base[a:b], 0.02).encode())
    qshift, lengths = pack_queries(reads)
    cfg = EndsFree(UNBOUNDED, included(60), UNBOUNDED, included(60))
    oracle = np.asarray(
        dp_fill_scores_ends_free(dg, flat, qshift, lengths, COSTS, cfg))
    bs = BandedScorer(flat, COSTS, dg=dg, aln_type=cfg)
    assert (np.asarray(bs.scores(qshift, lengths)) == oracle).all()
    bs.reset_stats()
    assert (np.asarray(bs.scores(qshift, lengths)) == oracle).all()
    assert bs.stats["tiers"] >= 1, "should band, not full-fill"
    full_cells = flat.n_nodes * int(qshift.shape[1]) * len(reads)
    assert bs.stats["cells_filled"] < full_cells / 1.5


def test_anchored_alignments_match_device_scores():
    """Production ends-free alignment path: the device reports each
    read's optimal end state; the native engine fills only an
    end-anchored corridor and backtraces.  Pinned: anchored score ==
    device score, alignment cost == score, full query span for
    semi-global (qry included(0))."""
    from poasta_tpu.aligner.wavefront import (
        alignment_cost,
        dp_fill_ends_free_with_ends,
    )
    from poasta_tpu.native import NativeAligner

    rng = random.Random(21)
    glen = 500
    base = "".join(rng.choice("ACGT") for _ in range(glen))
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * glen)
    for i in range(1, 3):
        s = _mutate(rng, base, 0.05).encode()
        _, aln, _ = NativeAligner(g).align(s, COSTS)
        g.add_alignment_with_weights(f"s{i}", s, aln, [1] * len(s))
    flat = g.flatten()
    dg = DeviceGraph.build(flat)
    na = NativeAligner(g)
    reads = []
    for _ in range(8):
        a = rng.randrange(0, 200)
        b = rng.randrange(a + 60, glen)
        reads.append(_mutate(rng, base[a:b], 0.03).encode())
    qshift, lengths = pack_queries(reads)
    cfg = EndsFree(UNBOUNDED, included(0), UNBOUNDED, UNBOUNDED)
    sc, er, ej = dp_fill_ends_free_with_ends(dg, flat, qshift, lengths,
                                             COSTS, cfg)
    sc = np.asarray(sc)
    er = np.asarray(er)
    ej = np.asarray(ej)
    for b, read in enumerate(reads):
        score, aln = na.align_anchored(
            read, COSTS, int(flat.node_of_rank[er[b]]), int(ej[b]),
            int(sc[b]))
        assert score == sc[b]
        assert alignment_cost(g, read, aln, COSTS) == score
        qs = [p.qpos for p in aln if p.qpos is not None]
        assert qs and qs[0] == 0 and qs[-1] == len(read) - 1


def test_batchmapper_ends_free_anchored_path():
    """BatchMapper(aln_type=...) serves ends-free alignments through the
    anchored path when the native engine is present."""
    from poasta_tpu.aligner.wavefront import alignment_cost
    from poasta_tpu.native import NativeAligner
    from poasta_tpu.parallel import BatchMapper

    rng = random.Random(31)
    glen = 600
    base = "".join(rng.choice("ACGT") for _ in range(glen))
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * glen)
    s = _mutate(rng, base, 0.04).encode()
    _, aln, _ = NativeAligner(g).align(s, COSTS)
    g.add_alignment_with_weights("s1", s, aln, [1] * len(s))
    reads = []
    for _ in range(6):
        a = rng.randrange(0, 250)
        b = rng.randrange(a + 80, glen)
        reads.append(_mutate(rng, base[a:b], 0.02).encode())
    cfg = EndsFree(UNBOUNDED, included(0), UNBOUNDED, UNBOUNDED)
    mapper = BatchMapper(g, COSTS, aln_type=cfg)
    out = mapper.align_batch(reads)
    ref = np.asarray(mapper.score_batch(reads))
    for b, (score, alignment) in enumerate(out):
        assert score == ref[b]
        assert alignment_cost(g, reads[b], alignment, COSTS) == score


def test_sharded_ends_free_matches_single_device():
    """dp-sharded ends-free fill (scores + end anchors) equals the
    single-device path on the virtual CPU mesh; BatchMapper ends-free
    alignments are mesh-invariant."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs the virtual CPU mesh")
    from poasta_tpu.aligner.wavefront import dp_fill_ends_free_with_ends
    from poasta_tpu.native import NativeAligner
    from poasta_tpu.parallel import BatchMapper, make_mesh

    rng = random.Random(6)
    base = "".join(rng.choice("ACGT") for _ in range(500))
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * 500)
    s = _mutate(rng, base, 0.05).encode()
    _, aln, _ = NativeAligner(g).align(s, COSTS)
    g.add_alignment_with_weights("s1", s, aln, [1] * len(s))
    flat = g.flatten()
    dg = DeviceGraph.build(flat)
    reads = []
    for _ in range(8):
        a = rng.randrange(0, 200)
        b = rng.randrange(a + 80, 500)
        reads.append(_mutate(rng, base[a:b], 0.02).encode())
    qshift, lengths = pack_queries(reads)
    cfg = EndsFree(UNBOUNDED, included(0), UNBOUNDED, UNBOUNDED)
    mesh = make_mesh(devices=jax.devices()[:4], dp=4, sp=1)
    s1, r1, j1 = (np.asarray(a) for a in dp_fill_ends_free_with_ends(
        dg, flat, qshift, lengths, COSTS, cfg))
    s2, r2, j2 = (np.asarray(a) for a in dp_fill_ends_free_with_ends(
        dg, flat, qshift, lengths, COSTS, cfg, mesh=mesh))
    assert (s1 == s2).all() and (r1 == r2).all() and (j1 == j2).all()

    out_mesh = BatchMapper(g, COSTS, mesh=mesh,
                           aln_type=cfg).align_batch(reads)
    out_one = BatchMapper(g, COSTS, aln_type=cfg).align_batch(reads)
    assert out_mesh == out_one


@pytest.mark.parametrize("seed", [61, 62, 63, 64])
def test_anchored_alignments_bounded_configs(seed):
    """The anchored corridor path under BOUNDED free-end configs: the
    device's permitted end anchor feeds the native corridor, and the
    emitted alignment's cost equals the device score."""
    from poasta_tpu.aligner.wavefront import alignment_cost
    from poasta_tpu.parallel import BatchMapper

    g, reads, rng = _graph_and_reads(seed, glen=300, n_reads=6)
    cfg = EndsFree(UNBOUNDED,
                   included(rng.randrange(5, 40)),
                   UNBOUNDED if rng.random() < 0.5 else included(3),
                   excluded(rng.randrange(10, 50)))
    mapper = BatchMapper(g, COSTS, aln_type=cfg)
    try:
        out = mapper.align_batch(reads)
    except RuntimeError as exc:
        assert "unsatisfiable" in str(exc)
        return
    ref = np.asarray(mapper.score_batch(reads))
    for b, (score, alignment) in enumerate(out):
        assert score == ref[b], (b, score, ref[b])
        assert alignment_cost(g, reads[b], alignment, COSTS) == score


def test_anchored_2p_fuzz():
    """Two-piece anchored corridor alignments (round-2 VERDICT missing
    #1): the 5-layer with-ends device fill anchors the native two-piece
    corridor; over >=50 random graph/read/cost configs the anchored
    score equals the device score and the emitted alignment's
    state-machine cost (I->I2 / D->D2 at extend2) equals that score.
    Bounded free-end configs are mixed in alongside semi-global."""
    from poasta_tpu.aligner.costs import GapAffine2Piece
    from poasta_tpu.aligner.wavefront import (
        alignment_cost,
        dp_fill_ends_free_with_ends,
    )
    from poasta_tpu.native import NativeAligner

    cost_sets = [
        GapAffine2Piece(4, 2, 8, 1, 24),
        GapAffine2Piece(5, 3, 6, 1, 30),
        GapAffine2Piece(4, 2, 6, 2, 20),
    ]
    checked = 0
    for seed in range(200, 220):
        g, reads, rng = _graph_and_reads(seed, glen=130, n_reads=3)
        flat = g.flatten()
        dg = DeviceGraph.build(flat)
        na = NativeAligner(g)
        costs = cost_sets[seed % len(cost_sets)]
        if seed % 4 < 3:
            cfg = EndsFree(UNBOUNDED, included(0), UNBOUNDED, UNBOUNDED)
        else:
            cfg = EndsFree(UNBOUNDED, included(rng.randrange(5, 30)),
                           UNBOUNDED, excluded(rng.randrange(10, 40)))
        free_start = cfg.graph_free_begin[0] == "unbounded"
        qshift, lengths = pack_queries(reads)
        sc, er, ej = (np.asarray(a) for a in dp_fill_ends_free_with_ends(
            dg, flat, qshift, lengths, costs, cfg))
        for b, read in enumerate(reads):
            if sc[b] >= INF:
                continue
            score, aln = na.align_anchored(
                read, costs, int(flat.node_of_rank[er[b]]), int(ej[b]),
                int(sc[b]), free_start=free_start)
            assert score == sc[b], (seed, b, score, sc[b])
            assert alignment_cost(g, read, aln, costs) == score, (seed, b)
            checked += 1
    assert checked >= 50


def test_batchmapper_2p_ends_free_alignments():
    """BatchMapper serves two-piece ends-free alignments through the
    anchored native path (the round-2 NotImplementedError is gone)."""
    from poasta_tpu.aligner.costs import GapAffine2Piece
    from poasta_tpu.aligner.wavefront import alignment_cost
    from poasta_tpu.parallel import BatchMapper

    g, reads, _ = _graph_and_reads(71, glen=300, n_reads=6)
    costs = GapAffine2Piece(4, 2, 8, 1, 24)
    cfg = EndsFree(UNBOUNDED, included(0), UNBOUNDED, UNBOUNDED)
    mapper = BatchMapper(g, costs, aln_type=cfg)
    out = mapper.align_batch(reads)
    ref = np.asarray(mapper.score_batch(reads))
    for b, (score, alignment) in enumerate(out):
        assert score == ref[b], (b, score, ref[b])
        assert alignment_cost(g, reads[b], alignment, costs) == score
        qs = [p.qpos for p in alignment if p.qpos is not None]
        assert qs and qs[0] == 0 and qs[-1] == len(reads[b]) - 1
