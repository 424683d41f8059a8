"""The banded fill's prepared tables, its XLA executor and the rules that
choose between executors.

One ``prepare_banded`` feeds both executors (the XLA body here, the CUDA
kernel on the card).  On the CPU these tests check the XLA executor on
the packed layout against the native exact engine, the full fill, and a
NumPy model of the CUDA kernel's formulation (per-slot drift frames in
place of ring rolls); the executor-choice, shared-memory and clamp rules
run from the shapes alone.  The CUDA kernel itself is compared with the
same XLA body on the card (``chip_smoke.py``, ``pytest -m gpu``).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest

from poasta_tpu.aligner import GapAffine, GapAffine2Piece
from poasta_tpu.aligner import banded as bd
from poasta_tpu.aligner.banded import BandedScorer
from poasta_tpu.aligner.costs import EndsFree, UNBOUNDED, included
from poasta_tpu.aligner.wavefront import (
    DeviceGraph,
    dp_fill_ends_free_with_ends,
    dp_fill_scores,
    dp_fill_scores_ends_free,
    ends_free_device_params,
    pack_queries,
)
from poasta_tpu.graphs import POAGraph
from poasta_tpu.native import NativeAligner
from poasta_tpu.ops import banded_fill as bf
from poasta_tpu.ops.dp_rows import INF

COSTS = GapAffine(4, 2, 6)
COSTS2P = GapAffine2Piece(4, 2, 6, 1, 24)
SEMI = EndsFree(UNBOUNDED, included(0), UNBOUNDED, UNBOUNDED)
BOUNDED = EndsFree(("unbounded", None), included(50), included(0),
                   included(50))


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


def _fused(rng, glen, n_seqs=3, div=0.04, costs=COSTS):
    base = "".join(rng.choice("ACGT") for _ in range(glen))
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * glen)
    for i in range(1, n_seqs):
        s = _mutate(rng, base, div).encode()
        _, aln, _ = NativeAligner(g).align(s, costs)
        g.add_alignment_with_weights(f"s{i}", s, aln, [1] * len(s))
    return g, base


def _sv_graph(rng, costs, glen=800, cut=100):
    base = "".join(rng.choice("ACGT") for _ in range(glen))
    variant = base[:cut] + base[glen - cut:]
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * glen)
    _, aln, _ = NativeAligner(g).align(variant.encode(), costs)
    g.add_alignment_with_weights("s1", variant.encode(), aln,
                                 [1] * len(variant))
    return g, base, variant


def _native(g, reads, costs):
    if getattr(costs, "is_two_piece", False):
        from poasta_tpu.aligner import Global, PoastaAligner

        aligner = PoastaAligner(costs, Global(), heuristic="dijkstra")
        return np.array([aligner.align(g, q).score for q in reads])
    na = NativeAligner(g)
    return np.array([na.align(q, costs)[0] for q in reads])


# ---------------------------------------------------------------------------
# NumPy model of the CUDA kernel (ops/cuda/banded_fill.cu), one read at a
# time: rings of W x Wb lanes, drift through per-slot write frames.
# ---------------------------------------------------------------------------

def _np_banded(dg, tables, q, lengths, costs, ends=None, n_min=0, mq=0):
    o, e, x = costs.gap_open, costs.gap_extend, costs.mismatch
    W, Wb, S = dg.window, tables.width, tables.S
    sym = np.asarray(dg.symbols)
    slots = np.asarray(dg.pred_slots)
    valid = np.asarray(tables.pred_valid)
    pws = np.asarray(tables.pred_wstarts)
    ws = np.asarray(tables.wstarts)
    wsl = np.asarray(dg.write_slots)
    s_r = np.asarray(tables.s_ranks) if S else None
    q = np.asarray(q).astype(np.int64)
    lengths = np.asarray(lengths)
    if ends is not None:
        free_start, end_ok, jlo = ends
        end_ok, jlo = np.asarray(end_ok), np.asarray(jlo)
    n = dg.n_nodes
    lanes = np.arange(Wb)
    out = []
    for b in range(q.shape[0]):
        ln = int(lengths[b])
        nbs = max(ln - n_min + 64, 0) // 128
        M = np.full((W, Wb), INF, np.int64)
        D = np.full((W, Wb), INF, np.int64)
        sigw = np.zeros(W, np.int64)
        best = INF
        for r in range(n):
            sig = 128 * ((nbs * int(s_r[r])) // S) if S else 0
            j = ws[r] + sig + lanes
            pm = np.full(Wb + 1, INF, np.int64)  # pm[0]: lane -1
            pd = np.full(Wb, INF, np.int64)
            for p in range(slots.shape[1]):
                if not valid[r, p]:
                    continue
                slot = slots[r, p]
                pos = ws[r] - pws[r, p] + np.arange(-1, Wb)
                s = pos + sig - sigw[slot]
                ok = (pos >= 0) & (s < Wb)
                sc = np.clip(s, 0, Wb - 1)
                pm = np.minimum(pm, np.where(ok, M[slot, sc], INF))
                pd = np.minimum(pd, np.where(ok[1:], D[slot, sc[1:]], INF))
            pm[0] = INF
            is_end = r == n - 1
            Dn = np.minimum(np.minimum(pm[1:] + o + e, pd + e), INF)
            qi = mq + j
            qs = np.where((qi >= 0) & (qi < q.shape[1]),
                          q[b, np.clip(qi, 0, q.shape[1] - 1)], 0)
            diag = np.minimum(pm[:-1] + np.where(qs == sym[r], 0, x), INF)
            A = np.minimum(diag, Dn)
            origin = r == 0 or (ends is not None and free_start
                                and not S and not is_end)
            if origin:
                A = np.where(j == 0, np.minimum(A, 0), A)
            pref = np.minimum.accumulate(A - e * j)
            before = np.concatenate([[INF], pref[:-1]])
            Mn = np.minimum(A, np.minimum(before + o + e * j, INF))
            if is_end:
                Mn, Dn = pm[1:].copy(), np.full(Wb, INF, np.int64)
            M[wsl[r]], D[wsl[r]], sigw[wsl[r]] = Mn, Dn, sig
            if ends is not None:
                if end_ok[r]:
                    win = (j >= jlo[b]) & (j <= ln)
                    if win.any():
                        best = min(best, int(Mn[win].min()))
            elif is_end and 0 <= ln - ws[r] - sig < Wb:
                best = int(Mn[ln - ws[r] - sig])
        out.append(best)
    return np.array(out)


def _layout(flat, dg, qshift, lengths, costs, ub, drift, aln_type=None):
    ln = np.asarray(lengths)
    n_min, n_max = int(ln.min()), int(ln.max())
    L = int(qshift.shape[1])
    if drift:
        S = bd.drift_steps_for(n_min, n_max)
        ws, width, s_r = bd.band_windows_drift(flat, n_min, n_max, costs,
                                               ub, S, aln_type=aln_type)
        mq = bd._round_up(max(0, -int(ws.min())), 128)
        tables = bf.prepare_banded(dg, ws, width, s_r, S)
        kw = {"n_min": n_min, "mq": mq}
    else:
        ws, width, _, _ = bd.band_windows(flat, n_min, n_max, costs, ub,
                                          aln_type=aln_type)
        tables, mq, kw = bf.prepare_banded(dg, ws, width), 0, {}
    req = bd._round_up(int(ws.max()) + width, 128)
    parts = [qshift]
    if mq:
        parts.insert(0, jnp.zeros((qshift.shape[0], mq), qshift.dtype))
    if req > L:
        parts.append(jnp.zeros((qshift.shape[0], req - L), qshift.dtype))
    return tables, jnp.concatenate(parts, axis=1), kw


@pytest.mark.parametrize("drift,span", [
    (False, None), (False, "bounded"), (False, "semi"), (True, None),
    (True, "bounded")], ids=["shared", "shared-ef", "shared-map", "drift",
                             "drift-ef"])
@pytest.mark.parametrize("ub", [40, 400])
def test_xla_executor_matches_kernel_model(drift, span, ub):
    """Raw fills (over-estimates included) of the XLA body equal the
    NumPy model of the CUDA kernel on the same tables."""
    rng = random.Random(3)
    g, base, variant = _sv_graph(rng, COSTS, glen=500, cut=60)
    flat = g.flatten()
    dg = DeviceGraph.build(flat)
    reads = [_mutate(rng, base if i % 2 else variant, 0.03).encode()
             for i in range(4)]
    qshift, lengths = pack_queries(reads)
    aln = {None: None, "bounded": BOUNDED, "semi": SEMI}[span]
    tables, q_in, kw = _layout(flat, dg, qshift, lengths, COSTS, ub, drift,
                               aln)
    ends = None
    if aln is not None:
        ends = ends_free_device_params(flat, aln, lengths, dg.n_nodes_padded)
    got = np.asarray(bf.banded_scores("xla", dg, tables, q_in, lengths,
                                      COSTS, ends=ends, **kw))
    ref = _np_banded(dg, tables, q_in, lengths, COSTS, ends=ends, **kw)
    assert (got == ref).all(), (got, ref)


def test_prepared_tables_layout():
    """Predecessor window starts follow the rank table; bucket padding
    rows read window 0 and step 0."""
    rng = random.Random(2)
    g, _ = _fused(rng, 90)
    flat = g.flatten()
    dg = DeviceGraph.build(flat)
    n = flat.n_nodes
    ws = np.arange(n, dtype=np.int32) * 3
    s_r = (np.arange(n) * 4 // max(n - 1, 1)).astype(np.int32)
    t = bf.prepare_banded(dg, ws, 256, s_r, 4)
    pw = np.asarray(t.pred_wstarts)
    assert pw.shape == (dg.n_nodes_padded, dg.pred_slots.shape[1])
    full = np.zeros(dg.n_nodes_padded, np.int32)
    full[:n] = ws
    assert (pw == full[dg.pred_ranks_np]).all()
    assert (np.asarray(t.wstarts)[n:] == 0).all()
    assert (np.asarray(t.s_ranks)[n:] == 0).all()
    assert (np.asarray(t.pred_valid) == dg.pred_valid_np).all()
    assert t.width == 256 and t.S == 4
    assert bf.prepare_banded(dg, ws, 256).s_ranks is None


@pytest.mark.parametrize("costs", [COSTS, COSTS2P], ids=["1p", "2p"])
def test_full_fill_matches_native(costs):
    rng = random.Random(5)
    g, base = _fused(rng, 150, costs=costs)
    dg = DeviceGraph.build(g.flatten())
    reads = [_mutate(rng, base, 0.05).encode() for _ in range(12)]
    qshift, lengths = pack_queries(reads)
    got = np.asarray(dp_fill_scores(dg, qshift, lengths, costs))
    assert (got == _native(g, reads, costs)).all()


def test_banded_scorer_uniform():
    """The production BandedScorer route on the CPU: the XLA executor,
    verify ladder; scores equal the exact engine's."""
    rng = random.Random(9)
    g, base = _fused(rng, 300, n_seqs=4)
    reads = [_mutate(rng, base, 0.03).encode() for _ in range(24)]
    qshift, lengths = pack_queries(reads)
    scorer = BandedScorer(g.flatten(), COSTS)
    assert scorer.executor == "xla"
    got = np.asarray(scorer.scores(qshift, lengths))
    assert (got == _native(g, reads, COSTS)).all()
    assert scorer.stats["tiers"] >= 1 and scorer.stats["xla_fills"] == 0


@pytest.mark.parametrize("costs", [COSTS, COSTS2P], ids=["1p", "2p"])
def test_banded_drift_mixed_lengths(costs):
    """Drifting windows on a mixed-length SV batch: once the first call
    has learned the batch's ub, the drift layout engages (its tables are
    cached) and scores equal the full fill."""
    rng = random.Random(13)
    g, base, variant = _sv_graph(rng, costs, glen=2500, cut=500)
    flat = g.flatten()
    dg = DeviceGraph.build(flat)
    reads = [_mutate(rng, base if i % 2 else variant, 0.015).encode()
             for i in range(8)]
    qshift, lengths = pack_queries(reads)
    ref = np.asarray(dp_fill_scores(dg, qshift, lengths, costs))
    scorer = BandedScorer(flat, costs, dg=dg)
    assert (np.asarray(scorer.scores(qshift, lengths)) == ref).all()
    got = np.asarray(scorer.scores(qshift, lengths))
    assert (got == ref).all()
    assert any(k[0] == "drift" and k[-1] == "tables"
               for k in scorer._prep_cache if isinstance(k, tuple))


@pytest.mark.parametrize("costs", [COSTS, COSTS2P], ids=["1p", "2p"])
def test_bounded_ends_free_with_ends(costs):
    """Bounded ends-free fill + end anchors (the mapping path's score
    phase): scores equal the scores-only fill, and each anchor replays
    to the same score in the native anchored corridor."""
    rng = random.Random(17)
    g, base = _fused(rng, 250, costs=costs)
    flat = g.flatten()
    dg = DeviceGraph.build(flat)
    reads = []
    for _ in range(12):
        a = rng.randrange(0, 80)
        b = rng.randrange(a + 40, 250)
        reads.append(_mutate(rng, base[a:b], 0.03).encode())
    qshift, lengths = pack_queries(reads)
    sc, er, ej = (np.asarray(a) for a in dp_fill_ends_free_with_ends(
        dg, flat, qshift, lengths, costs, SEMI))
    ref = np.asarray(dp_fill_scores_ends_free(dg, flat, qshift, lengths,
                                              costs, SEMI))
    assert (sc == ref).all()
    na = NativeAligner(g)
    for b, q in enumerate(reads):
        score, _ = na.align_anchored(q, costs,
                                     int(flat.node_of_rank[er[b]]),
                                     int(ej[b]), int(sc[b]),
                                     free_start=True)
        assert score == sc[b]


@pytest.mark.parametrize("nreads", [1, 3, 65])
def test_banded_odd_batch_sizes(nreads):
    """Batches of any size run as they are: no row granularity."""
    rng = random.Random(5)
    g, base = _fused(rng, 300, n_seqs=2)
    reads = [_mutate(rng, base, 0.05).encode() for _ in range(nreads)]
    qshift, lengths = pack_queries(reads)
    got = np.asarray(BandedScorer(g.flatten(), COSTS).scores(qshift,
                                                             lengths))
    assert got.shape == (nreads,)
    assert (got == _native(g, reads, COSTS)).all()


@pytest.mark.parametrize("nreads", [1, 3, 65])
def test_with_ends_odd_batch_sizes(nreads):
    rng = random.Random(7)
    g, base = _fused(rng, 250, n_seqs=2)
    flat = g.flatten()
    dg = DeviceGraph.build(flat)
    reads = [_mutate(rng, base[rng.randrange(0, 60):], 0.04).encode()
             for _ in range(nreads)]
    qshift, lengths = pack_queries(reads)
    sc, er, ej = dp_fill_ends_free_with_ends(dg, flat, qshift, lengths,
                                             COSTS, SEMI)
    assert np.asarray(sc).shape == (nreads,) == np.asarray(er).shape
    ref = dp_fill_scores_ends_free(dg, flat, qshift, lengths, COSTS, SEMI)
    assert (np.asarray(sc) == np.asarray(ref)).all()


@pytest.mark.parametrize("seed", [41, 43, 47])
def test_banded_randomized_costs(seed):
    rng = random.Random(seed)
    costs = GapAffine(rng.randrange(1, 9), rng.randrange(1, 5),
                      rng.randrange(0, 12))
    g, base = _fused(rng, 260, n_seqs=3, div=0.04, costs=costs)
    reads = [_mutate(rng, base, 0.05).encode() for _ in range(16)]
    qshift, lengths = pack_queries(reads)
    got = np.asarray(BandedScorer(g.flatten(), costs).scores(qshift,
                                                             lengths))
    assert (got == _native(g, reads, costs)).all()


@pytest.mark.parametrize("seed", [61, 67])
def test_drift_randomized_costs(seed):
    rng = random.Random(seed)
    costs = GapAffine(rng.randrange(1, 9), rng.randrange(1, 5),
                      rng.randrange(0, 12))
    g, base, variant = _sv_graph(rng, costs)
    flat = g.flatten()
    dg = DeviceGraph.build(flat)
    reads = [_mutate(rng, base if i % 2 else variant, 0.015).encode()
             for i in range(12)]
    qshift, lengths = pack_queries(reads)
    ref = np.asarray(dp_fill_scores(dg, qshift, lengths, costs))
    got = np.asarray(BandedScorer(flat, costs, dg=dg).scores(qshift,
                                                             lengths))
    assert (got == ref).all()


@pytest.mark.parametrize("seed,costs", [
    (53, GapAffine(3, 1, 5)), (59, GapAffine(6, 3, 2)),
    (71, GapAffine2Piece(4, 2, 6, 1, 24)),
    (73, GapAffine2Piece(5, 3, 4, 1, 16))])
def test_bounded_with_ends_randomized_costs(seed, costs):
    rng = random.Random(seed)
    g, base = _fused(rng, 200, costs=costs)
    flat = g.flatten()
    dg = DeviceGraph.build(flat)
    reads = [_mutate(rng, base[rng.randrange(0, 50):], 0.04).encode()
             for _ in range(8)]
    qshift, lengths = pack_queries(reads)
    sc, _, _ = dp_fill_ends_free_with_ends(dg, flat, qshift, lengths,
                                           costs, SEMI)
    ref = dp_fill_scores_ends_free(dg, flat, qshift, lengths, costs, SEMI)
    assert (np.asarray(sc) == np.asarray(ref)).all()


def _clamp_case():
    """A graph with a long deletion bubble, and a read with a 140-base
    insertion batched with a short read through the bubble: the shared
    window spans the bubble plus twice the gap budget, so a ub below the
    read's score already gives a band covering the whole row."""
    rng = random.Random(31)
    g, base, variant = _sv_graph(rng, COSTS, glen=800, cut=20)
    ins = "".join(rng.choice("ACGT") for _ in range(140))
    reads = [(base[:400] + ins + base[400:]).encode(), variant.encode()]
    flat = g.flatten()
    qshift, lengths = pack_queries(reads)
    L = int(qshift.shape[1])
    ln = np.asarray(lengths)
    for ub in range(60, 290, 2):
        width = bd.band_windows(flat, int(ln.min()), int(ln.max()), COSTS,
                                ub)[1]
        if width >= L:
            return g, flat, reads, qshift, lengths, ub
    raise AssertionError("no ub below the insertion's cost clamps the band")


@pytest.mark.parametrize("clamp", [True, False], ids=["clamped", "full-fill"])
def test_full_width_clamp_is_exact(clamp, monkeypatch):
    """A band clamped to full width is accepted without the <=ub check,
    so its fill must see every path: the 140-base insertion (score above
    the ub) must give the native engine's score, clamped or through the
    full fill."""
    g, flat, reads, qshift, lengths, ub = _clamp_case()
    assert ub < COSTS.gap_open + 140 * COSTS.gap_extend
    scorer = BandedScorer(flat, COSTS)
    # clamp as the CUDA executor would (or not), with the XLA body
    monkeypatch.setattr(scorer, "_clamps", lambda *a: clamp)
    scorer.DRIFT_MIN_SPREAD = 1 << 30  # the shared window is under test
    got = np.asarray(scorer.scores(qshift, lengths, ub=ub))
    assert (got == _native(g, reads, COSTS)).all()
    assert (scorer.stats["fullfill_fallbacks"] == 0) == clamp


@pytest.mark.parametrize("W,Wb,fits", [
    (5, 5120, True),     # uniform config, full-width clamp (204,948 B)
    (6, 5120, False),    # 245,908 B: past the 227 KB block limit
    (4, 8192, False),    # 262,288 B
    (2, 8192, True),     # widest band one block covers
    (1, 8320, False),    # more lanes than 1024 threads x 8
    (3, 200, False),     # not whole warps of 4 lanes
    (3, 4224, False),    # 8 lanes per thread need 256-lane multiples
])
def test_cuda_shared_memory_rule(W, Wb, fits):
    assert bf.cuda_fits(W, Wb) is fits
    assert bf.cuda_shared_bytes(W, Wb) == (2 * W * Wb + 32 + W) * 4


@pytest.mark.parametrize("width,two_piece,expect", [
    (512, False, "cuda"),
    (8192, False, "xla"),    # over the shared-memory budget
    (8320, False, "xla"),    # wider than one block covers
    (512, True, "xla"),      # two-piece costs: XLA 5-layer body
])
def test_executor_choice_rule(width, two_piece, expect):
    """On a GPU the scorer picks the executor from the shapes alone and
    counts every XLA fill; on the CPU it is always the XLA body."""
    rng = random.Random(4)
    g, _ = _fused(rng, 120)
    scorer = BandedScorer(g.flatten(), COSTS)
    assert scorer._executor(width, two_piece) == "xla"
    assert scorer.stats["xla_fills"] == 0
    scorer.executor = "cuda"
    assert scorer._executor(width, two_piece) == expect
    assert scorer.stats["xla_fills"] == (expect == "xla")


def test_clamp_and_padding_rules():
    rng = random.Random(4)
    g, _ = _fused(rng, 120)
    scorer = BandedScorer(g.flatten(), COSTS)
    assert not scorer._clamps(512, False)  # CPU: full fill serves
    pads = [scorer._pad_rows(n) for n in (1, 3, 37, 64)]
    assert pads == [1, 4, 64, 64]
    scorer.executor = "cuda"
    W = scorer.dg.window
    assert scorer._clamps(512, False) == bf.cuda_fits(W, 512)
    assert not scorer._clamps(512, True)
    # retry tails pad alike under either executor
    assert [scorer._pad_rows(n) for n in (1, 3, 37, 64)] == pads


def test_padded_query_is_cached_by_identity():
    rng = random.Random(4)
    g, base = _fused(rng, 120)
    scorer = BandedScorer(g.flatten(), COSTS)
    qshift, _ = pack_queries([base.encode()] * 3)
    L = int(qshift.shape[1])
    assert scorer._padded_query(qshift, qshift, 0, L) is qshift
    a = scorer._padded_query(qshift, qshift, 128, L + 128)
    assert a.shape == (3, L + 256)
    assert (np.asarray(a[:, 128:128 + L]) == np.asarray(qshift)).all()
    assert not np.asarray(a[:, :128]).any()
    assert scorer._padded_query(qshift, qshift, 128, L + 128) is a
    b = scorer._padded_query(None, qshift, 128, L + 128)
    assert b is not a and (np.asarray(b) == np.asarray(a)).all()
