"""Banded fill: exactness via verify-and-retry."""

import random

import numpy as np

from poasta_tpu.aligner import GapAffine, Global, PoastaAligner
from poasta_tpu.aligner.banded import BandedScorer, band_windows
from poasta_tpu.aligner.wavefront import DeviceGraph, dp_fill_scores, pack_queries
from poasta_tpu.graphs import POAGraph

COSTS = GapAffine(4, 2, 6)


def _case(seed, glen=80, nreads=8, rate=0.05):
    rng = random.Random(seed)
    base = "".join(rng.choice("ACGT") for _ in range(glen))

    def mutate(s):
        out = []
        for ch in s:
            r = rng.random()
            if r < rate / 3:
                continue
            out.append(rng.choice("ACGT") if r < rate else ch)
            if rng.random() < rate / 3:
                out.append(rng.choice("ACGT"))
        return "".join(out) or "A"

    g = POAGraph()
    py = PoastaAligner(COSTS, Global(), heuristic="mingap")
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * glen)
    for i in range(1, 3):
        s = mutate(base).encode()
        r = py.align(g, s)
        g.add_alignment_with_weights(f"s{i}", s, r.alignment, [1] * len(s))
    return g, [mutate(base).encode() for _ in range(nreads)]


def test_banded_matches_full():
    g, reads = _case(3)
    flat = g.flatten()
    dg = DeviceGraph.build(flat)
    qshift, lengths = pack_queries(reads)
    ref = np.asarray(dp_fill_scores(dg, qshift, lengths, COSTS))
    out = BandedScorer(flat, COSTS).scores(qshift, lengths)
    assert (out == ref).all()


def test_banded_tiny_ub_still_exact():
    """Deliberately bad initial UB must trigger retries, not wrong answers."""
    g, reads = _case(7, rate=0.15)
    flat = g.flatten()
    dg = DeviceGraph.build(flat)
    qshift, lengths = pack_queries(reads)
    ref = np.asarray(dp_fill_scores(dg, qshift, lengths, COSTS))
    out = BandedScorer(flat, COSTS).scores(qshift, lengths, ub=4)
    assert (out == ref).all()


def test_band_windows_cover_feasible_cells():
    g, reads = _case(9)
    flat = g.flatten()
    n = max(len(r) for r in reads)
    ws, width, lo, hi = band_windows(flat, min(len(r) for r in reads), n, COSTS, 64)
    assert (lo >= ws).all()
    assert (hi <= ws + width - 1).all()
    # the global end state (end rank, offset n) is always inside
    end = flat.n_nodes - 1
    assert ws[end] <= n <= ws[end] + width - 1


def test_banded_two_piece_matches_full():
    import random

    import numpy as np

    from poasta_tpu.aligner import GapAffine2Piece
    from poasta_tpu.aligner.banded import BandedScorer
    from poasta_tpu.aligner.wavefront import dp_fill_scores, pack_queries
    from poasta_tpu.graphs import POAGraph
    from poasta_tpu.native import NativeAligner

    rng = random.Random(23)
    base = "".join(rng.choice("ACGT") for _ in range(600))

    def mutate(s, p=0.008):
        out = []
        for ch in s:
            r = rng.random()
            if r < p:
                continue
            out.append(rng.choice("ACGT") if r < 2 * p else ch)
            if rng.random() < p:
                out.append(rng.choice("ACGT"))
        return "".join(out) or "A"

    costs2 = GapAffine2Piece(4, 2, 8, 1, 24)
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * 600)
    for i in range(1, 3):
        s = mutate(base).encode()
        _, aln, _ = NativeAligner(g).align(s, COSTS)
        g.add_alignment_with_weights(f"s{i}", s, aln, [1] * len(s))
    queries = [mutate(base).encode() for _ in range(8)]
    flat = g.flatten()
    qshift, lengths = pack_queries(queries)
    bs = BandedScorer(flat, costs2)
    s1 = bs.scores(qshift, lengths)   # may fall back + learn tight ub
    s2 = bs.scores(qshift, lengths)   # banded with learned ub
    full = np.asarray(dp_fill_scores(bs.dg, qshift, lengths, costs2))
    assert (np.asarray(s1) == full).all()
    assert (np.asarray(s2) == full).all()
    assert not any(
        isinstance(k, tuple) and k and k[0] == "fullfill"
        for k in bs._prep_cache
    ), "two-piece band did not engage after learning the tight ub"


def test_tiered_retry_heterogeneous_batch():
    """Mixed-divergence batch: low-divergence reads resolve in the first
    narrow tier; only the divergent tail refills at wider bands."""
    import random

    from poasta_tpu.native import NativeAligner

    rng = random.Random(77)
    base = "".join(rng.choice("ACGT") for _ in range(700))

    def mutate(s, d):
        out = []
        for ch in s:
            r = rng.random()
            if r < d:
                continue
            out.append(rng.choice("ACGT") if r < 2 * d else ch)
            if rng.random() < d:
                out.append(rng.choice("ACGT"))
        return "".join(out) or "A"

    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * 700)
    for i in range(1, 3):
        s = mutate(base, 0.01).encode()
        _, aln, _ = NativeAligner(g).align(s, COSTS)
        g.add_alignment_with_weights(f"s{i}", s, aln, [1] * len(s))
    # 6 easy reads + 2 divergent ones
    queries = [mutate(base, 0.01).encode() for _ in range(6)]
    queries += [mutate(base, 0.12).encode() for _ in range(2)]
    flat = g.flatten()
    qshift, lengths = pack_queries(queries)
    bs = BandedScorer(flat, COSTS)
    # narrow first tier that covers only the easy reads
    got = bs.scores(qshift, lengths, ub=60)
    na = NativeAligner(g)
    oracle = [na.align(q, COSTS)[0] for q in queries]
    assert list(np.asarray(got)) == oracle
    assert bs.last_attempts >= 2, "divergent tail should need extra tiers"
    # second call reuses the learned narrow first tier
    got2 = bs.scores(qshift, lengths)
    assert list(np.asarray(got2)) == oracle


def test_outlier_tail_falls_back_without_disabling_banding():
    """A few extreme outliers must not force the whole batch into the
    full fill or permanently disable banding for the length profile."""
    import random

    from poasta_tpu.native import NativeAligner

    rng = random.Random(91)
    base = "".join(rng.choice("ACGT") for _ in range(700))

    def mutate(s, d):
        out = []
        for ch in s:
            r = rng.random()
            if r < d:
                continue
            out.append(rng.choice("ACGT") if r < 2 * d else ch)
            if rng.random() < d:
                out.append(rng.choice("ACGT"))
        return "".join(out) or "A"

    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * 700)
    for i in range(1, 3):
        s = mutate(base, 0.01).encode()
        _, aln, _ = NativeAligner(g).align(s, COSTS)
        g.add_alignment_with_weights(f"s{i}", s, aln, [1] * len(s))
    queries = [mutate(base, 0.01).encode() for _ in range(7)]
    # one extreme outlier whose band is as wide as the read
    queries.append("".join(rng.choice("ACGT") for _ in range(690)).encode())
    flat = g.flatten()
    qshift, lengths = pack_queries(queries)
    bs = BandedScorer(flat, COSTS)
    got = np.asarray(bs.scores(qshift, lengths, ub=80))
    na = NativeAligner(g)
    oracle = [na.align(q, COSTS)[0] for q in queries]
    assert list(got) == oracle
    # banding must remain enabled for this profile
    assert not any(
        isinstance(k, tuple) and k and k[0] == "fullfill"
        for k in bs._prep_cache
    )
    got2 = np.asarray(bs.scores(qshift, lengths))
    assert list(got2) == oracle


def test_suffix_queries_on_band_edge():
    """Suffix queries at ub == optimal run the optimal path along the
    band's left edge — the adversarial shape for the window derivation's
    left-column diagonal handling."""
    import random

    from poasta_tpu.native import NativeAligner

    rng = random.Random(1)
    N = 300
    base = "".join(rng.choice("ACGT") for _ in range(N))
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * N)
    na = NativeAligner(g)
    flat = g.flatten()
    for cut in (10, 40, 100, 170):
        q = base[cut:].encode()
        s_true = na.align(q, COSTS)[0]
        qs, ln = pack_queries([q])
        bs = BandedScorer(flat, COSTS)
        got = int(np.asarray(bs.scores(qs, ln, ub=s_true))[0])
        assert got == s_true, (cut, got, s_true)


def test_quantile_retry_heterogeneous_exact():
    """Per-read ub seeding: a heterogeneous tail may split the retry at a
    score quantile (narrow bulk verifies early, wide residue refills);
    scores must stay exact either way, across several spreads."""
    for seed, glen, spread in ((11, 400, 0.3), (12, 600, 0.25), (13, 500, 0.2)):
        rng = random.Random(seed)
        base = "".join(rng.choice("ACGT") for _ in range(glen))
        g = POAGraph()
        g.add_alignment_with_weights("s0", base.encode(), None, [1] * glen)
        reads = []
        for i in range(16):
            rate = 0.01 + spread * (i / 15) ** 2  # heavy-tailed divergence
            out = []
            for ch in base:
                r = rng.random()
                if r < rate / 3:
                    continue
                out.append(rng.choice("ACGT") if r < rate else ch)
            reads.append(("".join(out) or "A").encode())
        flat = g.flatten()
        dg = DeviceGraph.build(flat)
        qshift, lengths = pack_queries(reads)
        ref = np.asarray(dp_fill_scores(dg, qshift, lengths, COSTS))
        sc = BandedScorer(flat, COSTS)
        sc.TIER_OVERHEAD_CELLS = 0  # always allow the split on tiny graphs
        out = sc.scores(qshift, lengths, ub=8, max_retries=8)
        assert (out == ref).all()


def test_long_insertion_reads_stay_exact_with_run_cap():
    """Reads carrying long insertion runs, started at a tiny ub: runs the
    first tiers' bands cannot hold push the score past ub and force a
    retry at a wider band — never a wrong verified score."""
    rng = random.Random(23)
    base = "".join(rng.choice("ACGT") for _ in range(2500))
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * 2500)
    reads = []
    for i in range(8):
        ins_len = rng.randrange(40, 240)
        at = rng.randrange(200, 2300)
        ins = "".join(rng.choice("ACGT") for _ in range(ins_len))
        s = list(base[:at] + ins + base[at:])
        for _ in range(20):  # sprinkle mismatches
            p = rng.randrange(len(s))
            s[p] = rng.choice("ACGT")
        reads.append("".join(s).encode())
    flat = g.flatten()
    dg = DeviceGraph.build(flat)
    qshift, lengths = pack_queries(reads)
    ref = np.asarray(dp_fill_scores(dg, qshift, lengths, COSTS))
    # tiny initial ub: the first tiers' bands are narrower than the runs
    out = BandedScorer(flat, COSTS, dg=dg).scores(qshift, lengths, ub=30)
    assert (out == ref).all(), (out, ref)


def test_fallback_hint_converges_to_bulk_tier():
    """When the ladder ends in the full-fill fallback, the next call's
    starting tier must be the tier that resolved the MOST reads — round
    4 pinned tiers[0] (this call's own starting guess) via setdefault,
    so a guess below the bulk's scores replayed a dead whole-batch fill
    forever (measured on the mixed-div bench: ub 1752 resolved 0/1024
    before 1924 resolved 768)."""
    import random

    from poasta_tpu.native import NativeAligner

    rng = random.Random(91)
    base = "".join(rng.choice("ACGT") for _ in range(700))

    def mutate(s, d):
        out = []
        for ch in s:
            r = rng.random()
            if r < d:
                continue
            out.append(rng.choice("ACGT") if r < 2 * d else ch)
            if rng.random() < d:
                out.append(rng.choice("ACGT"))
        return "".join(out) or "A"

    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * 700)
    # bulk at moderate divergence + one garbage read that never
    # verifies inside the retry budget (forces the fallback branch)
    queries = [mutate(base, 0.05).encode() for _ in range(7)]
    queries.append("".join(rng.choice("ACGT") for _ in range(700)).encode())
    flat = g.flatten()
    qshift, lengths = pack_queries(queries)
    bs = BandedScorer(flat, COSTS)
    na = NativeAligner(g)
    oracle = [na.align(q, COSTS)[0] for q in queries]
    # deliberately-too-low starting ub: resolves nothing at tier 0
    got = bs.scores(qshift, lengths, ub=8, max_retries=3)
    assert list(np.asarray(got)) == oracle
    key = (int(np.asarray(lengths).min()), int(np.asarray(lengths).max()))
    hint = bs._ub_hint.get(key)
    assert hint is not None and hint > 8, hint
    # second call starts at the learned bulk tier and stays exact
    got2 = bs.scores(qshift, lengths)
    assert list(np.asarray(got2)) == oracle
