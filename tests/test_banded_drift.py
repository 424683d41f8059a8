"""Per-read drifting band windows (VERDICT r1 weak #2 / next #2).

Mixed-length batches against structural-variant graphs are the case where
batch-shared windows pay each other's diagonals: every read is tight on
its own path, but the paths have different lengths.  Drifted windows keep
one shared layout and shift each read by its own length excess in
128-lane steps, so the width stops paying the batch's length spread.

Exactness still comes from the band bound + verify-and-retry; these tests
pin score equality against the full-fill oracle and the >=2x cell-count
reduction the drift is for.
"""

import random

import numpy as np
import pytest

from poasta_tpu.aligner import GapAffine
from poasta_tpu.aligner.banded import (
    BandedScorer,
    band_windows_drift,
    drift_steps_for,
)
from poasta_tpu.aligner.wavefront import (
    DeviceGraph,
    dp_fill_scores,
    pack_queries,
)
from poasta_tpu.graphs import POAGraph

COSTS = GapAffine(4, 2, 6)


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


def _sv_graph_and_reads(seed, base_len=2500, del_len=1500, n_reads=16,
                        div=0.02):
    """Graph with a long-deletion allele + reads from both alleles."""
    from poasta_tpu.native import NativeAligner

    rng = random.Random(seed)
    base = "".join(rng.choice("ACGT") for _ in range(base_len))
    keep = (base_len - del_len) // 2
    variant = base[:keep] + base[base_len - keep:]
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * len(base))
    _, aln, _ = NativeAligner(g).align(variant.encode(), COSTS)
    g.add_alignment_with_weights("s1", variant.encode(), aln,
                                 [1] * len(variant))
    reads = [_mutate(rng, base if i % 2 else variant, div).encode()
             for i in range(n_reads)]
    return g, reads


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_drift_scores_exact_on_sv_graph(seed):
    g, reads = _sv_graph_and_reads(seed)
    flat = g.flatten()
    dg = DeviceGraph.build(flat)
    qshift, lengths = pack_queries(reads)
    oracle = np.asarray(dp_fill_scores(dg, qshift, lengths, COSTS))
    bs = BandedScorer(flat, COSTS, dg=dg)
    got = np.asarray(bs.scores(qshift, lengths))
    assert (got == oracle).all(), (got, oracle)
    # warm call (ub hint) stays exact and actually uses the band
    bs.reset_stats()
    got = np.asarray(bs.scores(qshift, lengths))
    assert (got == oracle).all()
    assert bs.stats["tiers"] >= 1, "drift fill should engage, not full-fill"


def test_drift_beats_shared_windows_2x_on_mixed_batch():
    """The headline: cells_filled drops >=2x vs batch-shared windows on a
    mixed-length batch, scores still exact (VERDICT next #2 'Done')."""
    g, reads = _sv_graph_and_reads(9, base_len=5000, del_len=4000,
                                   n_reads=32, div=0.015)
    flat = g.flatten()
    dg = DeviceGraph.build(flat)
    qshift, lengths = pack_queries(reads)
    oracle = np.asarray(dp_fill_scores(dg, qshift, lengths, COSTS))

    drift = BandedScorer(flat, COSTS, dg=dg)
    assert (np.asarray(drift.scores(qshift, lengths)) == oracle).all()
    drift.reset_stats()
    assert (np.asarray(drift.scores(qshift, lengths)) == oracle).all()

    shared = BandedScorer(flat, COSTS, dg=dg)
    shared.DRIFT_MIN_SPREAD = 1 << 30  # disable drift
    assert (np.asarray(shared.scores(qshift, lengths)) == oracle).all()
    shared.reset_stats()
    assert (np.asarray(shared.scores(qshift, lengths)) == oracle).all()

    ratio = shared.stats["cells_filled"] / drift.stats["cells_filled"]
    assert ratio >= 2.0, f"only {ratio:.2f}x fewer cells with drift"


def test_drift_mesh_matches_single_device():
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs the virtual CPU mesh")
    from poasta_tpu.parallel import make_mesh

    g, reads = _sv_graph_and_reads(4, base_len=1500, del_len=800,
                                   n_reads=8, div=0.02)
    flat = g.flatten()
    dg = DeviceGraph.build(flat)
    qshift, lengths = pack_queries(reads)
    oracle = np.asarray(dp_fill_scores(dg, qshift, lengths, COSTS))
    mesh = make_mesh(devices=jax.devices()[:4], dp=4, sp=1)
    bs = BandedScorer(flat, COSTS, dg=dg, mesh=mesh)
    got = np.asarray(bs.scores(qshift, lengths))
    assert (got == oracle).all()


def test_drift_layout_covers_every_read_exactly():
    """Window-coverage invariant, checked directly: for every read length
    in the batch and every rank, the read's true bound<=ub corridor lies
    inside its drifted window."""
    g, reads = _sv_graph_and_reads(7, base_len=1800, del_len=1000,
                                   n_reads=12, div=0.03)
    flat = g.flatten()
    lens = sorted({len(r) for r in reads})
    n_min, n_max = lens[0], lens[-1]
    S = drift_steps_for(n_min, n_max)
    for ub in (60, 200, 700):
        wstart, width, s_ranks = band_windows_drift(
            flat, n_min, n_max, COSTS, ub, S)
        K = max((ub - COSTS.gap_open) // COSTS.gap_extend, 0) \
            if ub >= COSTS.gap_open + COSTS.gap_extend else 0
        ds_min = flat.min_dist_from_start.astype(np.int64)
        ds_max = flat.max_dist_from_start.astype(np.int64)
        de_min = flat.min_dist_to_end.astype(np.int64)
        de_max = flat.max_dist_to_end.astype(np.int64)
        for n in lens:
            nbs = (n - n_min + 64) // 128
            sig = 128 * ((nbs * s_ranks.astype(np.int64)) // S)
            lo = np.maximum.reduce([
                np.zeros_like(ds_min), ds_min - K, (n - de_max + 1) - K])
            hi = np.minimum.reduce([
                np.full_like(ds_min, n), ds_max + K, (n - de_min + 1) + K])
            feasible = lo <= hi
            win_lo = wstart.astype(np.int64) + sig
            win_hi = win_lo + width - 1
            ok = (~feasible) | ((win_lo <= lo) & (hi <= win_hi))
            bad = np.flatnonzero(~ok)
            assert bad.size == 0, (n, ub, bad[:5], lo[bad[:5]], hi[bad[:5]],
                                   win_lo[bad[:5]], win_hi[bad[:5]])


def test_drift_disabled_when_graph_shorter_than_spread():
    """A tiny graph with a huge read-length spread must NOT drift (the
    kernels roll at most 128 lanes per rank, so the step schedule needs
    S <= n_ranks-1); scores still come back exact via shared windows or
    the full fill."""
    g = POAGraph()
    g.add_alignment_with_weights("s0", b"ACGTACGTAC", None, [1] * 10)
    flat = g.flatten()
    dg = DeviceGraph.build(flat)
    # reads 5 and ~700 long: spread >> n_ranks
    reads = [b"ACGTA", b"ACGT" * 175]
    qshift, lengths = pack_queries(reads)
    oracle = np.asarray(dp_fill_scores(dg, qshift, lengths, COSTS))
    bs = BandedScorer(flat, COSTS, dg=dg)
    got = np.asarray(bs.scores(qshift, lengths))
    assert (got == oracle).all(), (got, oracle)


def test_two_piece_drift_scores_exact():
    """Two-piece drifting windows stay exact on mixed-length SV batches
    (cells savings depend on extend2 — 2p bands are inherently wide —
    but exactness must hold unconditionally)."""
    from poasta_tpu.aligner import GapAffine2Piece
    from poasta_tpu.native import NativeAligner

    costs2 = GapAffine2Piece(4, 2, 6, 1, 24)
    rng = random.Random(9)
    base = "".join(rng.choice("ACGT") for _ in range(2500))
    variant = base[:500] + base[2000:]
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * len(base))
    _, aln, _ = NativeAligner(g).align(variant.encode(), COSTS)
    g.add_alignment_with_weights("s1", variant.encode(), aln,
                                 [1] * len(variant))
    flat = g.flatten()
    dg = DeviceGraph.build(flat)
    reads = [_mutate(rng, base if i % 2 else variant, 0.02).encode()
             for i in range(16)]
    qshift, lengths = pack_queries(reads)
    oracle = np.asarray(dp_fill_scores(dg, qshift, lengths, costs2))
    bs = BandedScorer(flat, costs2, dg=dg)
    assert (np.asarray(bs.scores(qshift, lengths)) == oracle).all()
    bs.reset_stats()
    assert (np.asarray(bs.scores(qshift, lengths)) == oracle).all()
    assert bs.stats["fullfill_fallbacks"] == 0


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_drift_bounded_ends_free_exact(seed):
    """Drift x bounded ends-free (VERDICT r2 item 6): bounded spans are
    diagonal-anchored like global corridors (scripts/drift_endsfree_probe.py),
    so the drifting windows apply unchanged; only the end rules differ.
    Scores must match the bounded full-fill oracle exactly."""
    from poasta_tpu.aligner.costs import EndsFree, included, excluded
    from poasta_tpu.aligner.wavefront import dp_fill_scores_ends_free

    g, reads = _sv_graph_and_reads(seed)
    flat = g.flatten()
    dg = DeviceGraph.build(flat)
    qshift, lengths = pack_queries(reads)
    rng = random.Random(seed)
    cfg = EndsFree(
        ("unbounded", None),
        included(rng.randrange(0, 60)),
        included(0) if seed % 2 else excluded(1),
        included(rng.randrange(0, 60)) if rng.random() < 0.7
        else excluded(rng.randrange(1, 60)),
    )
    oracle = np.asarray(dp_fill_scores_ends_free(
        dg, flat, qshift, lengths, COSTS, cfg))
    bs = BandedScorer(flat, COSTS, dg=dg, aln_type=cfg)
    got = np.asarray(bs.scores(qshift, lengths))
    assert (got == oracle).all(), (got, oracle)
    # warm call stays exact and the drift fill engages (not a full fill)
    bs.reset_stats()
    got = np.asarray(bs.scores(qshift, lengths))
    assert (got == oracle).all()
    assert bs.stats["tiers"] >= 1, "drift-ef fill should engage"


def test_drift_bounded_ends_free_beats_shared_windows():
    """The point of the combination: cells_filled drops >=2x vs shared
    windows on a mixed-length batch under a bounded ends-free span."""
    from poasta_tpu.aligner.costs import EndsFree, included
    from poasta_tpu.aligner.wavefront import dp_fill_scores_ends_free

    g, reads = _sv_graph_and_reads(21, base_len=5000, del_len=4000,
                                   n_reads=32, div=0.015)
    flat = g.flatten()
    dg = DeviceGraph.build(flat)
    qshift, lengths = pack_queries(reads)
    cfg = EndsFree(("unbounded", None), included(50),
                   included(0), included(50))
    oracle = np.asarray(dp_fill_scores_ends_free(
        dg, flat, qshift, lengths, COSTS, cfg))

    drift = BandedScorer(flat, COSTS, dg=dg, aln_type=cfg)
    assert (np.asarray(drift.scores(qshift, lengths)) == oracle).all()
    drift.reset_stats()
    assert (np.asarray(drift.scores(qshift, lengths)) == oracle).all()

    shared = BandedScorer(flat, COSTS, dg=dg, aln_type=cfg)
    shared.DRIFT_MIN_SPREAD = 1 << 30  # disable drift
    assert (np.asarray(shared.scores(qshift, lengths)) == oracle).all()
    shared.reset_stats()
    assert (np.asarray(shared.scores(qshift, lengths)) == oracle).all()

    ratio = shared.stats["cells_filled"] / drift.stats["cells_filled"]
    assert ratio >= 2.0, f"only {ratio:.2f}x fewer cells with drift"


def test_drift_declines_free_begin_spans():
    """Free graph begins make every corridor corner-anchored (measured:
    scripts/drift_endsfree_probe.py) — drift must decline and route
    through the shared-window ends-free kernels, staying exact."""
    from poasta_tpu.aligner.costs import EndsFree, UNBOUNDED, included
    from poasta_tpu.aligner.wavefront import dp_fill_scores_ends_free

    g, reads = _sv_graph_and_reads(31)
    flat = g.flatten()
    dg = DeviceGraph.build(flat)
    qshift, lengths = pack_queries(reads)
    cfg = EndsFree(UNBOUNDED, included(40), UNBOUNDED, included(40))
    oracle = np.asarray(dp_fill_scores_ends_free(
        dg, flat, qshift, lengths, COSTS, cfg))
    bs = BandedScorer(flat, COSTS, dg=dg, aln_type=cfg)
    got = np.asarray(bs.scores(qshift, lengths))
    assert (got == oracle).all(), (got, oracle)


@pytest.mark.parametrize("seed", [1001, 1005, 1009, 1013])
def test_randomized_costs_banding_exact(seed):
    """Banding (drift + bounded ends-free) stays exact under randomized
    cost parameters — the window K formulas must hold for any (x, e, o),
    not just the defaults."""
    from poasta_tpu.aligner.costs import (
        EndsFree,
        UNBOUNDED,
        excluded,
        included,
    )
    from poasta_tpu.aligner.wavefront import dp_fill_scores_ends_free
    from poasta_tpu.native import NativeAligner

    rng = random.Random(seed)
    x = rng.randrange(1, 9)
    e = rng.randrange(1, 5)
    o = rng.randrange(0, 12)
    costs = GapAffine(x, e, o)
    glen = rng.randrange(300, 900)
    base = "".join(rng.choice("ACGT") for _ in range(glen))
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * glen)
    s = _mutate(rng, base, 0.05).encode()
    _, aln, _ = NativeAligner(g).align(s, costs)
    g.add_alignment_with_weights("s1", s, aln, [1] * len(s))
    flat = g.flatten()
    dg = DeviceGraph.build(flat)
    reads = []
    for _ in range(8):
        a = rng.randrange(0, glen // 3)
        b = rng.randrange(a + 50, glen)
        reads.append(_mutate(rng, base[a:b], 0.03).encode())
    qshift, lengths = pack_queries(reads)

    oracle = np.asarray(dp_fill_scores(dg, qshift, lengths, costs))
    got = np.asarray(BandedScorer(flat, costs, dg=dg).scores(
        qshift, lengths))
    assert (got == oracle).all()

    cfg = EndsFree(
        UNBOUNDED,
        included(rng.randrange(0, 40)) if rng.random() < 0.5 else UNBOUNDED,
        UNBOUNDED,
        excluded(rng.randrange(1, 40)) if rng.random() < 0.5 else UNBOUNDED,
    )
    oracle_e = np.asarray(dp_fill_scores_ends_free(
        dg, flat, qshift, lengths, costs, cfg))
    got_e = np.asarray(BandedScorer(flat, costs, dg=dg,
                                    aln_type=cfg).scores(qshift, lengths))
    assert (got_e == oracle_e).all()
