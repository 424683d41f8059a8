"""Host math of k-mer seeded corridors (aligner/seeds.py): the k-mer
index, cluster bounds, the k condition and the post-hoc certificate.

No device corridor fill serves them at present; the ends-free mapping
path runs the exact bounded full fill (see ROADMAP).  The prescore
pipeline test below covers that path.
"""

import random

import numpy as np
import pytest

from poasta_tpu.aligner import GapAffine
from poasta_tpu.aligner.costs import UNBOUNDED, EndsFree, included
from poasta_tpu.aligner.seeds import (
    CODE,
    KmerIndex,
    k_condition_holds,
)
from poasta_tpu.aligner.wavefront import pack_queries
from poasta_tpu.graphs import POAGraph
from poasta_tpu.parallel import BatchMapper

pytest.importorskip("poasta_tpu.native")

COSTS = GapAffine(4, 2, 6)
SEMI = EndsFree(UNBOUNDED, included(0), UNBOUNDED, UNBOUNDED)


def _mutate(rng, s, d):
    out = []
    for ch in s:
        r = rng.random()
        if r < d / 3:
            continue
        if r < 2 * d / 3:
            out.append(rng.choice("ACGT"))
            out.append(ch)
        elif r < d:
            out.append(rng.choice("ACGT"))
        else:
            out.append(ch)
    return "".join(out) or "A"


def _backbone_graph(rng, n, skip_every=97):
    base = "".join(rng.choice("ACGT") for _ in range(n))
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * n)
    for v in range(0, n - 3, skip_every):
        g.add_edge(v, v + 3, 0, 1)
    g.post_process()
    return g, base


def _brute_kpaths(flat, k):
    """All k-length path strings + end ranks, by explicit DFS."""
    codes = CODE[flat.symbols]
    out = set()

    def walk(r, s):
        if codes[r] == 255:
            return
        s = s + (int(codes[r]),)
        if len(s) == k:
            km = 0
            for c in s:
                km = (km << 2) | c
            out.add((km, r))
            return
        for t in flat.succ_idx[flat.succ_ptr[r]:flat.succ_ptr[r + 1]]:
            walk(int(t), s)

    for r in range(flat.n_nodes):
        walk(r, ())
    return out


def test_kmer_index_matches_bruteforce():
    rng = random.Random(3)
    g, _ = _backbone_graph(rng, 120, skip_every=17)
    flat = g.flatten()
    idx = KmerIndex(flat, k=6)
    assert idx.ok
    # the index stores end-rank POTENTIALS (all seed_bounds consumes);
    # distinct k-paths may repeat a (kmer, end rank) pair, so compare
    # as sets of (kmer, dmin, dmax)
    brute = _brute_kpaths(flat, 6)
    dmin = flat.min_dist_from_start
    dmax = flat.max_dist_from_start
    brute_pots = {(km, int(dmin[r]), int(dmax[r])) for km, r in brute}
    got_pots = set(zip(idx.kmers.tolist(), idx.post_dmin.tolist(),
                       idx.post_dmax.tolist()))
    assert got_pots == brute_pots


def test_kmer_index_budget_guard():
    # a dense bubble lattice blows the path budget -> ok stays False
    rng = random.Random(5)
    g = POAGraph()
    base = "".join(rng.choice("ACGT") for _ in range(64))
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * 64)
    # node 0/1 are the virtual start/end; sequence chars start at 2
    for a in range(2, 60):
        for b in range(a + 2, min(a + 6, 63)):
            g.add_edge(a, b, 0, 1)
    g.post_process()
    idx = KmerIndex(g.flatten(), k=12, budget_factor=2)
    assert not idx.ok


def test_seed_bounds_cover_planted_locus():
    rng = random.Random(7)
    g, base = _backbone_graph(rng, 400)
    flat = g.flatten()
    idx = KmerIndex(flat, k=8)
    assert idx.ok
    a = 123
    read = base[a:a + 80].encode()
    q_np, l_np = pack_queries([read], place_on_device=False)
    alpha_min, beta_max, nhits = idx.seed_bounds(q_np, l_np)
    assert nhits[0] > 0
    # the exact locus diagonal must lie inside [alpha_min, beta_max]:
    # cell (rank of node a+j-1, j) for consumed chars j
    dmin = flat.min_dist_from_start
    dmax = flat.max_dist_from_start
    # char i of the backbone is node i+2 (0/1 are virtual start/end)
    r_end = int(flat.rank_of_node[a + 79 + 2])
    assert alpha_min[0] <= 80 - int(dmax[r_end])
    assert beta_max[0] >= 80 - int(dmin[r_end])


def test_k_condition():
    assert k_condition_holds(5000, 400, COSTS, 14)
    assert not k_condition_holds(200, 400, COSTS, 14)
    assert not k_condition_holds(5000, 400, GapAffine(0, 0, 6), 14)


def _seeded_case(rng, n_nodes, n_reads, read_len, div):
    g, base = _backbone_graph(rng, n_nodes)
    reads = []
    for _ in range(n_reads):
        a = rng.randrange(0, n_nodes - read_len)
        reads.append(_mutate(rng, base[a:a + read_len], div).encode())
    return g, base, reads


def test_guaranteed_hits_engagement_boundary():
    """Pin the certificate's engagement envelope (VERDICT r4 #2): the
    interruption-counting bound T = (jlo - c//c_rm) - (c//c_int + 1)(k-1)
    at the bench operating point, and the exact c where it crosses 0."""
    from poasta_tpu.aligner.seeds import guaranteed_hits

    # costs 4/2/6: c_rm = min(4, 2) = 2, c_int = min(4, 6+2) = 4
    assert guaranteed_hits(5000, 1650, 10, COSTS) == 458
    # round 4's per-character bound gave NO guarantee here (E = 825,
    # runs >= (5000-825)/826 ~ 5 < k); the counting bound gives 458
    assert guaranteed_hits(5000, 1815, 10, COSTS) > 0   # engaged
    assert guaranteed_hits(5000, 1816, 10, COSTS) <= 0  # boundary
    # degenerate cost models give no guarantee
    assert guaranteed_hits(5000, 100, 10, GapAffine(0, 0, 6)) <= 0
    assert guaranteed_hits(5000, 100, 10, GapAffine(4, 0, 6)) <= 0


def test_certify_synthetic_hit_sets():
    """certify_reads on hand-built hit sets: scattered exterior hits
    below T pass; >= T co-windowed exterior hits must refuse."""
    import numpy as np

    from poasta_tpu.aligner.seeds import SeedHits, certify_reads

    k = 10
    jlo = np.array([400, 400], dtype=np.int64)
    scores = np.array([40, 40], dtype=np.int64)  # R=20, I=10, T=281
    K_u = np.array([60, 60], dtype=np.int64)
    # read 0: dense cluster at diag ~0 plus 5 scattered far hits
    a0 = np.concatenate([np.zeros(50), [5000, 9000, -4000, 7000, 12000]])
    # read 1: same cluster plus 290 co-windowed exterior hits at 5000
    a1 = np.concatenate([np.zeros(50), np.full(290, 5000.0)])
    alpha = np.concatenate([a0, a1]).astype(np.int64)
    beta = alpha.copy()
    start = np.array([0, a0.size, a0.size + a1.size], dtype=np.int64)
    hits = SeedHits(alpha, beta, start, np.array([True, True]))
    A_star = np.array([0, 0], dtype=np.int64)
    B_star = np.array([0, 0], dtype=np.int64)
    ok, T = certify_reads(hits, A_star, B_star, scores, K_u, k, jlo,
                          COSTS, True)
    assert T[0] == T[1] == 281
    assert ok[0]          # 5 scattered << T
    assert not ok[1]      # 290 co-windowed >= T: could carry an
    #                       all-exterior alignment — must refuse
    # all_acgt=False forbids certification outright
    ok2, _ = certify_reads(hits, A_star, B_star, scores, K_u, k, jlo,
                           COSTS, False)
    assert not ok2.any()


def test_ends_free_prescore_pipeline():
    """prescore() + align_batch(prescored=...) on a mapping span emits
    the same output as the direct call (the lasagna pipeline overlap
    now covers ends-free serving)."""
    rng = random.Random(59)
    g, base, reads = _seeded_case(rng, 1200, 8, 600, 0.01)
    m = BatchMapper(g, COSTS, aln_type=SEMI)
    # (supports_prescore gates the lasagna pipeline on host cores;
    # prescore itself works regardless)
    ref = m.align_batch(reads)
    pre = m.prescore(reads)
    assert pre is not None and pre[0] is reads
    out = m.align_batch(reads, prescored=pre)
    for (s1, a1), (s0, a0) in zip(out, ref):
        assert s1 == s0
        assert list(a1) == list(a0)


