"""Multi-chip (virtual CPU mesh) paths vs the single-device fill.

Mirrors the reference's lasagna data-parallel fan-out
(``src/bin/lasagna.rs:214-273``) recast as a jax.sharding Mesh; conftest
forces an 8-device CPU platform so every dp/sp layout here exercises the
real shard_map collectives (ppermute halo, all_gather prefix-min, pmin).
"""

import random

import jax
import numpy as np
import pytest

from poasta_tpu.aligner import GapAffine, Global, PoastaAligner
from poasta_tpu.aligner.wavefront import DeviceGraph, dp_fill_scores, pack_queries
from poasta_tpu.graphs import POAGraph
from poasta_tpu.parallel import BatchMapper, make_mesh, make_sharded_score_fn

COSTS = GapAffine(4, 2, 6)


def _case(seed=11, nseq=3, length=40, nq=8):
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
    aligner = PoastaAligner(COSTS, Global(), heuristic="mingap")
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * length)
    for i in range(1, nseq):
        s = mutate(base).encode()
        res = aligner.align(g, s)
        g.add_alignment_with_weights(f"s{i}", s, res.alignment, [1] * len(s))
    return g, [mutate(base).encode() for _ in range(nq)]


@pytest.mark.parametrize("dp,sp", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_scores_match_single_device(dp, sp):
    if jax.device_count() < dp * sp:
        pytest.skip("needs 8 virtual devices")
    g, queries = _case()
    dg = DeviceGraph.build(g.flatten())
    # B divisible by dp; L (pow2*128-ish) divisible by sp
    qshift, lengths = pack_queries(queries, pad_to=255)
    mesh = make_mesh(devices=jax.devices()[: dp * sp], dp=dp, sp=sp)
    fn = make_sharded_score_fn(dg, COSTS, mesh)
    sharded = np.asarray(fn(qshift, lengths))
    single = np.asarray(dp_fill_scores(dg, qshift, lengths, COSTS))
    assert (sharded == single).all(), (sharded, single)


def test_sharded_scores_match_oracle():
    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices")
    g, queries = _case(seed=23, nq=8)
    dg = DeviceGraph.build(g.flatten())
    qshift, lengths = pack_queries(queries, pad_to=255)
    mesh = make_mesh(devices=jax.devices()[:8], dp=4, sp=2)
    fn = make_sharded_score_fn(dg, COSTS, mesh)
    sharded = list(np.asarray(fn(qshift, lengths)))
    aligner = PoastaAligner(COSTS, Global(), heuristic="mingap")
    oracle = [aligner.align(g, q).score for q in queries]
    assert sharded == oracle


def test_batch_mapper_mesh_and_host_agree():
    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices")
    g, queries = _case(seed=37, nq=8)
    mesh = make_mesh(devices=jax.devices()[:8], dp=8, sp=1)
    mapped = BatchMapper(g, COSTS, mesh=mesh)
    plain = BatchMapper(g, COSTS, mesh=None)
    a = mapped.score_batch(queries)
    b = plain.score_batch(queries)
    assert (a == b).all()


@pytest.fixture(scope="module")
def long_read_case():
    # reads long enough that the band (>=128 offsets) is narrower than L,
    # otherwise the scorer falls back to the full fill and the sharded
    # branch never runs; graph built with the native engine for speed
    import random

    from poasta_tpu.native import NativeAligner

    rng = random.Random(41)
    length = 1200
    base = "".join(rng.choice("ACGT") for _ in range(length))

    def mutate(s):
        out = []
        for ch in s:
            r = rng.random()
            if r < 0.03:
                continue
            out.append(rng.choice("ACGT") if r < 0.06 else ch)
            if rng.random() < 0.02:
                out.append(rng.choice("ACGT"))
        return "".join(out) or "A"

    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * length)
    for i in range(1, 3):
        s = mutate(base).encode()
        _, aln, _ = NativeAligner(g).align(s, COSTS)
        g.add_alignment_with_weights(f"s{i}", s, aln, [1] * len(s))
    queries = [mutate(base).encode() for _ in range(8)]
    na = NativeAligner(g)
    oracle = [na.align(q, COSTS)[0] for q in queries]
    return g, queries, oracle


@pytest.mark.parametrize("dp,sp", [(8, 1), (4, 2)])
def test_sharded_banded_scorer_matches_oracle(dp, sp, long_read_case):
    if jax.device_count() < dp * sp:
        pytest.skip("needs 8 virtual devices")
    from poasta_tpu.aligner.banded import BandedScorer

    g, queries, oracle = long_read_case
    flat = g.flatten()
    mesh = make_mesh(devices=jax.devices()[: dp * sp], dp=dp, sp=sp)
    qshift, lengths = pack_queries(queries)
    scorer = BandedScorer(flat, COSTS, mesh=mesh)
    sharded = scorer.scores(qshift, lengths)
    assert not any(
        isinstance(k, tuple) and k and k[0] == "fullfill"
        for k in scorer._prep_cache
    ), "band did not engage; the sharded branch was not exercised"
    assert list(np.asarray(sharded)) == oracle


@pytest.mark.parametrize("dp,sp", [(8, 1), (4, 2)])
def test_sharded_banded_scorer_runs_cuda_executor_per_shard(
        dp, sp, long_read_case, monkeypatch):
    """Under a mesh the GPU executor runs inside shard_map, one call per
    shard on that shard's reads.  A stand-in with the CUDA call's
    signature (the XLA body over the same tables) takes its place here."""
    if jax.device_count() < dp * sp:
        pytest.skip("needs 8 virtual devices")
    import jax.numpy as jnp

    from poasta_tpu.aligner import banded as bd
    from poasta_tpu.ops import banded_fill as bf

    rows = []

    def stand_in(n_nodes, W, Wb, o, e, x, S, mq, n_min, free_start, ef):
        def fn(symbols, pred_slots, pred_valid, pred_wstarts, wstarts,
               write_slots, end_ok, s_ranks, q, lengths, jlo):
            rows.append(int(q.shape[0]))
            body = bf.xla_banded_exec(W, Wb, int(pred_slots.shape[1]), o, e,
                                      x, S, ef, free_start,
                                      vary_axes=("dp",))
            return body(symbols, pred_slots, pred_valid, pred_wstarts,
                        wstarts, write_slots, jnp.int32(n_nodes - 1),
                        end_ok, s_ranks, q, lengths, jlo, jnp.int32(n_min),
                        jnp.int32(mq))
        return fn

    monkeypatch.setattr(bd, "cuda_banded_exec", stand_in)
    g, queries, oracle = long_read_case
    mesh = make_mesh(devices=jax.devices()[: dp * sp], dp=dp, sp=sp)
    qshift, lengths = pack_queries(queries)
    scorer = bd.BandedScorer(g.flatten(), COSTS, mesh=mesh)
    scorer.executor = "cuda"
    assert list(np.asarray(scorer.scores(qshift, lengths))) == oracle
    assert rows and set(rows) == {len(queries) // dp}
    assert scorer.stats["xla_fills"] == 0


def test_batch_mapper_two_piece_mesh_scores():
    # regression: the plain sharded body is one-piece math; 2p mesh
    # scoring must route through the sharded banded scorer
    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices")
    from poasta_tpu.aligner import GapAffine2Piece

    costs2 = GapAffine2Piece(4, 2, 8, 1, 24)
    g, queries = _case(seed=53, nq=8, length=60)
    mesh = make_mesh(devices=jax.devices()[:8], dp=8, sp=1)
    bm = BatchMapper(g, costs2, mesh=mesh)
    got = bm.score_batch(queries)
    aligner = PoastaAligner(costs2, Global(), heuristic="dijkstra")
    assert list(got) == [aligner.align(g, q).score for q in queries]


@pytest.mark.parametrize("fs,fe", [(True, True), (False, True), (True, False)])
def test_sharded_free_ends_match_single_device(fs, fe):
    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices")
    g, queries = _case(seed=61)
    dg = DeviceGraph.build(g.flatten())
    qshift, lengths = pack_queries(queries, pad_to=255)
    mesh = make_mesh(devices=jax.devices()[:8], dp=4, sp=2)
    fn = make_sharded_score_fn(dg, COSTS, mesh, free_start=fs, free_end=fe)
    sharded = np.asarray(fn(qshift, lengths))
    single = np.asarray(dp_fill_scores(dg, qshift, lengths, COSTS,
                                       free_start=fs, free_end=fe))
    assert (sharded == single).all()


def test_pipelined_flush_matches_serial_batches():
    """lasagna's pipelined _flush_sorted (device scores batch k+1 while
    the host backtraces batch k) must emit exactly what serial
    per-batch align_batch calls emit."""
    import random

    from poasta_tpu.cli.lasagna import _flush_sorted
    from poasta_tpu.native import NativeAligner

    rng = random.Random(23)
    base = "".join(rng.choice("ACGT") for _ in range(600))

    def mutate(s, d=0.04):
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
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * 600)
    s = mutate(base).encode()
    _, aln, _ = NativeAligner(g).align(s, COSTS)
    g.add_alignment_with_weights("s1", s, aln, [1] * len(s))
    chunk = [(f"r{i}", mutate(base).encode()) for i in range(48)]

    # force the banded path at small sizes so prescore has work
    mapper = BatchMapper(g, COSTS, batch_size=16)
    mapper.DENSE_TABLE_BUDGET = 0
    got = []
    _flush_sorted(mapper, chunk, 16,
                  lambda n, s_, sc, a: got.append((n, sc, len(a))))

    mapper2 = BatchMapper(g, COSTS, batch_size=16)
    mapper2.DENSE_TABLE_BUDGET = 0
    want = []
    order = sorted(range(len(chunk)), key=lambda i: len(chunk[i][1]))
    results = [None] * len(chunk)
    for at in range(0, len(order), 16):
        idxs = order[at:at + 16]
        out = mapper2.align_batch([chunk[i][1] for i in idxs])
        for i, r in zip(idxs, out):
            results[i] = r
    for (name, seq), (score, alignment) in zip(chunk, results):
        want.append((name, score, len(alignment)))
    assert got == want


def test_two_piece_align_batch_seeds_from_banded_scores(monkeypatch):
    # regression: global 2p align_batch must seed its native backtraces
    # from BANDED device scores — BandedScorer routes 2p through the
    # 5-state banded XLA bodies; paying full-fill cells here was stale
    # wiring
    from poasta_tpu.aligner import GapAffine2Piece

    costs2 = GapAffine2Piece(4, 2, 8, 1, 24)
    g, queries = _case(seed=71, nq=6, length=60)
    bm = BatchMapper(g, costs2)
    assert bm.takes_banded_path(queries)  # 2p always takes the banded path
    if not bm._init_banded(True):
        pytest.skip("native engine unavailable")
    scorer = bm._banded_scorer
    assert getattr(scorer.costs, "is_two_piece", False)
    calls = []
    orig = scorer.scores

    def spy(qshift, lengths):
        calls.append(1)
        return orig(qshift, lengths)

    monkeypatch.setattr(scorer, "scores", spy)
    out = bm.align_batch(queries)
    assert calls, "2p scoring did not route through the banded scorer"
    aligner = PoastaAligner(costs2, Global(), heuristic="dijkstra")
    for (s, _aln), q in zip(out, queries):
        assert s == aligner.align(g, q).score
