"""Golden-file parity against upstream poasta truth MSAs.

These assert BYTE-IDENTICAL FASTA-MSA output on the bundled corpora
(BASELINE configs #1 and #2).
"""

import io
import os

import pytest

from poasta_tpu.graphs import POAGraph
from poasta_tpu.aligner import PoastaAligner, GapAffine, Global
from poasta_tpu.io import read_fasta
from poasta_tpu.io.fasta import poa_graph_to_fasta

COSTS = GapAffine(4, 2, 6)


def msa_for(fa_path, heuristic="mingap"):
    graph = POAGraph()
    aligner = PoastaAligner(GapAffine(4, 2, 6), Global(), heuristic=heuristic)
    for name, seq in read_fasta(fa_path):
        weights = [1] * len(seq)
        if graph.is_empty():
            graph.add_alignment_with_weights(name, seq, None, weights)
        else:
            res = aligner.align(graph, seq)
            graph.add_alignment_with_weights(name, seq, res.alignment, weights)
    buf = io.StringIO()
    poa_graph_to_fasta(graph, buf)
    return buf.getvalue()


def test_small_test_truth(reference_tests_dir):
    out = msa_for(os.path.join(reference_tests_dir, "small_test.fa"))
    truth = open(os.path.join(reference_tests_dir, "small_test.truth.fa")).read()
    assert out == truth


def test_test_from_abpoa_truth(reference_tests_dir):
    out = msa_for(os.path.join(reference_tests_dir, "test_from_abpoa.fa"))
    truth = open(os.path.join(reference_tests_dir, "test_from_abpoa.truth.fa")).read()
    assert out == truth


def test_test2_from_abpoa_truth(reference_tests_dir):
    out = msa_for(os.path.join(reference_tests_dir, "test2_from_abpoa.fa"))
    truth = open(os.path.join(reference_tests_dir, "test2_from_abpoa.truth.fa")).read()
    assert out == truth


def test_heuristics_same_score(reference_tests_dir):
    """All heuristics must return the same optimal score; informed
    heuristics visit no more states than Dijkstra
    (reference: tests/test_heuristics.rs:46-56)."""
    fa = os.path.join(reference_tests_dir, "small_test.fa")
    recs = list(read_fasta(fa))
    graph = POAGraph()
    graph.add_alignment_with_weights(recs[0][0], recs[0][1], None, [1] * len(recs[0][1]))

    results = {}
    for h in ("dijkstra", "mingap", "path"):
        aligner = PoastaAligner(GapAffine(4, 2, 6), Global(), heuristic=h)
        results[h] = aligner.align(graph, recs[1][1])

    scores = {h: r.score for h, r in results.items()}
    assert len(set(scores.values())) == 1, scores
    assert results["mingap"].num_visited <= results["dijkstra"].num_visited
    assert results["path"].num_visited <= results["dijkstra"].num_visited


def test_graph_reuse_from_imported_msa(reference_tests_dir):
    """BASELINE config #3: import half an MSA as a graph, align the rest."""
    import numpy as np

    from poasta_tpu.aligner.wavefront import DeviceGraph, dp_fill_scores, pack_queries
    from poasta_tpu.io import load_graph_from_fasta_msa, read_fasta

    g = load_graph_from_fasta_msa(f"{reference_tests_dir}/test2_half.msa.fa")
    have = {n for n, _ in read_fasta(f"{reference_tests_dir}/test2_half.msa.fa")}
    rest = [(n, s) for n, s in
            read_fasta(f"{reference_tests_dir}/test2_from_abpoa.fa")
            if n not in have]
    assert rest, "expected unaligned sequences beyond the half MSA"
    aligner = PoastaAligner(COSTS, Global(), heuristic="mingap")
    # device scores match the exact engine on the imported graph, and fusion
    # of the remaining sequences succeeds
    dg = DeviceGraph.build(g.flatten())
    qshift, lengths = pack_queries([s for _, s in rest])
    dev = list(np.asarray(dp_fill_scores(dg, qshift, lengths, COSTS)))
    for (name, seq), ds in zip(rest, dev):
        r = aligner.align(g, seq)
        assert r.score == ds
        g.add_alignment_with_weights(name, seq, r.alignment, [1] * len(seq))


def test_path_heuristic_on_gfa_graph(reference_tests_dir):
    """BASELINE config #4: path-aware heuristic on a GFA-loaded graph."""
    from poasta_tpu.io import load_graph_from_gfa, read_fasta

    graph, _segments = load_graph_from_gfa(f"{reference_tests_dir}/test.gfa")
    queries = [s for _, s in
               read_fasta(f"{reference_tests_dir}/small_test.query.fa")]
    results = {}
    for h in ("dijkstra", "mingap", "path"):
        a = PoastaAligner(COSTS, Global(), heuristic=h)
        results[h] = [(a.align(graph, q).score, a.align(graph, q).num_visited)
                      for q in queries]
    for i in range(len(queries)):
        scores = {results[h][i][0] for h in results}
        assert len(scores) == 1, "heuristics disagree on the optimal score"
        assert results["path"][i][1] <= results["dijkstra"][i][1]
        assert results["mingap"][i][1] <= results["dijkstra"][i][1]
