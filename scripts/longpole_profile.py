"""Phase profile of the two end-to-end alignment configs (VERDICT r3 #1).

Reproduces bench.py's pangenome-semiglobal and hybrid-global configs and
splits each into device-score vs host-backtrace wall, plus the native
anchored path's corridor/fill/backtrace ns, so the 3x target can be
aimed at the actual long pole.  Run on the real chip:
python scripts/longpole_profile.py
"""

import json
import os
import random
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench import _mutate, build_uniform  # noqa: E402


def main():
    from poasta_tpu.aligner import GapAffine
    from poasta_tpu.aligner.costs import EndsFree, UNBOUNDED, included
    from poasta_tpu.graphs import POAGraph
    from poasta_tpu.parallel import BatchMapper

    costs = GapAffine(4, 2, 6)
    out = {}

    # --- hybrid (bench.py uniform graph, 32 reads, global) -------------
    graph, reads = build_uniform(costs)
    hmap = BatchMapper(graph, costs)
    hsample = reads[:32]
    hmap.align_batch(hsample)  # warm
    ts_dev, ts_host = [], []
    for _ in range(3):
        from poasta_tpu.aligner.wavefront import pack_queries

        qshift, lengths = pack_queries(hsample)
        t0 = time.perf_counter()
        hmap._init_banded(False)
        scores = hmap._device_scores(qshift, lengths, False)
        t1 = time.perf_counter()
        hmap._align_batch_banded(hsample, qshift, lengths, scores=scores)
        t2 = time.perf_counter()
        ts_dev.append(t1 - t0)
        ts_host.append(t2 - t1)
    out["hybrid"] = {
        "n_reads": len(hsample),
        "device_score_s": round(statistics.median(ts_dev), 4),
        "host_backtrace_s": round(statistics.median(ts_host), 4),
    }

    # --- pangenome semiglobal (bench.py config) -------------------------
    rng = random.Random(17)
    N = 50_000
    pbase = "".join(rng.choice("ACGT") for _ in range(N))
    gp = POAGraph()
    t0 = time.perf_counter()
    gp.add_alignment_with_weights("s0", pbase.encode(), None, [1] * N)
    for v in range(0, N - 3, 500):
        gp.add_edge(v, v + 3, 0, 1)
    gp.post_process()
    out["pangenome_graph_build_s"] = round(time.perf_counter() - t0, 2)
    preads = []
    for _ in range(64):
        a = rng.randrange(0, N - 5000)
        preads.append(_mutate(rng, pbase[a:a + 5000], 0.015).encode())
    cfgp = EndsFree(UNBOUNDED, included(0), UNBOUNDED, UNBOUNDED)
    pmap = BatchMapper(gp, costs, aln_type=cfgp)
    pmap.align_batch(preads)  # warm
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        pmap.align_batch(preads)
        el = time.perf_counter() - t0
        st = dict(pmap.last_ends_free_stats)
        st["total_s"] = round(el, 4)
        runs.append(st)
    # per-read native anchored phase split (single-threaded probe so the
    # thread-local stats attribute cleanly)
    na = pmap._native
    node_of_rank = pmap.flat.node_of_rank
    from poasta_tpu.aligner.wavefront import pack_queries

    qshift, lengths = pack_queries(preads)
    sc, er, ej = pmap._ends_free_scores(qshift, lengths)
    agg = {"corridor_ns": 0, "fill_ns": 0, "backtrace_ns": 0,
           "corridor_cells": 0, "attempts": 0}
    t0 = time.perf_counter()
    for b, q in enumerate(preads):
        na.align_anchored(q, costs, int(node_of_rank[er[b]]), int(ej[b]),
                          int(sc[b]), free_start=True)
        st = na.last_anchored_stats()
        for k in agg:
            agg[k] += st[k]
    agg["serial_host_s"] = round(time.perf_counter() - t0, 4)
    for k in ("corridor_ns", "fill_ns", "backtrace_ns"):
        agg[k.replace("_ns", "_s")] = round(agg.pop(k) / 1e9, 4)
    out["pangenome"] = {"n_reads": 64, "runs": runs, "anchored_host": agg}

    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
