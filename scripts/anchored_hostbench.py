"""Host-only iteration bench for the native anchored corridor path.

Runs entirely on the CPU backend (no accelerator needed): computes each
read's semi-global score + end anchor with the XLA dense fill, then
times ``NativeAligner.align_anchored`` with the per-phase breakdown
(corridor BFS / fill / backtrace).  Used to iterate on the C++ fill
without touching the device; absolute reads/s at full pangenome scale
comes from scripts/profile_anchored.py on the GPU.

Usage: python scripts/anchored_hostbench.py [N_nodes] [read_len] [reads]
"""

import json
import random
import sys
import time

# host-only: pin JAX to the CPU even where a GPU is visible
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

sys.path.insert(0, ".")

from bench import _mutate  # noqa: E402


def main():
    N = int(sys.argv[1]) if len(sys.argv) > 1 else 5_000
    RL = int(sys.argv[2]) if len(sys.argv) > 2 else 1_000
    NR = int(sys.argv[3]) if len(sys.argv) > 3 else 8

    from poasta_tpu.aligner import GapAffine
    from poasta_tpu.aligner.costs import EndsFree, UNBOUNDED, included
    from poasta_tpu.aligner.wavefront import (
        DeviceGraph, dp_fill_ends_free_with_ends, pack_queries)
    from poasta_tpu.graphs import POAGraph
    from poasta_tpu.native import NativeAligner

    costs = GapAffine(4, 2, 6)
    rng = random.Random(17)
    pbase = "".join(rng.choice("ACGT") for _ in range(N))
    gp = POAGraph()
    gp.add_alignment_with_weights("s0", pbase.encode(), None, [1] * N)
    for v in range(0, N - 3, 500):
        gp.add_edge(v, v + 3, 0, 1)
    gp.post_process()
    preads = []
    for _ in range(NR):
        a = rng.randrange(0, N - RL)
        preads.append(_mutate(rng, pbase[a:a + RL], 0.015).encode())

    cfgp = EndsFree(UNBOUNDED, included(0), UNBOUNDED, UNBOUNDED)
    flat = gp.flatten()
    dg = DeviceGraph.build(flat)
    qshift, lengths = pack_queries(preads)
    t0 = time.perf_counter()
    sc, er, ej = dp_fill_ends_free_with_ends(
        dg, flat, qshift, lengths, costs, cfgp, mesh=None)
    sc = np.asarray(sc); er = np.asarray(er); ej = np.asarray(ej)
    t_cpu_fill = time.perf_counter() - t0
    node_of_rank = flat.node_of_rank

    native = NativeAligner(gp)
    # warm (meta build) + correctness
    s0, aln0 = native.align_anchored(
        preads[0], costs, int(node_of_rank[er[0]]), int(ej[0]),
        int(sc[0]), free_start=True)
    assert s0 == int(sc[0])

    agg = {"corridor_ns": 0, "fill_ns": 0, "backtrace_ns": 0,
           "corridor_nodes": 0, "corridor_cells": 0, "attempts": 0}
    reps = max(1, 64 // NR)
    t0 = time.perf_counter()
    for _ in range(reps):
        for b, q in enumerate(preads):
            s, aln = native.align_anchored(
                q, costs, int(node_of_rank[er[b]]), int(ej[b]), int(sc[b]),
                free_start=True)
            st = native.last_anchored_stats()
            for k in agg:
                agg[k] += st[k]
    t_host = time.perf_counter() - t0
    n = NR * reps
    print(json.dumps({
        "config": f"{N} nodes x {RL} bp x {NR} reads (x{reps} reps)",
        "cpu_device_fill_s": round(t_cpu_fill, 2),
        "host_only_reads_per_sec": round(n / t_host, 2),
        "mean_call_ms": round(t_host / n * 1e3, 2),
        "mean_corridor_ms": round(agg["corridor_ns"] / n / 1e6, 2),
        "mean_fill_ms": round(agg["fill_ns"] / n / 1e6, 2),
        "mean_backtrace_ms": round(agg["backtrace_ns"] / n / 1e6, 2),
        "mean_corridor_nodes": int(agg["corridor_nodes"] // n),
        "mean_corridor_cells": int(agg["corridor_cells"] // n),
        "mean_attempts": round(agg["attempts"] / n, 2),
        "fill_mcells_per_s": round(
            agg["corridor_cells"] / max(agg["fill_ns"], 1) * 1e3, 1),
    }))


if __name__ == "__main__":
    main()
