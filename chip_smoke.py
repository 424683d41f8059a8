#!/usr/bin/env python3
"""Smoke run of poasta_tpu on one NVIDIA GPU, through its user entry points.

    python chip_smoke.py              # one card, every phase
    python chip_smoke.py --cards 4    # only the four-card lasagna checks

Phases (any failure exits nonzero; nothing is caught and skipped):

1. device — platform, device kind and count, the card's name and power
   limit (``nvidia-smi``, in a child that never imports JAX), the compile
   cache directory and ``XLA_FLAGS``; fails unless the platform is ``gpu``.
2. build — compiles the CUDA banded fill from the committed source.
3. kernel — the CUDA kernel against the XLA body on the same prepared
   tables and against the native engine, at the uniform (1,024 x ~5 kb
   reads, ~6.2k-node graph; first-tier band and full-width clamp) and
   mixed-length SV (drifting windows) widths, plus the ends-free end
   rules; exact equality.  Times both executors in turns.
4. scoring — ``BandedScorer.scores`` on both configs and
   ``BatchMapper.align_batch`` on 32 reads, against ``NativeAligner``.
5. mapping — ``lasagna align -m semi-global`` on a generated 50k-node
   pangenome GFA and 256 reads of 5 kb; 16 of them again through the same
   CLI in a CPU-only child process: byte-equal GAF lines.
6. msa — ``poasta align --engine banded`` on four 20 kb sequences with
   ``--device-assist on`` against ``off``: equal FASTA, device seeds used.

``--cards 4`` runs only device, build and the four-card checks: ``lasagna
--mesh auto`` over the cards against ``--mesh off`` on one, byte-equal
GAF, for ``-m semi-global`` on the pangenome graph (the sharded bounded
full fill) and for ``-m global`` on a 5 kb graph (the sharded banded fill
through the CUDA kernel).

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
All inputs are generated from fixed seeds.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
COSTS_ARGS = (4, 2, 6)  # mismatch, gap extend, gap open (the CLI defaults)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# input generators (deterministic, shared with bench.py's configs)
# ---------------------------------------------------------------------------

def random_seq(rng: random.Random, n: int) -> str:
    return "".join(rng.choice("ACGT") for _ in range(n))


def mutate(rng: random.Random, s: str, d: float, target_len=None) -> str:
    """Substitutions, deletions and insertions at rate ~d each."""
    out = []
    for ch in s:
        r = rng.random()
        if r < d:
            continue
        out.append(rng.choice("ACGT") if r < 2.5 * d else ch)
        if rng.random() < d:
            out.append(rng.choice("ACGT"))
    s2 = "".join(out)
    if target_len is not None:
        s2 = s2[:target_len]
    return s2 or "A"


def _fuse(graph, seq: bytes, costs, name: str) -> None:
    from poasta_tpu.native import NativeAligner

    _, alignment, _ = NativeAligner(graph).align(seq, costs)
    graph.add_alignment_with_weights(name, seq, alignment, [1] * len(seq))


def uniform_inputs(costs, graph_len=5000, n_seqs=4, n_reads=1024, seed=7):
    """bench.py's uniform config: ~6.2k-node graph from four 5 kb
    sequences at 3% divergence; reads at 3% divergence."""
    from poasta_tpu.graphs import POAGraph

    rng = random.Random(seed)
    base = random_seq(rng, graph_len)
    graph = POAGraph()
    graph.add_alignment_with_weights("s0", base.encode(), None,
                                     [1] * graph_len)
    for i in range(1, n_seqs):
        _fuse(graph, mutate(rng, base, 0.03, graph_len).encode(), costs,
              f"s{i}")
    reads = [mutate(rng, base, 0.03, graph_len).encode()
             for _ in range(n_reads)]
    return graph, reads


def mixed_len_sv_inputs(costs, graph_len=5000, n_reads=1024, seed=13):
    """bench.py's mixed_len_sv config: a graph with a 4 kb deletion
    allele; reads alternate between the ~1 kb and ~5 kb alleles."""
    from poasta_tpu.graphs import POAGraph

    rng = random.Random(seed)
    base = random_seq(rng, graph_len)
    cut = graph_len // 10
    variant = base[:cut] + base[graph_len - cut:]
    graph = POAGraph()
    graph.add_alignment_with_weights("s0", base.encode(), None,
                                     [1] * graph_len)
    _fuse(graph, variant.encode(), costs, "s1")
    reads = [mutate(rng, base if i % 2 else variant, 0.015).encode()
             for i in range(n_reads)]
    return graph, reads


def pangenome_gfa(n_nodes=50_000, block=500, skip=2, seed=17):
    """GFA text of a backbone of ``n_nodes`` bases with a ``skip``-base
    deletion bubble every ``block`` bases (bench.py's pangenome shape),
    and the backbone sequence."""
    rng = random.Random(seed)
    backbone = random_seq(rng, n_nodes)
    lines = ["H\tVN:Z:1.0"]
    names = []
    at, k = 0, 0
    while at < n_nodes:
        big = backbone[at:at + block - skip]
        lines.append(f"S\tb{k}\t{big}")
        names.append(f"b{k}")
        at += len(big)
        if at + skip < n_nodes:
            lines.append(f"S\td{k}\t{backbone[at:at + skip]}")
            names.append(f"d{k}")
            at += skip
        k += 1
    for i in range(len(names) - 1):
        lines.append(f"L\t{names[i]}\t+\t{names[i + 1]}\t+\t0M")
        if names[i].startswith("b") and i + 2 < len(names) \
                and names[i + 1].startswith("d"):
            lines.append(f"L\t{names[i]}\t+\t{names[i + 2]}\t+\t0M")
    return "\n".join(lines) + "\n", backbone


def sample_reads(backbone: str, n_reads=256, length=5000, div=0.015,
                 seed=19):
    """(name, seq) reads drawn from random backbone positions."""
    rng = random.Random(seed)
    out = []
    for i in range(n_reads):
        a = rng.randrange(0, len(backbone) - length)
        out.append((f"read{i}", mutate(rng, backbone[a:a + length], div)))
    return out


def fastq_text(reads) -> str:
    return "".join(f"@{n}\n{s}\n+\n{'I' * len(s)}\n" for n, s in reads)


def msa_sequences(n_seqs=4, length=20_000, div=0.02, seed=23):
    rng = random.Random(seed)
    base = random_seq(rng, length)
    return [(f"seq{i}", base if i == 0 else mutate(rng, base, div))
            for i in range(n_seqs)]


def global_inputs(n_reads=256, length=5000, div=0.03, seed=29):
    """GFA text of a ``length``-base backbone with deletion bubbles and
    ``n_reads`` whole-length reads at ``div``: global alignments at the
    uniform config's read length."""
    gfa_text, backbone = pangenome_gfa(n_nodes=length, seed=seed)
    rng = random.Random(seed + 1)
    return gfa_text, [(f"read{i}", mutate(rng, backbone, div))
                      for i in range(n_reads)]


def last_line(platform: str, kind: str, count: int) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(cards: int):
    import jax

    from poasta_tpu.utils import backend

    devs = jax.devices()
    d = devs[0]
    log(f"[device] platform={d.platform} kind={d.device_kind} "
        f"count={len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    for row in smi.stdout.strip().splitlines():
        log(f"[device] nvidia-smi: {row.strip()}")
    log(f"[device] compile cache: {jax.config.jax_compilation_cache_dir}")
    log(f"[device] XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    if d.platform != "gpu":
        raise RuntimeError(f"platform is {d.platform!r}, not 'gpu'")
    if len(devs) < cards:
        raise RuntimeError(f"{cards} cards asked, {len(devs)} visible")
    backend.executor_for(d.platform)
    return d.platform, d.device_kind, len(devs)


def phase_build():
    from poasta_tpu.ops import cuda_fill
    from poasta_tpu.utils import backend

    t0 = time.perf_counter()
    path = cuda_fill.build()
    ex = backend.fill_executor()
    log(f"[build] {path.name} nvcc {cuda_fill.build_seconds():.1f}s "
        f"(set-up {time.perf_counter() - t0:.1f}s), executor={ex}")
    if ex != "cuda":
        raise RuntimeError(f"executor is {ex!r} on the GPU")


def _timed(fn, reps=1):
    import jax

    ts = []
    out = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return out, ts


def _layout_case(flat, dg, qshift, lengths, costs, ub, kind, aln_type=None):
    """(tables, q_in, kwargs) of one band layout at ``ub``."""
    import jax.numpy as jnp
    import numpy as np

    from poasta_tpu.aligner import banded as bd
    from poasta_tpu.ops.banded_fill import prepare_banded

    ln = np.asarray(lengths)
    n_min, n_max = int(ln.min()), int(ln.max())
    L = int(qshift.shape[1])
    kw = {}
    if kind == "drift":
        S = bd.drift_steps_for(n_min, n_max)
        ws, width, s_r = bd.band_windows_drift(flat, n_min, n_max, costs,
                                               ub, S, aln_type=aln_type)
        mq = bd._round_up(max(0, -int(ws.min())), 128)
        tables = prepare_banded(dg, ws, width, s_r, S)
        kw = {"n_min": n_min, "mq": mq}
    else:
        ws, width, _, _ = bd.band_windows(flat, n_min, n_max, costs, ub,
                                          aln_type=aln_type)
        mq = 0
        if kind == "clamp":
            ws, width = np.zeros_like(ws), L
        tables = prepare_banded(dg, ws, width)
    req = bd._round_up(int(ws.max()) + width, 128)
    parts = [qshift]
    if mq:
        parts.insert(0, jnp.zeros((qshift.shape[0], mq), qshift.dtype))
    if req > L:
        parts.append(jnp.zeros((qshift.shape[0], req - L), qshift.dtype))
    q_in = jnp.concatenate(parts, axis=1) if len(parts) > 1 else qshift
    return tables, q_in, kw


def phase_kernel():
    """CUDA vs XLA body (same tables) vs native, at real widths."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from poasta_tpu.aligner import GapAffine
    from poasta_tpu.aligner.costs import UNBOUNDED, EndsFree, included
    from poasta_tpu.aligner.wavefront import (
        DeviceGraph,
        ends_free_device_params,
        pack_queries,
    )
    from poasta_tpu.native import NativeAligner
    from poasta_tpu.ops.banded_fill import banded_scores, cuda_fits

    costs = GapAffine(*COSTS_ARGS)
    # bounded ends (drift-capable) and the mapping span (free graph begin)
    cfg_ef = EndsFree(("unbounded", None), included(50), included(0),
                      included(50))
    cfg_map = EndsFree(UNBOUNDED, included(0), UNBOUNDED, UNBOUNDED)
    results = []
    for cname, make in (("uniform", uniform_inputs),
                        ("mixed_len_sv", mixed_len_sv_inputs)):
        graph, reads = make(costs)
        flat = graph.flatten()
        dg = DeviceGraph.build(flat)
        na = NativeAligner(graph)
        qshift, lengths = pack_queries(reads)
        sample = list(range(16))
        native = np.asarray([na.align(reads[i], costs)[0] for i in sample])
        ub = int(native.max())
        log(f"[kernel] {cname}: {flat.n_nodes} nodes, W={dg.window}, "
            f"{len(reads)} reads, L={int(qshift.shape[1])}, ub={ub}")
        kinds = (["band", "clamp"] if cname == "uniform"
                 else ["drift", "band"])
        for kind in kinds:
            for aln in (None, cfg_ef, cfg_map):
                ends_free = aln is not None
                if ends_free and kind == "clamp":
                    continue
                if aln is cfg_map and kind == "drift":
                    continue  # free graph begins never drift
                tables, q_in, kw = _layout_case(
                    flat, dg, qshift, lengths, costs, ub, kind, aln)
                fits = cuda_fits(dg.window, tables.width)
                span = {None: "", id(cfg_ef): "/ef",
                        id(cfg_map): "/map"}[id(aln) if aln else None]
                label = f"{cname}/{kind}{span} Wb={tables.width}"
                if not fits:
                    log(f"[kernel] {label}: over the shared-memory budget, "
                        "XLA body only")
                    continue
                ends = None
                if ends_free:
                    ends = ends_free_device_params(flat, aln, lengths,
                                                   dg.n_nodes_padded)
                idx = jnp.asarray(sample, dtype=jnp.int32)
                q16, l16 = q_in[idx], lengths[idx]
                ends16 = None if ends is None else (
                    ends[0], ends[1], ends[2][idx])
                c16 = np.asarray(banded_scores("cuda", dg, tables, q16, l16,
                                               costs, ends=ends16, **kw))
                x16 = np.asarray(banded_scores("xla", dg, tables, q16, l16,
                                               costs, ends=ends16, **kw))
                if not np.array_equal(c16, x16):
                    bad = np.nonzero(c16 != x16)[0][:8]
                    raise AssertionError(
                        f"{label}: CUDA != XLA at {bad.tolist()}: "
                        f"{c16[bad].tolist()} vs {x16[bad].tolist()}")
                if not ends_free:
                    ok = (c16 <= ub) if kind != "clamp" else np.ones(16, bool)
                    if not np.array_equal(c16[ok], native[ok]):
                        raise AssertionError(
                            f"{label}: CUDA != native: {c16.tolist()} vs "
                            f"{native.tolist()}")
                # full batch, in turns: XLA, CUDA, CUDA, XLA
                ef_full = ends

                def run(ex):
                    return banded_scores(ex, dg, tables, q_in, lengths,
                                         costs, ends=ef_full, **kw)

                run("cuda").block_until_ready()
                run("xla").block_until_ready()  # compile both first
                t = {"xla": [], "cuda": []}
                outs = {}
                for ex in ("xla", "cuda", "cuda", "xla"):
                    o, ts = _timed(lambda: run(ex))
                    t[ex] += ts
                    outs[ex] = np.asarray(o)
                if not np.array_equal(outs["xla"], outs["cuda"]):
                    raise AssertionError(f"{label}: full batch CUDA != XLA")
                if cname == "uniform" and kind == "band" and aln is None:
                    _memory_analysis(label, dg, tables, q_in, lengths,
                                     costs)
                cells = flat.n_nodes * tables.width * len(reads)
                row = {"case": label, "cells": cells}
                for ex in ("xla", "cuda"):
                    med = statistics.median(t[ex])
                    row[ex] = {"median_s": med, "spread_s": [min(t[ex]),
                                                           max(t[ex])],
                               "raw_gcells_s": cells / med / 1e9}
                log(f"[kernel] {label}: exact on 16 (native) and "
                    f"{len(reads)} (XLA); xla {row['xla']['median_s']:.4f}s "
                    f"{row['xla']['raw_gcells_s']:.2f} Gcells/s, cuda "
                    f"{row['cuda']['median_s']:.4f}s "
                    f"{row['cuda']['raw_gcells_s']:.2f} Gcells/s "
                    f"(spread xla {row['xla']['spread_s']}, cuda "
                    f"{row['cuda']['spread_s']})")
                results.append(row)
    stats = jax.devices()[0].memory_stats() or {}
    log(f"[kernel] peak_bytes_in_use={stats.get('peak_bytes_in_use')}")
    return results


def _memory_analysis(label, dg, tables, q_in, lengths, costs):
    """compiled.memory_analysis() of both executors' jitted programs."""
    import jax.numpy as jnp

    from poasta_tpu.ops import banded_fill as bf

    P = int(dg.pred_slots.shape[1])
    xfn = bf.xla_banded_exec(dg.window, tables.width, P, costs.gap_open,
                             costs.gap_extend, costs.mismatch)
    xargs = (dg.symbols, dg.pred_slots, tables.pred_valid,
             tables.pred_wstarts, tables.wstarts, dg.write_slots,
             dg.end_rank, tables.wstarts, tables.wstarts, q_in, lengths,
             lengths, jnp.int32(0), jnp.int32(0))
    cfn = bf.cuda_banded_exec(dg.n_nodes, dg.window, tables.width,
                        costs.gap_open, costs.gap_extend, costs.mismatch,
                        0, 0, 0, False, False)
    cargs = xargs[:6] + (tables.wstarts, tables.wstarts, q_in, lengths,
                         lengths)
    for ex, fn, args in (("xla", xfn, xargs), ("cuda", cfn, cargs)):
        ma = fn.lower(*args).compile().memory_analysis()
        log(f"[kernel] {label} {ex} memory_analysis: "
            f"args {ma.argument_size_in_bytes} out {ma.output_size_in_bytes}"
            f" temp {ma.temp_size_in_bytes}")


def _check_against_native(na, reads, scores, costs, n, label):
    for i in range(n):
        s = na.align(reads[i], costs)[0]
        if s != int(scores[i]):
            raise AssertionError(f"{label}: read {i}: device {int(scores[i])}"
                                 f" != native {s}")


def phase_scoring():
    import numpy as np

    from poasta_tpu.aligner import GapAffine
    from poasta_tpu.aligner.banded import BandedScorer
    from poasta_tpu.aligner.wavefront import pack_queries
    from poasta_tpu.native import NativeAligner
    from poasta_tpu.parallel import BatchMapper

    costs = GapAffine(*COSTS_ARGS)
    for cname, make in (("uniform", uniform_inputs),
                        ("mixed_len_sv", mixed_len_sv_inputs)):
        graph, reads = make(costs)
        flat = graph.flatten()
        scorer = BandedScorer(flat, costs)
        qshift, lengths = pack_queries(reads)
        t0 = time.perf_counter()
        scores = np.asarray(scorer.scores(qshift, lengths))
        t_cold = time.perf_counter() - t0
        scorer.reset_stats()
        t0 = time.perf_counter()
        scores2 = np.asarray(scorer.scores(qshift, lengths))
        t_warm = time.perf_counter() - t0
        if not np.array_equal(scores, scores2):
            raise AssertionError(f"{cname}: repeat call changed scores")
        if (scores >= (1 << 28)).any():
            raise AssertionError(f"{cname}: unaligned reads")
        na = NativeAligner(graph)
        _check_against_native(na, reads, scores, costs, 16, cname)
        log(f"[scoring] {cname}: BandedScorer.scores {len(reads)} reads "
            f"cold {t_cold:.2f}s warm {t_warm:.3f}s "
            f"({len(reads) / t_warm:.1f} reads/s), stats {scorer.stats}; "
            "16 equal to NativeAligner")
        # the same served call with the XLA body as executor, in turns
        xla = BandedScorer(flat, costs, dg=scorer.dg)
        xla.executor = "xla"
        if not np.array_equal(np.asarray(xla.scores(qshift, lengths)),
                              scores):
            raise AssertionError(f"{cname}: XLA-executor scorer differs")
        xla.scores(qshift, lengths)
        walls = {"xla": [], "cuda": []}
        for ex in ("xla", "cuda", "cuda", "xla", "xla", "cuda"):
            sc = xla if ex == "xla" else scorer
            t0 = time.perf_counter()
            np.asarray(sc.scores(qshift, lengths))
            walls[ex].append(time.perf_counter() - t0)
        log(f"[scoring] {cname}: BandedScorer.scores wall, median "
            f"(spread) over 3 turns each: xla "
            f"{statistics.median(walls['xla']):.4f}s "
            f"({min(walls['xla']):.4f}-{max(walls['xla']):.4f}), cuda "
            f"{statistics.median(walls['cuda']):.4f}s "
            f"({min(walls['cuda']):.4f}-{max(walls['cuda']):.4f})")
        if cname == "uniform":
            mapper = BatchMapper(graph, costs)
            out = mapper.align_batch(reads[:32])
            _check_against_native(na, reads, [s for s, _ in out], costs, 32,
                                  "align_batch")
            if any(aln is None for _, aln in out):
                raise AssertionError("align_batch returned no alignment")
            log(f"[scoring] BatchMapper.align_batch: 32 reads equal to "
                f"NativeAligner, {mapper.last_banded_stats}")


def _gaf_by_name(path):
    out = {}
    with open(path) as fh:
        for line in fh:
            out[line.split("\t", 1)[0]] = line
    return out


def _write_inputs(workdir, tag, gfa_text, reads):
    gfa = os.path.join(workdir, f"{tag}.gfa")
    fq = os.path.join(workdir, f"{tag}.fq")
    with open(gfa, "w") as fh:
        fh.write(gfa_text)
    with open(fq, "w") as fh:
        fh.write(fastq_text(reads))
    return gfa, fq


def phase_cards(workdir: str, cards: int):
    """lasagna --mesh auto over ``cards`` cards against --mesh off on one:
    semi-global on the pangenome graph, global on a 5 kb graph."""
    from poasta_tpu.cli import lasagna

    gfa_text, backbone = pangenome_gfa()
    cases = [("semi-global", gfa_text, sample_reads(backbone)),
             ("global", *global_inputs())]
    for span, gtext, reads in cases:
        gfa, fq = _write_inputs(workdir, span, gtext, reads)
        runs = {}
        for mesh in ("auto", "off"):
            gaf = os.path.join(workdir, f"{span}_mesh_{mesh}.gaf")
            t0 = time.perf_counter()
            rc = lasagna.main(["align", gfa, fq, "-m", span, "--mesh", mesh,
                               "-o", gaf, "-v"])
            if rc != 0:
                raise RuntimeError(f"lasagna -m {span} --mesh {mesh} "
                                   f"exited {rc}")
            runs[mesh] = (open(gaf).read(), time.perf_counter() - t0)
            log(f"[cards] -m {span} --mesh {mesh}: {len(reads)} reads in "
                f"{runs[mesh][1]:.1f}s")
        if runs["auto"][0] != runs["off"][0]:
            raise AssertionError(f"-m {span}: --mesh auto GAF != --mesh off")
        n = runs["auto"][0].count("\n")
        if n != len(reads):
            raise AssertionError(f"-m {span}: {n} GAF records for "
                                 f"{len(reads)} reads")
        log(f"[cards] -m {span}, {cards} cards: GAF byte-identical to one "
            f"card ({n} records)")


def phase_mapping(workdir: str):
    """lasagna semi-global on the GPU vs the same CLI on the CPU."""
    from poasta_tpu.cli import lasagna

    gfa_text, backbone = pangenome_gfa()
    reads = sample_reads(backbone)
    gfa, fq = _write_inputs(workdir, "pangenome", gfa_text, reads)
    base = ["align", gfa, fq, "-m", "semi-global"]
    gaf = os.path.join(workdir, "gpu.gaf")
    t0 = time.perf_counter()
    rc = lasagna.main(base + ["-o", gaf, "-v", "--mesh", "off"])
    if rc != 0:
        raise RuntimeError(f"lasagna exited {rc}")
    dt = time.perf_counter() - t0
    gpu = _gaf_by_name(gaf)
    if len(gpu) != len(reads):
        raise AssertionError(f"{len(gpu)} GAF records for {len(reads)}")
    log(f"[mapping] lasagna semi-global: {len(reads)} reads x 5 kb on a "
        f"{len(backbone)}-node graph in {dt:.1f}s")
    sub = reads[::16][:16]
    fq16 = os.path.join(workdir, "reads16.fq")
    with open(fq16, "w") as fh:
        fh.write(fastq_text(sub))
    gaf16 = os.path.join(workdir, "cpu.gaf")
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "poasta_tpu.cli.lasagna", "align", gfa, fq16,
         "-m", "semi-global", "-o", gaf16], env=env, cwd=HERE,
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"CPU lasagna failed: {proc.stderr[-2000:]}")
    cpu = _gaf_by_name(gaf16)
    for name, _ in sub:
        if cpu.get(name) != gpu.get(name):
            raise AssertionError(f"GAF differs for {name}:\nGPU "
                                 f"{gpu.get(name)}CPU {cpu.get(name)}")
    log(f"[mapping] 16 reads through the CLI on the CPU "
        f"({time.perf_counter() - t0:.1f}s): GAF lines byte-equal")


def phase_msa(workdir: str):
    import contextlib
    import io
    import re

    from poasta_tpu.cli import poasta

    fa = os.path.join(workdir, "msa.fa")
    with open(fa, "w") as fh:
        for name, seq in msa_sequences():
            fh.write(f">{name}\n{seq}\n")
    outs = {}
    for mode in ("on", "off"):
        path = os.path.join(workdir, f"msa_{mode}.fa")
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = poasta.main(["-v", "align", "--engine", "banded",
                              "--device-assist", mode, "-O", "fasta", "-o",
                              path, fa])
        if rc not in (0, None):
            raise RuntimeError(f"poasta align --device-assist {mode}: {rc}"
                               f"\n{err.getvalue()[-2000:]}")
        outs[mode] = open(path).read()
        used = re.findall(r"device-assist seeds used: (\d+)", err.getvalue())
        log(f"[msa] --device-assist {mode}: {time.perf_counter() - t0:.1f}s,"
            f" device seeds used {used[-1] if used else 0}")
        if mode == "on" and not (used and int(used[-1]) > 0):
            raise AssertionError("--device-assist on used no device seed")
    if outs["on"] != outs["off"] or not outs["on"].startswith(">"):
        raise AssertionError("MSA with device assist differs from without")
    log("[msa] FASTA equal with and without device assist")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card lasagna checks")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    from poasta_tpu.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    platform, kind, count = phase_device(args.cards)
    with tempfile.TemporaryDirectory() as workdir:
        phase_build()
        if args.cards > 1:
            phase_cards(workdir, args.cards)
        else:
            phase_kernel()
            phase_scoring()
            phase_mapping(workdir)
            phase_msa(workdir)
    print(last_line(platform, kind, count), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
