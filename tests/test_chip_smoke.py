"""chip_smoke.py's input generators, output contract and refusal to run
without a GPU — everything of it that a CPU can check."""

import json
import os
import random
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def test_last_line_contract():
    line = cs.last_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    obj = json.loads(line)
    assert obj == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


def test_mutate_is_seeded():
    a = cs.mutate(random.Random(1), "ACGT" * 100, 0.05)
    b = cs.mutate(random.Random(1), "ACGT" * 100, 0.05)
    assert a == b and a != "ACGT" * 100 and set(a) <= set("ACGT")


def test_pangenome_gfa_shape():
    """The generated GFA loads into a backbone with one deletion bubble
    per block: every base a node, the skip links present."""
    from poasta_tpu.io import load_graph_from_gfa

    text, backbone = cs.pangenome_gfa(n_nodes=2000, block=500, skip=2)
    assert len(backbone) == 2000
    segs = [ln.split("\t") for ln in text.splitlines() if ln[0] == "S"]
    assert "".join(s[2] for s in segs) == backbone
    links = [ln for ln in text.splitlines() if ln[0] == "L"]
    assert len(links) == len(segs) - 1 + sum(
        s[1].startswith("d") for s in segs)
    path = REPO / "tests" / ".tmp_smoke.gfa"
    path.write_text(text)
    try:
        graph, segments = load_graph_from_gfa(str(path))
    finally:
        path.unlink()
    assert graph.node_count() == 2000
    assert len(segments.names) == len(segs)


def test_reads_and_fastq(tmp_path):
    from poasta_tpu.io import read_fastq

    _, backbone = cs.pangenome_gfa(n_nodes=6000)
    reads = cs.sample_reads(backbone, n_reads=5, length=1000)
    assert reads == cs.sample_reads(backbone, n_reads=5, length=1000)
    fq = tmp_path / "r.fq"
    fq.write_text(cs.fastq_text(reads))
    back = list(read_fastq(str(fq)))
    assert [(n, s.decode()) for n, s in back] == reads
    assert all(900 < len(s) < 1100 for _, s in reads)


def test_global_inputs(tmp_path):
    """Whole-length reads of a bubbled backbone, seeded: the four-card
    check's global case loads and its reads span the graph."""
    from poasta_tpu.io import load_graph_from_gfa

    text, reads = cs.global_inputs(n_reads=4, length=1500)
    assert (text, reads) == cs.global_inputs(n_reads=4, length=1500)
    path = tmp_path / "g.gfa"
    path.write_text(text)
    graph, _ = load_graph_from_gfa(str(path))
    assert graph.node_count() == 1500
    assert [n for n, _ in reads] == [f"read{i}" for i in range(4)]
    assert all(1350 < len(s) < 1650 for _, s in reads)


def test_msa_sequences():
    seqs = cs.msa_sequences(n_seqs=3, length=2000)
    assert [n for n, _ in seqs] == ["seq0", "seq1", "seq2"]
    assert len(seqs[0][1]) == 2000 and seqs[1][1] != seqs[0][1]
    assert seqs == cs.msa_sequences(n_seqs=3, length=2000)


def test_bench_shapes_reproduced():
    """The uniform and mixed_len_sv generators build bench.py's graphs:
    ~6.1k and ~5k nodes, reads of the stated lengths."""
    from poasta_tpu.aligner import GapAffine

    costs = GapAffine(*cs.COSTS_ARGS)
    g, reads = cs.uniform_inputs(costs, n_reads=3)
    assert 5800 < g.flatten().n_nodes < 6500
    assert len(reads) == 3 and all(4500 < len(r) <= 5000 for r in reads)
    g2, reads2 = cs.mixed_len_sv_inputs(costs, n_reads=4)
    assert 4900 < g2.flatten().n_nodes < 5100
    lens = sorted(len(r) for r in reads2)
    assert lens[0] < 1200 and lens[-1] > 4500


def test_refuses_to_run_without_a_gpu():
    """On the CPU the script exits nonzero and prints no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_refuses_to_run_alone(tmp_path):
    """A directory holding only chip_smoke.py has none of the program."""
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
