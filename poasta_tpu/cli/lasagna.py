"""`lasagna` CLI: align reads to a static GFA graph, emit GAF.

Flag-compatible with the reference binary (``src/bin/lasagna.rs:46-106``).
Where the reference fans reads out over ``-j`` host threads
(``lasagna.rs:214-273``), this implementation batches reads onto the
accelerator: the wavefront engine scores/aligns whole batches per device
dispatch, and ``-j`` selects the batch size instead of a thread count.
Use ``--engine exact`` to force the host A* engine per read.
"""

from __future__ import annotations

import argparse
import sys


def align_subcommand(args):
    from ..aligner import GapAffine, Global, PoastaAligner
    from ..bubbles import BubbleIndex
    from ..io import (
        alignment_to_gaf,
        load_graph_from_gfa,
        NodeSegmentResolver,
        read_fasta,
        read_fastq,
    )
    from ..parallel import BatchMapper

    graph, segments = load_graph_from_gfa(
        args.graph,
        reverse_links=getattr(args, "reverse_links", "reject"))
    if graph.node_count() == 0:
        raise SystemExit(f"Error: graph {args.graph!r} contains no segments")
    resolver = NodeSegmentResolver(graph, segments)
    costs = GapAffine(args.cost_mismatch, args.cost_gap_extend, args.cost_gap_open)

    path = str(args.sequences)
    base = path[:-3] if path.endswith(".gz") else path
    is_fastq = base.endswith((".fastq", ".fq"))
    reader = read_fastq(args.sequences) if is_fastq else read_fasta(args.sequences)

    # Multi-host layout: dp has no intra-fill communication, so hosts
    # need no collectives at all — each process aligns a round-robin
    # slice of the read stream and writes its own output shard
    # (<output>.part<pid>; concatenate when done).  This is the
    # accelerator shape of the reference's fan-out/fan-in worker pool
    # (lasagna.rs:214-273) scaled over hosts.  Decided BEFORE opening any
    # file so no process ever truncates the shared output path.
    multi_host = False
    out_path = args.output
    pid = np_ = None
    shard_idx = getattr(args, "shard_index", None)
    shard_cnt = getattr(args, "shard_count", None)
    if (shard_idx is None) != (shard_cnt is None):
        raise ValueError(
            "--shard-index and --shard-count must be given together")
    if shard_cnt is not None:
        # standalone shard mode: the recovery path.  Shards are a pure
        # function of (input order, shard-count, shard-index), so a shard
        # lost to a mid-stream process failure is regenerated exactly by
        # re-running just that index — no coordinator, no rendezvous
        # (docs/DEPLOY.md "Failure handling").
        if getattr(args, "distributed", False):
            raise ValueError(
                "--shard-index/--shard-count cannot be combined with "
                "--distributed (the process index already selects the "
                "shard)")
        if not (0 <= shard_idx < shard_cnt):
            raise ValueError(
                f"--shard-index {shard_idx} out of range for "
                f"--shard-count {shard_cnt}")
        pid, np_ = shard_idx, shard_cnt
    elif args.engine != "exact":
        import jax

        if jax.process_count() > 1:
            multi_host = True
            pid, np_ = jax.process_index(), jax.process_count()
    if pid is not None:
        reader = (
            rec for i, rec in enumerate(reader) if i % np_ == pid
        )
        if args.output:
            out_path = f"{args.output}.part{pid}"

    out = open(out_path, "w") if out_path else sys.stdout

    def emit_record(name, seq, score, alignment):
        rec = alignment_to_gaf(graph, segments, name, seq, alignment, resolver)
        if rec is not None:
            rec.additional_fields.append(("AS", "i", str(score)))
            out.write(str(rec) + "\n")

    # -m is honored for real (DELIBERATE deviation: the reference parses
    # and ignores it, hardcoding global — lasagna.rs:256; see PARITY.md).
    # semi-global = whole query, free graph ends (the read-mapping
    # semantics); ends-free = all-unbounded (poasta's own -m mapping).
    aln_type = None
    if args.alignment_span == "semi-global":
        from ..aligner.costs import EndsFree, UNBOUNDED, included

        aln_type = EndsFree(UNBOUNDED, included(0), UNBOUNDED, UNBOUNDED)
    elif args.alignment_span == "ends-free":
        from ..aligner.costs import EndsFree, UNBOUNDED

        aln_type = EndsFree(UNBOUNDED, UNBOUNDED, UNBOUNDED, UNBOUNDED)

    if args.engine == "exact":
        bubble_index = BubbleIndex(graph)
        aligner = PoastaAligner(costs, aln_type if aln_type is not None
                                else Global(), heuristic="mingap")
        for name, seq in reader:
            res = aligner.align_with_existing_bubbles(graph, seq, bubble_index)
            emit_record(name, seq, res.score, res.alignment)
    else:
        from ..parallel import make_mesh, parse_mesh_spec

        if multi_host:
            # each process runs a dp-only mesh over its own devices; an
            # explicit global spec cannot be honored per-host, so reject
            # it instead of silently substituting a different layout
            if args.mesh not in ("auto", "off", "1", "none"):
                raise ValueError(
                    f"--mesh {args.mesh!r} cannot be honored per-host "
                    "under --distributed; use --mesh auto (dp over each "
                    "host's local devices) or --mesh off"
                )
            import jax

            local = jax.local_devices()
            mesh = (make_mesh(devices=local, dp=len(local), sp=1)
                    if args.mesh == "auto" and len(local) > 1 else None)
        else:
            mesh = parse_mesh_spec(args.mesh)
        batch_size = args.batch_size
        if mesh is not None:
            # the dp shard path needs the batch to split evenly over dp;
            # round the batch size up so full batches always take the
            # mesh path — tail batches run single-device
            dp = mesh.shape.get("dp", 1)
            batch_size = ((batch_size + dp - 1) // dp) * dp
            if args.verbose:
                print(
                    f"INFO: mesh dp={dp} sp={mesh.shape.get('sp', 1)} "
                    f"({len(mesh.devices.flat)} devices), "
                    f"batch size {batch_size}",
                    file=sys.stderr,
                )
        mapper = BatchMapper(graph, costs, mesh=mesh, batch_size=batch_size,
                             aln_type=aln_type)
        # Super-batches are sorted by read length before splitting into
        # device batches: the banded fill shares one window layout per
        # batch, so mixing lengths pays gap_extend * (max_len - min_len)
        # of extra band width.  Output is restored to input order.
        super_size = batch_size * 16
        chunk = []
        for rec in reader:
            if not rec[1]:
                # per-record failures are logged and skipped, matching the
                # reference's reader behavior (lasagna.rs:153-156)
                print(f"WARNING: skipping empty read {rec[0]!r}",
                      file=sys.stderr)
                continue
            chunk.append(rec)
            if len(chunk) >= super_size:
                _flush_sorted(mapper, chunk, batch_size, emit_record,
                              args.verbose)
                chunk = []
        if chunk:
            _flush_sorted(mapper, chunk, batch_size, emit_record,
                          args.verbose)

    if args.output:
        out.close()


def _flush_sorted(mapper, chunk, batch_size, emit_record, verbose=0):
    import time
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    order = sorted(range(len(chunk)), key=lambda i: len(chunk[i][1]))
    results = [None] * len(chunk)
    batches = [order[at:at + batch_size]
               for at in range(0, len(order), batch_size)]
    queries = [[chunk[i][1] for i in idxs] for idxs in batches]

    # Pipelined batches (reference analogue: the reader/aligner/writer
    # thread pipeline, lasagna.rs:217-273): the device scores batch k+1
    # on a background thread while the host backtraces batch k — device
    # time is mostly accelerator/remote wait, so the overlap pays even
    # on few-core hosts.  Scoring calls are serialized on one thread
    # (the scorer's caches are not written concurrently).
    pipeline = len(batches) > 1 and mapper.supports_prescore(queries[0])
    with ThreadPoolExecutor(max_workers=1) as scorer_thread:
        fut = (scorer_thread.submit(mapper.prescore, queries[0])
               if pipeline else None)
        for k, idxs in enumerate(batches):
            pre = fut.result() if fut is not None else None
            if pipeline and k + 1 < len(batches):
                fut = scorer_thread.submit(mapper.prescore, queries[k + 1])
            else:
                fut = None
            out = mapper.align_batch(queries[k], prescored=pre)
            for i, r in zip(idxs, out):
                results[i] = r
    for (name, seq), (score, alignment) in zip(chunk, results):
        emit_record(name, seq, score, alignment)
    if verbose:
        dt = time.perf_counter() - t0
        msg = f"INFO: aligned {len(chunk)} reads in {dt:.2f}s"
        scorer = getattr(mapper, "_banded_scorer", None)
        if scorer is not None:
            s = scorer.stats
            msg += (f" (device fills: {s['fills']}, cells: {s['cells_filled']}"
                    f", tiers: {s['tiers']}, xla fills: {s['xla_fills']})")
            scorer.reset_stats()
        ef = getattr(mapper, "last_ends_free_stats", None)
        if ef:
            msg += (f" [anchored path: device {ef['device_s']:.2f}s,"
                    f" host {ef['host_s']:.2f}s,"
                    f" ok {ef['anchored_ok']},"
                    f" exact-fallback {ef['exact_fallback']}]")
        print(msg, file=sys.stderr)


def build_parser():
    p = argparse.ArgumentParser(prog="lasagna",
                                description="Read-to-graph aligner")
    p.add_argument("-v", "--verbose", action="count", default=0)
    sub = p.add_subparsers(dest="command")

    a = sub.add_parser("align", help="Align reads to a graph, output GAF")
    # -v works in either position (lasagna -v align / lasagna align -v);
    # SUPPRESS so the subparser's default can't clobber the top-level one
    a.add_argument("-v", "--verbose", action="count",
                   default=argparse.SUPPRESS)
    a.add_argument("graph")
    a.add_argument("sequences")
    a.add_argument("-j", "--num-threads", dest="batch_size", type=int, default=64,
                   help="device batch size (reference: worker thread count)")
    a.add_argument("-o", "--output", default=None)
    a.add_argument("-O", "--output-type", dest="output_type", default="gaf",
                   choices=["gaf"])
    a.add_argument("-m", "--alignment-span", dest="alignment_span", default="global",
                   choices=["global", "semi-global", "ends-free"])
    a.add_argument("-n", dest="cost_mismatch", type=int, default=4)
    a.add_argument("-g", dest="cost_gap_open", type=int, default=6)
    a.add_argument("-e", dest="cost_gap_extend", type=int, default=2)
    a.add_argument("--engine", default="wavefront", choices=["wavefront", "exact"])
    a.add_argument("--reverse-links", dest="reverse_links",
                   default="reject", choices=["reject", "double"],
                   help="GFA links touching the reverse strand: 'reject' "
                        "errors like the reference; 'double' (extension) "
                        "adds reverse-complement segment copies + the "
                        "strand-complement link closure, reported as "
                        "<name entries in GAF paths")
    a.add_argument("--mesh", default="auto", metavar="auto|off|DP[,SP]",
                   help="device mesh for the wavefront engine: 'auto' "
                        "shards the read batch over every visible device "
                        "(dp axis; the reference's -j worker-thread "
                        "analogue), 'off' forces single-device, 'DP,SP' "
                        "sets explicit data/sequence-parallel axis sizes")
    a.add_argument("--distributed", action="store_true",
                   help="call jax.distributed.initialize() before backend "
                        "init so the read stream spans processes "
                        "(coordinator/process settings come from the "
                        "flags below or the standard JAX env vars)")
    a.add_argument("--coordinator-address", default=None,
                   help="host:port of process 0 (with --distributed)")
    a.add_argument("--num-processes", type=int, default=None,
                   help="total process count (with --distributed)")
    a.add_argument("--process-id", type=int, default=None,
                   help="this process's index (with --distributed)")
    a.add_argument("--local-device-ids", default=None, metavar="I[,J...]",
                   help="with --distributed: the cards of this host this "
                        "process drives (e.g. its process index when "
                        "several processes share a host, one card each)")
    a.add_argument("--shard-index", type=int, default=None,
                   help="standalone shard recovery: align only round-robin "
                        "slice K of the read stream and write "
                        "<output>.partK, without jax.distributed — "
                        "regenerates a shard lost to a process failure")
    a.add_argument("--shard-count", type=int, default=None,
                   help="total shard count for --shard-index (must match "
                        "the failed run's process count)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if (getattr(args, "distributed", False)
            and getattr(args, "shard_count", None) is not None):
        # must be rejected BEFORE jax.distributed.initialize() — a
        # mis-wired recovery invocation should error, not rendezvous
        print("Error: --shard-index/--shard-count cannot be combined "
              "with --distributed (the process index already selects "
              "the shard)", file=sys.stderr)
        return 1
    if getattr(args, "distributed", False):
        # must run before anything initializes a backend: the runtime
        # wires every process's local devices into one global device
        # list; each process then maps its own slice of the read stream
        # on its local devices (dp has no intra-fill communication)
        import jax

        kwargs = {}
        if args.coordinator_address is not None:
            kwargs["coordinator_address"] = args.coordinator_address
        if args.num_processes is not None:
            kwargs["num_processes"] = args.num_processes
        if args.process_id is not None:
            kwargs["process_id"] = args.process_id
        if args.local_device_ids is not None:
            kwargs["local_device_ids"] = [
                int(v) for v in args.local_device_ids.split(",")]
        jax.distributed.initialize(**kwargs)
    from ..utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    try:
        if args.command == "align":
            align_subcommand(args)
        else:
            print("No subcommand given.", file=sys.stderr)
            return 1
    except (OSError, ValueError) as exc:
        print(f"Error: {exc}", file=sys.stderr)
        return 1
    except Exception as exc:
        from ..utils.errors import PoastaError

        if isinstance(exc, PoastaError):
            print(f"Error: {exc}", file=sys.stderr)
            return 1
        raise
    return 0


if __name__ == "__main__":
    sys.exit(main())


def main_entry() -> None:
    """console_scripts entry point (sys.exit for shell status)."""
    sys.exit(main())
