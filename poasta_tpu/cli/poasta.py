"""`poasta` CLI: multiple sequence alignment and POA graph tooling.

Flag-compatible with the reference binary (``src/bin/poasta.rs:66-161``):

  poasta align [-I graph] [-o out] [-O poasta|fasta|gfa|gfav1|dot]
               [-m global|semi-global|ends-free] [-n N] [-g G[,G2]]
               [-e E[,E2]] [-H dijkstra|mingap|path] [-d DIR] sequences.fa
  poasta view  graph -O fasta|gfa|gfav1|dot|poasta [-o out]
  poasta stats graph
"""

from __future__ import annotations

import argparse
import io
import os
import sys


def _load_any_graph(path):
    from ..io import is_fasta_path, load_graph, load_graph_from_fasta_msa

    if is_fasta_path(path):
        return load_graph_from_fasta_msa(path)
    with open(path, "rb") as fh:
        return load_graph(fh)


def _parse_penalties(s: str):
    return [int(v.strip()) for v in str(s).split(",")]


def _make_aligner(args, debug_sink=None):
    from ..aligner import (
        EndsFree,
        GapAffine,
        GapAffine2Piece,
        Global,
        PoastaAligner,
        parse_heuristic,
    )

    heuristic = parse_heuristic(args.heuristic)
    if heuristic is None:
        raise SystemExit(
            "Invalid heuristic type. Valid options are: dijkstra, mingap, path"
        )

    if args.alignment_span == "global":
        span = Global()
    else:
        span = EndsFree()

    gap_open = _parse_penalties(args.cost_gap_open)
    gap_extend = _parse_penalties(args.cost_gap_extend)
    mismatch = args.cost_mismatch

    if len(gap_open) == 2 and len(gap_extend) == 2:
        if gap_extend[0] <= gap_extend[1]:
            print(
                f"Warning: gap_extend1 ({gap_extend[0]}) should be greater than "
                f"gap_extend2 ({gap_extend[1]}) for two-piece model",
                file=sys.stderr,
            )
            print("Using standard affine gap model instead.", file=sys.stderr)
            costs = GapAffine(mismatch, gap_extend[0], gap_open[0])
        else:
            costs = GapAffine2Piece(
                mismatch, gap_extend[0], gap_open[0], gap_extend[1], gap_open[1]
            )
    elif len(gap_open) == 1 and len(gap_extend) == 1:
        costs = GapAffine(mismatch, gap_extend[0], gap_open[0])
    else:
        raise SystemExit(
            "Gap penalties must both be single values (affine) or both "
            "comma-separated pairs (two-piece affine)"
        )

    return PoastaAligner(costs, span, heuristic=heuristic, debug_sink=debug_sink)


def _emit(graph, output_type: str, out_path):
    from ..io import (
        format_as_dot,
        graph_to_gfa,
        graph_to_gfav1,
        poa_graph_to_fasta,
        save_graph,
    )

    if output_type in ("poasta", "poasta-rs"):
        if output_type == "poasta-rs":
            # Extension over the reference surface: emit the *reference's*
            # bincode layout so graphs built here resume in the Rust binary.
            from ..io.bincode import dump_rust_poasta as save_graph  # noqa: F811
        if out_path is None and sys.stdout.isatty():
            print(
                "WARNING: not writing binary graph data to terminal standard output!",
                file=sys.stderr,
            )
            return
        if out_path is None:
            save_graph(graph, sys.stdout.buffer)
        else:
            with open(out_path, "wb") as fh:
                save_graph(graph, fh)
        return

    buf = io.StringIO()
    if output_type == "fasta":
        poa_graph_to_fasta(graph, buf)
    elif output_type == "gfa":
        graph_to_gfa(graph, buf)
    elif output_type == "gfav1":
        graph_to_gfav1(graph, buf)
    elif output_type == "dot":
        format_as_dot(graph, buf)
    else:
        raise SystemExit(f"unknown output type {output_type}")

    if out_path is None:
        sys.stdout.write(buf.getvalue())
    else:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as fh:
            fh.write(buf.getvalue())


def align_subcommand(args):
    from ..graphs import POAGraph
    from ..io import read_fasta
    from ..utils.debug import DebugOutputWriter

    debug_sink = DebugOutputWriter(args.debug_output) if args.debug_output else None
    aligner = _make_aligner(args, debug_sink=debug_sink)

    graph = _load_any_graph(args.graph) if args.graph else POAGraph()

    # The native engine is byte-identical to the Python engine (same search
    # and backtrace semantics); prefer it for speed when it covers the
    # requested configuration.
    use_native = False
    if args.alignment_span == "global" and debug_sink is None and (
        aligner.heuristic_name in ("mingap", "dijkstra")
    ):
        try:
            from ..native import native_available

            use_native = native_available()
        except Exception:
            use_native = False

    # --engine banded: exact scores via the verify-and-retry banded fill
    # (orders of magnitude faster on long divergent sequences), with
    # co-optimal tiebreaks that may differ from the exact A* engine's.
    use_banded = getattr(args, "engine", "exact") == "banded"
    if use_banded:
        if args.alignment_span != "global" or debug_sink is not None:
            raise SystemExit(
                "--engine banded supports global alignment without "
                "debug output"
            )
        try:
            from ..native import native_available

            if not native_available():
                raise SystemExit("--engine banded requires the native engine")
        except ImportError:
            raise SystemExit("--engine banded requires the native engine")

    # Device assist (banded engine only): while the native engine aligns
    # sequence i, the device scores sequence i+1 against the current
    # graph in a background thread; fusion only adds paths, so the stale
    # score is a valid upper bound that makes the next native fill verify
    # first-try at near-minimal band width.  "auto" takes a seed only
    # when it is ready (else the heuristic seed serves); "on" waits for
    # each one.  A device failure raises.
    records = list(read_fasta(args.sequences))
    assist = None
    assist_mode = getattr(args, "device_assist", "auto")
    if use_banded and assist_mode != "off":
        want = assist_mode == "on"
        if not want:
            import os as _os

            from ..utils import backend

            # the background device work is only free with a spare
            # host core and an accelerator to run it
            want = ((_os.cpu_count() or 1) >= 2
                    and backend.has_accelerator()
                    and any(len(s) >= 8192 for _, s in records))
        if want:
            from ..aligner.fusion_assist import DeviceSeedPrefetcher

            assist = DeviceSeedPrefetcher(aligner.costs)

    last_banded_score = None
    for idx, (name, seq) in enumerate(records):
        weights = [1] * len(seq)
        if debug_sink is not None:
            debug_sink.new_sequence(name, seq, graph)
        if graph.is_empty():
            graph.add_alignment_with_weights(name, seq, None, weights)
        else:
            if use_banded and graph.node_count() > 0:
                from ..native import NativeAligner

                # sequences of one MSA have similar divergence: seeding the
                # band with the previous score (+slack) usually makes the
                # first fill verify, halving per-sequence work; a low seed
                # just triggers the normal verify-and-retry.  A prefetched
                # device score is a true upper bound and beats both.
                # "on" waits for the device seed; "auto" takes it only if
                # it is ready
                ub_dev = (assist.take(seq, wait=assist_mode == "on")
                          if assist is not None else None)
                if assist is not None and idx + 1 < len(records):
                    assist.prefetch(graph, records[idx + 1][1])
                if ub_dev is not None:
                    ub = ub_dev
                elif last_banded_score is not None:
                    ub = int(last_banded_score * 3 / 2) + 64
                else:
                    ub = None
                score, alignment = NativeAligner(graph).align_banded(
                    seq, aligner.costs, ub=ub
                )
                last_banded_score = score
            elif use_native and graph.node_count() > 0:
                from ..native import NativeAligner

                score, alignment, _stats = NativeAligner(graph).align(
                    seq, aligner.costs, heuristic=aligner.heuristic_name
                )
            else:
                result = aligner.align(graph, seq)
                score, alignment = result.score, result.alignment
            print(
                f"DEBUG: Aligned '{name}' (len={len(seq)}) - "
                f"Score: Score({score}), "
                f"Alignment length: {len(alignment)}",
                file=sys.stderr,
            )
            if alignment is not None and not any(
                p.is_aligned() for p in alignment
            ):
                # co-optimal alignments of a completely unrelated sequence
                # can collapse to pure indel runs, which fusion cannot
                # anchor (the reference errors out here; divergence noted
                # in PARITY.md); keep the run alive by fusing the sequence
                # as a fresh unaligned chain.  Checked up front so genuine
                # fusion bugs (malformed pairs) still propagate as errors.
                print(
                    f"WARNING: '{name}' shares no aligned column with the "
                    "graph; fusing it unaligned",
                    file=sys.stderr,
                )
                graph.add_alignment_with_weights(name, seq, None, weights)
            else:
                graph.add_alignment_with_weights(name, seq, alignment, weights)

    if assist is not None:
        assist.close()
        if getattr(args, "verbose", 0):
            print(f"INFO: device-assist seeds used: {assist.seeds_used}",
                  file=sys.stderr)
    _emit(graph, args.output_type or "poasta", args.output)
    if debug_sink is not None:
        debug_sink.close()


def view_subcommand(args):
    from ..io import graph_to_dot

    graph = _load_any_graph(args.graph)
    if args.output_type == "dot":
        # the view subcommand uses the annotated visualization DOT
        buf = io.StringIO()
        graph_to_dot(graph, buf)
        if args.output is None:
            sys.stdout.write(buf.getvalue())
        else:
            with open(args.output, "w") as fh:
                fh.write(buf.getvalue())
        return
    _emit(graph, args.output_type, args.output)


def stats_subcommand(args):
    graph = _load_any_graph(args.graph)
    print(f"node_count: {graph.node_count()}", file=sys.stderr)
    print(
        f"node_count_with_start: {graph.node_count_with_start_and_end()}",
        file=sys.stderr,
    )
    print(f"edge_count: {graph.edge_count()}", file=sys.stderr)
    nodes = list(graph.all_nodes())
    avg_in = sum(graph.in_degree(n) for n in nodes) / len(nodes)
    avg_out = sum(graph.out_degree(n) for n in nodes) / len(nodes)
    print(f"avg_in_degree: {avg_in:.2f}", file=sys.stderr)
    print(f"avg_out_degree: {avg_out:.2f}", file=sys.stderr)


def build_parser():
    p = argparse.ArgumentParser(prog="poasta", description="Fast and exact partial order alignment")
    p.add_argument("-v", "--verbose", action="count", default=0)
    sub = p.add_subparsers(dest="command")

    a = sub.add_parser("align", help="Perform MSA and create or update POA graphs")
    a.add_argument("sequences")
    a.add_argument("-I", "--graph", default=None)
    a.add_argument("-o", "--output", default=None)
    a.add_argument("-O", "--output-type", dest="output_type", default=None,
                   choices=["poasta", "poasta-rs", "fasta", "gfa", "gfav1", "dot"])
    a.add_argument("-d", "--debug-output", dest="debug_output", default=None)
    a.add_argument("-m", "--alignment-span", dest="alignment_span", default="global",
                   choices=["global", "semi-global", "ends-free"])
    a.add_argument("-n", dest="cost_mismatch", type=int, default=4)
    a.add_argument("-g", dest="cost_gap_open", default="6")
    a.add_argument("-e", dest="cost_gap_extend", default="2")
    a.add_argument("-H", "--heuristic", default="mingap")
    a.add_argument("--device-assist", dest="device_assist", default="auto",
                   choices=["auto", "on", "off"],
                   help="with --engine banded: prefetch each sequence's "
                        "score on the accelerator in the background as an "
                        "exact band seed (auto: on for >=8 kb sequences "
                        "on an accelerator backend, used when ready; on: "
                        "wait for every seed)")
    a.add_argument("--engine", default="exact", choices=["exact", "banded"],
                   help="exact: reference-parity A* (default); banded: "
                        "verify-and-retry banded fill — true optimal "
                        "scores, much faster on long divergent sequences; "
                        "co-optimal tiebreaks may differ, and for "
                        "two-piece penalties the A* engine's scores can "
                        "be higher (its 2-piece heuristic reproduces the "
                        "reference's inadmissible quirk)")

    v = sub.add_parser("view", help="Convert POA graphs to various output formats")
    v.add_argument("graph")
    v.add_argument("-o", "--output", default=None)
    v.add_argument("-O", "--output-type", dest="output_type", required=True,
                   choices=["poasta", "poasta-rs", "fasta", "gfa", "gfav1", "dot"])

    s = sub.add_parser("stats", help="Print graph statistics")
    s.add_argument("graph")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    try:
        if args.command == "align":
            align_subcommand(args)
        elif args.command == "view":
            view_subcommand(args)
        elif args.command == "stats":
            stats_subcommand(args)
        else:
            print("No subcommand given.", file=sys.stderr)
            return 1
    except (OSError, ValueError) as exc:
        # user-input errors exit cleanly (the reference prints anyhow's
        # "Error: ..." line, not a backtrace)
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
