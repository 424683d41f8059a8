"""Debug output sink: per-alignment DP-state dumps + intermediate graphs.

Mirrors the reference's debug subsystem (``src/debug.rs``): for each
aligned sequence it writes ``graph_for_<seq>.dot`` and an
``astar_iterations/<seq>.iter0.tsv`` dump of the visited score table with
the same TSV schema (``node_id\toffset\tmatrix\tscore``;
``gap_affine.rs:659-698``), so the contrib visualization tooling
(``poasta_plot.py``) keeps working unchanged.
"""

from __future__ import annotations

import io
import os

from ..aligner.costs import AlignState

_MATRIX_NAMES = {
    AlignState.MATCH: "match",
    AlignState.INSERTION: "insertion",
    AlignState.DELETION: "deletion",
    AlignState.INSERTION2: "insertion2",
    AlignState.DELETION2: "deletion2",
}


class DebugOutputWriter:
    def __init__(self, directory: str) -> None:
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        os.makedirs(os.path.join(directory, "astar_iterations"), exist_ok=True)
        self.curr_seq = "none"
        self.curr_seq_str = ""
        self.curr_max_rank = 0

    def new_sequence(self, name: str, sequence: bytes, graph) -> None:
        self.curr_seq = name
        self.curr_seq_str = sequence.decode("ascii", "replace")
        self.curr_max_rank = graph.node_count_with_start_and_end()
        if not graph.is_empty():
            from ..io import format_as_dot

            buf = io.StringIO()
            format_as_dot(graph, buf)
            path = os.path.join(self.directory, f"graph_for_{name}.dot")
            with open(path, "w") as fh:
                fh.write(buf.getvalue())

    def log_astar_data(self, visited, graph) -> None:
        """Dump the visited score table as TSV (reference schema)."""
        path = os.path.join(
            self.directory, "astar_iterations", f"{self.curr_seq}.iter0.tsv"
        )
        two_piece = visited.costs.is_two_piece
        states = (
            (AlignState.MATCH, AlignState.INSERTION, AlignState.DELETION)
            if not two_piece
            else tuple(AlignState)
        )
        with open(path, "w") as fh:
            # header comment line matches the reference byte-for-byte
            # (``debug.rs:103``)
            fh.write(
                f"# seq_name: {self.curr_seq} - seq: {self.curr_seq_str}"
                f" - max_rank: {self.curr_max_rank}\n"
            )
            fh.write("node_id\toffset\tmatrix\tscore\n")
            for (node, offset), cell in sorted(visited.scores.items()):
                for st in states:
                    if cell[st] is not None:
                        name = _MATRIX_NAMES[st]
                        if two_piece and st in (AlignState.INSERTION, AlignState.DELETION):
                            name += "1"
                        fh.write(f"{node}\t{offset}\t{name}\t{cell[st]}\n")

    def close(self) -> None:
        pass


def dump_wavefront_tsv(flat, M, I, D, path) -> None:
    """Write the device wavefront fill's dense score tables as debug TSV.

    Same schema as the exact engine's dumps (``node_id/offset/matrix/
    score``; reference ``gap_affine.rs:659-698``), so ``tools/plot_dp``
    and the reference's contrib plot script both render them.  ``M/I/D``
    are (n_ranks, L) tables for ONE read (e.g. a slice of
    ``dp_fill_full``'s output); INF-sentinel cells are skipped.
    """
    import numpy as np

    INF_CUT = 1 << 27
    # tables may carry bucket-padded ranks beyond the real node count
    n = min(M.shape[0], flat.n_nodes)
    nodes = np.asarray(flat.node_of_rank[:n])
    names = ("match", "insertion", "deletion")
    # stack to (3, n, L) and find finite cells in one vectorized pass;
    # emit rank-major, offset-next, matrix-last — the same row order the
    # old per-cell loop produced
    stacked = np.stack([np.asarray(M[:n]), np.asarray(I[:n]),
                        np.asarray(D[:n])])
    mats, rs, js = np.nonzero(stacked < INF_CUT)
    order = np.lexsort((mats, js, rs))
    vals = stacked[mats, rs, js]
    with open(path, "w") as fh:
        fh.write("node_id\toffset\tmatrix\tscore\n")
        for k in order:
            fh.write(f"{int(nodes[rs[k]])}\t{int(js[k])}\t"
                     f"{names[mats[k]]}\t{int(vals[k])}\n")
