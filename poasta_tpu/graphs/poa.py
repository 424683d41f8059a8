"""Host-side partial-order alignment (POA) graph.

This is the mutable, host-resident representation of the growing MSA graph.
It intentionally reproduces the *observable semantics* of the reference
implementation's graph layer (reference: ``src/graphs/poa.rs``), because the
framework promises byte-identical FASTA-MSA/GFA/DOT outputs:

* Node indices are assigned in creation order; the virtual start node ``#``
  is index 0 and the virtual end node ``$`` is index 1
  (reference: ``src/graphs/poa.rs:100-112``).
* Adjacency iteration returns neighbors in *reverse edge-insertion order*
  (the behaviour of petgraph's adjacency linked lists, on which the
  reference is built); many emitters and the aligner backtrace depend on
  this order.
* Edge storage slots are reused LIFO after removal (petgraph
  ``StableDiGraph`` free-list behaviour); GFA L-line emission iterates edges
  in slot order (reference: ``src/io/graph.rs:318-324``).
* ``post_process`` rewires the virtual start/end nodes and recomputes the
  topological order after every fused sequence
  (reference: ``src/graphs/poa.rs:323-363``).
* The topological sort replicates the iterative DFS finish-order algorithm
  used by the reference's graph library so node *ranks* (used by the
  aligner's visited storage and debug dumps) are identical.

Device-side consumption goes through :meth:`POAGraph.flatten`, which lowers
the graph to flat SoA arrays (symbols, topo ranks, CSR adjacency) — the form
the device wavefront fills operate on.  The mutable graph itself never leaves
the host; after each fusion step only the flat arrays are re-uploaded.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence as Seq, Tuple

from ..utils.errors import PoastaError

START_SYMBOL = ord("#")
END_SYMBOL = ord("$")


@dataclass
class _Edge:
    source: int
    target: int
    weight: int
    sequence_ids: List[int]


@dataclass
class SequenceInfo:
    """A sequence aligned to the POA graph: name + its first node."""

    name: str
    start_node: int


class POAGraph:
    """Mutable POA DAG with deterministic, reference-compatible ordering."""

    def __init__(self) -> None:
        self.symbols: List[int] = []
        self.aligned_nodes: List[List[int]] = []
        # Edge slots; ``None`` marks a vacant (removed) slot.
        self._edges: List[Optional[_Edge]] = []
        self._free_edges: List[int] = []  # LIFO stack of vacant slots
        # Per-node adjacency in *insertion order*; iteration reverses.
        self._out: List[List[int]] = []
        self._in: List[List[int]] = []
        self.sequences: List[SequenceInfo] = []
        self.topological_sorted: List[int] = []

        self.start_node = self.add_node(START_SYMBOL)
        self.end_node = self.add_node(END_SYMBOL)

    # ------------------------------------------------------------------
    # Basic structure
    # ------------------------------------------------------------------
    def add_node(self, symbol: int) -> int:
        ix = len(self.symbols)
        self.symbols.append(symbol)
        self.aligned_nodes.append([])
        self._out.append([])
        self._in.append([])
        return ix

    def find_edge(self, s: int, t: int) -> Optional[int]:
        # Newest-first scan, mirroring adjacency-list walk order.
        for eid in reversed(self._out[s]):
            if self._edges[eid].target == t:
                return eid
        return None

    def _new_edge_slot(self, edge: _Edge) -> int:
        if self._free_edges:
            eid = self._free_edges.pop()
            self._edges[eid] = edge
        else:
            eid = len(self._edges)
            self._edges.append(edge)
        return eid

    def add_edge(self, s: int, t: int, sequence_id: int, weight: int) -> None:
        """Add or update an edge (reference: ``src/graphs/poa.rs:118-134``)."""
        eid = self.find_edge(s, t)
        if eid is not None:
            e = self._edges[eid]
            e.sequence_ids.append(sequence_id)
            e.weight += weight
        else:
            eid = self._new_edge_slot(_Edge(s, t, weight, [sequence_id]))
            self._out[s].append(eid)
            self._in[t].append(eid)

    def _add_plain_edge(self, s: int, t: int) -> None:
        """Start/end rewiring edges carry no weight or sequence ids."""
        eid = self._new_edge_slot(_Edge(s, t, 0, []))
        self._out[s].append(eid)
        self._in[t].append(eid)

    def remove_edge(self, eid: int) -> None:
        e = self._edges[eid]
        self._out[e.source].remove(eid)
        self._in[e.target].remove(eid)
        self._edges[eid] = None
        self._free_edges.append(eid)

    # -- iteration ------------------------------------------------------
    def successors(self, n: int) -> Iterator[int]:
        for eid in reversed(self._out[n]):
            yield self._edges[eid].target

    def predecessors(self, n: int) -> Iterator[int]:
        for eid in reversed(self._in[n]):
            yield self._edges[eid].source

    def predecessors_oldest_first(self, n: int) -> Iterator[int]:
        """Predecessors in edge-insertion order (used by the backtrace's
        candidate scan; this order reproduces the published truth MSAs)."""
        for eid in self._in[n]:
            yield self._edges[eid].source

    def out_edges(self, n: int) -> Iterator[_Edge]:
        """Outgoing edges, *slot index order* (ascending edge id)."""
        for eid in sorted(self._out[n]):
            yield self._edges[eid]

    def out_edges_newest_first(self, n: int) -> Iterator[_Edge]:
        for eid in reversed(self._out[n]):
            yield self._edges[eid]

    def edge_references(self) -> Iterator[_Edge]:
        """All live edges in slot order (GFA/DOT emission order)."""
        for e in self._edges:
            if e is not None:
                yield e

    def all_nodes(self) -> Iterator[int]:
        return iter(range(len(self.symbols)))

    def in_degree(self, n: int) -> int:
        return len(self._in[n])

    def out_degree(self, n: int) -> int:
        return len(self._out[n])

    def node_count(self) -> int:
        """Number of *real* nodes (excluding virtual start/end)."""
        return len(self.symbols) - 2

    def node_count_with_start_and_end(self) -> int:
        return len(self.symbols)

    def edge_count(self) -> int:
        """Number of edges excluding virtual start/end wiring."""
        total = sum(1 for e in self._edges if e is not None)
        return total - self.out_degree(self.start_node) - self.in_degree(self.end_node)

    def is_empty(self) -> bool:
        return self.node_count() == 0

    def get_symbol(self, n: int) -> int:
        return self.symbols[n]

    def get_symbol_char(self, n: int) -> str:
        return chr(self.symbols[n])

    def is_symbol_equal(self, n: int, symbol: int) -> bool:
        """End node matches every symbol (reference: ``poa.rs:462-465``)."""
        return n == self.end_node or self.symbols[n] == symbol

    def get_aligned_nodes(self, n: int) -> List[int]:
        return self.aligned_nodes[n]

    # ------------------------------------------------------------------
    # Sequence fusion
    # ------------------------------------------------------------------
    def add_nodes_for_sequence(
        self, sequence: bytes, weights: Seq[int], start: int, end: int
    ) -> Optional[Tuple[int, int]]:
        """Append a chain of nodes for ``sequence[start:end]``.

        Reference: ``src/graphs/poa.rs:136-169``.
        """
        if start == end:
            return None

        first_node = None
        prev = None
        for pos in range(start, end):
            curr = self.add_node(sequence[pos])
            if first_node is None:
                first_node = curr
            if prev is not None:
                self.add_edge(prev, curr, len(self.sequences), weights[pos - 1] + weights[pos])
            prev = curr
        return (first_node, prev)

    def add_alignment_with_weights(
        self,
        sequence_name: str,
        sequence: bytes,
        alignment: Optional[List["AlignedPair"]],
        weights: Seq[int],
    ) -> None:
        """Fuse a new sequence into the graph along its alignment.

        Matched symbols reuse graph nodes, mismatches extend the
        ``aligned_nodes`` clique of their aligned column, insertions create
        fresh node chains.  Reference: ``src/graphs/poa.rs:171-321``.
        """
        if len(sequence) != len(weights):
            raise PoastaError(
                f"sequence length {len(sequence)} != weights length {len(weights)}"
            )

        if alignment is None:
            if len(sequence) == 0:
                self.sequences.append(SequenceInfo(sequence_name, self.start_node))
                self.post_process()
                return
            nfirst, _ = self.add_nodes_for_sequence(sequence, weights, 0, len(sequence))
            self.sequences.append(SequenceInfo(sequence_name, nfirst))
            self.post_process()
            return

        valid_ix = [p.qpos for p in alignment if p.qpos is not None and p.qpos < len(sequence)]
        if not valid_ix:
            if len(sequence) == 0:
                self.sequences.append(SequenceInfo(sequence_name, self.start_node))
                self.post_process()
                return
            raise PoastaError(f"invalid alignment for sequence {sequence_name!r}")

        first, last = valid_ix[0], valid_ix[-1]

        nodes_unaligned_begin = self.add_nodes_for_sequence(sequence, weights, 0, first)
        prev = nodes_unaligned_begin[1] if nodes_unaligned_begin is not None else None
        nodes_unaligned_end = self.add_nodes_for_sequence(
            sequence, weights, last + 1, len(sequence)
        )

        for pair in alignment:
            if pair.qpos is None or pair.qpos >= len(sequence):
                # valid_ix above already tolerates out-of-range qpos from
                # external alignments; the fusion loop must skip them too
                continue
            q = pair.qpos
            qsymbol = sequence[q]
            curr: Optional[int] = None

            if pair.rpos is not None:
                r = pair.rpos
                if self.symbols[r] == qsymbol:
                    curr = r
                else:
                    for other_ix in self.aligned_nodes[r]:
                        if self.symbols[other_ix] == qsymbol:
                            curr = other_ix
                            break
                    if curr is None:
                        new_node = self.add_node(qsymbol)
                        curr = new_node
                        for other_ix in list(self.aligned_nodes[r]):
                            self.aligned_nodes[other_ix].append(new_node)
                            self.aligned_nodes[new_node].append(other_ix)
                        self.aligned_nodes[r].append(new_node)
                        self.aligned_nodes[new_node].append(r)
            else:
                curr = self.add_node(qsymbol)

            if nodes_unaligned_begin is None:
                nodes_unaligned_begin = (curr, curr)

            if prev is not None:
                self.add_edge(prev, curr, len(self.sequences), weights[q - 1] + weights[q])
            prev = curr

        if nodes_unaligned_end is not None:
            self.add_edge(
                prev,
                nodes_unaligned_end[0],
                len(self.sequences),
                weights[last] + weights[last + 1],
            )

        self.sequences.append(SequenceInfo(sequence_name, nodes_unaligned_begin[0]))
        self.post_process()

    def post_process(self) -> None:
        """Rewire virtual start/end nodes and recompute the topo order.

        Reference: ``src/graphs/poa.rs:323-363``.
        """
        self.topological_sorted = []

        # Strip all current start/end wiring (newest-first, matching the
        # reference's repeated `edges(..).next()` removal loop).
        while self._out[self.start_node]:
            self.remove_edge(self._out[self.start_node][-1])
        while self._in[self.end_node]:
            self.remove_edge(self._in[self.end_node][-1])

        for node in range(len(self.symbols)):
            if node not in (self.start_node, self.end_node) and not self._in[node]:
                self._add_plain_edge(self.start_node, node)
        for node in range(len(self.symbols)):
            if node not in (self.start_node, self.end_node) and not self._out[node]:
                self._add_plain_edge(node, self.end_node)

        self.topological_sorted = self._toposort()

    def _toposort(self) -> List[int]:
        """Topological order via iterative DFS finish order.

        Replicates the graph library algorithm the reference relies on
        (DFS roots in node-index order, neighbor pushes in newest-edge-first
        order, reversed finish stack) so that node ranks match exactly.
        """
        n = len(self.symbols)
        discovered = [False] * n
        finished = [False] * n
        finish_stack: List[int] = []
        stack: List[int] = []

        for i in range(n):
            if discovered[i]:
                continue
            stack.append(i)
            while stack:
                nx = stack[-1]
                if not discovered[nx]:
                    discovered[nx] = True
                    for eid in reversed(self._out[nx]):
                        succ = self._edges[eid].target
                        if succ == nx:
                            raise PoastaError("graph contains a self-cycle")
                        if not discovered[succ]:
                            stack.append(succ)
                else:
                    stack.pop()
                    if not finished[nx]:
                        finished[nx] = True
                        finish_stack.append(nx)

        finish_stack.reverse()
        order = {node: i for i, node in enumerate(finish_stack)}
        for e in self._edges:
            if e is not None and order[e.source] > order[e.target]:
                raise PoastaError("graph contains a cycle")
        return finish_stack

    def get_node_ranks(self) -> List[int]:
        ranks = [0] * len(self.topological_sorted)
        for rank, node in enumerate(self.topological_sorted):
            ranks[node] = rank
        return ranks

    # ------------------------------------------------------------------
    # Device lowering
    # ------------------------------------------------------------------
    def flatten(self) -> "FlatGraph":
        from .flat import FlatGraph

        return FlatGraph.from_poa_graph(self)


# Deferred import target for type checkers; AlignedPair lives in the aligner
# layer but fusion consumes it.
from ..aligner.alignment import AlignedPair  # noqa: E402  (cycle-free at runtime)
