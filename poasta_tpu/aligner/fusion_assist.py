"""Async device assistance for the sequential graph-fusion loop.

``poasta align`` fuses sequences one at a time; each alignment depends on
the graph produced by the previous fusion, so the loop cannot batch onto
the accelerator.  What CAN overlap: while the host's native engine aligns
sequence *i*, the device scores sequence *i+1* against the CURRENT graph
in a background thread.  Fusion only adds nodes and edges — every
alignment that existed before still exists — so the optimal score against
the pre-fusion graph is a valid UPPER BOUND for the post-fusion graph,
and seeding the native banded fill with it makes the first fill verify at
a near-minimal band width (reference analogue: the work-proportional-to-
score property of the A*'s bucket queue, ``src/aligner/astar.rs``).

By default ``take()`` polls and never blocks — if the device result isn't
ready (e.g. a cold compile), the caller falls back to its heuristic seed
and the late result is discarded; ``take(wait=True)`` blocks for it.
Correctness is untouched either way: the seed only changes band width,
and the native verify-and-retry certifies exactness (a backtrace within
any certified band visits only optimal-path cells, so the emitted
alignment is ub-independent).  A device failure is not hidden: ``take``
re-raises it.
"""

from __future__ import annotations

import threading
from typing import Optional


class DeviceSeedPrefetcher:
    """Background device scoring of the next sequence to fuse."""

    def __init__(self, costs) -> None:
        self.costs = costs
        self._thread: Optional[threading.Thread] = None
        self._result: Optional[int] = None
        self._done = threading.Event()
        self._error: Optional[BaseException] = None
        self._last_score: Optional[int] = None
        self._seq: Optional[bytes] = None  # request identity for take()
        self.seeds_used = 0  # device seeds handed to the caller

    def prefetch(self, graph, seq: bytes) -> bool:
        """Start scoring ``seq`` against a snapshot of ``graph``.

        The flatten runs synchronously (the caller mutates the graph
        later); device lowering + scoring run in a background thread.
        Returns False (and does nothing) if a previous prefetch is still
        running — threads never stack up.
        """
        if self._thread is not None and self._thread.is_alive():
            return False
        flat = graph.flatten()
        self._done.clear()
        self._result = None
        self._error = None
        self._seq = seq
        hint = self._last_score

        def work():
            try:
                import numpy as np

                from .banded import BandedScorer
                from .wavefront import DeviceGraph, pack_queries

                dg = DeviceGraph.build(flat)
                scorer = BandedScorer(flat, self.costs, dg=dg)
                qshift, lengths = pack_queries([seq])
                ub = None if hint is None else hint * 5 // 4 + 32
                score = int(np.asarray(scorer.scores(qshift, lengths,
                                                     ub=ub))[0])
                self._result = score
            except BaseException as exc:  # re-raised by take()
                self._error = exc
            finally:
                self._done.set()

        # non-daemon + close(): a daemon thread killed inside an XLA call
        # at interpreter exit aborts the process (observed: "FATAL:
        # exception not rethrown")
        self._thread = threading.Thread(target=work, daemon=False)
        self._thread.start()
        return True

    def close(self) -> None:
        """Wait for any in-flight prefetch (device calls always finish;
        tearing the interpreter down under one aborts the process)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def take(self, seq: Optional[bytes] = None,
             wait: bool = False) -> Optional[int]:
        """The prefetched score if it is ready AND was computed for
        ``seq``, else None; ``wait`` blocks until it is ready.  Without
        identity checking, a late result from a skipped prefetch could
        seed the band of a *different* sequence with an unrelated bound.
        Raises the device's exception if the prefetch failed."""
        if self._thread is None:
            return None
        if wait:
            self._thread.join()
        if not self._done.is_set():
            return None
        if seq is not None and self._seq is not seq:
            return None  # stale result for another sequence: discard
        self._thread = None
        if self._error is not None:
            raise self._error
        if self._result is not None:
            self._last_score = self._result
            self.seeds_used += 1
        return self._result
