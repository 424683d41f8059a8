"""Device seeds for the sequential fusion loop (aligner/fusion_assist.py):
counted when used, and a device failure is raised, not swallowed."""

import random

import pytest

from poasta_tpu.aligner import GapAffine
from poasta_tpu.aligner.fusion_assist import DeviceSeedPrefetcher
from poasta_tpu.graphs import POAGraph

COSTS = GapAffine(4, 2, 6)


def _graph_and_seq():
    rng = random.Random(5)
    base = "".join(rng.choice("ACGT") for _ in range(300))
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * 300)
    seq = (base[:150] + "ACGT" + base[150:]).encode()
    return g, seq


def test_waited_seed_is_exact_and_counted():
    from poasta_tpu.native import NativeAligner

    g, seq = _graph_and_seq()
    pf = DeviceSeedPrefetcher(COSTS)
    assert pf.prefetch(g, seq)
    got = pf.take(seq, wait=True)
    assert got == NativeAligner(g).align(seq, COSTS)[0]
    assert pf.seeds_used == 1
    assert pf.take(seq) is None  # consumed
    pf.close()


def test_stale_seed_is_discarded():
    g, seq = _graph_and_seq()
    pf = DeviceSeedPrefetcher(COSTS)
    pf.prefetch(g, seq)
    pf.close()  # finished, but asked for another sequence
    assert pf.take(seq + b"A", wait=True) is None


def test_device_failure_is_raised(monkeypatch):
    from poasta_tpu.aligner import banded

    def broken(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(banded.BandedScorer, "scores", broken)
    g, seq = _graph_and_seq()
    pf = DeviceSeedPrefetcher(COSTS)
    pf.prefetch(g, seq)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        pf.take(seq, wait=True)
