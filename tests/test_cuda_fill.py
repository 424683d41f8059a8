"""The CUDA banded fill on the card against the XLA body on the same
prepared tables (``pytest -m gpu tests/``; skips without a GPU)."""

import random

import numpy as np
import pytest

from poasta_tpu.aligner import GapAffine
from poasta_tpu.aligner.costs import EndsFree, UNBOUNDED, included
from poasta_tpu.aligner.wavefront import (
    DeviceGraph,
    ends_free_device_params,
    pack_queries,
)

COSTS = GapAffine(4, 2, 6)


@pytest.mark.gpu
@pytest.mark.parametrize("drift,span", [(False, None), (False, "semi"),
                                        (True, None), (True, "bounded")])
def test_cuda_equals_xla_body(gpu, drift, span):
    from test_banded_executors import _layout, _mutate, _sv_graph

    from poasta_tpu.ops.banded_fill import banded_scores

    rng = random.Random(3)
    g, base, variant = _sv_graph(rng, COSTS, glen=1500, cut=200)
    flat = g.flatten()
    dg = DeviceGraph.build(flat)
    reads = [_mutate(rng, base if i % 2 else variant, 0.03).encode()
             for i in range(37)]
    qshift, lengths = pack_queries(reads)
    aln = {None: None,
           "semi": EndsFree(UNBOUNDED, included(0), UNBOUNDED, UNBOUNDED),
           "bounded": EndsFree(("unbounded", None), included(50),
                               included(0), included(50))}[span]
    tables, q_in, kw = _layout(flat, dg, qshift, lengths, COSTS, 300,
                               drift, aln)
    ends = None if aln is None else ends_free_device_params(
        flat, aln, lengths, dg.n_nodes_padded)
    got = np.asarray(banded_scores("cuda", dg, tables, q_in, lengths,
                                   COSTS, ends=ends, **kw))
    ref = np.asarray(banded_scores("xla", dg, tables, q_in, lengths,
                                   COSTS, ends=ends, **kw))
    assert (got == ref).all()
