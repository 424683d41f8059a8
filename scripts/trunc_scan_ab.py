"""A/B of the XLA banded body's insertion closure: ``lax.cummin`` over the
whole band against a prefix-min truncated to ``cap`` lanes (log2(cap)
shift+min rounds, cap = the band's longest affordable insertion run
rounded up to a power of two).

The truncated scan was the body's other mode until measurement removed
it; this script rebuilds it by tracing the same body with
``jax.lax.cummin`` replaced, so the comparison runs on the current tree.
Uniform config (bench.py / chip_smoke.py): ~6.2k-node graph, 1,024 reads
of ~5 kb, first-tier band at the 16-read sample's largest exact score.
Turns alternate cummin, truncated, truncated, cummin, twice.

    python scripts/trunc_scan_ab.py
"""

import os
import shutil
import statistics
import subprocess
import sys
import time
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from poasta_tpu.aligner import GapAffine  # noqa: E402
from poasta_tpu.aligner import banded as bd  # noqa: E402
from poasta_tpu.aligner.wavefront import DeviceGraph, pack_queries  # noqa: E402
from poasta_tpu.native import NativeAligner  # noqa: E402
from poasta_tpu.ops import banded_fill as bf  # noqa: E402
from poasta_tpu.ops.dp_rows import INF  # noqa: E402
from poasta_tpu.utils.compile_cache import enable_persistent_cache  # noqa: E402


def truncated_cummin(cap):
    """Prefix-min along axis 1 over the last ``cap`` lanes only."""
    def fn(x, axis=1):
        assert axis == 1
        k = 1
        while k < cap:
            pad = jnp.full(x.shape[:1] + (k,), INF, x.dtype)
            x = jnp.minimum(x, jnp.concatenate([pad, x[:, :-k]], axis=1))
            k *= 2
        return x
    return fn


def main():
    enable_persistent_cache()
    card = "n/a"
    if shutil.which("nvidia-smi"):
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    print(f"card: {card} device: {jax.devices()[0]}", flush=True)
    costs = GapAffine(*cs.COSTS_ARGS)
    graph, reads = cs.uniform_inputs(costs)
    flat = graph.flatten()
    dg = DeviceGraph.build(flat)
    qshift, lengths = pack_queries(reads)
    na = NativeAligner(graph)
    ub = max(na.align(reads[i], costs)[0] for i in range(16))
    ln = np.asarray(lengths)
    ws, width, _, _ = bd.band_windows(flat, int(ln.min()), int(ln.max()),
                                      costs, ub)
    tables = bf.prepare_banded(dg, ws, width)
    req = bd._round_up(int(ws.max()) + width, 128)
    q_in = qshift if req <= qshift.shape[1] else jnp.concatenate(
        [qshift, jnp.zeros((qshift.shape[0], req - qshift.shape[1]),
                           qshift.dtype)], axis=1)
    run = max((ub - costs.gap_open) // costs.gap_extend, 1)
    cap = min(1 << (run - 1).bit_length(), width)
    print(f"ub={ub} Wb={width} cap={cap}", flush=True)

    P = int(dg.pred_slots.shape[1])
    args = (dg.symbols, dg.pred_slots, tables.pred_valid,
            tables.pred_wstarts, tables.wstarts, dg.write_slots, dg.end_rank,
            tables.wstarts, tables.wstarts, q_in, lengths, lengths,
            jnp.int32(0), jnp.int32(0))
    fns = {}
    for name in ("cummin", "truncated"):
        body = bf.xla_banded_exec.__wrapped__(
            dg.window, width, P, costs.gap_open, costs.gap_extend,
            costs.mismatch)
        if name == "truncated":
            with mock.patch.object(jax.lax, "cummin", truncated_cummin(cap)):
                out = np.asarray(body(*args))  # traces with the patch
        else:
            out = np.asarray(body(*args))
        fns[name] = (body, out)
    a, b = fns["cummin"][1], fns["truncated"][1]
    print(f"scores differ on {int((a != b).sum())} of {len(a)} reads",
          flush=True)
    times = {"cummin": [], "truncated": []}
    for name in ("cummin", "truncated", "truncated", "cummin") * 2:
        t0 = time.perf_counter()
        jax.block_until_ready(fns[name][0](*args))
        times[name].append(time.perf_counter() - t0)
    for name, ts in times.items():
        print(f"{name}: median {statistics.median(ts):.4f}s spread "
              f"{min(ts):.4f}-{max(ts):.4f}", flush=True)


if __name__ == "__main__":
    main()
