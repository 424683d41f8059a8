"""Big-batch pangenome serving: the lasagna-realistic shape (B=512)
where fixed per-call costs amortize and locus-sorted blocks tighten.
Also exercises the pipelined (prescore-overlapped) serving loop."""
import os, sys, time
sys.path.insert(0, ".")
from poasta_tpu.utils.compile_cache import enable_persistent_cache
enable_persistent_cache()
import random
from poasta_tpu.aligner import GapAffine
from poasta_tpu.aligner.costs import EndsFree, UNBOUNDED, included
from poasta_tpu.parallel import BatchMapper

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from pangenome_common import load  # noqa: E402
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from bench import _mutate  # noqa: E402

costs = GapAffine(4, 2, 6)
gp, _ = load()
rng = random.Random(29)
N = 50_000
# fresh reads off the SAME base the fixture used (seed 17 first): rebuild base
rng17 = random.Random(17)
pbase = "".join(rng17.choice("ACGT") for _ in range(N))
B = int(os.environ.get("BB", "512"))
reads = []
for _ in range(B):
    a = rng.randrange(0, N - 5000)
    reads.append(_mutate(rng, pbase[a:a + 5000], 0.015).encode())
cfgp = EndsFree(UNBOUNDED, included(0), UNBOUNDED, UNBOUNDED)
m = BatchMapper(gp, costs, aln_type=cfgp)
m.align_batch(reads)  # warm 1: learn ub
m.align_batch(reads)  # warm 2
for it in range(3):
    t0 = time.perf_counter()
    out = m.align_batch(reads)
    el = time.perf_counter() - t0
    st = dict(m.last_ends_free_stats)
    print(f"iter{it} B={B} el={el:.3f} r/s={B/el:.1f} {st}", flush=True)

# pipelined serving over 4 sub-batches (prescore overlap)
from concurrent.futures import ThreadPoolExecutor

batches = [reads[i:i + B // 4] for i in range(0, B, B // 4)]
for b in batches:
    m.align_batch(b)  # warm shapes
t0 = time.perf_counter()
with ThreadPoolExecutor(max_workers=1) as scorer:
    fut = scorer.submit(m.prescore, batches[0])
    for k in range(len(batches)):
        pre = fut.result()
        if k + 1 < len(batches):
            fut = scorer.submit(m.prescore, batches[k + 1])
        m.align_batch(batches[k], prescored=pre)
el = time.perf_counter() - t0
print(f"pipelined 4x{B//4}: el={el:.3f} r/s={B/el:.1f}", flush=True)
