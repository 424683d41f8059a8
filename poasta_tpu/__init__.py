"""poasta_tpu — a partial-order alignment framework for NVIDIA GPUs.

Capabilities mirror ``pangenome/poasta`` (fast, optimal gap-affine
sequence-to-graph and partial-order alignment); the architecture is
accelerator-first: JAX/XLA wavefront fills plus a CUDA banded kernel,
``jax.sharding``/``shard_map`` data parallelism for read mapping at scale,
and a host-side graph/IO substrate that preserves byte-identical output
formats (FASTA-MSA, GFA v1/v1.1, DOT, GAF).
"""

__version__ = "0.1.0"

from . import aligner, bubbles, graphs, io  # noqa: F401
