"""Parallelism of the port beyond data parallelism, over ``torch.distributed`` groups.

The JAX package's ``parallel/`` (its ``__init__`` exports the same names):

- ``collectives``: :func:`scaled_all_reduce`, :func:`pmean_tree` (means
  over a group) and :func:`barrier`;
- ``tensor``: the class-parallel head, :func:`column_parallel_logits` and
  the vocab-parallel :func:`tp_cross_entropy`, over a ``model`` group;
- ``pipeline``: the GPipe schedule, :func:`pipeline_apply`, over a
  ``stage`` group;
- ``moe``: switch-style top-1 mixture-of-experts, :func:`switch_moe`, over
  an ``expert`` group, on the hand-written dispatch and combine kernels;
- ``fsdp``: parameter and optimizer-state sharding over an ``fsdp`` group
  (the trainer's ``MESH.FSDP``);
- ``seq``: the ``seq`` axis of training (``MESH.SEQ``), with
  :func:`ring_attention` and :func:`ulysses_attention`.

:func:`distribuuuu_tpu_torch.runtime.mesh.create_mesh` lays named axes
over the processes and gives each axis's group.
"""

from distribuuuu_tpu_torch.parallel import fsdp, seq
from distribuuuu_tpu_torch.parallel.collectives import barrier, pmean_tree, scaled_all_reduce
from distribuuuu_tpu_torch.parallel.moe import switch_moe, token_slot_positions
from distribuuuu_tpu_torch.parallel.pipeline import pipeline_apply
from distribuuuu_tpu_torch.parallel.ring_attention import ring_attention
from distribuuuu_tpu_torch.parallel.tensor import column_parallel_logits, tp_cross_entropy
from distribuuuu_tpu_torch.parallel.ulysses import ulysses_attention

__all__ = [
    "fsdp",
    "seq",
    "barrier",
    "pmean_tree",
    "scaled_all_reduce",
    "pipeline_apply",
    "switch_moe",
    "token_slot_positions",
    "ring_attention",
    "ulysses_attention",
    "column_parallel_logits",
    "tp_cross_entropy",
]
