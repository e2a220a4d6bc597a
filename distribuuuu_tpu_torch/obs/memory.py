"""Train-state byte census and device-memory snapshots (counterpart of ``obs/memory.py``).

- :func:`state_bytes`: what this process holds of parameters, optimizer
  state and BN statistics, and the logical global sums: the ``state_bytes``
  record, the measured half of the fsdp 1/N claim. Each leaf counts its
  elements times its dtype's size, as JAX counts its arrays: the alignment
  gaps of the trainer's flat buffers (``trainer._aligned_offsets``) are not
  state. The flat gradient buffer, which a JAX step does not keep between
  steps, is reported beside them as ``grad_bytes``.
- :func:`activation_bytes`: ``parallel/seq.activation_bytes``, the priced
  1/seq claim.
- :func:`snapshot`: on a card, the caching allocator's counters
  (``torch.cuda.memory_stats``): live blocks and allocated bytes, with
  every byte-valued counter under ``per_device`` (its
  ``allocated_bytes.all.peak`` is the epoch log line's peak memory); on the
  CPU the TrainState's own tensors, ``per_device`` None. Host reads only,
  at epoch boundaries.
"""

from __future__ import annotations

import torch

from distribuuuu_tpu_torch.parallel import fsdp
from distribuuuu_tpu_torch.parallel.seq import activation_bytes  # noqa: F401


def state_bytes(state) -> dict:
    """The ``state_bytes`` record's fields for a ``trainer.TrainState``:
    ``params``/``opt``/``bn`` bytes this process holds and their global
    sums, the fsdp size, the run's devices, and ``grad_bytes``."""
    named = list(state.model.named_parameters())
    c = fsdp.census(named, state.fsdp, state.min_size)  # f32 leaves: 4 bytes an element
    params = c["sharded_bytes"] // state.fsdp + c["replicated_bytes"]
    params_global = c["sharded_bytes"] + c["replicated_bytes"]
    opt = opt_global = 0
    for v in state.optimizer.state_dict().values():
        if v.dim() == 1:  # parameter-shaped: a leaf a parameter, sharded as the parameters
            opt += params // 4 * v.element_size()
            opt_global += params_global // 4 * v.element_size()
        else:
            opt += v.numel() * v.element_size()
            opt_global += v.numel() * v.element_size()
    bn = sum(b.numel() * b.element_size() for b in state.model.buffers())
    grads = [state.grads] + ([state.grad_shard] if state.layout is not None else [])
    return {
        "fsdp": int(state.fsdp),
        "devices": int(state.world),
        "params_bytes": params,
        "opt_bytes": opt,
        "bn_bytes": bn,
        "total_bytes": params + opt + bn,
        "params_global_bytes": params_global,
        "opt_global_bytes": opt_global,
        "bn_global_bytes": bn,
        "grad_bytes": sum(g.numel() * g.element_size() for g in grads),
    }


def snapshot(device, state=None) -> dict:
    """``{live_arrays, live_bytes, per_device}`` of this process: on a card
    the allocator's active blocks and allocated bytes and its byte-valued
    counters under the card's index; elsewhere ``state``'s own tensors
    (its flat buffers and optimizer state), ``per_device`` None."""
    device = torch.device(device)
    if device.type == "cuda":
        stats = torch.cuda.memory_stats(device)
        per = {k: int(v) for k, v in stats.items() if "bytes" in k}
        return {"live_arrays": int(stats.get("active.all.current", 0)),
                "live_bytes": int(stats.get("allocated_bytes.all.current", 0)),
                "per_device": {str(device.index or 0): per}}
    tensors = [] if state is None else _state_tensors(state)
    return {"live_arrays": len(tensors),
            "live_bytes": sum(t.numel() * t.element_size() for t in tensors),
            "per_device": None}


def _state_tensors(state) -> list:
    seen, out = set(), []
    extra = [state.master] + ([state.grad_shard] if state.layout is not None else [])
    for t in [state.params, state.grads, state.stats, *extra,
              *state.optimizer.state_dict().values()]:
        if id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out
