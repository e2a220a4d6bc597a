"""Optimizers and epoch-granular learning rates (the port's ``optim.py``).

- LR schedules, term for term as the JAX package's: cosine ``(1 - MIN_LR) *
  0.5 * (1 + cos(pi * e / MAX_EPOCH)) + MIN_LR`` or steps ``LR_MULT ** i``,
  times BASE_LR, with the linear warmup factor ``WARMUP_FACTOR * (1 - a) +
  a``, ``a = e / WARMUP_EPOCHS``; one value per epoch.
- :class:`SGD`, as the JAX chain ``add_decayed_weights`` -> ``sgd_momentum``:
  ``g = grad + wd * p`` on every parameter (BN included); the momentum
  buffer is seeded with the raw first ``g`` (a step counter says which step
  is the first), then ``buf = m * buf + (1 - dampening) * g``; the update is
  ``g + m * buf`` under nesterov, else ``buf``; ``p <- p - lr * u``.
- :class:`LAMB`, as ``construct_optimizer`` builds it: Adam moments with
  bias correction, weight decay on parameters of more than one dimension,
  and optax's trust ratio ``|p| / |u|`` per parameter (1 where either norm
  is 0), the norms accumulated in float64 (as accurate as XLA's pairwise
  sums; an f32 running sum over millions of elements is not). On fsdp shards (``sharded`` segments and the fsdp ``group``) the
  norms of a sharded parameter are global, as JAX's
  ``_scale_by_trust_ratio_fsdp``: the shards' squared norms summed over the
  group in one all-reduce, then the square root.

Both work on the flat float32 buffers the trainer keeps (every parameter a
view into one tensor, or one fsdp rank's shard buffer), in place, with
their state in plain tensors; ``keep`` (a 0-d bool tensor, the non-finite
guard) leaves parameters and state as they were, bitwise, without a host
sync. SGD is elementwise, so it runs on a shard unchanged.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from distribuuuu_tpu_torch.config import cfg


def lr_fun_steps(cur_epoch: int) -> float:
    """Steps schedule (OPTIM.LR_POLICY 'steps')."""
    ind = [i for i, s in enumerate(cfg.OPTIM.STEPS) if cur_epoch >= s][-1]
    return cfg.OPTIM.LR_MULT**ind


def lr_fun_cos(cur_epoch: int) -> float:
    """Half-period cosine schedule (OPTIM.LR_POLICY 'cos')."""
    lr = 0.5 * (1.0 + np.cos(np.pi * cur_epoch / cfg.OPTIM.MAX_EPOCH))
    return (1.0 - cfg.OPTIM.MIN_LR) * lr + cfg.OPTIM.MIN_LR


_LR_POLICIES = {"steps": lr_fun_steps, "cos": lr_fun_cos}


def get_epoch_lr(cur_epoch: int) -> float:
    """The LR of an epoch: policy x BASE_LR, with the linear warmup."""
    try:
        lr_fun = _LR_POLICIES[cfg.OPTIM.LR_POLICY]
    except KeyError:
        raise ValueError(f"Unknown LR policy: {cfg.OPTIM.LR_POLICY}") from None
    lr = lr_fun(cur_epoch) * cfg.OPTIM.BASE_LR
    if cur_epoch < cfg.OPTIM.WARMUP_EPOCHS:
        alpha = cur_epoch / cfg.OPTIM.WARMUP_EPOCHS
        lr *= cfg.OPTIM.WARMUP_FACTOR * (1.0 - alpha) + alpha
    return float(lr)


def _commit(dst: torch.Tensor, new: torch.Tensor, keep) -> None:
    dst.copy_(new if keep is None else torch.where(keep, new, dst))


class SGD:
    """Torch-semantics SGD with momentum over a flat parameter buffer."""

    def __init__(self, params: torch.Tensor, *, momentum: float, dampening: float,
                 nesterov: bool, weight_decay: float):
        self.momentum, self.dampening = momentum, dampening
        self.nesterov, self.weight_decay = nesterov, weight_decay
        self.state = {"momentum": torch.zeros_like(params),
                      "step": torch.zeros((), dtype=torch.int32, device=params.device)}

    def step(self, params: torch.Tensor, grads: torch.Tensor, lr: float, keep=None) -> None:
        """One update of ``params`` in place from ``grads`` (flat, f32)."""
        st = self.state
        m = self.momentum
        g = grads + self.weight_decay * params
        buf = torch.where(st["step"] == 0, g, m * st["momentum"] + (1.0 - self.dampening) * g)
        u = g + m * buf if self.nesterov else buf
        _commit(params, params - lr * u, keep)
        _commit(st["momentum"], buf, keep)
        st["step"] += 1 if keep is None else keep.to(torch.int32)

    def state_dict(self) -> dict:
        return dict(self.state)

    def load_state_dict(self, sd: dict) -> None:
        for k, v in self.state.items():
            v.copy_(sd[k])


class LAMB:
    """Adam moments -> masked weight decay -> trust ratio, over a flat
    buffer whose parameters are ``segments`` (offset, numel, ndim of the
    whole parameter), in order; the zeros between two of them (alignment
    gaps) stay zero. ``sharded`` (a bool a segment) marks the segments that
    are one fsdp rank's shard of a parameter, whose norms are summed over
    ``group``."""

    def __init__(self, params: torch.Tensor, segments, *, b1: float, b2: float, eps: float,
                 weight_decay: float, sharded=None, group=None):
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        dev = params.device
        self.group = group
        self.sharded = None
        if group is not None and sharded is not None and any(sharded):
            self.sharded = torch.tensor([i for i, s in enumerate(sharded) if s], device=dev)
        # each segment's span up to the next one's offset: its gap takes its ratio
        ends = [o for o, _, _ in segments[1:]] + [params.numel()]
        spans = [end - o for (o, _, _), end in zip(segments, ends)]
        self.sizes = torch.tensor(spans, device=dev)
        self.decay = torch.cat([torch.full((n,), nd > 1, dtype=torch.bool, device=dev)
                                for (_, _, nd), n in zip(segments, spans)])
        self.segments = segments
        self.state = {"mu": torch.zeros_like(params), "nu": torch.zeros_like(params),
                      "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def step(self, params: torch.Tensor, grads: torch.Tensor, lr: float, keep=None) -> None:
        st = self.state
        b1, b2 = self.b1, self.b2
        mu = (1 - b1) * grads + b1 * st["mu"]
        nu = (1 - b2) * torch.square(grads) + b2 * st["nu"]
        count = st["count"] + 1
        mu_hat = mu / (1 - torch.pow(b1, count))
        nu_hat = nu / (1 - torch.pow(b2, count))
        u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        u = torch.where(self.decay, u + self.weight_decay * params, u)
        # accumulated in float64: an f32 sum over a segment of millions
        # (ViT-B's MLP weights, 2.4 M) is off by ~4e-5, and the ratio with it
        p_norm = torch.stack(torch._foreach_norm(self._views(params), dtype=torch.float64))
        u_norm = torch.stack(torch._foreach_norm(self._views(u), dtype=torch.float64))
        if self.sharded is not None:  # global norms: the shards' squares summed
            sq = torch.stack([p_norm[self.sharded], u_norm[self.sharded]]).square()
            dist.all_reduce(sq, group=self.group)
            p_norm = p_norm.index_copy(0, self.sharded, sq[0].sqrt())
            u_norm = u_norm.index_copy(0, self.sharded, sq[1].sqrt())
        ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm),
                            p_norm / u_norm).to(u.dtype)
        u = u * torch.repeat_interleave(ratio, self.sizes, output_size=params.numel())
        _commit(params, params - lr * u, keep)
        _commit(st["mu"], mu, keep)
        _commit(st["nu"], nu, keep)
        st["count"] += 1 if keep is None else keep.to(torch.int32)

    def _views(self, t):
        return [t[o:o + n] for o, n, _ in self.segments]

    def state_dict(self) -> dict:
        return dict(self.state)

    def load_state_dict(self, sd: dict) -> None:
        for k, v in self.state.items():
            v.copy_(sd[k])


def construct_optimizer(params: torch.Tensor, segments, sharded=None, group=None):
    """The OPTIM.OPTIMIZER of the config over the flat ``params``
    (``sharded`` and ``group``: an fsdp rank's shard buffer, for LAMB)."""
    name = cfg.OPTIM.OPTIMIZER
    if name == "sgd":
        return SGD(params, momentum=cfg.OPTIM.MOMENTUM, dampening=cfg.OPTIM.DAMPENING,
                   nesterov=cfg.OPTIM.NESTEROV, weight_decay=cfg.OPTIM.WEIGHT_DECAY)
    if name == "lamb":
        return LAMB(params, segments, b1=cfg.OPTIM.BETA1, b2=cfg.OPTIM.BETA2, eps=cfg.OPTIM.EPS,
                    weight_decay=cfg.OPTIM.WEIGHT_DECAY, sharded=sharded, group=group)
    raise ValueError(f"Unknown OPTIM.OPTIMIZER {name!r} (available: 'sgd', 'lamb')")
