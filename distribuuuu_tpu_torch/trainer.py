"""Training and evaluation loops of the port (counterpart of ``trainer.py``).

One process a GPU, over the process group laid out as JAX's ``('data',
'fsdp', 'seq')`` mesh (:mod:`distribuuuu_tpu_torch.runtime.mesh`; rank ``(d *
F + f) * S + s``, batch rank ``d * F + f``):

| JAX (shard_map over Mesh('data'[, 'fsdp']))  | here                                        |
|------------------------------------------|---------------------------------------------|
| ``pmean(grads, 'data')``                  | one all-reduce of the flat gradient buffer (the loss rides in its last slot), divided by the world |
| fsdp: ``all_gather_params`` in the loss   | one all-gather a step, after the update, of every rank's shard buffer into the full working buffer (``TrainState.gather``) |
| fsdp: the gather's transpose, ``average_grads``, then ``pmean('data')`` | a reduce-scatter of the sharded leaves' gradients over the fsdp group, an all-reduce over the data group; the replicated leaves and the loss all-reduced over the world (``TrainState.reduce_grads``) |
| fsdp: ``psum`` of local finiteness        | one all-reduce of the guard's flag over the world |
| ``pmean(new_stats)`` after every step     | one all-reduce of the flat BN-statistics buffer |
| SyncBN: BN ``axis_name='data'``           | ``BatchNorm.sync_group``: ``[E[x], E[x^2]]`` all-reduced in the forward |
| non-finite guard (``jnp.where(keep, ..)``) | the same selection on the flat buffers, ``keep`` a device bool |
| metric psums, fetched at PRINT_FREQ      | device sums per step, all-reduced and fetched at PRINT_FREQ |
| seq: ``local_tokens``, ring/Ulysses attention over ``'seq'`` | the same over the seq group (:mod:`distribuuuu_tpu_torch.parallel.seq`): slices, ``batch_isend_irecv`` exchanges, ``all_to_all_single`` |
| seq: ``psum_partial`` of the loss's sums and the head's logits | an all-reduce over the seq group whose backward is the identity |
| seq: ``psum(grads, 'seq')`` before the fsdp/data reductions | one all-reduce of the flat gradient buffer (not the loss slot) over the seq group, first |
| seq: metric psums over the batch axes only | the world's sums divided by ``S`` (each member holds the same sums) |
| seq: the RNG fold without the seq index  | the dropout stream's rank is the batch rank |
| seq: loader and samples a step by ``batch_device_count`` | by the batch ranks, ``D * F`` |

:class:`TrainState` keeps every parameter as a view into one float32
buffer, its gradient as a view into a second and every BN running
statistic as a view into a third, so the collectives, the guard and the
optimizer each act on one tensor. On the card every BN runs K1 forward and
K1-bwd backward (53 of each per ResNet-50 or BoTNet-50 step, 121 per
DenseNet-121, 59 per RegNetY-16GF, 49 per EfficientNet-B0, none in ViT),
and BoTNet's MHSA the attention kernel and its backward kernel (3 of each
a step, the backward on its one-launch cluster route at 224^2, on the
blockwise route at 512^2); on the CPU their plain versions. Under
``MODEL.REMAT`` each block's forward runs again in the backward, so K1
and the attention launch once more a recomputed BN or attention (105 K1 a
ResNet-50 step: the stem's BN is not recomputed). Dropout and drop path
draw from a generator seeded each micro-step from ``(seed, epoch, step,
micro-step, rank)`` (:func:`dropout_seed`).

``TRAIN.TASK mae`` (an ``mae_*`` arch): the loss is the masked patches'
pixel MSE (:func:`mae_loss`); the mask is drawn first from the same
micro-step stream, on the device, so a resumed run draws it again; eval
uses one fixed mask from ``RNG_SEED or 0`` for every batch. The top-k
counters stay zero, so the meters and checkpoints are the classifier's.
``MODEL.PRETRAINED`` warm-starts from the port's converted checkpoint
(:func:`_pretrained_path`), without the optimizer.

``QUANT.QAT`` (:func:`_build_qat`, ``quant/qat.py``): after any resume or
warm start the fake-quant sites are calibrated on the run's weights, and
every train and eval forward (``test_net`` too) runs on the int8 or fp8
grid; ``QUANT.QAT_DISTILL`` > 0 adds the distillation term toward the
model's own plain logits, whose forward launches K1 once more a BN.

``MESH.SEQ`` > 1 (ViT and MAE; ``MODEL.SEQ_ATTN`` ring or ulysses): the
members of a seq group read the same rows and draw the same mask, the
model runs over the group (:func:`_seq_parallel`) and each member's
gradient is the partial one of its tokens, summed over the group before
the fsdp or data reduction. Eval runs sequence-parallel too. A model with
BN statistics, ``SEQ_ATTN none`` and ``MESH.SEQ -1`` raise, as in JAX; a
classifier ViT gets ``pool='gap'``. The state is seq-replicated, so a
checkpoint resumes at any ``MESH.SEQ``.

Fault tolerance, as the JAX trainer's (:mod:`distribuuuu_tpu_torch.resilience`):
at every step boundary the watchdog is beaten, the fault injector may kill,
hang or preempt, and a preemption (SIGTERM, SIGINT, an injected step)
writes a mid-epoch checkpoint and raises ``Preempted``. One process reads
its preemption flag at every step; with several, each rank's flag rides
the all-reduce of the metric window (every ``TRAIN.PRINT_FREQ`` steps), so
every rank reads the same sum after the same step and stops at the next
boundary, with no added sync or collective a step. A resume re-enters the
epoch at the checkpoint's step (remapped from its sample offset on another
world size); non-finite steps back to back raise ``NonFiniteDivergence``.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from distribuuuu_tpu_torch import checkpoint as ckpt
from distribuuuu_tpu_torch import obs, optim, resilience
from distribuuuu_tpu_torch.config import cfg, dump_cfg, get_default, lookup
from distribuuuu_tpu_torch.data.loader import (
    DevicePrefetcher,
    HostDataLoader,
    construct_train_loader,
    construct_val_loader,
    service_address,
)
from distribuuuu_tpu_torch.data.transforms import device_normalize
from distribuuuu_tpu_torch.logging import logger, setup_logger
from distribuuuu_tpu_torch.metrics import (
    construct_meters,
    count_parameters,
    cross_entropy_loss,
    per_example_nll,
    topk_correct,
    topk_correct_weighted,
)
from distribuuuu_tpu_torch.models import build_model, layers
from distribuuuu_tpu_torch.models.mae import patchify
from distribuuuu_tpu_torch.obs import monitors
from distribuuuu_tpu_torch.parallel import fsdp
from distribuuuu_tpu_torch.parallel import seq as seqpar
from distribuuuu_tpu_torch.runtime.dist import setup_distributed
from distribuuuu_tpu_torch.runtime.mesh import data_mesh
from distribuuuu_tpu_torch.runtime.seeding import configure_determinism, setup_seed

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _aligned_offsets(tensors) -> tuple[list[int], int]:
    """Offsets of ``tensors`` laid out one after another in a flat f32
    buffer, each rounded up to 4 elements so that every view starts 16 bytes
    aligned, as an allocation of its own would (K1's vector route and
    PyTorch's vectorised kernels need it; an odd-sized parameter, such as
    EfficientNet-B0's 6-wide SE bias, would misalign every view after it);
    and the buffer's length. The gaps hold zeros."""
    offsets, o = [], 0
    for t in tensors:
        o = -(-o // 4) * 4
        offsets.append(o)
        o += t.numel()
    return offsets, o


class TrainState:
    """A model, its flat parameter/gradient/statistics buffers and the
    optimizer. ``grads`` has one slot more than ``params``: the step's loss,
    all-reduced with the gradients. Each parameter and buffer is a 16-byte
    aligned view (:func:`_aligned_offsets`).

    ``mesh`` (:class:`~distribuuuu_tpu_torch.runtime.mesh.ProcessMesh`)
    with an fsdp axis above 1: ``master`` is this rank's shard buffer
    (:class:`~distribuuuu_tpu_torch.parallel.fsdp.ShardLayout`: its shards
    of the leaves the rule shards, the rest whole, ``min_size`` the rule's
    ``MESH.FSDP_MIN_SIZE``) and the optimizer's state is of exactly that;
    ``grad_shard`` the reduced gradient of it, with the loss slot. ``params``
    stays the full working buffer the model's views point into, filled by
    one all-gather after each update (:meth:`gather`), so the forward, eval
    and the checkpoints read whole parameters. The staging buffers of the
    collectives are ``params`` (before the reduce-scatter: the parameters
    are not read again before the gather, and its alignment gaps hold
    nothing after it) and ``grads`` (before the gather). Without fsdp
    ``master`` is ``params``."""

    def __init__(self, model: torch.nn.Module, group=None, mesh=None,
                 min_size: int = fsdp.DEFAULT_MIN_SIZE):
        self.model, self.group, self.mesh, self.min_size = model, group, mesh, min_size
        # seq: the members' partial gradients are summed over seq_group; the
        # batch reductions run over the batch ranks of this seq index
        self.seq_group = getattr(mesh, "seq_group", None)
        self.batch_group = group if mesh is None else mesh.batch_group
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        offsets, total = _aligned_offsets([p for _, p in named])
        device = named[0][1].device
        self.params = torch.zeros(total, device=device)
        self.grads = torch.zeros(total + 1, device=device)
        self.segments = []
        for (_, p), o in zip(named, offsets):
            k = p.numel()
            self.params[o:o + k].copy_(p.detach().reshape(-1))
            p.data = self.params[o:o + k].view(p.shape)
            p.grad = self.grads[o:o + k].view(p.shape)
            self.segments.append((o, k, p.dim()))
        bufs = [b for _, b in model.named_buffers()]
        offsets_b, total = _aligned_offsets(bufs)
        self.stats = torch.zeros(total, device=device)
        for b, o in zip(bufs, offsets_b):
            self.stats[o:o + b.numel()].copy_(b.reshape(-1))
            b.data = self.stats[o:o + b.numel()].view(b.shape)
        self.layout = None
        self.master = self.params
        if mesh is not None and mesh.fsdp > 1:
            self.layout = fsdp.ShardLayout([(n, p.shape) for n, p in named], offsets, mesh.fsdp,
                                           mesh.fsdp_rank, min_size)
            self.master = self.layout.take(self.params)
            self.grad_shard = torch.zeros(self.layout.size + 1, device=device)
            self.optimizer = optim.construct_optimizer(self.master, self.layout.segments,
                                                       self.layout.sharded, mesh.fsdp_group)
        else:
            self.optimizer = optim.construct_optimizer(self.params, self.segments)
        # the dropout and drop-path layers that draw in training, one
        # generator reseeded for them (and, before them, for an MAE model's
        # patch mask) each micro-step, and the base of its stream
        # (:func:`dropout_seed`), which a mid-epoch checkpoint carries as
        # JAX's carries its rng_key
        self.masks = [m for m in model.modules()
                      if isinstance(m, layers.RandomMask) and m.rate > 0.0]
        self.mask_generator = torch.Generator(device=device)
        self.dropout_seed: int | None = None

    @property
    def draws(self) -> bool:
        return bool(self.masks)

    @property
    def world(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def fsdp(self) -> int:
        return 1 if self.layout is None else self.layout.fsdp

    @property
    def seq(self) -> int:
        return seqpar.seq_size(self.mesh)

    @property
    def batch_world(self) -> int:
        """The processes reading distinct batch shards (the world without seq)."""
        return self.world // self.seq

    @property
    def batch_rank(self) -> int:
        return self.rank // self.seq

    def unflatten(self, flat: torch.Tensor) -> dict:
        """A flat parameter-shaped buffer (the momentum, say) by parameter name."""
        shapes = dict(self.model.named_parameters())
        return {n: flat[o:o + k].view(shapes[n].shape)
                for n, (o, k, _) in zip(self.names, self.segments)}

    def reduce_grads(self) -> torch.Tensor:
        """Under fsdp: ``grad_shard``, the mean over the batch ranks of the
        gradient of this rank's shard buffer, and the mean loss in its last
        slot. The sharded chunk: one reduce-scatter over the fsdp group (the
        sum over it, divided by its size), then an all-reduce over the data
        group; the replicated leaves and the loss: one all-reduce over the
        batch ranks (the world without seq)."""
        lay, mesh, gs = self.layout, self.mesh, self.grad_shard
        lay.reduce_scatter(self.grads, gs, self.params, mesh.fsdp_group)
        gs[-1:].copy_(self.grads[-1:])
        sharded = gs[:lay.chunk]
        sharded.div_(lay.fsdp)
        if mesh.data > 1:
            dist.all_reduce(sharded, group=mesh.data_group)
            sharded.div_(mesh.data)
        rest = gs[lay.chunk:]
        dist.all_reduce(rest, group=self.batch_group)
        rest.div_(self.batch_world)
        return gs

    def gather(self) -> None:
        """Under fsdp: the full parameters from every rank's shard buffer
        (one all-gather over the fsdp group, ``grads`` as its staging)."""
        self.layout.gather(self.master, self.params, self.grads, self.mesh.fsdp_group)

    def reshard(self) -> None:
        """This rank's shard buffer anew from the full parameters (after a
        load into the model's views); nothing without fsdp."""
        if self.layout is not None:
            self.layout.take(self.params, out=self.master)

    def full_optimizer_state(self) -> dict:
        """The optimizer's state in the layout of the full buffer, as it is
        without fsdp (the checkpoints' format at every ``MESH.FSDP``). Under
        fsdp a collective: every rank of the run must call it."""
        sd = self.optimizer.state_dict()
        if self.layout is None:
            return sd
        out = {}
        for k, v in sd.items():
            if v.dim() == 1:  # parameter-shaped: gathered from the shards
                full = torch.zeros_like(self.params)
                self.layout.gather(v, full, self.grads, self.mesh.fsdp_group)
                v = full
            out[k] = v
        return out

    def load_full_optimizer_state(self, sd: dict) -> None:
        """Load :meth:`full_optimizer_state`'s layout (this rank's shards of it)."""
        if self.layout is not None:
            sd = {k: self.layout.take(v.to(self.params.device)) if v.dim() == 1 else v
                  for k, v in sd.items()}
        self.optimizer.load_state_dict(sd)

    def held_bytes(self) -> dict:
        """The bytes this process holds of parameters (its shard buffer),
        optimizer state and BN statistics: what JAX's ``state_bytes``
        record counts per device."""
        nbytes = lambda t: t.numel() * t.element_size()  # noqa: E731
        return dict(params=nbytes(self.master),
                    opt=sum(nbytes(v) for v in self.optimizer.state_dict().values()),
                    bn=nbytes(self.stats))


def dropout_seed(seed: int, epoch: int, step: int, micro: int, rank: int) -> int:
    """The seed of one micro-step's dropout stream on one rank, from
    ``(seed, epoch, step, micro, rank)`` alone, as JAX folds ``epoch``,
    ``step`` and the device into its key and splits it per micro-step.
    Ranks draw different masks, and a resumed run draws the same ones
    without any saved generator state."""
    hi, lo = np.random.SeedSequence([seed, epoch, step, micro, rank]).generate_state(2)
    return (int(hi) << 32 | int(lo)) >> 1


def mae_loss(model, images: torch.Tensor, mask: torch.Tensor, weights=None) -> torch.Tensor:
    """The masked-autoencoder loss of JAX's ``_forward_loss_mae``: ``model``
    (an ``mae_*`` arch) on the normalised NHWC ``images`` with ``mask``
    (``[B, L]`` bool, True: masked), each patch's mean squared error in f32
    against :func:`patchify` of the images, summed over the masked patches
    (each weighted by its sample's ``weights``, when given: a padded eval
    sample counts for nothing) and divided by their count, at least 1. A
    sequence-parallel model predicts its member's tokens: the target and
    the mask are sliced alike, and the sum and the count are summed over
    the seq group by ``psum_partial``, so the loss is the whole one on
    every member and each member's gradient the partial one."""
    pred = model(images, mask)
    target = patchify(images.float(), model.patch)
    mask_f = mask.float()
    if weights is not None:
        mask_f = mask_f * weights.float()[:, None]
    group = getattr(model, "seq_group", None)
    if group is not None:
        target, mask_f = seqpar.local_tokens(target, group), seqpar.local_tokens(mask_f, group)
    err = (pred.float() - target).square().mean(-1)  # [B, L]
    se, cnt = (err * mask_f).sum(), mask_f.sum()
    if group is not None:
        se, cnt = seqpar.psum_partial(torch.stack([se, cnt]), group).unbind()
    return se / cnt.clamp_min(1.0)


def mae_mask(n: int, tokens: int, generator: torch.Generator, device=None) -> torch.Tensor:
    """``[n, tokens]`` Bernoulli(``MODEL.MAE_MASK_RATIO``) draws from
    ``generator`` (on its device unless ``device`` says where to put them)."""
    u = torch.rand((n, tokens), generator=generator, device=generator.device)
    return (u < cfg.MODEL.MAE_MASK_RATIO).to(device or generator.device)


def train_step(state: TrainState, batch: dict, lr: float, *, accum_steps: int = 1,
               topk: int = 5, label_smooth: float = 0.0, guard: bool = True,
               dropout_key: tuple | None = None, task: str = "classify",
               mask: torch.Tensor | None = None, qat=None, distill: float = 0.0) -> dict:
    """One optimizer step on the local batch (``image`` uint8 or float NHWC,
    ``label``), on the batch's device. Forward and backward per micro-batch
    (BN statistics updated in order), gradients and loss averaged over the
    micro-batches and over the group, the running statistics averaged over
    the group, then the update. With ``guard``, a non-finite loss or
    gradient leaves parameters, optimizer state and statistics as they
    were. ``dropout_key``: ``(seed, epoch, step, rank)``, from which each
    micro-step's dropout and drop-path masks are drawn
    (:func:`dropout_seed`); a model that draws none needs none.
    ``task`` "mae": the loss is :func:`mae_loss`, top-k stays zero, and
    each micro-step's patch mask is ``mask``'s rows (``[n, L]``), or, when
    ``mask`` is None, drawn from the micro-step's stream before any
    dropout (so ``dropout_key`` is needed).
    ``qat`` (a ``quant.QATModel``, ``QUANT.QAT``): the forward and backward
    run on its fake-quant grid; ``distill`` > 0 adds ``distill * mean((q -
    fp)^2)`` over the logits, ``fp`` the plain forward's on the same batch
    with the same masks, without gradient and leaving the BN statistics as
    the fake-quant forward left them (JAX's ``QUANT.QAT_DISTILL``).
    Returns this rank's metric sums as 0-d device tensors (no sync)."""
    model = state.model.train()
    images, labels = batch["image"], batch["label"]
    n = images.shape[0]
    if n % accum_steps:
        raise ValueError(f"batch {n} does not split into {accum_steps} micro-batches")
    mae = task == "mae"
    if mae and mask is None and dropout_key is None:
        raise ValueError("TRAIN.TASK mae draws its mask from the dropout stream: pass "
                         "dropout_key (or the mask)")
    mb = n // accum_steps
    state.grads.zero_()
    stats_before = state.stats.clone() if guard else None
    zero = torch.zeros((), device=images.device)
    loss_sum, correct = 0.0, {1: zero, topk: zero}
    for i in range(accum_steps):
        sl = slice(i * mb, (i + 1) * mb)
        gen = seed = None
        if dropout_key is not None and (state.masks or mae):
            seed = dropout_seed(*dropout_key[:3], i, dropout_key[3])
            gen = state.mask_generator.manual_seed(seed)
        for m in state.masks:  # without a key the layers raise rather than draw
            m.generator = gen
        x = device_normalize(images[sl])
        with contextlib.nullcontext() if qat is None else qat.intercept(model):
            if mae:
                tokens = (x.shape[1] // model.patch) * (x.shape[2] // model.patch)
                m_i = mask[sl] if mask is not None else mae_mask(mb, tokens, gen)
                loss = mae_loss(model, x, m_i)
            else:
                logits = model(x)
                loss = cross_entropy_loss(logits, labels[sl], label_smooth)
            if qat is not None and distill > 0.0:
                if gen is not None:  # the teacher draws the student's masks
                    gen.manual_seed(seed)
                with torch.no_grad(), qat.bypass(), layers.frozen_running_stats():
                    fp_logits = model(x)
                drift = logits.float() - fp_logits.float()
                loss = loss + distill * drift.square().mean()
            loss.backward()
        loss_sum = loss_sum + loss.detach()
        if not mae:
            for k, v in topk_correct(logits.detach(), labels[sl], ks=(1, topk)).items():
                correct[k] = correct[k] + v
    loss = loss_sum / accum_steps
    grads = state.grads[:-1]
    if accum_steps > 1:
        grads.div_(accum_steps)
    state.grads[-1:].copy_(loss.reshape(1))
    if state.seq_group is not None:  # the members' partial gradients (the loss is whole)
        dist.all_reduce(grads, group=state.seq_group)
    reduced = state.grads
    if state.layout is not None:  # fsdp: this rank's shard of the mean gradient
        reduced = state.reduce_grads()
    elif state.batch_world > 1:
        dist.all_reduce(state.grads, group=state.batch_group)
        state.grads.div_(state.batch_world)
    if state.batch_world > 1 and state.stats.numel():
        dist.all_reduce(state.stats, group=state.batch_group)
        state.stats.div_(state.batch_world)
    n_t = torch.full((), float(n), device=loss.device)
    keep = None
    if guard:
        keep = torch.isfinite(reduced[-1]) & torch.isfinite(reduced[:-1]).all()
        if state.layout is not None:  # shards: finiteness is local, agreed over the run
            ok = keep.float()
            dist.all_reduce(ok, group=state.group)
            keep = ok == state.world
    state.optimizer.step(state.master, reduced[:-1], lr, keep)
    if state.layout is not None:
        state.gather()
    metrics = {"loss_sum": loss * n_t, "n": n_t, "correct1": correct[1],
               f"correct{topk}": correct[topk]}
    if guard:
        state.stats.copy_(torch.where(keep, state.stats, stats_before))
        metrics = {k: torch.where(keep, v, zero) for k, v in metrics.items()}
        metrics["skipped"] = (~keep).float()
    return metrics


@torch.no_grad()
def eval_step(model, batch: dict, totals: torch.Tensor, topk: int = 5,
              task: str = "classify", qat=None) -> torch.Tensor:
    """Add the batch's ``[sum(nll * w), sum(w), correct@1, correct@k]`` to
    ``totals`` (a 4-vector on the device) and return it; ``qat``: of the
    fake-quant forward (``QUANT.QAT``). ``task`` "mae":
    ``[mae_loss * sum(w), sum(w), 0, 0]`` under one fixed mask, drawn from
    ``RNG_SEED or 0`` on the CPU for every batch and run (so the card and
    the CPU evaluate the same mask), the weights excluding padded samples."""
    model.eval()
    x = device_normalize(batch["image"])
    w = batch["weight"]
    if task == "mae":
        tokens = (x.shape[1] // model.patch) * (x.shape[2] // model.patch)
        gen = torch.Generator().manual_seed(cfg.RNG_SEED or 0)
        loss = mae_loss(model, x, mae_mask(x.shape[0], tokens, gen, x.device), w)
        zero = torch.zeros((), device=x.device)
        return totals + torch.stack([loss * w.sum(), w.sum(), zero, zero])
    logits = (model(x) if qat is None else qat.apply(model, x)).float()
    nll = per_example_nll(logits, batch["label"])
    c = topk_correct_weighted(logits, batch["label"], w, ks=(1, topk))
    return totals + torch.stack([(nll * w).sum(), w.sum(), c[1], c[topk]])


# Keys the port accepts, so that the JAX package's YAMLs and command lines
# merge, but does not honour yet: any value other than the default raises
# with the ROADMAP Queue 1 item that ports the subsystem.
UNPORTED_KEYS = (("DATA.ADVERTISE_HOST", "item 13"),)


def _check_supported() -> None:
    """Raise on a config value whose subsystem the port does not have yet
    (before the mesh's sizes are checked against the processes)."""
    todo = (# a fleet-scheduled dataplane (the key or DTPU_DATA_SERVICE); a
            # host:port address is ported
            ("DATA.SERVICE", service_address().lower() != "fleet", "item 13"),
            *((key, lookup(key) == get_default(key), item) for key, item in UNPORTED_KEYS))
    for key, ok, item in todo:
        if not ok:
            raise NotImplementedError(f"this {key} is not ported yet (ROADMAP Queue 1 {item})")
    if cfg.OBS.PERFDB:
        raise NotImplementedError("OBS.PERFDB is not ported: the JAX package's perfdb is a "
                                  "kernel on/off switch, which the port has no use for (on the "
                                  "card a CUDA tensor always takes the kernel)")
    if cfg.MODEL.DTYPE not in _DTYPES:
        raise ValueError(f"MODEL.DTYPE must be 'float32' or 'bfloat16', got {cfg.MODEL.DTYPE!r}")
    if cfg.MODEL.BN_DTYPE not in ("auto", *_DTYPES):
        raise ValueError(f"MODEL.BN_DTYPE must be 'auto', 'float32' or 'bfloat16', "
                         f"got {cfg.MODEL.BN_DTYPE!r}")


def build_cfg_model(generator: torch.Generator | None = None) -> torch.nn.Module:
    """``MODEL.ARCH`` with the config's classes, compute dtype, BN boundary
    dtype (``auto`` follows ``MODEL.DTYPE``) and ``MODEL.REMAT``, weights
    drawn from ``generator`` with the JAX initialisers
    (:func:`layers.init_weights`). ``MODEL.STEM_S2D`` reaches the factory,
    which refuses it outside the ResNet family (a TypeError, as JAX's).
    ``TRAIN.TASK`` and ``MODEL.SEQ_ATTN`` are checked as JAX's
    ``_build_cfg_model`` checks them: ``mae`` needs an ``mae_*`` arch (and
    gets ``MODEL.MAE_DECODER_DIM``), an ``mae_*`` arch needs ``mae``, and
    ``MESH.SEQ`` > 1 needs ring or Ulysses attention (and gives a
    classifier ViT ``pool='gap'``)."""
    for mod in filter(None, (m.strip() for m in cfg.MODEL.MODULE.split(","))):
        importlib.import_module(mod)
    if cfg.TRAIN.TASK not in ("classify", "mae"):
        raise ValueError(f"TRAIN.TASK must be 'classify' or 'mae', got {cfg.TRAIN.TASK!r}")
    if cfg.MODEL.SEQ_ATTN not in ("none", "ring", "ulysses"):
        raise ValueError(f"MODEL.SEQ_ATTN must be 'none', 'ring' or 'ulysses', "
                         f"got {cfg.MODEL.SEQ_ATTN!r}")
    dtype = _DTYPES[cfg.MODEL.DTYPE]
    bn = cfg.MODEL.BN_DTYPE
    bn_dtype = dtype if bn == "auto" else _DTYPES[bn]
    # the ResNet family's option, as in JAX: another family's factory
    # refuses the keyword with a TypeError
    kwargs = {"stem_s2d": True} if cfg.MODEL.STEM_S2D else {}
    if cfg.MESH.SEQ > 1:
        if cfg.MODEL.SEQ_ATTN == "none":
            # dense attention on each block alone would attend within blocks only
            raise ValueError("MESH.SEQ > 1 needs MODEL.SEQ_ATTN 'ring' or 'ulysses' to stitch "
                             "the attention contraction across token shards")
        if cfg.TRAIN.TASK == "classify" and cfg.MODEL.ARCH.startswith("vit_"):
            kwargs["pool"] = "gap"  # the class token has no home block
    if cfg.TRAIN.TASK == "mae":
        if not cfg.MODEL.ARCH.startswith("mae_"):
            raise ValueError(f"TRAIN.TASK 'mae' needs a pixel-decoder arch (mae_*), got "
                             f"MODEL.ARCH {cfg.MODEL.ARCH!r}")
        kwargs["decoder_dim"] = cfg.MODEL.MAE_DECODER_DIM
    elif cfg.MODEL.ARCH.startswith("mae_"):
        raise ValueError(f"MODEL.ARCH {cfg.MODEL.ARCH!r} emits pixel reconstructions, not "
                         f"class logits: set TRAIN.TASK 'mae'")
    model = build_model(cfg.MODEL.ARCH, num_classes=cfg.MODEL.NUM_CLASSES, dtype=dtype,
                        bn_dtype=bn_dtype, im_size=cfg.TRAIN.IM_SIZE, remat=cfg.MODEL.REMAT,
                        **kwargs)
    if generator is not None:
        layers.init_weights(model, generator)
    return model


def _check_crop(model) -> None:
    """A model whose position tables are sized by the crop at construction
    (``crop_sized``: BoTNet-50, ViT) refuses an eval crop other than the
    training one, as the JAX trainer does for botnet50: now, rather than at
    the first validation after an epoch."""
    if getattr(model, "crop_sized", False) and cfg.TRAIN.IM_SIZE != cfg.TEST.CROP_SIZE:
        raise ValueError(f"{cfg.MODEL.ARCH} requires TRAIN.IM_SIZE == TEST.CROP_SIZE (got "
                         f"{cfg.TRAIN.IM_SIZE} vs {cfg.TEST.CROP_SIZE}): its position tables "
                         f"are sized by the training crop")


def _pretrained_path() -> str:
    """``MODEL.PRETRAINED``'s directory, ``$DTPU_PRETRAINED_DIR/<arch>``
    (default ``~/.cache/distribuuuu_tpu_torch/pretrained/<arch>``, the
    port's own root: a JAX Orbax directory is never found by default). A
    missing directory, or one without the port's ``checkpoint.pt`` (such as
    an Orbax one), raises ``FileNotFoundError`` naming the command that
    provisions it from a torchvision ``.pth``."""
    root = os.environ.get("DTPU_PRETRAINED_DIR", os.path.join(
        os.path.expanduser("~"), ".cache", "distribuuuu_tpu_torch", "pretrained"))
    path = os.path.join(root, cfg.MODEL.ARCH)
    provision = (f"provision it once with: python -m distribuuuu_tpu_torch.convert --arch "
                 f"{cfg.MODEL.ARCH} --src <torchvision .pth> --dst {path}")
    if not os.path.isdir(path):
        raise FileNotFoundError(f"MODEL.PRETRAINED=True but no converted weights at {path}; "
                                f"{provision}")
    if not os.path.isfile(os.path.join(path, "checkpoint.pt")):
        raise FileNotFoundError(f"MODEL.PRETRAINED=True but {path} holds no checkpoint.pt of "
                                f"the port (a JAX Orbax directory cannot be read); {provision}")
    return path


def _load_pretrained(state: TrainState) -> str:
    """Verify ``MODEL.PRETRAINED``'s checkpoint against its manifest and load
    its model into ``state`` (the optimizer untouched); returns its path."""
    path = _pretrained_path()
    status, errors = ckpt.verify_checkpoint(path)
    if status != "ok":
        raise RuntimeError(f"MODEL.PRETRAINED: {path} is {status} against its manifest "
                           f"({errors or 'no dtpu_manifest.json'}); provision it again with "
                           f"python -m distribuuuu_tpu_torch.convert")
    ckpt.load_checkpoint(path, state, load_opt=False)
    return path


_ROUTES = ("cluster", "blockwise", "scalar")  # the attention backward's routes
# K1, K1-bwd, their scalar routes, the attention kernel, its backward and the
# backward's calls on each route: the journal's counters, by name
_LAUNCH_KEYS = ("epilogue.launches", "epilogue.bwd_launches", "epilogue.scalar_launches",
                "epilogue.bwd_scalar_launches", "attention.launches", "attention.bwd_launches",
                *(f"attention.bwd_route_calls.{r}" for r in _ROUTES))


def _launch_counts() -> tuple[int, ...]:
    """The counters of :data:`_LAUNCH_KEYS`, as ``obs/monitors.py`` reads
    them for the journal."""
    counts = monitors.launch_counts()
    return tuple(counts[k] for k in _LAUNCH_KEYS)


def _fetch(window: list, state: TrainState, stop: bool = False) -> tuple[list[dict], bool]:
    """The window's per-step metric sums on the host, summed over the group,
    and whether any rank asked to stop: with several processes this rank's
    preemption flag ``stop`` rides the same all-reduce, so every rank gets
    the same answer after the same step."""
    keys = list(window[0])
    t = torch.stack([torch.stack([m[k] for k in keys]) for m in window]).reshape(-1)
    if state.world > 1:
        t = torch.cat([t, torch.full((1,), float(stop), dtype=t.dtype, device=t.device)])
        dist.all_reduce(t, group=state.group)
    flat = t.tolist()  # the sync point
    if state.world > 1:
        stop = flat.pop() > 0
    rows = [dict(zip(keys, flat[i:i + len(keys)])) for i in range(0, len(flat), len(keys))]
    for v in rows:  # each seq member holds its group's sums; "skipped" every rank
        for k in v:
            v[k] /= state.world if k == "skipped" else state.seq
    return rows, stop


def _preempt(state: TrainState, epoch: int, it: int, best_acc1: float, samples_per_step: int,
             is_primary: bool) -> None:
    """Write the emergency checkpoint before step ``it`` (rank 0, after
    every rank entered the optimizer state's gather; the other ranks wait
    for the write), log its wall time and bytes, raise ``Preempted``."""
    tic = time.perf_counter()
    opt = state.full_optimizer_state()
    if is_primary:
        path = ckpt.save_mid_checkpoint(cfg.OUT_DIR, epoch, it, state, best_acc1,
                                        samples_per_step=samples_per_step, optimizer=opt)
        wall = time.perf_counter() - tic
        size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)
        logger.warning(f"Preempted at epoch {epoch} step {it}: emergency checkpoint {path} "
                       f"committed in {1e3 * wall:.1f} ms ({size} bytes); exiting")
        tel = obs.current()
        tel.event("preempt", epoch=epoch, step=it, path=path)
        tel.commit()  # durable now: the hard deadline may SIGKILL us
    if state.world > 1:  # no rank leaves before the checkpoint is durable
        dist.barrier(group=state.group)
        if not is_primary:
            logger.warning(f"Preempted at epoch {epoch} step {it}: rank "
                           f"{dist.get_rank(state.group)} exiting with rank 0's checkpoint")
    resilience.RUN_STATS.preempted_at = (epoch, it)
    raise resilience.Preempted(f"preempted at epoch {epoch} step {it}")


def train_epoch(loader, state: TrainState, epoch: int, device, is_primary: bool, *,
                start_epoch: int = 0, run_tic: float | None = None,
                start_step: int = 0, best_acc1: float = 0.0, injector=None, qat=None) -> None:
    """One epoch from batch ``start_step`` (a mid-epoch resume: the loader
    skips the consumed batches unread), reported to ``obs.current()``: a
    window record a PRINT_FREQ fetch, the epoch's records at its end, and
    the profiler windows of ``OBS.PROFILE_*`` and ``TRAIN.PROFILE`` on rank 0."""
    lr = optim.get_epoch_lr(epoch)
    if is_primary:
        logger.info(f"Epoch[{epoch}] current learning rate: {lr:.6f}")
    loader.set_epoch(epoch, start_batch=start_step)
    if start_step and is_primary:
        logger.info(f"Epoch[{epoch}] resuming mid-epoch at step {start_step}/{len(loader)}")
    topk = cfg.TRAIN.TOPK
    batch_time, data_time, losses, top1, topk_m, progress = construct_meters(
        len(loader), prefix=f"Epoch[{epoch}] ", topk=topk)
    progress.configure_run_eta(tic=run_tic or time.time(), cur_epoch=epoch,
                               start_epoch=start_epoch, max_epoch=cfg.OPTIM.MAX_EPOCH)
    step_imgs = cfg.TRAIN.BATCH_SIZE * cfg.TRAIN.ACCUM_STEPS * state.batch_world
    steps_per_epoch = len(loader)
    # the group's verdict on stopping, from the last window (one process:
    # None, its own flag is read at every step)
    agreed = None if state.world == 1 else False
    epoch_skipped = consec = 0
    window: list = []
    first_window = True
    tel = obs.current()
    tel.epoch_start(epoch)
    prof = obs.ProfilerWindows.from_cfg(epoch, telemetry=tel, device=device) if is_primary else None
    launches0 = _launch_counts()
    epoch_start = t_end = t_window = time.time()
    for it, batch in enumerate(DevicePrefetcher(loader, device, cfg.TRAIN.PREFETCH,
                                                 cfg.TRAIN.PIN_MEMORY), start=start_step):
        data_time.update(time.time() - t_end)
        gstep = epoch * steps_per_epoch + it
        resilience.watchdog_beat(gstep)
        if injector is not None and injector.should_kill(gstep):
            injector.kill_now()  # a hard death: no cleanup, no checkpoint
        if injector is not None and injector.should_hang(gstep):
            injector.hang_now()  # the watchdog's prey
        if injector is not None and injector.should_preempt(gstep):
            # gstep is the same on every rank: no agreement needed
            resilience.request_preemption(f"injected at global step {gstep}")
            stop_here = True
        else:
            stop_here = resilience.preemption_stop_requested(agreed)
        if stop_here:
            _preempt(state, epoch, it, best_acc1, step_imgs, is_primary)
        if injector is not None and injector.is_nan_step(gstep):
            batch = resilience.poison_batch_nan(batch)
            if is_primary:
                logger.warning(f"FAULT INJECTION: NaN batch at global step {gstep}")
        if prof is not None:
            prof.maybe_start(gstep)
        window.append(train_step(state, batch, lr, accum_steps=cfg.TRAIN.ACCUM_STEPS,
                                 topk=topk, label_smooth=cfg.TRAIN.LABEL_SMOOTH,
                                 guard=cfg.FAULT.NONFINITE_GUARD,
                                 dropout_key=(state.dropout_seed, epoch, it, state.batch_rank),
                                 task=cfg.TRAIN.TASK, qat=qat,
                                 distill=float(cfg.QUANT.QAT_DISTILL)))
        if prof is not None:
            prof.after_step(gstep)
        if it % cfg.TRAIN.PRINT_FREQ == 0 or it == len(loader) - 1:
            vals, stop = _fetch(window, state, resilience.preemption_requested())
            if agreed is not None:
                agreed = stop
            now = time.time()
            win_wall, win_steps, warmup = now - t_window, len(window), first_window
            if first_window:  # the first window carries cuDNN's autotuning: shown, not averaged
                batch_time.val = win_wall / win_steps
                first_window = False
            else:
                batch_time.update(win_wall / win_steps, n=win_steps)
            t_window = now
            win_skipped = 0
            for v in vals:
                if v.get("skipped", 0.0) >= 0.5:
                    win_skipped += 1
                    consec += 1
                    if consec >= cfg.FAULT.MAX_CONSECUTIVE_SKIPS:
                        tel.event("fault_abort", epoch=epoch, step=it, consecutive=consec)
                        tel.commit()
                        raise resilience.NonFiniteDivergence(
                            f"{consec} consecutive non-finite steps at epoch {epoch} step {it}: "
                            f"aborting (FAULT.MAX_CONSECUTIVE_SKIPS="
                            f"{cfg.FAULT.MAX_CONSECUTIVE_SKIPS})")
                else:
                    consec = 0
            epoch_skipped += win_skipped
            n = sum(v["n"] for v in vals)
            win_loss = win_acc1 = win_acck = None
            if n > 0:  # a window of skipped steps only has nothing to average
                win_loss = sum(v["loss_sum"] for v in vals) / n
                win_acc1 = 100.0 * sum(v["correct1"] for v in vals) / n
                win_acck = 100.0 * sum(v[f"correct{topk}"] for v in vals) / n
                losses.update(win_loss, n=int(n))
                top1.update(win_acc1, n=int(n))
                topk_m.update(win_acck, n=int(n))
            window.clear()
            # the floats fetched above: telemetry adds no sync of its own
            tel.window(epoch=epoch, step=it, gstep=gstep, steps=win_steps, skipped=win_skipped,
                       lr=lr, wall_s=win_wall, data_time=data_time.avg,
                       imgs=win_steps * step_imgs, warmup=warmup, loss=win_loss,
                       acc1=win_acc1, acck=win_acck)
            if is_primary:
                progress.display(it)
        t_end = time.time()
    if prof is not None:  # the epoch ended inside a window
        prof.finish()
    wall = time.time() - epoch_start
    resilience.RUN_STATS.skipped_steps[epoch] = epoch_skipped
    deltas = [b - a for a, b in zip(launches0, _launch_counts())]
    fwd, bwd, fwd_s, bwd_s, att_f, att_b, *att_r = deltas
    steps = max(1, len(loader) - start_step)  # the steps this run took
    if state.world > 1:  # every rank's launches and bytes, gathered once an epoch
        _log_by_rank(state, epoch, deltas, device, is_primary)
    if is_primary:
        logger.info(f"Epoch[{epoch}] K1 launches: {fwd} forward ({fwd / steps:.2f} a step), "
                    f"{bwd} backward ({bwd / steps:.2f} a step), scalar route {fwd_s} forward, "
                    f"{bwd_s} backward; attention {att_f} forward ({att_f / steps:.2f} a step), "
                    f"{att_b} backward ({att_b / steps:.2f} a step); backward calls by route: "
                    + ", ".join(f"{r} {c}" for r, c in zip(_ROUTES, att_r)))
        if epoch_skipped:
            logger.warning(f"Epoch[{epoch}] skipped_steps: {epoch_skipped} non-finite step(s) "
                           f"left parameters and optimizer state untouched")
        peak = ""
        if torch.device(device).type == "cuda":  # the memory record's allocated_bytes.all.peak
            b = torch.cuda.max_memory_allocated(device)
            peak = f"; peak memory {b / 2**30:.2f} GiB ({b} bytes)"
        logger.info(f"Epoch[{epoch}] done: {wall:.1f}s, {step_imgs * steps / wall:.0f} img/s; "
                    f"steady state {1e3 * batch_time.avg:.2f} ms a step, "
                    f"{step_imgs / max(batch_time.avg, 1e-9):.0f} img/s; data wait "
                    f"{100 * data_time.sum / wall:.1f}% of the epoch{_input_tail(loader)}{peak}")
    if len(loader) > start_step:
        tel.epoch_end(epoch=epoch, steps=len(loader) - start_step, skipped=epoch_skipped,
                      wall_s=wall, imgs=step_imgs * (len(loader) - start_step), state=state)


def _log_by_rank(state: TrainState, epoch: int, launches: list, device, is_primary: bool) -> None:
    """One all-gather an epoch: each rank's launches of the epoch (as the
    ``K1 launches`` line counts them), the bytes it holds (parameters,
    optimizer state) and its peak memory, logged by rank 0."""
    held = state.held_bytes()
    peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
    row = torch.tensor([*launches, held["params"], held["opt"], peak], dtype=torch.float64,
                       device=device)
    rows = torch.empty(state.world * row.numel(), dtype=row.dtype, device=device)
    dist.all_gather_into_tensor(rows, row, group=state.group)
    cols = rows.view(state.world, -1).T.long().tolist()
    if is_primary:
        logger.info(f"Epoch[{epoch}] by rank: K1 forward {cols[0]}, backward {cols[1]}, scalar "
                    f"route {cols[2]} / {cols[3]}; attention {cols[4]} / {cols[5]}; params "
                    f"bytes {cols[-3]}, optimizer bytes {cols[-2]}, peak memory bytes {cols[-1]}")


def validate(loader, model, device, is_primary: bool, group=None, prefix="Test: ", seq: int = 1,
             epoch: int | None = None, qat=None):
    """Weighted top-1/top-k and loss over ``loader``; returns ``(acc1, acck)``
    and journals an ``eval`` record (of ``epoch``). The totals are summed
    over ``group``, each divided by ``seq`` (the members of a seq group hold
    the same totals)."""
    eval_tic = time.time()
    topk = cfg.TRAIN.TOPK
    batch_time, data_time, losses, top1, topk_m, progress = construct_meters(
        len(loader), prefix=prefix, topk=topk)
    totals = torch.zeros(4, device=device)
    t_end = t_window = time.time()
    window_n = 0

    def summed(t):
        t = t.clone()
        if group is not None:
            dist.all_reduce(t, group=group)
        return [v / seq for v in t.tolist()]

    for it, batch in enumerate(DevicePrefetcher(loader, device, cfg.TRAIN.PREFETCH,
                                                 cfg.TRAIN.PIN_MEMORY)):
        data_time.update(time.time() - t_end)
        resilience.watchdog_beat(it, phase="eval")
        totals = eval_step(model, batch, totals, topk, cfg.TRAIN.TASK, qat)
        window_n += 1
        if it % cfg.TEST.PRINT_FREQ == 0 or it == len(loader) - 1:
            loss_s, n, c1, ck = summed(totals)
            now = time.time()
            if it == 0:
                batch_time.val = (now - t_window) / window_n
            else:
                batch_time.update((now - t_window) / window_n, n=window_n)
            t_window, window_n = now, 0
            n = max(n, 1.0)
            losses.avg = losses.val = loss_s / n
            top1.avg = top1.val = 100.0 * c1 / n
            topk_m.avg = topk_m.val = 100.0 * ck / n
            if is_primary:
                progress.display(it)
        t_end = time.time()
    loss_s, n, c1, ck = summed(totals)
    n = max(n, 1.0)
    acc1, acck = 100.0 * c1 / n, 100.0 * ck / n
    if is_primary:
        mse = f"; masked-MSE loss {loss_s / n:.6f}" if cfg.TRAIN.TASK == "mae" else ""
        logger.info(f" * Acc@1 {acc1:.3f} Acc@{topk} {acck:.3f} over {n:.0f} images{mse}"
                    f"{_input_tail(loader)}")
    obs.current().event("eval", epoch=epoch, acc1=acc1, acck=acck, loss=loss_s / n,
                        wall_s=round(time.time() - eval_tic, 3), samples=n)
    return acc1, acck


def _setup(device, journal: bool = False):
    """The run's process group and ``(data, fsdp, seq)`` mesh: ``(info,
    mesh)``; ``journal``: the run writes the telemetry journal (a training
    run), whose path the log names."""
    configure_determinism(cfg.CUDNN.DETERMINISTIC, cfg.CUDNN.BENCHMARK)
    _check_supported()
    info = setup_distributed(device)
    mesh = data_mesh(cfg.MESH.DATA, cfg.MESH.FSDP, info.world_size, info.rank, info.group,
                     seq=cfg.MESH.SEQ)
    journal = journal and info.is_primary and cfg.OBS.ENABLED
    setup_logger(cfg.OUT_DIR if info.is_primary else None,
                 journal_path=obs.journal_path(cfg.OUT_DIR) if journal else None)
    if not info.is_primary:  # one progress log for the run: rank 0's
        logger.setLevel("WARNING")
    return info, mesh


def _train_state(model, info, mesh) -> TrainState:
    """The model's :class:`TrainState` on ``mesh`` (built whole on every
    rank from the seed; under fsdp each rank keeps its shards), with the
    census of what sharded logged as JAX's ``create_train_state`` logs it,
    and the bytes this process holds (logged, and journaled as JAX's
    ``state_bytes`` record)."""
    state = TrainState(model, info.group, mesh, cfg.MESH.FSDP_MIN_SIZE)
    obs.current().event("state_bytes", **obs.state_bytes(state))
    named = list(model.named_parameters())
    c = fsdp.census(named, mesh.fsdp, cfg.MESH.FSDP_MIN_SIZE)
    n_opt = sum(v.dim() == 1 for v in state.optimizer.state_dict().values())
    scalars = sum(v.numel() * v.element_size() for v in state.optimizer.state_dict().values()
                  if v.dim() == 0)
    held = state.held_bytes()
    logger.info(f"fsdp={mesh.fsdp}: params {c['sharded_leaves']} leaves/"
                f"{c['sharded_bytes'] / 1e6:.1f} MB sharded, {c['replicated_leaves']} leaves/"
                f"{c['replicated_bytes'] / 1e6:.1f} MB replicated; opt state "
                f"{n_opt * c['sharded_bytes'] / 1e6:.1f} MB sharded/"
                f"{(n_opt * c['replicated_bytes'] + scalars) / 1e6:.1f} MB replicated")
    seq = f" x seq {mesh.seq}" if mesh.seq > 1 else ""
    logger.info(f"Mesh: data {mesh.data} x fsdp {mesh.fsdp}{seq}; census {json.dumps(c)}; this "
                f"process holds params {held['params']} bytes, optimizer state {held['opt']} "
                f"bytes, BN statistics {held['bn']} bytes")
    return state


def _seq_parallel(model, mesh, device) -> None:
    """``MESH.SEQ`` > 1: refuse a model with BN statistics (its token blocks
    would see different activations), as JAX does; run ``model`` over the
    seq group with ``MODEL.SEQ_ATTN``; say over which backend, and that
    gloo stages the card's tensors through host memory."""
    if seqpar.seq_size(mesh) == 1:
        return
    if next(model.buffers(), None) is not None:
        raise ValueError(f"MESH.SEQ > 1 requires a BatchNorm-free model (vit_*/mae_*): "
                         f"{cfg.MODEL.ARCH} carries batch_stats")
    seqpar.set_seq(model, mesh.seq_group, cfg.MODEL.SEQ_ATTN)
    backend = dist.get_backend(mesh.seq_group)
    staged = ("; gloo stages the exchanges' and all-to-alls' CUDA tensors through host memory"
              if device.type == "cuda" and backend == "gloo" else "")
    logger.info(f"Sequence parallel: {mesh.seq} processes a group, {cfg.MODEL.SEQ_ATTN} "
                f"attention over {backend}{staged}")


def _log_activations(model, mesh) -> None:
    """A transformer model's activation census a process, as one line and
    as JAX's ``activation_bytes`` record."""
    geometry = [getattr(model, a, None) for a in ("patch", "dim", "depth", "mlp_dim")]
    if None in geometry:
        return
    patch, dim, depth, mlp_dim = geometry
    l_global = (cfg.TRAIN.IM_SIZE // patch) ** 2 + (getattr(model, "pool", None) == "token")
    c = seqpar.activation_bytes(batch_per_device=cfg.TRAIN.BATCH_SIZE, l_global=l_global,
                                seq=seqpar.seq_size(mesh), dim=dim, depth=depth, mlp_dim=mlp_dim,
                                dtype_bytes=2 if cfg.MODEL.DTYPE == "bfloat16" else 4)
    logger.info(f"Activation census: {json.dumps(c)}")
    obs.current().event("activation_bytes", **c)


def _sync_bn(model, group) -> None:
    if cfg.MODEL.SYNCBN and group is not None:
        for m in model.modules():
            if isinstance(m, layers.BatchNorm):
                m.sync_group = group


def _build_qat(model, mesh, device):
    """Calibrate the ``QUANT.QAT`` fake-quant sites on ``model``'s weights
    (JAX's ``_build_qat``): ``QUANT.CALIB_BATCHES`` standard-normal NHWC
    batches from ``QUANT.CALIB_SEED`` (the post-normalization scale a
    training batch has), on ``device``, through ``quant.calibrate_qat``
    (eval mode; the model returns to its mode untouched). The mode is
    checked first, then the mesh and the task, with JAX's messages, then
    the arch (ResNet family and DenseNet, else item 8c). Journals the
    ``qat`` record. Returns the ``quant.QATModel``."""
    from distribuuuu_tpu_torch.quant import qat as qat_mod

    try:
        qat_mod._check_mode(cfg.QUANT.QAT_MODE)
    except ValueError as exc:
        raise ValueError(f"QUANT.QAT_MODE: {exc}") from None
    if mesh.fsdp > 1:
        raise ValueError("QUANT.QAT requires MESH.FSDP 1: the calibration pass runs on the "
                         "unsharded weights (fine-tune the model data-parallel)")
    if mesh.seq > 1 or cfg.TRAIN.TASK == "mae":
        raise ValueError("QUANT.QAT requires MESH.SEQ 1 and TRAIN.TASK 'classify' (fine-tune "
                         "the classifier data-parallel)")
    tic = time.time()
    rng = np.random.default_rng(cfg.QUANT.CALIB_SEED)
    shape = (cfg.QUANT.CALIB_BATCH_SIZE, cfg.TRAIN.IM_SIZE, cfg.TRAIN.IM_SIZE, 3)
    batches = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
               for _ in range(cfg.QUANT.CALIB_BATCHES)]
    qat = qat_mod.calibrate_qat(model, batches, mode=cfg.QUANT.QAT_MODE, arch=cfg.MODEL.ARCH)
    wall = time.time() - tic
    obs.current().event("qat", mode=cfg.QUANT.QAT_MODE, layers=qat.n_sites,
                        calib_batches=cfg.QUANT.CALIB_BATCHES,
                        distill=float(cfg.QUANT.QAT_DISTILL), wall_s=round(wall, 3),
                        im_size=cfg.TRAIN.IM_SIZE)
    logger.info(f"QUANT.QAT: {cfg.QUANT.QAT_MODE} fake-quant fine-tune over {qat.n_sites} "
                f"conv/dense site(s) (calibrated in {wall:.2f}s, distill weight "
                f"{cfg.QUANT.QAT_DISTILL})")
    return qat


def _pin_device(device: torch.device):
    """The device whose context the loader pins its batches in
    (TRAIN.PIN_MEMORY on a card), else None."""
    return device if cfg.TRAIN.PIN_MEMORY and device.type == "cuda" else None


def _log_input(*loaders) -> None:
    """One line a loader: its images, batches, where it decodes (here, or
    the dataplane service and its pool) and the decoder backend."""
    for ld in loaders:
        if isinstance(ld, HostDataLoader) or hasattr(ld, "address"):
            if hasattr(ld, "address"):  # a dataplane ServiceLoader
                pool = ld.pool
                where = (f"service {ld.address} ({pool.get('workers', '?')} DATA.WORKERS x "
                         f"{pool.get('worker_threads', '?')} threads)")
            else:
                where = f"{ld.workers} workers"
            logger.info(f"Input: {'train' if ld.train else 'val'} {len(ld.dataset)} images "
                        f"({ld.shard_size} in this process's shard, {len(ld)} batches of "
                        f"{ld.host_batch}) from {ld.dataset.root}; decoder: {ld.decoder}; "
                        f"{where}; pinned: {ld.pin_device is not None}")


def _input_tail(loader) -> str:
    """Where ``loader``'s batches came from, for the end of an epoch's line."""
    if hasattr(loader, "address"):  # a dataplane ServiceLoader
        return f"; input: service {loader.address}, {loader.fallbacks} fallback(s)"
    return "; input: local"


def train_model(device=None):
    """A full training run on ``device`` (None: the card). Returns
    ``(state, best_acc1)``."""
    info, mesh = _setup(device, journal=True)
    gen = setup_seed(cfg.RNG_SEED, info.rank, info.group, info.device)
    if info.is_primary:
        dump_cfg()
    resilience.reset_run_stats()
    # a flag left by an earlier preempted run in this process must not stop this one
    resilience.clear_preemption()
    if cfg.FAULT.HANDLE_SIGNALS:
        resilience.install_preemption_handler()
    # telemetry opens before the model is built; ranks but 0 get the inert handle
    obs.start_run(cfg.OUT_DIR, is_primary=info.is_primary, device=info.device,
                  devices=info.world_size, batch_ranks=seqpar.batch_device_count(mesh))
    if cfg.OBS.ENABLED and cfg.OBS.PROFILE_SIGUSR1 and info.is_primary:
        obs.install_sigusr1_handler()
    try:
        return _train(info, mesh, gen)
    finally:
        resilience.uninstall_preemption_handler()
        obs.end_run(clean=False)  # a run that failed before its epochs; else a no-op


def _train(info, mesh, gen):
    # the step's FLOPs for MFU, counted on the meta device (nothing launches)
    # before the run's model is built and the watchdog armed: the count's
    # first call takes seconds
    obs.current().capture_step_cost()
    injector = resilience.FaultInjector()
    if injector.active:
        logger.warning(f"FAULT INJECTION active: io_indices={sorted(injector.io_indices)} "
                       f"(failures={injector.io_failures}), nan_steps="
                       f"{sorted(injector.nan_steps)}, preempt_step={injector.preempt_step}, "
                       f"hang_step={injector.hang_step}, kill_step={injector.kill_step}")
    model = build_cfg_model(gen)
    _check_crop(model)
    model = model.to(info.device)
    _sync_bn(model, info.group)
    _seq_parallel(model, mesh, info.device)
    state = _train_state(model, info, mesh)
    _log_activations(model, mesh)
    state.dropout_seed = gen.initial_seed()  # a mid-epoch resume replaces it with the saved one
    # the samples a step consumes over the batch ranks: the unit of the elastic remap
    samples_per_step = (cfg.TRAIN.BATCH_SIZE * cfg.TRAIN.ACCUM_STEPS
                        * seqpar.batch_device_count(mesh))
    logger.info(f"Processes: {info.world_size} (rank 0 on {info.device}), global batch "
                f"{samples_per_step}")
    logger.info(f"Model:\n{cfg.MODEL.ARCH}")
    logger.info(f"Params(M): {count_parameters(model):.3f}")
    train_loader = construct_train_loader(mesh.batch_world, mesh.batch_rank,
                                          _pin_device(info.device))
    val_loader = construct_val_loader(mesh.batch_world, mesh.batch_rank, _pin_device(info.device))
    _log_input(train_loader, val_loader)
    start_epoch, start_step, best_acc1 = 0, 0, 0.0
    res = None
    if cfg.TRAIN.AUTO_RESUME:
        # the supervisor's poison escalation rides the env var (it never edits YAMLs)
        rollback = int(os.environ.get("DTPU_RESUME_ROLLBACK", cfg.RESUME.ROLLBACK))
        if rollback > 0:
            logger.warning(f"Auto-resume with rollback depth {rollback}: the {rollback} most "
                           f"advanced known-good checkpoint(s) will be skipped")
        res = ckpt.restore_latest(cfg.OUT_DIR, state, step_granular=cfg.RESUME.STEP_GRANULAR,
                                  verify_integrity=cfg.RESUME.VERIFY_INTEGRITY,
                                  skip_corrupt=cfg.RESUME.SKIP_CORRUPT,
                                  samples_per_step=samples_per_step, rollback=rollback)
        if res is not None:
            start_epoch, start_step, best_acc1, path = res
            obs.current().event("resume", path=path, epoch=start_epoch, step=start_step,
                                best_acc1=float(best_acc1))
            logger.info(f"Resumed from {path} (epoch {start_epoch}, step {start_step}, best "
                        f"{best_acc1:.3f})")
    if res is None and cfg.MODEL.WEIGHTS:
        ckpt.load_checkpoint(cfg.MODEL.WEIGHTS, state, load_opt=cfg.TRAIN.LOAD_OPT)
        logger.info(f"Warm-started weights from {cfg.MODEL.WEIGHTS}")
    elif res is None and cfg.MODEL.PRETRAINED:
        path = _load_pretrained(state)
        logger.info(f"Initialized from pretrained weights ({cfg.MODEL.ARCH}) at {path}")
    # calibrated on the weights the run trains: after the resume or warm start
    qat = _build_qat(model, mesh, info.device) if cfg.QUANT.QAT else None
    run_tic = time.time()
    # armed over train and eval (both hang when a peer dies); its first beat
    # window holds the first steps' cuDNN autotuning: HANG_TIMEOUT_S must cover it
    resilience.start_watchdog(cfg.FAULT.HANG_TIMEOUT_S)
    try:
        for epoch in range(start_epoch, cfg.OPTIM.MAX_EPOCH):
            train_epoch(train_loader, state, epoch, info.device, info.is_primary,
                        start_epoch=start_epoch, run_tic=run_tic,
                        start_step=start_step if epoch == start_epoch else 0,
                        best_acc1=best_acc1, injector=injector, qat=qat)
            acc1, _ = validate(val_loader, model, info.device, info.is_primary, info.group,
                               seq=mesh.seq, epoch=epoch, qat=qat)
            is_best = acc1 > best_acc1
            best_acc1 = max(acc1, best_acc1)
            resilience.watchdog_beat(phase="checkpoint")
            ck_tic = time.time()
            opt = state.full_optimizer_state()  # every rank: a gather under fsdp
            if info.is_primary:
                path = ckpt.save_checkpoint(cfg.OUT_DIR, epoch, state, best_acc1, is_best,
                                            optimizer=opt)
                if cfg.OBS.TRAIN_SPANS:  # the epoch boundary's checkpoint phase
                    tel = obs.current()
                    tel.span(tel.trace_tag(f"ck{epoch}"), "checkpoint",
                             1000.0 * (time.time() - ck_tic), epoch=epoch)
                logger.info(f"Saving checkpoint: {path} (best Acc@1 {best_acc1:.3f})")
    finally:
        # disarmed first: a finished or failing run must not be killed by its own watchdog
        resilience.stop_watchdog()
        # the journal gets its run_end on every way out: clean, preempted, diverged or crashed
        obs.end_run(best_acc1=best_acc1, epochs=cfg.OPTIM.MAX_EPOCH,
                    clean=sys.exc_info()[0] is None)
    if info.is_primary:  # every epoch checkpoint written: the emergency ones are dominated
        ckpt.prune_mid_checkpoints(cfg.OUT_DIR, before_epoch=cfg.OPTIM.MAX_EPOCH)
    return state, best_acc1


def test_model(device=None):
    """Evaluate ``MODEL.WEIGHTS`` (a checkpoint) on the val loader, through
    the fake-quant forward under ``QUANT.QAT`` (calibrated on the weights
    loaded); returns ``(acc1, acck)``."""
    info, mesh = _setup(device)
    model = build_cfg_model(torch.Generator().manual_seed(0))
    _check_crop(model)
    model = model.to(info.device)
    _seq_parallel(model, mesh, info.device)
    state = _train_state(model, info, mesh)
    logger.info(f"Params(M): {count_parameters(model):.3f}")
    if cfg.MODEL.WEIGHTS:
        ckpt.load_checkpoint(cfg.MODEL.WEIGHTS, state, load_opt=False)
        logger.info(f"Loaded weights from {cfg.MODEL.WEIGHTS}")
    elif cfg.MODEL.PRETRAINED:
        path = _load_pretrained(state)
        logger.info(f"Loaded pretrained weights ({cfg.MODEL.ARCH}) from {path}")
    qat = _build_qat(model, mesh, info.device) if cfg.QUANT.QAT else None
    val_loader = construct_val_loader(mesh.batch_world, mesh.batch_rank, _pin_device(info.device))
    _log_input(val_loader)
    return validate(val_loader, model, info.device, info.is_primary, info.group, seq=mesh.seq,
                    qat=qat)
