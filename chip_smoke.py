#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --profile-only   # build, then phase 5/6's latency and profile
                                           # and phase 8's K6/K7 timings only

The option exists to compare two trees in one call: copied into an older
checkout and run from its root, the file profiles that checkout's serving
path and times its MoE kernels through their public entry points, beside
this one's on the same card.

Phases (any failure exits non-zero):

1. device: the card's name and power limit (``nvidia-smi``); no CUDA -> fail;
2. build: the fused conv-epilogue kernel (K1, ``ops/csrc/epilogue.cu``),
   the fused attention kernel (K2-K5, ``ops/csrc/attention.cu``) and the MoE
   kernels (K6/K7, ``ops/csrc/moe.cu``), one nvcc each, started together,
   with nvcc's register and spill report;
3. [k1] K1 against its plain PyTorch version (bitwise, ``torch.equal``) at
   every K1 site of a ResNet-50 and of a BoTNet-50 forward at batch 128,
   224x224 (recorded from the models on the meta device,
   :func:`epilogue_sites`; the downsample BNs and BoTNet's 14x14x2048 BoT
   blocks included), x bf16 -> f32 in each mode (a: the f32 boundary, b:
   the next conv's bf16 input, c: both) and bf16 -> bf16, timed with CUDA
   events as device time (at least 10 calls replayed from a CUDA graph,
   cycling through enough input sets that a replay moves 128 MiB, beyond
   the L2), over 10 back-to-back calls and over one call from an idle
   stream, beside the plain version, the ``F.batch_norm`` composition of
   the same outputs and the bytes bound of the mode; the scalar route (C
   36, a misaligned view);
4. the attention kernel (bf16: tensor cores; f32: scalar) against its
   single-tile and its blockwise plain version at the shapes the BoTNet
   paths give it (K2: B*N 512, L 196; K4: B*N 32, L 1024; the table mode
   K3/K5 at both; K2's shape with an f32 bias; bf16 and f32 at a small
   ragged shape), timed (10 back-to-back calls, and one call from an idle
   stream) beside the plain version, ``F.scaled_dot_product_attention`` and
   the bytes/FLOP bound, with the TFLOP/s reached; then [attention-bwd]: the
   attention backward kernels (dq, dk, dv, dbias; the custom_vjp of K2/K4)
   against ``attention_backward_reference`` at BoTNet-50 training's shape
   (B*N 128, L 196), at B*N 512, at K4's B*N 32, L 1024, with an f32 bias,
   in f32, and at a small ragged shape; the table mode (dq, dk, dv, demb;
   K3/K5's custom_vjp) against ``attention_table_backward_reference`` at
   K3's training shapes (B*N 128 and 512, L 196), K5's (B*N 32, L 1024), in
   f32 and ragged; two calls bitwise equal, each call's route (bf16 at
   L <= 256: the one-launch cluster kernel; bf16 above: the three-launch
   blockwise kernels; f32: scalar) and launches; the training shapes (B*N
   32 and 128 at L 196; B*N 32 and 128 at L 1024, the 512^2 step's) timed
   as device time past the L2, back to back and as a single call, with each
   CUDA kernel's device µs from the profiler, beside the plain version, the
   backward of ``F.scaled_dot_product_attention`` with the bias needing a
   gradient (table mode: autograd through ``einsum(q, emb)`` and SDPA) and
   the bytes/FLOP bound;
5. serve ResNet-50: ``config/serve_resnet50.yaml`` at full width (224, 1000
   classes, bf16, uint8 wire, ladder [1, 8, 32, 128]) on seeded random
   weights; mixed-size concurrent requests through ``ServeReplica.handle``
   plus one HTTP round trip; every forward must launch K1 53 times (every
   BN), none on the scalar route; each response must equal the direct
   forward of its images; f32 card vs f32 CPU and bf16 serve vs f32
   tolerances; per-ladder-size latency;
   profile by kernel class (K1 against its bound, copy/cast, convs, ...);
6. serve BoTNet-50: the same config with ``MODEL.ARCH botnet50``; every
   forward must launch the attention kernel 3 times and K1 53 times; the
   same checks, and a profile with an attention class;
7. large crop: botnet50 at 512x512, batch 8 (L 1024, the K4 route), f32
   card vs f32 CPU on 2 images and bf16 vs f32; ``MHSA(rel_pos_emb=False)``
   at full width (batch 128, fmap 14x14) and at fmap 32x32, card vs CPU
   (the K3/K5 route), then its forward + backward at both: f32 card vs CPU
   gradients, bf16 gradients of the tables and ``to_qk`` finite and non-zero,
   the backward's launches by route;
8. [moe-kernels] the switch-MoE dispatch (K6) and combine (K7) kernels
   (``ops/csrc/moe.cu``) against their plain versions on the card: the soak's
   per-device shard (N 8192, D 128, E 8, C 1280) and the Switch-Transformer-
   Base width (D 768), x f32 and bf16, the shard ``switch_moe`` gets in
   phase 9, a ragged N, one and two tiles, capacity 1 and the forced
   overflow boundary; bitwise on dyadic inputs, near-ties only on continuous
   ones; at the timed shards their backward kernels against the plain
   backward (d_back bitwise, the rest within 1e-5 of max|grad|), gradients
   of the soak's loss against autograd through the plain versions, one
   launch of each kernel per forward + backward (the profiler's kernel
   names), dispatch + combine captured in a CUDA graph and replayed bitwise
   equal to eager, two dispatches of one input bitwise equal; each kernel
   timed as device time (a CUDA-graph replay cycling through input sets
   past the L2), back to back and as a single call, with the wrappers' host
   µs, beside the plain versions, an eager index-op composition and the
   bytes bound;
9. [moe-dist] ``switch_moe`` forward and backward on 8 ranks (one expert
   each) sharing the card in a ``gloo`` group, N 4096 tokens per rank, D 128,
   C 640, then the same ranks on the CPU (plain versions): loss, aux, out,
   routing and gradients must agree, and every rank must launch K6, K7 and
   their backward kernels once each;
10. [k1-bwd] (after [k1]) K1's backward kernel against its plain version
   (autograd through ``epilogue_reference``) at every K1 site of a ResNet-50
   training step at batch 128, 224^2 (bf16 boundaries: the training modes,
   from :func:`epilogue_sites`) and at the served model's sites with f32
   boundaries in their modes: d_x and d_identity bitwise, the per-channel
   sums within K1_BWD_SUM_RTOL of sum|terms|, two calls bitwise equal; timed
   at the training sites as [k1] is, beside the plain version, autograd
   through the ``F.batch_norm`` composition and the bytes bound;
11. [train] ``python -m distribuuuu_tpu_torch.train_net --cfg
   config/resnet50.yaml MODEL.DUMMY_INPUT True TRAIN.BATCH_SIZE 128`` for 40
   steps as a subprocess: the loss finite and falling, 53 K1 and 53 K1-bwd
   launches a step (none on the scalar route), a checkpoint verified against
   its manifest, ``test_net`` on it, a relaunch that resumes from it; step ms,
   images/s and the profile of 3 steps by kernel class; then one f32
   ResNet-18 step at 64^2, card vs CPU;
12. [train-bot] ``python -m distribuuuu_tpu_torch.train_net --cfg
   config/botnet50.yaml MODEL.DUMMY_INPUT True`` (224^2, bf16, batch 32) for
   35 steps as a subprocess: the loss finite and falling, 53 K1, 53 K1-bwd,
   3 attention and 3 attention-backward calls a step (none scalar, every
   backward call on the cluster route), the
   checkpoint's manifest, ``test_net`` on it, step ms, images/s and the
   profile of 3 steps by kernel class (attention and attention-bwd among
   them); then one f32 BoTNet-50 step at 64^2, card vs CPU;
13. [train-bot-512] ``python -m distribuuuu_tpu_torch.train_net --cfg
   config/botnet50.yaml MODEL.DUMMY_INPUT True TRAIN.IM_SIZE 512`` with the
   eval crop at 512 too (``TEST.IM_SIZE 512 TEST.CROP_SIZE 512``: the
   position tables are sized by the training crop, and the trainer refuses
   another eval crop, as the JAX one does) for BOT512_STEPS steps at batch
   BOT512_BATCH: L 1024 in the three BoT blocks, so 3 attention calls a step
   on K4's route and 3 backward calls on the blockwise route, none scalar
   and none on the cluster route, beside 53 K1 and 53 K1-bwd; the loss
   finite and falling, the checkpoint, ``test_net`` on it, step ms,
   images/s and the profile of 3 steps by kernel class, attention-bwd µs a
   step against its bound;
14. [input] a JPEG ImageFolder written from a seed (4096 train and 512 val
   images over 100 classes, 500x375, quality 90, ~110 KB a file), then the
   port's ``HostDataLoader`` alone: train-transform images/s at 224^2,
   batch 128, pinned, at TRAIN.WORKERS 4 and min(32, cpu count), the
   decoder backend, the time to pin a batch;
15. [train-jpeg] ``python -m distribuuuu_tpu_torch.train_net --cfg
   config/resnet50.yaml TRAIN.DATASET <that folder> TRAIN.BATCH_SIZE 128
   OPTIM.MAX_EPOCH 1``: 32 steps on real JPEG decode, the loss finite, 53
   K1 and 53 K1-bwd launches a step, the val pass over exactly the 512 val
   images in padded batches of 200; step ms, images/s, the Data meter's
   share, the profile of 3 steps beside [train]'s;
16. [train-dataplane] ``python -m distribuuuu_tpu_torch.dataplane`` (DP_POOL
   decode worker processes x threads) beside [train-jpeg]'s command with
   ``DATA.SERVICE 127.0.0.1:<port> DATA.FALLBACK False``: the same checks,
   the val pass through the service, zero fallbacks, no CUDA context in the
   service's processes, the first train batches through a ``ServiceLoader``
   bitwise the local loader's, and the decode rate the service sustains
   alone over uncached epochs (the step cannot show it: its windows read
   the lead decoded while the trainer started); step ms, the profile and
   the service's cache and lease counters beside [train-jpeg] and [train];
   the service stopped and its workers reaped in any case;
17. [oracle] the digits recipe of ``tutorial/real_data_oracle.py`` through
   ``train_net`` on ``config/resnet18.yaml`` (5 epochs, 1497 train and 300
   val JPEGs): val Acc@1 and Acc@5 an epoch; fails below the band of 65;
18. [train-preempt] [train]'s command with ``CUDNN.DETERMINISTIC True`` over
   2 epochs of PREEMPT_STEPS steps, each run a subprocess: one uninterrupted
   run; one sent a real SIGTERM once its log shows a step of epoch 2, which
   must exit 143 leaving a ``ckpt_mid_ep_001_it_*`` that verifies against
   its manifest, after 53 K1 and 53 K1-bwd launches a step; its relaunch,
   which must log ``Resumed from ... (epoch 1, step S`` and end with model
   and optimizer tensors ``torch.equal`` to the uninterrupted run's; then
   ``FAULT.INJECT_HANG_STEP 3`` under a ``FAULT.HANG_TIMEOUT_S`` just above
   the first window, which must exit 124 within the timeout and a margin
   of the hang, every thread's stack in the rank log. The emergency save's
   ms and bytes, the relaunch's time to its first step and the steps run
   after the signal, beside the card's name and power limit;
19. [train-zoo] the rest of the classification zoo through ``train_net`` at
   full width, 224^2, bf16, batch 64 (each config's), ZOO_STEPS steps:
   DenseNet-121 (``config/resnet50.yaml MODEL.ARCH densenet121
   MODEL.STEM_S2D False``), RegNetY-16GF, EfficientNet-B0 (drop path and
   dropout from the trainer's stream) and ViT-B/16 (LAMB), each on its
   config: the loss finite and falling, K1 and K1-bwd 121 / 59 / 49 / 0
   times a step (every BN), none scalar, the checkpoint, ``test_net`` on
   it, step ms, images/s, peak memory and the profile of 3 steps by kernel
   class beside K1's and K1-bwd's bound from the step's sites;
20. [zoo f32] (after 21) each of those families at full width, 64^2, batch 8: the f32
   eval forward card vs CPU (F32_REL_TOL of max|logit|) and one f32 step
   card vs CPU ([train]'s and [train-bot]'s limits), every BN one K1 and
   one K1-bwd launch; then served by the engine in bf16 at 224^2 on
   [serve]'s seeded weights against the CPU's f32 forward (BF16_REL_TOL, or
   no farther than the JAX package's own bf16 forward: ZOO_BF16_JAX_GAP);
21. [train-mae] ``python -m distribuuuu_tpu_torch.train_net --cfg
   config/mae_vit_b16.yaml MESH.FSDP 1 MESH.SEQ 1 MODEL.DUMMY_INPUT True``:
   ViT-B/16 MAE at the YAML's 448^2 (784 tokens), batch 8, REMAT on, LAMB,
   MAE_STEPS steps: the masked patches' MSE finite and falling, no K1 or
   attention launch (MAE is cuBLAS and eager ops), the checkpoint,
   ``test_net`` on it (a finite masked MSE), step ms, images/s, peak memory
   and the profile of 3 steps;
22. [pretrained] a seeded ResNet-50 written as a torchvision ``.pth``,
   provisioned by ``python -m distribuuuu_tpu_torch.convert`` (and botnet50
   ``--from-resnet50`` from it), each directory verified and bitwise its
   source; ``test_model`` with ``MODEL.PRETRAINED True`` in this process,
   its logits bitwise those of ``MODEL.WEIGHTS`` on the same directory, and
   ``test_net MODEL.PRETRAINED True`` as a subprocess;
23. the ``test_net`` runs of [train], [train-bot], [train-bot-512],
   [train-zoo], [train-mae] and [pretrained] (each on its phase's
   checkpoint), concurrently, after the last timed training phase: each
   must exit 0 reporting Acc@1 (and [train-mae]'s a finite masked MSE);
24. [mae f32] (after [zoo f32]) MAE-ViT-B/16 at full width, 64^2, batch 2,
   f32, card vs CPU under one mask: eval predictions within F32_REL_TOL of
   max|pred|, one LAMB step's update within MAE_F32_UPDATE_RL2;
25. [remat] ``MODEL.REMAT`` on against off in this process, cuDNN
   deterministic, two steps from one state of ResNet-50 b32, BoTNet-50 b8
   (the attention kernel and its backward under recompute),
   EfficientNet-B0 b16 (drop path and dropout from the trainer's stream) and
   MAE-ViT-B/16 at 448^2 b8: parameters, optimizer state and BN statistics
   ``torch.equal``; K1 twice and K1-bwd once a step for every BN inside a
   recomputed block, the attention kernel twice and its backward once, none
   scalar; peak memory and step ms both ways, and remat must lower MAE's
   peak;
26. the whole run's wall time and each phase's, the ``{"kernels": [...]}``
   line; 27. the ``{"ok": true, ...}`` last line.

Each path is driven with the launch counts set to 0 just before it and read
just after. Per-shape numbers are also written to ``smoke_out/``.
"""

from __future__ import annotations

import base64
import importlib.util
import itertools
import json
import math
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SERVE_CFG = ROOT / "config" / "serve_resnet50.yaml"
LADDER_BATCH = 128
IM = 224
# bf16 serve logits vs f32 logits, relative to max|logit|: bf16 keeps 8
# mantissa bits (relative rounding 2^-9 ~ 2e-3 per op); over ~50 layers the
# errors add roughly as a random walk, to about 1e-2. 5e-2 leaves headroom
# while still catching a wrong layer, which moves logits by O(1).
BF16_REL_TOL = 5e-2
# f32 on the card (TF32 off) vs f32 on the CPU: only summation order differs.
F32_REL_TOL = 1e-3
# One MHSA layer, f32 card vs f32 CPU: one conv and one attention of
# summation-order differences, ~1e-6 relative; 1e-4 still catches any
# wrong index, which moves outputs by O(1).
MHSA_F32_REL_TOL = 1e-4
# Attention kernel vs its plain versions, relative to max(1, max|out|).
# ATTN_TOL, against the single-tile plain version: f32 differs in summation
# order only (the JAX tests' 2e-5); in bf16 the kernel casts p to bf16 before
# normalising (as the TPU's blockwise kernel) and the plain version after (as
# the single-tile one): the two differ by up to one bf16 rounding of p (2^-9
# relative) and of the output (2^-8 near 1), ~4e-3; 2e-2 is the JAX tests'
# bf16 bound. ATTN_BLOCKWISE_TOL, against the blockwise plain version, which
# rounds where the kernel does: only the f32 summation order of the logits,
# of l and of acc differs, so an output lands at most one bf16 ulp away
# (2^-7 = 7.8e-3 of max(1, max|out|)) where the two f32 values straddle a
# rounding boundary, plus the rare p whose own bf16 rounding flips (2^-8 p
# |v| / l): 1e-2, half the single-tile bound.
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
ATTN_BLOCKWISE_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
# the served models and the launches each of their forwards must make (K1:
# every BN)
SERVED = {"resnet50": dict(name="rn50", k1=53, attention=0),
          "botnet50": dict(name="bot", k1=53, attention=3)}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def hbm_bytes_per_s(name: str) -> float:
    """Published HBM bandwidth of the card (NVIDIA data sheets)."""
    if "H100" in name:
        return 2.0e12 if "PCIe" in name else 3.35e12
    if "H200" in name:
        return 4.8e12
    fail(f"no HBM bandwidth known for {name!r}; add it to hbm_bytes_per_s")


F32_PEAK_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
BF16_PEAK_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores


def epilogue_sites(arch: str, n: int, im: int = IM, bn_dtype=None) -> Counter:
    """(N, H, W, C, residual, relu, mode) -> K1 calls in one bf16 forward of
    ``arch`` at batch ``n``, recorded by a spy on K1 while the model runs on
    the meta device (shapes only, no data; the attention returns an empty
    tensor of its shape). mode: a (the BN boundary), b (the next conv's
    input), c (both). ``bn_dtype``: the boundaries' dtype (None: f32, as
    served; bf16: as trained, where b and c are one tensor)."""
    import torch

    from distribuuuu_tpu_torch.models import botnet, build_model, layers
    from distribuuuu_tpu_torch.ops import epilogue as ep

    sites: Counter = Counter()

    def k1(x, mean, mul, bias, identity=None, **kw):
        mode = "a" if kw.get("cast_to") is None else "c" if kw.get("keep_boundary", True) else "b"
        b, c, h, w = x.shape
        sites[(b, h, w, c, identity is not None, kw["relu"], mode)] += 1
        return ep.epilogue_reference(x, mean, mul, bias, identity, **kw)

    def attention(q, k, v, bias):
        return q.new_empty((*q.shape[:-1], v.shape[-1]))

    real = layers.fused_conv_epilogue, botnet.fused_attention
    with torch.device("meta"):
        model = build_model(arch, num_classes=1000, dtype=torch.bfloat16, im_size=im,
                            bn_dtype=bn_dtype or torch.float32)
    layers.fused_conv_epilogue, botnet.fused_attention = k1, attention
    try:
        with torch.inference_mode():
            model.eval()(torch.empty(n, im, im, 3, device="meta"))
    finally:
        layers.fused_conv_epilogue, botnet.fused_attention = real
    return sites


# K1's modes as keyword arguments of fused_conv_epilogue (cast_to added per call)
K1_MODES = {"a": {}, "b": dict(keep_boundary=False), "c": {}}
K1_BATCH = 10  # calls per timing, at least (graph_ms, cuda_ms)
# Bytes one timed replay of K1 touches at least: 2.5 x the H100's 50 MB L2,
# so no call finds in the L2 what an earlier call of the replay left there
# and the time is that of HBM streaming (k1_rotation).
K1_ROTATE_BYTES = 128 << 20


def k1_kwargs(mode: str, relu: bool, bn_dtype, cast_to) -> dict:
    return dict(K1_MODES[mode], relu=relu, bn_dtype=bn_dtype,
                cast_to=None if mode == "a" else cast_to)


def k1_bound(site, bw: float, items=(2, 4, 4, 2)) -> tuple[float, int, str]:
    """(bound ms, bytes, what bounds it) of one K1 call at ``site``: x and
    the residual read once, the boundary (modes a, c) and the cast (modes b,
    c) written once, the three f32 [C] vectors; 3-5 f32 operations per
    element. ``items``: bytes per element of x, residual, boundary and cast
    (serving: bf16, f32, f32, bf16)."""
    n, h, w, c, res, relu, mode = site
    elems = n * h * w * c
    x_b, res_b, out_b, cast_b = items
    nbytes = elems * (x_b + (res_b if res else 0) + (out_b if mode != "b" else 0)
                      + (cast_b if mode != "a" else 0)) + 3 * c * 4
    flops = elems * (3 + int(relu) + int(res))
    by = "bytes" if nbytes / bw >= flops / F32_PEAK_FLOPS else "operations"
    return 1e3 * max(nbytes / bw, flops / F32_PEAK_FLOPS), nbytes, by


def k1_rotation(nbytes: int) -> tuple[int, int]:
    """(input sets, calls) for timing a K1 call that moves ``nbytes``: the
    calls cycle through the sets, each writes outputs of its own, and a
    set comes round again only after K1_ROTATE_BYTES of other traffic."""
    sets = -(-K1_ROTATE_BYTES // nbytes)
    return sets, max(K1_BATCH, sets)


def k1_inputs(n, h, w, c, res, bn_dtype, gen, offset: int = 0):
    """Seeded K1 arguments on the card: bf16 x and a ``bn_dtype`` residual
    as channels-last NCHW views of NHWC tensors ``offset`` elements into
    their allocation, and the three f32 vectors."""
    import torch

    def nhwc(dtype):
        t = torch.randn(n * h * w * c + offset, generator=gen, device="cuda").to(dtype)
        return t[offset:].view(n, h, w, c).permute(0, 3, 1, 2)

    x = nhwc(torch.bfloat16)
    mean = torch.randn(c, generator=gen, device="cuda") * 0.1
    mul = torch.rand(c, generator=gen, device="cuda") + 0.5
    bias = torch.randn(c, generator=gen, device="cuda") * 0.1
    return x, mean, mul, bias, nhwc(bn_dtype) if res else None


def k1_check(ep, args, kw, what: str) -> float:
    """One K1 call against its plain version: dtype, layout and bits of
    every output. Returns max|kernel - plain| over the outputs."""
    import torch

    got, want = ep.fused_conv_epilogue(*args, **kw), ep.epilogue_reference(*args, **kw)
    torch.cuda.synchronize()
    pairs = list(zip(got, want)) if isinstance(want, tuple) else [(got, want)]
    err = 0.0
    for g, w in pairs:
        if g.dtype != w.dtype or not g.is_contiguous(memory_format=torch.channels_last):
            fail(f"K1 output dtype/layout wrong at {what}")
        d = (g.float() - w.float()).abs().max().item()
        if not torch.equal(g, w):
            fail(f"K1 != plain at {what}: max|d|={d}")
        err = max(err, d)
    return err


def cycling(fns):
    """A zero-argument callable that calls ``fns`` in turn, one per call."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def phase_k1(card: str, sites: dict):
    """K1 vs plain at every site of the served models' forwards at batch
    128 (``sites``: arch -> Counter, from :func:`epilogue_sites`), in every
    mode, timed three ways: device time (the calls replayed from a CUDA
    graph), 10 calls back to back, and one call from an idle stream (the
    last two carry the wrapper's host cost, which sets them where the kernel
    is shorter); beside the device times of the plain version and of the
    ``F.batch_norm`` composition of the same outputs, and the bytes bound.
    Every timing cycles through enough input sets that a replay outruns the
    L2 (:func:`k1_rotation`). Then the scalar route. Returns (rows, scalar
    route, max|kernel - plain| over every call checked)."""
    import torch
    import torch.nn.functional as F

    from distribuuuu_tpu_torch.ops import epilogue as ep

    bw = hbm_bytes_per_s(card)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, err = [], 0.0
    combos = [("bf16->f32", torch.float32, "abc", (2, 4, 4, 2)),
              ("bf16->bf16", torch.bfloat16, "a", (2, 2, 2, 2))]
    shapes = sorted({s[:6] for by_site in sites.values() for s in by_site})
    for n, h, w, c, res, relu in shapes:
        for label, bn_dtype, modes, items in combos:
            # sized by mode b, which moves the least: every mode's replay, and the
            # plain version's and F.batch_norm's, then moves K1_ROTATE_BYTES or more
            sets, calls = k1_rotation(k1_bound((n, h, w, c, res, relu, "b"), bw, items)[1])
            inputs = [k1_inputs(n, h, w, c, res, bn_dtype, gen) for _ in range(sets)]
            # yardstick only: var + eps ~ 1, so F.batch_norm applies ~mul
            var = torch.full((c,), 1.0 - 1e-5, device="cuda")
            for mode in modes:
                site = (n, h, w, c, res, relu, mode)
                kw = k1_kwargs(mode, relu, bn_dtype, torch.bfloat16)
                err = max(err, k1_check(ep, inputs[0], kw, f"{site} {label}"))

                def library(x, mean, mul, bias, identity, mode=mode):
                    y = F.batch_norm(x.float(), mean, var, mul, bias, False, 0.0, 1e-5)
                    y = y.to(bn_dtype)
                    if identity is not None:
                        y = y + identity
                    if relu:
                        y = y.relu_()
                    if mode == "a":
                        return y
                    cast = y.to(torch.bfloat16)
                    return (y, cast) if mode == "c" else cast

                def calls_of(fn, kw=kw):
                    return [lambda a=inputs[i % sets]: fn(*a, **kw) for i in range(calls)]

                kernel = calls_of(ep.fused_conv_epilogue)
                device_ms = graph_ms(kernel)
                ms = cuda_ms(cycling(kernel), batch=K1_BATCH)
                single_ms = cuda_ms(cycling(kernel))
                plain_ms = graph_ms(calls_of(ep.epilogue_reference), runs=5)
                lib_ms = graph_ms(calls_of(library, {}), runs=10)
                bound_ms, nbytes, bound_by = k1_bound(site, bw, items)
                mult = {arch: by_site[site] if label == "bf16->f32" else 0
                        for arch, by_site in sites.items()}
                rows.append(dict(
                    n=n, h=h, w=w, c=c, residual=res, relu=relu, mode=mode, combo=label,
                    launches_per_forward=mult, input_sets=sets, calls=calls, device_ms=device_ms,
                    ms=ms, single_call_ms=single_ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by))
                say(f"[k1] N{n} {h}x{w} C{c} res={int(res)} relu={int(relu)} {label} mode {mode} "
                    f"per forward {mult}: equal; device {device_ms:.4f} ms "
                    f"({100 * bound_ms / device_ms:.0f}% of bound {bound_ms:.4f}; {calls} calls over "
                    f"{sets} input sets), back-to-back {ms:.4f}, single call {single_ms:.4f}; "
                    f"plain {plain_ms:.4f}, F.batch_norm {lib_ms:.4f}")
            del inputs
    scalar, scalar_err = phase_k1_scalar(ep, gen, bw)
    torch.cuda.empty_cache()
    return rows, scalar, max(err, scalar_err)


def phase_k1_scalar(ep, gen, bw) -> tuple[dict, float]:
    """K1's scalar route, bitwise in every mode: C 36 (C % 8 != 0), and a
    ResNet-50 site's tensors 2 elements off a 16-byte boundary, timed.
    Returns the times and max|kernel - plain|."""
    import torch

    res, err = {}, 0.0
    for n, h, w, c, offset in ((8, 14, 14, 36, 0), (LADDER_BATCH, 7, 7, 2048, 2)):
        site = (n, h, w, c, True, True, "c")
        bound_ms, nbytes, _ = k1_bound(site, bw)
        sets, calls = k1_rotation(nbytes)
        inputs = [k1_inputs(n, h, w, c, True, torch.float32, gen, offset) for _ in range(sets)]
        for mode in K1_MODES:
            kw = k1_kwargs(mode, True, torch.float32, torch.bfloat16)
            before = ep.SCALAR_LAUNCHES
            err = max(err, k1_check(ep, inputs[0], kw,
                                    f"scalar route N{n} {h}x{w} C{c} offset {offset} mode {mode}"))
            if ep.SCALAR_LAUNCHES != before + 1:
                fail(f"K1 at C {c}, offset {offset} did not take the scalar route")
        kw = k1_kwargs("c", True, torch.float32, torch.bfloat16)
        ms = graph_ms([lambda a=inputs[i % sets]: ep.fused_conv_epilogue(*a, **kw)
                       for i in range(calls)])
        res[f"N{n} {h}x{w} C{c} offset {offset}"] = dict(device_ms=ms, bound_ms=bound_ms,
                                                         input_sets=sets, calls=calls)
        say(f"[k1] scalar route N{n} {h}x{w} C{c} offset {offset}: modes a/b/c equal plain; mode c "
            f"device {ms:.4f} ms (bound {bound_ms:.4f}, {100 * bound_ms / ms:.0f}% of bound; "
            f"{calls} calls over {sets} input sets)")
        del inputs
    return res, err


# K1-bwd's per-channel sums against the plain version's, relative to an upper
# bound of the sum of |terms| per channel (k1_bwd_scales): both are f32 sums of
# the same rounded products in different orders (the kernel: per-thread runs,
# a block tree, a fixed-order pass over the blocks; PyTorch: its reduction
# tree), each within a few hundred roundings (2^-24) of the sum of |terms| at
# every ResNet-50 site; 1e-5 is above that and far below a wrong term.
K1_BWD_SUM_RTOL = 1e-5
TRAIN_K1 = 53  # K1 launches per ResNet-50 training step, forward; as many K1-bwd backward


def k1_bwd_bound(site, bw: float, x_b: int = 2, res_b: int = 2, g_b: int = 2,
                 cast_b: int = 0) -> tuple[float, int, str]:
    """(bound ms, bytes, what bounds it) of one K1-bwd call at ``site``
    (N, H, W, C, residual, relu, mode): read g (``g_b`` bytes an element;
    ``cast_b`` more for a second gradient, mode c), x, and the residual
    where ReLU needs it for the mask; write d_x and d_identity (a
    residual); the per-channel vectors: mean, mul, bias read, d_mean, d_mul,
    d_bias written (6 x C x 4). The kernel's own block partials are
    scratch, not counted. About 10 f32 operations an element."""
    n, h, w, c, res, relu, _mode = site
    elems = n * h * w * c
    nbytes = elems * (g_b + cast_b + x_b + (res_b if res and relu else 0) + x_b
                      + (res_b if res else 0)) + 6 * c * 4
    flops = 10 * elems
    by = "bytes" if nbytes / bw >= flops / F32_PEAK_FLOPS else "operations"
    return 1e3 * max(nbytes / bw, flops / F32_PEAK_FLOPS), nbytes, by


def k1_bwd_scales(ep, args, grads, kw):
    """Per channel, upper bounds of sum|terms| of d_mean, d_mul and d_bias:
    the plain backward fed |g| gives sum|g1| (the ReLU mask and the
    roundings keep |.|), times |mul| and max|x - mean|."""
    x, mean, mul = args[:3]
    s = ep.epilogue_backward_reference(*args, *[None if g is None else g.abs() for g in grads],
                                       **kw)[3]
    spread = (x.float() - mean.view(1, -1, 1, 1)).abs().amax((0, 2, 3))
    return s * mul.abs(), s * spread, s


def k1_bwd_check(ep, args, grads, kw, what: str) -> tuple[float, float]:
    """K1-bwd against its plain version: d_x and d_identity bitwise, the
    sums within K1_BWD_SUM_RTOL; two calls bitwise equal. Returns (max|kernel
    - plain| over every output, worst sum error relative to its bound)."""
    import torch

    got = ep.fused_conv_epilogue_backward(*args, *grads, **kw)
    again = ep.fused_conv_epilogue_backward(*args, *grads, **kw)
    want = ep.epilogue_backward_reference(*args, *grads, **kw)
    torch.cuda.synchronize()
    for g, a in zip(got, again):
        if (g is None) != (a is None) or (g is not None and not torch.equal(g, a)):
            fail(f"K1-bwd: two calls differ at {what}")
    err = 0.0
    for name, g, w in (("d_x", got[0], want[0]), ("d_identity", got[4], want[4])):
        if (g is None) != (w is None):
            fail(f"K1-bwd {name} missing at {what}")
        if g is None:
            continue
        if g.dtype != w.dtype or not g.is_contiguous(memory_format=torch.channels_last):
            fail(f"K1-bwd {name} dtype/layout wrong at {what}")
        if not torch.equal(g, w):
            fail(f"K1-bwd {name} != plain at {what}: max|d|={(g.float() - w.float()).abs().max()}")
    worst = 0.0
    for name, g, w, sc in zip(("d_mean", "d_mul", "d_bias"), got[1:4], want[1:4],
                              k1_bwd_scales(ep, args, grads, kw)):
        err = max(err, (g - w).abs().max().item())
        rel = ((g - w).abs() / sc.clamp_min(1e-30)).max().item()
        if not rel <= K1_BWD_SUM_RTOL:
            fail(f"K1-bwd {name} at {what}: {rel:.3e} of sum|terms| (limit {K1_BWD_SUM_RTOL})")
        worst = max(worst, rel)
    return err, worst


def phase_k1_bwd(card: str, train_sites: Counter, serve_sites: Counter):
    """K1-bwd against its plain version at every K1 site of a ResNet-50
    training step at batch 128 (bf16 boundaries: ``train_sites``) and, as
    the f32-boundary case, at the served model's sites in their modes
    (``serve_sites``), timed at the training sites three ways as [k1] does
    (device time from a CUDA-graph replay over >= 128 MiB of input sets, 10
    calls back to back, one call from an idle stream), beside the plain
    version (autograd through epilogue_reference), autograd through the
    ``F.batch_norm`` composition of the same outputs (d_x, d_mul, d_bias,
    d_identity; it has no gradient for a running mean) and the bytes bound.
    Returns (rows, per-step sums, max|kernel - plain|, worst sum error)."""
    import torch
    import torch.nn.functional as F

    from distribuuuu_tpu_torch.ops import epilogue as ep

    bw = hbm_bytes_per_s(card)
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows, err, worst = [], 0.0, 0.0

    def grad_like(x, dtype):
        return torch.randn(x.shape, generator=gen, device="cuda").to(dtype).contiguous(
            memory_format=torch.channels_last)

    # the f32-boundary case: x bf16, f32 boundary and residual, the cast bf16
    for site in sorted(serve_sites):
        n, h, w, c, res, relu, mode = site
        args = k1_inputs(n, h, w, c, res, torch.float32, gen)
        kw = k1_kwargs(mode, relu, torch.float32, torch.bfloat16)
        grads = (None if mode == "b" else grad_like(args[0], torch.float32),
                 None if mode == "a" else grad_like(args[0], torch.bfloat16))
        e, r = k1_bwd_check(ep, args, grads, kw, f"{site} f32 boundary")
        err, worst = max(err, e), max(worst, r)
        del args, grads
    say(f"[k1-bwd] f32 boundaries, x bf16, cast bf16: {len(serve_sites)} sites of the served "
        f"ResNet-50 in their modes: d_x, d_identity equal plain, sums within "
        f"{worst:.2e} of sum|terms| (limit {K1_BWD_SUM_RTOL}), two calls equal")
    shapes: Counter = Counter()  # with bf16 boundaries every mode is one output: by shape
    for site, m in train_sites.items():
        shapes[(*site[:6], "a")] += m
    for site in sorted(shapes):
        n, h, w, c, res, relu, _mode = site
        kw = dict(relu=relu, bn_dtype=torch.bfloat16)
        bound_ms, nbytes, bound_by = k1_bwd_bound(site, bw)
        sets, calls = k1_rotation(nbytes)
        inputs = []
        for _ in range(sets):
            args = k1_inputs(n, h, w, c, res, torch.bfloat16, gen)
            inputs.append((args, (grad_like(args[0], torch.bfloat16), None)))
        e, r = k1_bwd_check(ep, *inputs[0], kw, f"{site} bf16")
        err, worst = max(err, e), max(worst, r)

        def calls_of(fn):
            return [lambda a=inputs[i % sets]: fn(*a[0], *a[1], **kw) for i in range(calls)]

        kernel = calls_of(ep.fused_conv_epilogue_backward)
        device_ms = graph_ms(kernel)
        ms = cuda_ms(cycling(kernel), batch=K1_BATCH)
        single_ms = cuda_ms(cycling(kernel))
        plain_ms = cuda_ms(cycling(calls_of(ep.epilogue_backward_reference)), runs=5,
                           batch=K1_BATCH)
        # yardstick: autograd through F.batch_norm (var + eps ~ 1, so it applies ~mul)
        var = torch.full((c,), 1.0 - 1e-5, device="cuda")
        graphs = []
        for (x, mean, mul, bias, ident), (g, _) in inputs[:min(sets, 4)]:
            xl, ml, bl = (t.detach().requires_grad_() for t in (x, mul, bias))
            il = None if ident is None else ident.detach().requires_grad_()
            y = F.batch_norm(xl.float(), mean, var, ml, bl, False, 0.0, 1e-5).to(torch.bfloat16)
            if il is not None:
                y = y + il
            if relu:
                y = torch.relu(y)
            leaves = [t for t in (xl, ml, bl, il) if t is not None]
            graphs.append((y, leaves, g))
        lib_ms = cuda_ms(cycling([lambda t=t: torch.autograd.grad(t[0], t[1], t[2], retain_graph=True)
                                  for t in graphs]), runs=10, batch=K1_BATCH)
        del graphs
        mult = shapes[site]
        rows.append(dict(n=n, h=h, w=w, c=c, residual=res, relu=relu, per_step=mult,
                         input_sets=sets, calls=calls, device_ms=device_ms, ms=ms,
                         single_call_ms=single_ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by))
        say(f"[k1-bwd] N{n} {h}x{w} C{c} res={int(res)} relu={int(relu)} bf16, {mult} a step: "
            f"equal; device {device_ms:.4f} ms ({100 * bound_ms / device_ms:.0f}% of bound "
            f"{bound_ms:.4f} = {nbytes / 1e6:.1f} MB / {bw / 1e12:.2f} TB/s; {calls} calls over "
            f"{sets} input sets), back-to-back {ms:.4f}, single call {single_ms:.4f}; plain "
            f"{plain_ms:.4f}, autograd through F.batch_norm {lib_ms:.4f}")
        del inputs
    torch.cuda.empty_cache()
    per_step = {k: sum(r[k] * r["per_step"] for r in rows)
                for k in ("device_ms", "ms", "single_call_ms", "plain_ms", "library_ms",
                          "bound_ms", "bytes")}
    say(f"[k1-bwd] per ResNet-50 training step at batch {LADDER_BATCH} "
        f"({sum(train_sites.values())} launches; x, g, residual, d_x, d_identity bf16): device "
        f"{per_step['device_ms']:.3f} ms ({100 * per_step['bound_ms'] / per_step['device_ms']:.0f}%"
        f" of bound {per_step['bound_ms']:.3f} ms, {per_step['bytes'] / 1e9:.2f} GB), "
        f"{per_step['ms']:.3f} back-to-back, {per_step['single_call_ms']:.3f} single calls; plain "
        f"{per_step['plain_ms']:.3f}, autograd through F.batch_norm {per_step['library_ms']:.3f}; "
        f"max|kernel - plain| {err:.3e}, sums within {worst:.2e} of sum|terms|")
    return rows, per_step, err, worst


# [train]: ResNet-50 steps at full width through the training CLI
TRAIN_STEPS = 40  # steps of the counted epoch
TRAIN_PRINT = 5  # TRAIN.PRINT_FREQ: a progress line (and a window time) every 5 steps
TRAIN_PROFILE = (30, 3)  # TRAIN.PROFILE_START, TRAIN.PROFILE_STEPS
# one f32 step of ResNet-18 at 64^2 (TF32 off), card vs CPU, within this of
# each tensor's max|.|: summation order in the convs and the statistics,
# through one SGD step
TRAIN_F32_REL_TOL = 1e-3


def run_cli(args: list, what: str, timeout: int = 600) -> str:
    """``python -m <args>`` from the repository's root; its log (stderr)."""
    proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        fail(f"{what} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    return proc.stderr


def train_log(log: str) -> tuple[list, dict]:
    """The progress lines ``(step, window s a step, loss)`` of epoch 0 and
    the epoch's launch counts (the attention backward's calls by route) from
    a ``train_net`` log."""
    prog = [(int(m[1]), float(m[2]), float(m[3])) for m in re.finditer(
        r"Epoch\[0\] \[\s*(\d+)/\d+\]\s+Time (\S+) \(\S+\).*?Loss (\S+) \(", log)]
    m = re.search(r"K1 launches: (\d+) forward \(\S+ a step\), (\d+) backward \(\S+ a step\), "
                  r"scalar route (\d+) forward, (\d+) backward; attention (\d+) forward "
                  r"\(\S+ a step\), (\d+) backward \(\S+ a step\); backward calls by route: "
                  r"cluster (\d+), blockwise (\d+), scalar (\d+)", log)
    if not prog or m is None:
        fail(f"train_net printed no progress or launch counts:\n{log[-3000:]}")
    keys = ("k1", "k1_bwd", "k1_scalar", "k1_bwd_scalar", "attention", "attention_bwd",
            "attention_bwd_cluster", "attention_bwd_blockwise", "attention_bwd_scalar")
    return prog, dict(zip(keys, (int(v) for v in m.groups())))


def train_profile(path: Path, steps: int, bound_ms: dict, what: str, tag: str) -> dict:
    """Device time per training step by kernel class from the trainer's
    TRAIN.PROFILE window (``OUT_DIR/profile/train_steps.json``), the idle
    share between the window's first kernel start and last kernel end."""
    data = json.loads(path.read_text())
    spans = data["events"]
    if not spans:
        say(f"[{tag}] the profiler recorded no device time (not measured)")
        return {}
    by_class: Counter = Counter()
    count: Counter = Counter()
    by_name: Counter = Counter()
    for name, start, end in spans:
        cls = kernel_class(name)
        by_class[cls] += end - start
        count[cls] += 1
        by_name[name[:70]] += end - start
    busy, last = 0.0, None
    for _, start, end in sorted(spans, key=lambda e: e[1]):
        if last is None or start >= last:
            busy += end - start
            last = end
        elif end > last:
            busy += end - last
            last = end
    window = max(e for _, _, e in spans) - min(s for _, s, _ in spans)
    res = {"per_step_us": {k: v / steps for k, v in by_class.items()},
           "events_per_step": {k: v / steps for k, v in count.items()},
           "busy_per_step_us": busy / steps, "idle_share": 1.0 - busy / window,
           "window_wall_ms": data["wall_ms"], "kernels_per_step": len(spans) / steps,
           "top": [(n, t / steps) for n, t in by_name.most_common(12)]}
    say(f"[{tag} profile] {what} batch {data['batch']}, per step over {steps} steps: " + ", ".join(
        f"{k} {v:.0f} us in {res['events_per_step'][k]:.0f}"
        for k, v in sorted(res["per_step_us"].items()))
        + f"; device busy {res['busy_per_step_us']:.0f} us, idle share "
        f"{100 * res['idle_share']:.1f}%, {res['kernels_per_step']:.0f} kernels; bounds " + ", ".join(
            f"{k} {1e3 * v:.0f} us" for k, v in bound_ms.items()))
    say(f"[{tag} profile] top kernels per step: " + "; ".join(
        f"{n} {t:.0f} us" for n, t in res["top"]))
    return res


def crop_args(im: int) -> list:
    """The training and eval crop ``im`` as ``train_net`` and ``test_net``
    arguments (none at 224^2, the config's)."""
    return [] if im == IM else ["TRAIN.IM_SIZE", str(im), "TEST.IM_SIZE", str(im),
                                "TEST.CROP_SIZE", str(im)]


def train_args(cfg_file: str, batch: int, out: Path, im: int = IM, extra=()) -> list:
    """``train_net``'s arguments for ``cfg_file`` on dummy input at ``batch`` a GPU
    and crop ``im``, then ``extra``."""
    return ["--cfg", cfg_file, "MODEL.DUMMY_INPUT", "True", *crop_args(im), "TRAIN.BATCH_SIZE",
            str(batch), "TEST.BATCH_SIZE", str(batch), "TRAIN.PRINT_FREQ", str(TRAIN_PRINT),
            "RNG_SEED", "0", "OUT_DIR", str(out), *extra]


def train_run(card: str, out: Path, tag: str, what: str, cfg_file: str, batch: int, steps: int,
              window: tuple, attention: int, bound_ms: dict, im: int = IM,
              route: str = "cluster", k1: int = TRAIN_K1, extra=(), *, deferred: list,
              mse: bool = False) -> dict:
    """``python -m distribuuuu_tpu_torch.train_net --cfg <cfg_file>
    MODEL.DUMMY_INPUT True`` (then ``extra``) at ``batch`` a GPU and crop
    ``im`` over ``steps`` steps into ``out``, as a subprocess, with the
    TRAIN.PROFILE ``window`` (start, steps): the loss finite and falling;
    ``k1`` K1 and K1-bwd launches a step and ``attention`` attention and
    attention-backward calls, every backward call on ``route`` (the
    trainer's counts, set to 0 just before the first
    step and read just after the last); the checkpoint verified against its
    manifest; ``test_net`` on it, appended to ``deferred`` (a list) for
    :func:`run_test_nets` (``mse``: it must report a finite masked-MSE
    loss too, TRAIN.TASK mae). Step ms and images/s from
    the progress lines before the profiler window; the peak memory the
    trainer logs; the profile by kernel class."""
    from distribuuuu_tpu_torch import checkpoint as ckpt

    tic = time.perf_counter()
    log = run_cli(["distribuuuu_tpu_torch.train_net", *train_args(cfg_file, batch, out, im, extra),
                   "OPTIM.MAX_EPOCH", "1", "TRAIN.DUMMY_EPOCH_SAMPLES", str(batch * steps),
                   "TRAIN.PROFILE", "True", "TRAIN.PROFILE_START", str(window[0]),
                   "TRAIN.PROFILE_STEPS", str(window[1])], f"train_net {what}")
    wall = time.perf_counter() - tic
    prog, counts = train_log(log)
    losses = [p[2] for p in prog]
    say(f"[{tag}] train_net {what} {im}^2 batch {batch}, {steps} steps in {wall:.1f} s (process "
        f"start, cuDNN autotuning, eval and checkpoint included); loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; launches {counts}")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f"{what} training loss not finite or not falling: {losses}")
    # every attention backward call on ``route`` (cluster at L 196, blockwise at L 1024)
    want = dict(k1=k1 * steps, k1_bwd=k1 * steps, k1_scalar=0, k1_bwd_scalar=0,
                attention=attention * steps, attention_bwd=attention * steps,
                attention_bwd_cluster=0, attention_bwd_blockwise=0, attention_bwd_scalar=0)
    want[f"attention_bwd_{route}"] = attention * steps
    if counts != want:
        fail(f"{what} launches over {steps} steps: {counts}; want {want}")
    steady = [t for it, t, _ in prog if TRAIN_PRINT * 2 <= it <= window[0] - TRAIN_PRINT]
    step_ms = 1e3 * statistics.median(steady)
    peak = re.search(r"peak memory (\S+) GiB", log)
    peak_gib = float(peak[1]) if peak else float("nan")
    say(f"[{tag}] step {step_ms:.2f} ms (median of the {len(steady)} windows of {TRAIN_PRINT} "
        f"steps from step {TRAIN_PRINT * 2} to {window[0] - TRAIN_PRINT}), "
        f"{1e3 * batch / step_ms:.0f} images/s, peak memory {peak_gib:.2f} GiB ({card})")
    path = ckpt.get_checkpoint_path(str(out), 1)
    status, errors = ckpt.verify_checkpoint(path)
    if status != "ok":
        fail(f"checkpoint {path}: {status} {errors}")
    profile = train_profile(out / "profile" / "train_steps.json", window[1], bound_ms, what, tag)
    wait = re.search(r"data wait (\S+)% of the epoch", log)
    res = dict(steps=steps, batch=batch, im=im, launches=counts, losses=losses, step_ms=step_ms,
               images_per_s=1e3 * batch / step_ms, windows=prog, wall_s=wall, profile=profile,
               peak_gib=peak_gib, data_wait_pct=float(wait[1]) if wait else float("nan"))
    # the eval-only check autotunes nothing (no number is taken from its time)
    ev = Evaluation(["distribuuuu_tpu_torch.test_net", "--cfg", cfg_file, "MODEL.DUMMY_INPUT",
                     "True", *crop_args(im), "TEST.BATCH_SIZE", str(batch),
                     "TRAIN.DUMMY_EPOCH_SAMPLES", str(batch * 4), "MODEL.WEIGHTS", path,
                     "OUT_DIR", f"{out}_eval", *extra, "CUDNN.BENCHMARK", "False"],
                    Path(f"{out}_eval.log"),
                    f"[{tag}] {path} verified against its manifest; test_net {what} on it", res,
                    mse=mse)
    deferred.append(ev)
    return res


class Evaluation:
    """A ``test_net`` run on a checkpoint (its arguments, its log file, the
    variables ``env`` adds) whose Acc@1 and Acc@5 (and, with ``mse``, its
    masked-MSE loss) go into ``res`` once :func:`run_test_nets` ran it."""

    def __init__(self, args: list, log: Path, what: str, res: dict, *, mse: bool = False,
                 env: dict | None = None):
        self.args, self.log, self.what, self.res = args, log, what, res
        self.mse, self.env = mse, env


def run_test_nets(evals: list) -> None:
    """Run ``evals`` (:class:`Evaluation`) as concurrent subprocesses on the
    card (no timing is read from them), each logging to its file, wait for
    every one, and fail unless each exits 0 reporting Acc@1 (and a finite
    masked-MSE loss where asked)."""
    import os

    procs = []
    try:
        for ev in evals:
            with open(ev.log, "w") as log:
                procs.append(subprocess.Popen([sys.executable, "-m", *ev.args], cwd=ROOT,
                                              stdout=subprocess.DEVNULL, stderr=log,
                                              env=dict(os.environ, **(ev.env or {}))))
        for proc in procs:
            proc.wait(timeout=600)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for ev, proc in zip(evals, procs):
        log = ev.log.read_text()
        acc = re.search(r"\* Acc@1 (\S+) Acc@5 (\S+)", log)
        if proc.returncode != 0 or acc is None:
            fail(f"{ev.what}: exit {proc.returncode}, no Acc@1:\n{log[-3000:]}")
        ev.res.update(acc1=float(acc[1]), acc5=float(acc[2]))
        if ev.mse:
            mse = re.search(r"masked-MSE loss ([-+.\w]+)", log)
            if mse is None or not math.isfinite(float(mse[1])):
                fail(f"{ev.what}: no finite masked-MSE loss:\n{log[-3000:]}")
            ev.res["eval_mse"] = float(mse[1])
        say(f"{ev.what}: Acc@1 {acc[1]}, Acc@5 {acc[2]}"
            + (f", masked-MSE loss {ev.res['eval_mse']}" if ev.mse else ""))


def phase_train(card: str, tmp: Path, bound_ms: dict, deferred: list) -> dict:
    """[train]: ResNet-50 training at full width, :func:`train_run` on
    ``config/resnet50.yaml`` at batch LADDER_BATCH over TRAIN_STEPS steps
    (its ``test_net`` appended to ``deferred``); then a relaunch with
    ``OPTIM.MAX_EPOCH 2`` that must resume from the checkpoint and write
    the next; then one f32 ResNet-18 step card vs CPU."""
    from distribuuuu_tpu_torch import checkpoint as ckpt

    out = tmp / "train"
    res = train_run(card, out, "train", "ResNet-50", "config/resnet50.yaml", LADDER_BATCH,
                    TRAIN_STEPS, TRAIN_PROFILE, 0, bound_ms, deferred=deferred)
    log = run_cli(["distribuuuu_tpu_torch.train_net",
                   *train_args("config/resnet50.yaml", LADDER_BATCH, out), "OPTIM.MAX_EPOCH", "2",
                   "TRAIN.DUMMY_EPOCH_SAMPLES", str(LADDER_BATCH * 4)], "train_net relaunch")
    resumed = re.search(r"Resumed from (\S+) \(epoch (\d+)", log)
    if resumed is None or not resumed[1].endswith("ckpt_ep_001") or resumed[2] != "1" or \
            ckpt.verify_checkpoint(ckpt.get_checkpoint_path(str(out), 2))[0] != "ok":
        fail(f"the relaunch did not resume from ckpt_ep_001 and write ckpt_ep_002:\n{log[-3000:]}")
    say(f"[train] the relaunch with OPTIM.MAX_EPOCH 2 logged 'Resumed from {resumed[1]} (epoch "
        f"{resumed[2]}' and wrote ckpt_ep_002")
    res["f32_check"] = train_f32_check()
    return res


def train_f32_check() -> dict:
    """One f32 training step (TF32 off) of ResNet-18 at 64^2, 10 classes,
    batch 8, on the card against the same step on the CPU: loss, parameters
    and BN statistics within TRAIN_F32_REL_TOL of each one's max|.|."""
    import torch

    from distribuuuu_tpu_torch.config import cfg, reset_cfg
    from distribuuuu_tpu_torch.ops import epilogue as ep
    from distribuuuu_tpu_torch.trainer import TrainState, build_cfg_model, train_step

    torch.backends.cudnn.allow_tf32 = False  # f32 convs and products in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_cfg()
    cfg.MODEL.ARCH, cfg.MODEL.NUM_CLASSES, cfg.MODEL.DTYPE = "resnet18", 10, "float32"
    cfg.TRAIN.IM_SIZE = 64
    gen = torch.Generator().manual_seed(0)
    imgs = torch.randint(0, 256, (8, 64, 64, 3), dtype=torch.uint8, generator=gen)
    labels = torch.randint(0, 10, (8,), generator=gen)
    res = {}
    for dev in ("cpu", "cuda"):
        st = TrainState(build_cfg_model(torch.Generator().manual_seed(1)).to(dev))
        before = (ep.LAUNCHES, ep.BWD_LAUNCHES)
        m = train_step(st, {"image": imgs.to(dev), "label": labels.to(dev)}, 0.1)
        res[dev] = (m["loss_sum"].item() / 8, st.params.cpu(), st.stats.cpu(),
                    (ep.LAUNCHES - before[0], ep.BWD_LAUNCHES - before[1]))
    reset_cfg()
    (lc, pc, sc, _), (lg, pg, sg, launches) = res["cpu"], res["cuda"]
    d = dict(loss=abs(lc - lg) / abs(lc), params=float((pc - pg).abs().max() / pc.abs().max()),
             stats=float((sc - sg).abs().max() / sc.abs().max()))
    say(f"[train f32] ResNet-18 64^2 batch 8, one step card vs CPU: loss {lg:.6f} / {lc:.6f}; "
        f"relative to max|.|: " + ", ".join(f"{k} {v:.2e}" for k, v in d.items())
        + f" (limit {TRAIN_F32_REL_TOL}); card launches K1 {launches[0]}, K1-bwd {launches[1]}")
    if not all(v <= TRAIN_F32_REL_TOL for v in d.values()) or launches != (20, 20):
        fail("the f32 ResNet-18 step on the card is outside the stated tolerance of the CPU's")
    return d


# [train-bot]: BoTNet-50 steps at full width through the training CLI, at
# config/botnet50.yaml's batch of 32 a GPU
BOT_STEPS = 35  # steps of the counted epoch
BOT_BATCH = 32
BOT_PROFILE = (25, 3)  # TRAIN.PROFILE_START, TRAIN.PROFILE_STEPS
BOT_ATTENTION = 3  # attention forward calls a BoTNet-50 step; as many backward calls
# One f32 botnet50 step at 64^2 (TF32 off), card vs CPU. Without zero-γ
# residuals the ResNet-50 trunk's gradient grows from the head to the stem
# at init, and f32 summation order alone moves it: on the CPU the JAX
# package and the port, from one state, part by 8.8e-5 in the loss, 3.6e-2 in
# the update's relative L2 and 3.3e-5 in the BN statistics'
# (tests/test_torch_gpu.py holds the same limits).
BOT_F32_LOSS_RTOL = 1e-3
BOT_F32_UPDATE_RL2 = 1e-1
BOT_F32_STATS_RL2 = 1e-3


def phase_train_bot(card: str, tmp: Path, bound_ms: dict, deferred: list) -> dict:
    """[train-bot]: BoTNet-50 training at full width, :func:`train_run` on
    ``config/botnet50.yaml`` (224^2, bf16, batch 32 a GPU, SGD nesterov,
    cosine) over BOT_STEPS steps, 3 attention and 3 attention-backward calls
    a step beside K1's and K1-bwd's 53; then one f32 botnet50 step card vs
    CPU."""
    res = train_run(card, tmp / "train_bot", "train-bot", "BoTNet-50", "config/botnet50.yaml",
                    BOT_BATCH, BOT_STEPS, BOT_PROFILE, BOT_ATTENTION, bound_ms,
                    deferred=deferred)
    res["f32_check"] = train_f32_botnet_check()
    return res


# [train-bot-512]: BoTNet-50 at a 512^2 crop through the training CLI (fmap
# 32x32: L 1024 in the three BoT blocks, the attention backward's blockwise
# route), at config/botnet50.yaml's batch of 32 a GPU
BOT512_IM = 512
BOT512_STEPS = 25  # steps of the counted epoch; [train-bot] keeps its 35
BOT512_BATCH = 32
BOT512_PROFILE = (20, 3)  # TRAIN.PROFILE_START, TRAIN.PROFILE_STEPS


def phase_train_bot_512(card: str, tmp: Path, bound_ms: dict, deferred: list) -> dict:
    """[train-bot-512]: :func:`train_run` on ``config/botnet50.yaml`` at a
    BOT512_IM^2 crop (train and eval), bf16, batch BOT512_BATCH, over
    BOT512_STEPS steps: 3 attention calls a step on K4's route and 3
    backward calls on the blockwise route beside K1's and K1-bwd's 53."""
    return train_run(card, tmp / "train_bot_512", "train-bot-512", "BoTNet-50",
                     "config/botnet50.yaml", BOT512_BATCH, BOT512_STEPS, BOT512_PROFILE,
                     BOT_ATTENTION, bound_ms, im=BOT512_IM, route="blockwise",
                     deferred=deferred)


def train_f32_botnet_check() -> dict:
    """One f32 training step (TF32 off) of botnet50 at 64^2, 10 classes,
    batch 8, every BN scale drawn in [0.5, 1.5] (so MHSA trains in this
    step), on the card against the same step on the CPU: the loss, the
    update of all parameters and the MHSA parameters' gradient (relative
    L2), the BN statistics (relative L2) within the BOT_F32_* limits; 3
    attention backward calls on the card."""
    import torch

    from distribuuuu_tpu_torch.config import cfg, reset_cfg
    from distribuuuu_tpu_torch.models import layers
    from distribuuuu_tpu_torch.ops import attention as att
    from distribuuuu_tpu_torch.trainer import TrainState, build_cfg_model, train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_cfg()
    cfg.MODEL.ARCH, cfg.MODEL.NUM_CLASSES, cfg.MODEL.DTYPE = "botnet50", 10, "float32"
    cfg.TRAIN.IM_SIZE = 64
    gen = torch.Generator().manual_seed(3)
    imgs = torch.randint(0, 256, (8, 64, 64, 3), dtype=torch.uint8, generator=gen)
    labels = torch.randint(0, 10, (8,), generator=gen)
    res = {}
    for dev in ("cpu", "cuda"):
        model = build_cfg_model(torch.Generator().manual_seed(0))
        scales = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, layers.BatchNorm):
                    m.weight.uniform_(0.5, 1.5, generator=scales)
        st = TrainState(model.to(dev))
        start = st.params.cpu().clone()
        before = att.BWD_LAUNCHES
        m = train_step(st, {"image": imgs.to(dev), "label": labels.to(dev)}, 0.2 * 8 / 256)
        mhsa = torch.cat([st.grads[o:o + k].cpu() for name, (o, k, _) in
                          zip(st.names, st.segments) if ".net.3." in name])
        res[dev] = (m["loss_sum"].item() / 8, st.params.cpu() - start, st.stats.cpu(), mhsa,
                    att.BWD_LAUNCHES - before)
    reset_cfg()

    def rel_l2(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    (lc, uc, sc, ac, _), (lg, ug, sg, ag, launches) = res["cpu"], res["cuda"]
    d = dict(loss=abs(lc - lg) / abs(lc), update=rel_l2(ug, uc), mhsa_grad=rel_l2(ag, ac),
             stats=rel_l2(sg, sc))
    say(f"[train-bot f32] BoTNet-50 64^2 batch 8, one step card vs CPU: loss {lg:.6f} / "
        f"{lc:.6f}; " + ", ".join(f"{k} {v:.2e}" for k, v in d.items())
        + f" (limits {BOT_F32_LOSS_RTOL}, {BOT_F32_UPDATE_RL2} relative L2 for the update and "
        f"the MHSA gradient, {BOT_F32_STATS_RL2} for the statistics); card attention backward "
        f"calls {launches}")
    if not (d["loss"] <= BOT_F32_LOSS_RTOL and d["update"] <= BOT_F32_UPDATE_RL2
            and d["mhsa_grad"] <= BOT_F32_UPDATE_RL2 and d["stats"] <= BOT_F32_STATS_RL2
            and float(ac.abs().max()) > 0 and launches == BOT_ATTENTION):
        fail("the f32 BoTNet-50 step on the card is outside the stated tolerance of the CPU's")
    return d


# [train-zoo]: the rest of the classification zoo through the training CLI at
# full width, each at its config's batch of 64 a GPU, 224^2, bf16, dummy input.
# (tag, config, extra arguments, K1 and K1-bwd launches a step: every BN).
# DenseNet trains on resnet50.yaml's recipe (the repo has no DenseNet YAML;
# the reference trains it so), without the ResNet stem option.
ZOO_RUNS = [
    ("densenet121", "config/resnet50.yaml",
     ["MODEL.ARCH", "densenet121", "MODEL.STEM_S2D", "False", "TRAIN.BATCH_SIZE", "64"], 121),
    ("regnety_160", "config/regnety_160.yaml", [], 59),
    ("efficientnet_b0", "config/efficientnet_b0.yaml", [], 49),
    ("vit_b16", "config/vit_b16.yaml", [], 0),
]
ZOO_BATCH = 64
ZOO_STEPS = 25  # steps of the counted epoch
ZOO_PROFILE = (20, 3)  # TRAIN.PROFILE_START, TRAIN.PROFILE_STEPS


def zoo_sites(arch: str) -> Counter:
    """The K1 sites of a training step of ``arch`` at ZOO_BATCH, 224^2,
    bf16 boundaries (:func:`epilogue_sites`)."""
    import torch

    return epilogue_sites(arch, ZOO_BATCH, bn_dtype=torch.bfloat16)


def zoo_bounds(sites: Counter, bw: float) -> dict:
    """K1's and K1-bwd's bound (ms) a training step from its K1 ``sites``."""
    if not sites:
        return {}
    return {"k1": sum(k1_bound((*site[:6], "a"), bw, (2, 2, 2, 2))[0] * m
                      for site, m in sites.items()),
            "k1_bwd": sum(k1_bwd_bound(site, bw)[0] * m for site, m in sites.items())}


def zoo_k1_check(sites: Counter) -> dict:
    """K1 and K1-bwd against their plain versions at each distinct site of
    a zoo training step (``sites``), on seeded inputs of the step's
    shapes and dtypes (x, residual and gradient bf16): K1 bitwise in the
    site's mode, K1-bwd as [k1-bwd] holds it (:func:`k1_bwd_check`), every
    call on the vector route. These shapes give K1's launch group counts
    that are not powers of two (C 24, 40, 112, 1232, 3024, ...), which
    ResNet-50's sites never do. Returns the counts and the errors."""
    import torch

    from distribuuuu_tpu_torch.ops import epilogue as ep

    gen = torch.Generator(device="cuda").manual_seed(11)
    bf16 = torch.bfloat16
    scalar = ep.SCALAR_LAUNCHES + ep.BWD_SCALAR_LAUNCHES
    err, bwd_err, worst = 0.0, 0.0, 0.0
    for site in sorted(sites):
        n, h, w, c, res, relu, mode = site
        args = k1_inputs(n, h, w, c, res, bf16, gen)
        err = max(err, k1_check(ep, args, k1_kwargs(mode, relu, bf16, bf16), f"{site} bf16"))
        g = torch.randn(args[0].shape, generator=gen, device="cuda").to(bf16).contiguous(
            memory_format=torch.channels_last)
        e, r = k1_bwd_check(ep, args, (g, None), dict(relu=relu, bn_dtype=bf16), f"{site} bf16")
        bwd_err, worst = max(bwd_err, e), max(worst, r)
        del args, g
    torch.cuda.empty_cache()
    if ep.SCALAR_LAUNCHES + ep.BWD_SCALAR_LAUNCHES != scalar:
        fail("K1 or K1-bwd took the scalar route at a zoo training site")
    return dict(sites=len(sites), launches_a_step=sum(sites.values()), k1_max_abs_err=err,
                k1_bwd_max_abs_err=bwd_err, k1_bwd_sum_rel_err=worst)


def phase_train_zoo(card: str, tmp: Path, bw: float, deferred: list) -> dict:
    """[train-zoo]: for each of ZOO_RUNS, K1 and K1-bwd against their plain
    versions at the step's sites (:func:`zoo_k1_check`), then
    :func:`train_run`, ZOO_STEPS steps at batch ZOO_BATCH: the loss finite
    and falling, every BN's K1 and K1-bwd launches a step and none scalar,
    the checkpoint (its ``test_net`` appended to ``deferred``), step ms,
    images/s, peak memory and the profile of 3 steps."""
    out = {}
    for arch, cfg_file, extra, k1 in ZOO_RUNS:
        sites = zoo_sites(arch)
        if sum(sites.values()) != k1:
            fail(f"[train-zoo] {arch}: {sum(sites.values())} K1 sites a step, want {k1}")
        check = zoo_k1_check(sites)
        bound_ms = zoo_bounds(sites, bw)
        out[arch] = train_run(card, tmp / f"zoo_{arch}", "train-zoo", arch, cfg_file, ZOO_BATCH,
                              ZOO_STEPS, ZOO_PROFILE, 0, bound_ms, k1=k1, extra=extra,
                              deferred=deferred)
        launches = out[arch]["launches"]
        say(f"[train-zoo] {arch}: K1 and K1-bwd at the step's {check['sites']} distinct sites "
            f"(batch {ZOO_BATCH}, 224^2, x/residual/gradient bf16), each against its plain "
            f"version: K1 bitwise, K1-bwd d_x and d_identity bitwise, sums within "
            f"{check['k1_bwd_sum_rel_err']:.2e} of sum|terms| (limit {K1_BWD_SUM_RTOL}), none "
            f"scalar; in the run K1 {launches['k1']}, K1-bwd {launches['k1_bwd']} launches "
            f"({k1} a step x {ZOO_STEPS} steps), scalar {launches['k1_scalar']} / "
            f"{launches['k1_bwd_scalar']}")
        out[arch].update(bound_ms=bound_ms, k1_a_step=k1, k1_check=check)
    return out


# [zoo f32]: each family at full width, a 64^2 crop and batch 8 (the cut: the
# resolution and the batch, not the depth), card against CPU with TF32 off:
# the eval forward within F32_REL_TOL of max|logit|; one training step with
# the loss within BOT_F32_LOSS_RTOL, the statistics within TRAIN_F32_REL_TOL
# of max|.| and BOT_F32_STATS_RL2 in relative L2, and the parameters and the
# update within the family's own limits (ZOO_F32_STEP). Then the engine's bf16
# forward at 224^2 on the card against the CPU's f32 forward, on [serve]'s
# seeded weights (:func:`synthetic_state_dict`), within BF16_REL_TOL, as
# [serve]; or, where the JAX package's own bf16 forward of those weights lies
# farther from its f32 one, no farther than it (ZOO_BF16_JAX_GAP).
ZOO_F32 = {arch: k1 for arch, _, _, k1 in ZOO_RUNS}  # arch -> K1 launches a forward
ZOO_F32_IM, ZOO_F32_BATCH, ZOO_SERVE_BATCH = 64, 8, 4
# The JAX package's bf16 logits against its f32 ones on the served weights,
# relative to max|logit| (``scripts/torch_zoo_numerics.py serve``, CPU): the
# SE gates of RegNetY, in the compute dtype as in JAX, amplify bf16 rounding
# on random weights (RegNetY-4GF 0.239, RegNetX-16GF, without them, 4.3e-3).
# DenseNet-121 4.3e-3, EfficientNet-B0 4.8e-3 and ViT-B/16 1.0e-2 stay
# within BF16_REL_TOL.
ZOO_BF16_JAX_GAP = {"regnety_160": 0.160}
# arch -> (the parameters after the step, max|card - CPU| / max|p|; the
# update, relative L2) a family's f32 step is held to. The parameters:
# [train]'s TRAIN_F32_REL_TOL wherever the JAX package's own f32 step lies
# closer than that to its float64 one. The update, and RegNetY's parameters:
# about 3x the card's reading (NVIDIA H100 80GB HBM3, 700 W; card and CPU
# both deterministic, the same reading on every run), and no more than twice
# the JAX package's own f32 gap from float64 at this size where that is known
# (``scripts/torch_zoo_numerics.py step``: the gradient in relative L2, the
# SGD step in max|.|): two f32 summation orders can differ by the sum of
# their distances from exact.
#   densenet121     reads 2.1e-4, 6.0e-3; JAX gap 7.4e-4, 2.17e-2
#   regnety_160     reads 5.0e-3, 1.98e-2; JAX gap 6.8e-3, 2.65e-2: the only
#                   family above [train]'s TRAIN_F32_REL_TOL, as JAX itself is
#   efficientnet_b0 reads 5.6e-7, 1.18e-5; JAX gap 1.6e-6, 2.0e-5
#   vit_b16         reads 7.9e-6, 2.0e-4 (LAMB's first step is ~sign(g), so a
#                   gradient's last bits move the update more than the SGD
#                   gap of 2.5e-9, 9.3e-7 predicts)
ZOO_F32_STEP = {"densenet121": (TRAIN_F32_REL_TOL, 1.8e-2),
                "regnety_160": (1.36e-2, 5.3e-2),
                "efficientnet_b0": (TRAIN_F32_REL_TOL, 4e-5),
                "vit_b16": (TRAIN_F32_REL_TOL, 6e-4)}


def zoo_model(arch: str, im: int, seed: int = 0):
    """``arch`` in f32 with the JAX initialisers from ``seed``, every BN
    scale drawn in [0.5, 1.5] and bias N(0, 0.1), and ViT's head (zero at
    init, which would leave the first step without a gradient below it)
    N(0, 0.02). EfficientNet without dropout and drop path: the card's and
    the CPU's generators draw different masks ([train-zoo] trains it with
    both)."""
    import torch

    from distribuuuu_tpu_torch.models import build_model, layers

    kw = dict(dropout=0.0, drop_path_rate=0.0) if arch.startswith("efficientnet") else {}
    model = layers.init_weights(build_model(arch, num_classes=1000 if im == IM else 10,
                                            dtype=torch.float32, im_size=im, **kw),
                                torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, layers.BatchNorm):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
        if arch.startswith("vit"):
            model.heads.head.weight.normal_(0.0, 0.02, generator=gen)
    return model


def zoo_f32_step(arch: str) -> dict:
    """The f32 eval forward and one f32 training step of ``arch`` at
    ZOO_F32_IM, batch ZOO_F32_BATCH (SGD, or LAMB for ViT as its config),
    card against CPU; the card's K1 and K1-bwd launches in the step."""
    import torch

    from distribuuuu_tpu_torch.config import cfg, reset_cfg
    from distribuuuu_tpu_torch.data.transforms import device_normalize
    from distribuuuu_tpu_torch.ops import epilogue as ep
    from distribuuuu_tpu_torch.trainer import TrainState, train_step

    reset_cfg()
    cfg.MODEL.DTYPE = "float32"
    if arch.startswith("vit"):
        cfg.OPTIM.OPTIMIZER, cfg.OPTIM.WEIGHT_DECAY = "lamb", 0.05
    lr = 2e-3 if arch.startswith("vit") else 0.4 * ZOO_F32_BATCH / 256
    gen = torch.Generator().manual_seed(7)
    imgs = torch.randint(0, 256, (ZOO_F32_BATCH, ZOO_F32_IM, ZOO_F32_IM, 3), dtype=torch.uint8,
                         generator=gen)
    labels = torch.randint(0, 10, (ZOO_F32_BATCH,), generator=gen)
    res = {}
    for dev in ("cpu", "cuda"):
        model = zoo_model(arch, ZOO_F32_IM).to(dev, memory_format=torch.channels_last)
        with torch.no_grad():
            logits = model.eval()(device_normalize(imgs.to(dev))).cpu()
        st = TrainState(model)
        start = st.params.cpu().clone()
        before = (ep.LAUNCHES, ep.BWD_LAUNCHES, ep.SCALAR_LAUNCHES + ep.BWD_SCALAR_LAUNCHES)
        m = train_step(st, {"image": imgs.to(dev), "label": labels.to(dev)}, lr)
        res[dev] = (logits, m["loss_sum"].item() / ZOO_F32_BATCH, st.params.cpu(),
                    st.params.cpu() - start, st.stats.cpu(),
                    tuple(b - a for a, b in zip(before, (
                        ep.LAUNCHES, ep.BWD_LAUNCHES,
                        ep.SCALAR_LAUNCHES + ep.BWD_SCALAR_LAUNCHES))))
    reset_cfg()
    (oc, lc, pc, uc, sc, _), (og, lg, pg, ug, sg, launches) = res["cpu"], res["cuda"]

    def rel_l2(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm()) if b.numel() else 0.0

    def rel_max(a, b):
        return float((a - b).abs().max() / b.abs().max()) if b.numel() else 0.0

    d = dict(logits=rel_max(og, oc), loss=abs(lc - lg) / abs(lc), params=rel_max(pg, pc),
             stats=rel_max(sg, sc), update_l2=rel_l2(ug, uc), stats_l2=rel_l2(sg, sc))
    limits = dict(zip(("params", "update_l2"), ZOO_F32_STEP[arch]), logits=F32_REL_TOL,
                  loss=BOT_F32_LOSS_RTOL, stats=TRAIN_F32_REL_TOL, stats_l2=BOT_F32_STATS_RL2)
    ok = (all(d[k] <= v for k, v in limits.items())
          and launches == (ZOO_F32[arch], ZOO_F32[arch], 0))
    say(f"[zoo f32] {arch} {ZOO_F32_IM}^2 batch {ZOO_F32_BATCH}, card vs CPU: eval logits "
        f"{d['logits']:.2e} of max|logit| (limit {F32_REL_TOL}); one step: loss {lg:.6f} / "
        f"{lc:.6f}; " + ", ".join(f"{k} {v:.2e} (limit {limits[k]})" for k, v in d.items()
                                  if k != "logits")
        + f" (params, stats: of max|.|; update_l2, stats_l2: relative L2); card launches K1, "
        f"K1-bwd, scalar {launches}")
    if not ok:
        fail(f"[zoo f32] {arch}: the card's f32 forward or step is outside the stated limits")
    return dict(d, launches=launches, limits=limits)


def zoo_serve(arch: str, tmp: Path) -> dict:
    """``arch`` hosted by the serving engine (bf16, uint8 wire, f32 BN
    boundaries) on :func:`synthetic_state_dict`'s weights: its forward of
    ZOO_SERVE_BATCH seeded images at IM against the CPU's f32 forward,
    within BF16_REL_TOL of max|logit| (or ZOO_BF16_JAX_GAP); every BN one
    K1 launch, none scalar."""
    import numpy as np
    import torch

    from distribuuuu_tpu_torch.data.transforms import device_normalize
    from distribuuuu_tpu_torch.models import build_model
    from distribuuuu_tpu_torch.ops import epilogue as ep
    from distribuuuu_tpu_torch.serve.engine import InferenceEngine, ModelSpec

    sd = synthetic_state_dict(arch)
    path = tmp / f"{arch}.pt"
    torch.save(sd, path)
    engine = InferenceEngine(batch_sizes=[ZOO_SERVE_BATCH], im_size=IM, num_classes=1000,
                             compute_dtype="bfloat16", device="cuda")
    engine.load(ModelSpec(name=arch, arch=arch, weights=str(path)))
    imgs = np.random.default_rng(11).integers(0, 256, size=(ZOO_SERVE_BATCH, IM, IM, 3),
                                              dtype=np.uint8)
    engine.forward(arch, imgs)  # warm-up: cuDNN's algorithm choice
    ep.LAUNCHES = ep.SCALAR_LAUNCHES = 0
    got = engine.forward(arch, imgs)
    launches = (ep.LAUNCHES, ep.SCALAR_LAUNCHES)
    ref_model = build_model(arch, num_classes=1000, dtype=torch.float32, im_size=IM)
    ref_model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        ref = ref_model.to(memory_format=torch.channels_last).eval()(
            device_normalize(torch.from_numpy(imgs))).numpy()
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    limit = max(BF16_REL_TOL, ZOO_BF16_JAX_GAP.get(arch, 0.0))
    say(f"[zoo f32] {arch} served bf16 {IM}^2 batch {ZOO_SERVE_BATCH} vs CPU f32: {err:.2e} of "
        f"max|logit| {float(np.abs(ref).max()):.3f} (limit {limit}); K1 launches, scalar "
        f"{launches}")
    if not err <= limit or launches != (ZOO_F32[arch], 0) or not np.isfinite(got).all():
        fail(f"[zoo f32] {arch}: the served bf16 forward is outside {limit} of the CPU's "
             f"f32 one, or its launches {launches} are not every BN's")
    return dict(bf16_rel_err=err, limit=limit, launches=launches[0])


def phase_zoo_f32(tmp: Path) -> dict:
    """[zoo f32]: :func:`zoo_f32_step` and :func:`zoo_serve` for each family."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return {arch: dict(zoo_f32_step(arch), serve=zoo_serve(arch, tmp)) for arch in ZOO_F32}


# [train-mae]: config/mae_vit_b16.yaml through the training CLI on one card:
# ViT-B/16 MAE at the YAML's 448^2 (784 tokens), batch 8, REMAT on, LAMB,
# mask ratio 0.25, with the mesh cut to one card (the YAML's fsdp 2 x seq 2
# is ROADMAP item 12); its checkpoint then through test_net (the eval's
# masked MSE under the fixed mask)
MAE_CFG = "config/mae_vit_b16.yaml"
MAE_IM, MAE_BATCH = 448, 8  # the YAML's
MAE_STEPS = 25  # steps of the counted epoch
MAE_PROFILE = (20, 3)  # TRAIN.PROFILE_START, TRAIN.PROFILE_STEPS
MAE_MESH = ["MESH.FSDP", "1", "MESH.SEQ", "1"]


def phase_train_mae(card: str, tmp: Path, deferred: list) -> dict:
    """[train-mae]: :func:`train_run` on MAE_CFG with MAE_MESH: the loss (the
    masked patches' MSE) finite and falling, no K1 or attention launch (MAE
    runs cuBLAS and eager ops), the checkpoint, ``test_net`` on it (its
    masked MSE finite), step ms, images/s, peak memory and the profile."""
    return train_run(card, tmp / "mae", "train-mae", "MAE-ViT-B/16 (REMAT)", MAE_CFG, MAE_BATCH,
                     MAE_STEPS, MAE_PROFILE, 0, {}, im=MAE_IM, k1=0, extra=MAE_MESH,
                     deferred=deferred, mse=True)


# [remat]: MODEL.REMAT on against off, in this process, two steps of each model
# from one state with cuDNN deterministic (so that a recompute gives the bits of
# its forward): parameters, optimizer state and BN statistics torch.equal; K1
# twice and K1-bwd once a step for every BN inside a recomputed block (once for
# the stem's and the head's), the attention kernel twice and its backward once,
# none scalar; each model's peak memory both ways, and its step ms both ways
# as the median of REMAT_TIMED further steps (CUDA events around each).
# (arch, batch, crop, TRAIN.TASK)
REMAT_RUNS = [("resnet50", 32, IM, "classify"), ("botnet50", 8, IM, "classify"),
              ("efficientnet_b0", 16, IM, "classify"), ("mae_vit_b16", MAE_BATCH, MAE_IM, "mae")]
REMAT_STEPS = 2
REMAT_TIMED = 5


def remat_expected(model) -> dict:
    """Launches a step of ``model``: (K1 and attention forward without
    remat, with remat; their backward), from its modules: every BN and
    every MHSA once, and once more inside a :class:`layers.RematUnit`."""
    from distribuuuu_tpu_torch.models import layers
    from distribuuuu_tpu_torch.models.botnet import MHSA

    def count(kind, root):
        return sum(isinstance(m, kind) for m in root.modules())

    units = [m for m in model.modules() if isinstance(m, layers.RematUnit)]
    bn, att = count(layers.BatchNorm, model), count(MHSA, model)
    rbn = sum(count(layers.BatchNorm, u) for u in units)
    ratt = sum(count(MHSA, u) for u in units)
    return dict(k1=(bn, bn + rbn), attention=(att, att + ratt), k1_bwd=bn, attention_bwd=att,
                units=len(units))


def remat_run(arch: str, batch: int, im: int, task: str, remat: bool) -> dict:
    """REMAT_STEPS bf16 steps of ``arch`` on the card from seed 0 (every BN
    scale drawn in [0.5, 1.5], so that BoTNet's zero-gamma blocks pass a
    gradient to MHSA), the masks from the trainer's stream; the state after
    them on the host, the launches and the peak memory; then the median ms
    of REMAT_TIMED more steps."""
    import torch

    from distribuuuu_tpu_torch.config import cfg, reset_cfg
    from distribuuuu_tpu_torch.models import layers
    from distribuuuu_tpu_torch.ops import attention as att
    from distribuuuu_tpu_torch.ops import epilogue as ep
    from distribuuuu_tpu_torch.trainer import TrainState, build_cfg_model, train_step

    reset_cfg()
    cfg.MODEL.ARCH, cfg.TRAIN.TASK, cfg.TRAIN.IM_SIZE, cfg.MODEL.REMAT = arch, task, im, remat
    if task == "mae":
        cfg.OPTIM.OPTIMIZER, cfg.OPTIM.WEIGHT_DECAY = "lamb", 0.05
    model = build_cfg_model(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, layers.BatchNorm):
                m.weight.uniform_(0.5, 1.5, generator=gen)
    want = remat_expected(model)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = TrainState(model.to("cuda", memory_format=torch.channels_last))
    images = torch.randint(0, 256, (batch, im, im, 3), dtype=torch.uint8, generator=gen).cuda()
    labels = torch.randint(0, 1000, (batch,), generator=gen).cuda()
    torch.cuda.synchronize()
    ep.LAUNCHES = ep.BWD_LAUNCHES = ep.SCALAR_LAUNCHES = ep.BWD_SCALAR_LAUNCHES = 0
    att.LAUNCHES = att.BWD_LAUNCHES = 0
    att.BWD_ROUTE_CALLS.update(dict.fromkeys(att.BWD_ROUTE_CALLS, 0))
    batch_ = {"image": images, "label": labels}
    lr = 1e-3 if task == "mae" else 0.1
    for step in range(REMAT_STEPS):
        train_step(state, batch_, lr, dropout_key=(0, 0, step, 0), task=task)
    torch.cuda.synchronize()
    counts = dict(k1=ep.LAUNCHES, k1_bwd=ep.BWD_LAUNCHES,
                  scalar=ep.SCALAR_LAUNCHES + ep.BWD_SCALAR_LAUNCHES
                  + att.BWD_ROUTE_CALLS["scalar"],
                  attention=att.LAUNCHES, attention_bwd=att.BWD_LAUNCHES)
    res = dict(params=state.params.cpu(), stats=state.stats.cpu(),
               opt={k: v.cpu() for k, v in state.optimizer.state.items()}, counts=counts,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30, want=want)
    times = []
    for step in range(REMAT_STEPS, REMAT_STEPS + REMAT_TIMED):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        train_step(state, batch_, lr, dropout_key=(0, 0, step, 0), task=task)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    res["step_ms"] = statistics.median(times)
    reset_cfg()
    del state, model, images, labels
    torch.cuda.empty_cache()
    return res


def phase_remat(card: str) -> dict:
    """[remat]: :func:`remat_run` off then on for each of REMAT_RUNS (module
    comment above REMAT_RUNS). Fails on any difference, any launch count
    other than the modules say, any scalar launch, or unless remat lowers
    MAE's peak memory."""
    import torch

    before = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    out = {}
    try:
        for arch, batch, im, task in REMAT_RUNS:
            off, on = (remat_run(arch, batch, im, task, r) for r in (False, True))
            w, steps = on["want"], REMAT_STEPS
            equal = (torch.equal(on["params"], off["params"])
                     and torch.equal(on["stats"], off["stats"])
                     and on["opt"].keys() == off["opt"].keys()
                     and all(torch.equal(on["opt"][k], v) for k, v in off["opt"].items()))
            want = {r: dict(k1=steps * w["k1"][r], k1_bwd=steps * w["k1_bwd"], scalar=0,
                            attention=steps * w["attention"][r],
                            attention_bwd=steps * w["attention_bwd"]) for r in (0, 1)}
            say(f"[remat] {arch} batch {batch} {im}^2 bf16, {steps} steps from one state "
                f"(cuDNN deterministic), REMAT off / on ({w['units']} recomputed blocks): "
                f"parameters, optimizer state and BN statistics "
                f"{'torch.equal' if equal else 'DIFFER'}; launches {off['counts']} / "
                f"{on['counts']} (want {want[0]} / {want[1]}); peak memory "
                f"{off['peak_gib']:.2f} / {on['peak_gib']:.2f} GiB; step {off['step_ms']:.2f} / "
                f"{on['step_ms']:.2f} ms (median of {REMAT_TIMED} more steps; {card})")
            if not equal or off["counts"] != want[0] or on["counts"] != want[1]:
                fail(f"[remat] {arch}: REMAT changed the result or the launches")
            out[arch] = dict(batch=batch, im=im, launches_off=off["counts"],
                             launches_on=on["counts"], peak_gib_off=off["peak_gib"],
                             peak_gib_on=on["peak_gib"], step_ms_off=off["step_ms"],
                             step_ms_on=on["step_ms"], recomputed_blocks=w["units"])
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before
    mae = out["mae_vit_b16"]
    if not mae["peak_gib_on"] < mae["peak_gib_off"]:
        fail(f"[remat] REMAT did not lower MAE-ViT-B/16's peak memory: {mae}")
    return out


# [mae f32]: MAE-ViT-B/16 at full width, a 64^2 crop and batch 2 (16 tokens;
# the cut: the crop and the batch, for the CPU's side), f32 with TF32 off,
# card against CPU under one mask drawn on the CPU: the eval predictions
# within F32_REL_TOL of max|pred|; one LAMB step (the YAML's optimizer) with
# the loss within BOT_F32_LOSS_RTOL, the parameters within TRAIN_F32_REL_TOL
# of max|p| and the update within MAE_F32_UPDATE_RL2 in relative L2: 3x the
# card's reading of 1.20e-4 (NVIDIA H100 80GB HBM3, 700 W; both sides
# deterministic, the same reading on every run). That reading lies above the
# JAX package's own f32 LAMB update's distance from its float64 one at this
# size, 1.59e-5 (its gradient's 1.04e-6; ``scripts/torch_zoo_numerics.py
# step mae_vit_b16``), and the port's f32 gradient on the CPU moves the
# update as little (1.62e-5), so the card's f32 gradient is the one farther
# from exact; how far is not measured (``grad_l2`` reads its distance from
# the CPU's). LAMB's first step is ~g / (|g| + eps): the last bits of small
# gradients move it most.
MAE_F32_IM, MAE_F32_BATCH = 64, 2
MAE_F32_UPDATE_RL2 = 3.6e-4


def phase_mae_f32() -> dict:
    import torch

    from distribuuuu_tpu_torch.config import cfg, reset_cfg
    from distribuuuu_tpu_torch.data.transforms import device_normalize
    from distribuuuu_tpu_torch.trainer import TrainState, mae_mask, train_step

    reset_cfg()
    cfg.MODEL.DTYPE, cfg.TRAIN.TASK = "float32", "mae"
    cfg.OPTIM.OPTIMIZER, cfg.OPTIM.WEIGHT_DECAY = "lamb", 0.05
    gen = torch.Generator().manual_seed(7)
    imgs = torch.randint(0, 256, (MAE_F32_BATCH, MAE_F32_IM, MAE_F32_IM, 3), dtype=torch.uint8,
                         generator=gen)
    mask = mae_mask(MAE_F32_BATCH, (MAE_F32_IM // 16) ** 2, gen)
    res = {}
    for dev in ("cpu", "cuda"):
        model = zoo_model("mae_vit_b16", MAE_F32_IM).to(dev)
        with torch.no_grad():
            pred = model.eval()(device_normalize(imgs.to(dev)), mask.to(dev)).cpu()
        st = TrainState(model)
        start = st.params.cpu().clone()
        m = train_step(st, {"image": imgs.to(dev), "label": torch.zeros(MAE_F32_BATCH,
                                                                        dtype=torch.long,
                                                                        device=dev)},
                       2e-3, task="mae", mask=mask.to(dev))
        res[dev] = (pred, m["loss_sum"].item() / MAE_F32_BATCH, st.params.cpu(),
                    st.params.cpu() - start, st.grads[:-1].cpu())
    reset_cfg()
    (oc, lc, pc, uc, gc), (og, lg, pg, ug, gg) = res["cpu"], res["cuda"]

    def rel_l2(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    d = dict(pred=float((og - oc).abs().max() / oc.abs().max()), loss=abs(lc - lg) / abs(lc),
             params=float((pg - pc).abs().max() / pc.abs().max()), update_l2=rel_l2(ug, uc))
    grad_l2 = rel_l2(gg, gc)
    limits = dict(pred=F32_REL_TOL, loss=BOT_F32_LOSS_RTOL, params=TRAIN_F32_REL_TOL,
                  update_l2=MAE_F32_UPDATE_RL2)
    say(f"[mae f32] MAE-ViT-B/16 {MAE_F32_IM}^2 batch {MAE_F32_BATCH}, mask {int(mask.sum())} of "
        f"{mask.numel()} tokens, card vs CPU: eval predictions {d['pred']:.2e} of max|pred| "
        f"(limit {F32_REL_TOL}); one LAMB step: loss {lg:.6f} / {lc:.6f}; "
        + ", ".join(f"{k} {v:.2e} (limit {limits[k]})" for k, v in d.items() if k != "pred")
        + f"; the gradient {grad_l2:.2e} (relative L2, no limit)")
    if not all(d[k] <= v for k, v in limits.items()) or not torch.isfinite(og).all():
        fail("[mae f32] the card's f32 MAE forward or step is outside the stated limits")
    return dict(d, grad_l2=grad_l2, limits=limits)


# [pretrained]: MODEL.PRETRAINED on the card. A seeded ResNet-50 written as a
# torchvision .pth (num_batches_tracked included), provisioned with the port's
# CLI into $DTPU_PRETRAINED_DIR/resnet50, and botnet50 from it with
# --from-resnet50; test_net with MODEL.PRETRAINED True (the CLI, deferred to
# run_test_nets) and, in this process, test_model's logits bitwise those of
# MODEL.WEIGHTS on the same directory.
PRE_ARGS = ["--cfg", "config/resnet50.yaml", "MODEL.DUMMY_INPUT", "True", "TEST.BATCH_SIZE", "32",
            "TRAIN.DUMMY_EPOCH_SAMPLES", "64", "CUDNN.DETERMINISTIC", "True"]


def torchvision_file(path: Path, arch: str, seed: int) -> dict:
    """A seeded ``arch`` state_dict as a downloaded torchvision file holds it
    (running statistics drawn, ``num_batches_tracked`` beside them)."""
    import torch

    from distribuuuu_tpu_torch.models import build_model, layers

    sd = {k: v.clone() for k, v in layers.init_weights(
        build_model(arch), torch.Generator().manual_seed(seed)).state_dict().items()}
    gen = torch.Generator().manual_seed(seed + 1)
    for k in sd:
        if k.endswith("running_mean"):
            sd[k] = torch.randn(sd[k].shape, generator=gen) * 0.1
        elif k.endswith("running_var"):
            sd[k] = torch.rand(sd[k].shape, generator=gen) + 0.5
    torch.save(dict(sd, **{k.replace("running_mean", "num_batches_tracked"): torch.tensor(5)
                           for k in sd if k.endswith("running_mean")}), path)
    return sd


def captured_test_model(argv: list, out: Path) -> list:
    """``trainer.test_model`` on the card in this process with ``argv``; the
    logits of each val batch, from a forward hook on the model it builds."""
    import torch

    from distribuuuu_tpu_torch import trainer
    from distribuuuu_tpu_torch.config import load_cfg_fom_args, reset_cfg

    logits, build = [], trainer.build_cfg_model

    def spy(*a):
        model = build(*a)
        model.register_forward_hook(lambda m, i, o: logits.append(o.detach().cpu()))
        return model

    before = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    reset_cfg()
    load_cfg_fom_args(argv=[*argv, "OUT_DIR", str(out)])
    trainer.build_cfg_model = spy
    try:
        trainer.test_model()
    finally:
        trainer.build_cfg_model = build
        reset_cfg()
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before
    return logits


def phase_pretrained(tmp: Path, deferred: list) -> dict:
    import os

    import torch

    from distribuuuu_tpu_torch import checkpoint as ckpt
    from distribuuuu_tpu_torch.convert import botnet50_trunk_from_resnet50, merge_pretrained
    from distribuuuu_tpu_torch.models import build_model, layers

    src, root = tmp / "resnet50.pth", tmp / "pretrained"
    want = torchvision_file(src, "resnet50", seed=3)
    tic = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", "distribuuuu_tpu_torch.convert", "--arch",
                               arch, "--src", str(src), "--dst", str(root / arch), *extra],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for arch, extra in (("resnet50", []), ("botnet50", ["--from-resnet50"]))]
    for p in procs:
        text = p.communicate(timeout=300)[0]
        if p.returncode != 0:
            fail(f"[pretrained] the provisioning CLI exited {p.returncode}:\n{text[-3000:]}")
    cli_s = time.perf_counter() - tic
    for arch in ("resnet50", "botnet50"):
        if ckpt.verify_checkpoint(str(root / arch)) != ("ok", []):
            fail(f"[pretrained] {root / arch} does not verify against its manifest")
    got = {a: torch.load(root / a / "checkpoint.pt", weights_only=True)["model"]
           for a in ("resnet50", "botnet50")}
    bot = merge_pretrained(layers.init_weights(build_model("botnet50"),
                                               torch.Generator().manual_seed(0)).state_dict(),
                           botnet50_trunk_from_resnet50(torch.load(src, weights_only=True)))
    for name, a, b in (("resnet50", got["resnet50"], want), ("botnet50", got["botnet50"], bot)):
        if a.keys() != b.keys() or not all(torch.equal(a[k], b[k]) for k in b):
            fail(f"[pretrained] the provisioned {name} is not its source")
    env = {"DTPU_PRETRAINED_DIR": str(root)}
    os.environ.update(env)
    try:
        pre = captured_test_model([*PRE_ARGS, "MODEL.PRETRAINED", "True"], tmp / "eval_pre")
    finally:
        del os.environ["DTPU_PRETRAINED_DIR"]
    weights = captured_test_model([*PRE_ARGS, "MODEL.WEIGHTS", str(root / "resnet50")],
                                  tmp / "eval_weights")
    bitwise = len(pre) == len(weights) > 0 and all(torch.equal(a, b) for a, b in
                                                   zip(pre, weights))
    say(f"[pretrained] provisioned resnet50 and botnet50 --from-resnet50 with python -m "
        f"distribuuuu_tpu_torch.convert in {cli_s:.1f} s (both concurrently), each verified and "
        f"equal to its source ({len(want)} / {len(bot)} tensors); test_model MODEL.PRETRAINED "
        f"True: {len(pre)} val batches of logits "
        f"{'bitwise' if bitwise else 'NOT bitwise'} those of MODEL.WEIGHTS on the directory")
    if not bitwise or not all(torch.isfinite(t).all() for t in pre):
        fail("[pretrained] MODEL.PRETRAINED's logits differ from MODEL.WEIGHTS' on the same "
             "directory")
    res = dict(cli_s=cli_s, batches=len(pre))
    deferred.append(Evaluation(["distribuuuu_tpu_torch.test_net", *PRE_ARGS,
                                "MODEL.PRETRAINED", "True", "OUT_DIR", str(tmp / "eval_cli")],
                               tmp / "eval_cli.log", "[pretrained] test_net MODEL.PRETRAINED "
                               "True (resnet50)", res, env=env))
    return res


# [input], [train-jpeg], [oracle]: the real-image input path. A JPEG
# ImageFolder written from a seed: JPEG_SPLITS images over JPEG_CLASSES class
# folders at ImageNet's most common size, each a seeded low-frequency pattern
# (a JPEG_GRID of random colours, bicubic) plus uniform noise of +-JPEG_NOISE,
# which lands the files near ImageNet's ~110 KB mean at quality 90
JPEG_SPLITS = {"train": 4096, "val": 512}
JPEG_CLASSES = 100
JPEG_SIZE = (500, 375)  # (w, h)
JPEG_QUALITY = 90
JPEG_GRID, JPEG_NOISE = (24, 32), 36
# TRAIN.PROFILE_START, TRAIN.PROFILE_STEPS of [train-jpeg]'s 32 steps: mid-epoch,
# while the loader still decodes (it runs up to 6 batches ahead: a queue of
# TRAIN.PREFETCH * 2 and the prefetcher's 2)
JPEG_PROFILE = (16, 3)
JPEG_VAL_BATCH = 200  # TEST.BATCH_SIZE's default: 512 = 2 x 200 + 112, a padded last batch
# the digits oracle of tutorial/real_data_oracle.py:main as train_net
# overrides on config/resnet18.yaml: 1497 train and 300 val images, 23 steps
# an epoch, and the band its best val Acc@1 must reach (ORACLE_MIN_ACC1 at
# tutorial/real_data_oracle.py:76; the JAX package's transcript: 76.7)
ORACLE_ARGS = ["MODEL.NUM_CLASSES", "10", "MODEL.SYNCBN", "True", "TRAIN.IM_SIZE", "32",
               "TEST.IM_SIZE", "36", "TEST.CROP_SIZE", "32", "TRAIN.BATCH_SIZE", "64",
               "TEST.BATCH_SIZE", "64", "OPTIM.BASE_LR", "0.05", "OPTIM.WARMUP_EPOCHS", "1",
               "OPTIM.MAX_EPOCH", "5", "RNG_SEED", "1", "TRAIN.AUTO_RESUME", "False"]
ORACLE_EPOCHS, ORACLE_STEPS, ORACLE_VAL = 5, 23, 300
ORACLE_MIN_ACC1 = 65.0
ORACLE_K1 = 20  # K1 launches per ResNet-18 training step; as many K1-bwd


def write_jpeg(path: Path, seed: int, index: int) -> int:
    """One JPEG of the [input] folder, drawn from ``(seed, index)``; its bytes."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng([seed, index])
    coarse = Image.fromarray(rng.integers(0, 256, (*JPEG_GRID, 3), dtype=np.uint8))
    low = np.asarray(coarse.resize(JPEG_SIZE, Image.Resampling.BICUBIC), np.int16)
    noise = rng.integers(-JPEG_NOISE, JPEG_NOISE + 1, low.shape, dtype=np.int16)
    Image.fromarray(np.clip(low + noise, 0, 255).astype(np.uint8)).save(path, quality=JPEG_QUALITY)
    return path.stat().st_size


def write_jpeg_imagefolder(root: Path, seed: int = 0) -> dict:
    """``root/{train,val}/c<k>/<i>.jpg`` (class ``i % JPEG_CLASSES``), one
    thread a core (PIL's encoder releases the GIL)."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    jobs, first = [], 0
    for split, n in JPEG_SPLITS.items():
        for k in range(JPEG_CLASSES):
            (root / split / f"c{k:03d}").mkdir(parents=True)
        jobs += [(root / split / f"c{i % JPEG_CLASSES:03d}" / f"{i:05d}.jpg", first + i)
                 for i in range(n)]
        first += n
    tic = time.perf_counter()
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        sizes = list(pool.map(lambda job: write_jpeg(job[0], seed, job[1]), jobs))
    return dict(files=len(sizes), mean_bytes=statistics.fmean(sizes),
                wall_s=time.perf_counter() - tic)


def phase_input(card: str, root: Path, smi: str) -> dict:
    """[input]: the port's HostDataLoader alone, no model: the train
    transform (RandomResizedCrop to 224^2 + flip) over JPEG_SPLITS["train"]
    JPEGs in batches of LADDER_BATCH, decoded into pinned memory as the
    trainer runs it, at TRAIN.WORKERS 4 (the config's default) and at
    min(32, cpu count); then the time to pin a decoded batch, on the
    consumer's side (``pin_memory()``, what the step paid before) and on
    the producer's (a block from the caching host allocator + the copy)."""
    import os

    import torch

    from distribuuuu_tpu_torch.data import loader, native
    from distribuuuu_tpu_torch.data.dataset import open_image_dataset

    ds = open_image_dataset(str(root / "train"))
    cpus = os.cpu_count()
    res = {"cpu_count": cpus, "images_per_s": {}}
    for workers in sorted({4, min(32, cpus)}):
        ld = loader.HostDataLoader(ds, host_batch=LADDER_BATCH, train=True, im_size=IM,
                                   process_index=0, process_count=1, workers=workers, seed=0,
                                   pin_device=torch.device("cuda"))
        tic, n = time.perf_counter(), 0
        for batch in ld:
            n += batch["image"].shape[0]
            if not batch["image"].is_pinned():
                fail("[input] the loader's producer handed over an unpinned batch")
        res["images_per_s"][workers] = n / (time.perf_counter() - tic)
        res["decoder"] = ld.decoder
    if n != JPEG_SPLITS["train"] // LADDER_BATCH * LADDER_BATCH:
        fail(f"[input] the loader yielded {n} images, want {JPEG_SPLITS['train']}")
    batch = ld.decode_batch(0)["image"]
    pin, fresh = [], []
    for _ in range(10):
        tic = time.perf_counter()
        torch.from_numpy(batch).pin_memory()
        pin.append(time.perf_counter() - tic)
        tic = time.perf_counter()
        t = torch.empty(batch.shape, dtype=torch.uint8, pin_memory=True)
        t.numpy()[...] = batch
        fresh.append(time.perf_counter() - tic)
        del t
    res.update(pin_ms=1e3 * statistics.median(pin), producer_pin_ms=1e3 * statistics.median(fresh),
               batch_mb=batch.nbytes / 1e6)
    why = "" if res["decoder"] == "native" else f" (native: {native.unavailable_reason()})"
    say(f"[input] HostDataLoader, train transform to {IM}^2, batch {LADDER_BATCH}, pinned, "
        f"{JPEG_SPLITS['train']} JPEGs of {JPEG_SIZE[0]}x{JPEG_SIZE[1]}: decoder "
        f"{res['decoder']}{why}; os.cpu_count() {cpus}; " + ", ".join(
            f"{v:.0f} images/s at TRAIN.WORKERS {w}" for w, v in res["images_per_s"].items())
        + f"; pinning a decoded {res['batch_mb']:.1f} MB batch: pin_memory() "
        f"{res['pin_ms']:.2f} ms, a cached pinned block + copy {res['producer_pin_ms']:.2f} ms "
        f"({card}; {smi})")
    return res


def phase_train_jpeg(card: str, tmp: Path, root: Path, bound_ms: dict, dummy: dict) -> dict:
    """[train-jpeg]: ``python -m distribuuuu_tpu_torch.train_net --cfg
    config/resnet50.yaml TRAIN.DATASET <root> TRAIN.BATCH_SIZE 128
    OPTIM.MAX_EPOCH 1`` at the recipe's TRAIN.WORKERS: 32 steps on the
    JPEGs, the loss finite, TRAIN_K1 K1 and K1-bwd launches a step (none
    scalar), the val pass counting exactly the 512 val images in padded
    batches of JPEG_VAL_BATCH; step ms, images/s, the Data meter's share of
    the epoch and the profile of 3 steps, beside [train]'s (dummy input)."""
    out = tmp / "train_jpeg"
    steps = JPEG_SPLITS["train"] // LADDER_BATCH
    tic = time.perf_counter()
    log = run_cli(jpeg_train_args(root, out), "train_net ResNet-50 on JPEGs")
    wall = time.perf_counter() - tic
    prog, counts = train_log(log)
    losses = [p[2] for p in prog]
    want = dict(k1=TRAIN_K1 * steps, k1_bwd=TRAIN_K1 * steps, k1_scalar=0, k1_bwd_scalar=0,
                attention=0, attention_bwd=0, attention_bwd_cluster=0, attention_bwd_blockwise=0,
                attention_bwd_scalar=0)
    if counts != want or not all(math.isfinite(v) for v in losses):
        fail(f"[train-jpeg] launches over {steps} steps {counts} (want {want}) or a loss not "
             f"finite: {losses}")
    inp = re.search(r"Input: train (\d+) images .*?decoder: (\w+); (\d+) workers; pinned: (\w+)",
                    log)
    val = re.search(r"Input: val (\d+) images \(\d+ in this process's shard, (\d+) batches of "
                    r"(\d+)\)", log)
    acc = re.search(r"\* Acc@1 (\S+) Acc@5 (\S+) over (\d+) images", log)
    wait = re.search(r"Epoch\[0\] done: .*; data wait (\S+)% of the epoch", log)
    if inp is None or int(inp[1]) != JPEG_SPLITS["train"] or val is None or acc is None \
            or wait is None:
        fail(f"[train-jpeg] the log lacks the input, val or epoch lines:\n{log[-3000:]}")
    n_val, val_batches = JPEG_SPLITS["val"], -(-JPEG_SPLITS["val"] // JPEG_VAL_BATCH)
    if (int(val[1]), int(val[2]), int(val[3]), int(acc[3])) != (n_val, val_batches,
                                                                JPEG_VAL_BATCH, n_val):
        fail(f"[train-jpeg] the val pass counted {acc[3]} images in {val[2]} batches of "
             f"{val[3]}; want exactly {n_val} in {val_batches} padded batches of "
             f"{JPEG_VAL_BATCH}")
    steady = [t for it, t, _ in prog if TRAIN_PRINT * 2 <= it < JPEG_PROFILE[0]]
    step_ms = 1e3 * statistics.median(steady)
    profile = train_profile(out / "profile" / "train_steps.json", JPEG_PROFILE[1], bound_ms,
                            "ResNet-50 on JPEGs", "train-jpeg")
    res = dict(steps=steps, batch=LADDER_BATCH, launches=counts, losses=losses, step_ms=step_ms,
               images_per_s=1e3 * LADDER_BATCH / step_ms, windows=prog, wall_s=wall,
               data_wait_pct=float(wait[1]), decoder=inp[2], workers=int(inp[3]),
               pinned=inp[4] == "True", val_images=int(acc[3]), acc1=float(acc[1]),
               profile=profile)
    say(f"[train-jpeg] train_net ResNet-50 {IM}^2 batch {LADDER_BATCH} on {JPEG_SPLITS['train']} "
        f"JPEGs, {steps} steps in {wall:.1f} s (process start and the val pass included); "
        f"decoder {res['decoder']}, TRAIN.WORKERS {res['workers']}, pinned {res['pinned']}; "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; launches {counts}; step {step_ms:.2f} ms "
        f"(median of the {len(steady)} windows of {TRAIN_PRINT} steps ending at steps "
        f"{TRAIN_PRINT * 2} to {JPEG_PROFILE[0] - 1}), {res['images_per_s']:.0f} images/s, Data "
        f"meter {res['data_wait_pct']:.1f}% of the epoch; ms a step by window (ending at step): "
        + ", ".join(f"{1e3 * t:.0f} ({it})" for it, t, _ in prog)
        + f"; val: {acc[3]} images in {val[2]} batches of {val[3]}, Acc@1 {acc[1]} ({card})")
    dp, jp = dummy.get("profile", {}), profile
    say("[train-jpeg] beside [train] (dummy input, this run): step "
        f"{step_ms:.2f} / {dummy['step_ms']:.2f} ms, {res['images_per_s']:.0f} / "
        f"{dummy['images_per_s']:.0f} images/s, Data meter {res['data_wait_pct']:.1f} / "
        f"{dummy.get('data_wait_pct', float('nan')):.1f}% of the epoch; per step: "
        + ", ".join(f"{k} {jp.get('per_step_us', {}).get(k, 0):.0f} / "
                    f"{dp.get('per_step_us', {}).get(k, 0):.0f} us"
                    for k in sorted(set(jp.get("per_step_us", {})) | set(dp.get("per_step_us", {}))))
        + f"; busy {jp.get('busy_per_step_us', 0):.0f} / {dp.get('busy_per_step_us', 0):.0f} us, "
        f"idle share {100 * jp.get('idle_share', 0):.1f} / {100 * dp.get('idle_share', 0):.1f}%")
    return res


# [train-dataplane]: [train-jpeg]'s command fed by the dataplane service. The
# pool (DATA.WORKERS processes x DATA.WORKER_THREADS threads; 0: cpu_count /
# processes) is the layout whose decode rate alone read highest on the card's
# 8 cores (`scripts/torch_input_workers.py --service` and `--rates-only`):
# the config's default
DP_POOL = (2, 0)
DP_BITWISE_BATCHES = 4  # train batches held bitwise against the local loader
DP_START_S = 60  # the service must print its address within this
# The decode rate a loader sustains alone: train epochs the phase's run did
# not decode (it trains epoch 0), so the service's cache holds none of
# them; of each, the batches after the first DP_RATE_SKIP are timed
DP_RATE_EPOCHS = (1, 2, 3)
DP_RATE_SKIP = 8


def loader_rate(ld, epochs=DP_RATE_EPOCHS, skip: int = DP_RATE_SKIP) -> dict:
    """Images/s ``ld`` (a HostDataLoader or ServiceLoader) sustains alone,
    each batch taken as it comes and dropped: per epoch of ``epochs``, the
    batches after the first ``skip`` over the time from batch ``skip``'s
    arrival to the last's. The untimed batches cover what was decoded
    before the consumer's clock could see it (the dispatcher's DATA.WINDOW
    lead at most); after them each arrival waits on the decode."""
    images, secs = 0, 0.0
    for epoch in epochs:
        ld.set_epoch(epoch)
        for b, batch in enumerate(ld):
            if b == skip:
                tic = time.perf_counter()
            elif b > skip:
                images += batch["image"].shape[0]
        secs += time.perf_counter() - tic
    return dict(images_per_s=images / secs, batches=images // ld.host_batch,
                epochs=list(epochs), skip=skip)


def start_dataplane(root: Path, log_path: Path, workers: int, threads: int):
    """``python -m distribuuuu_tpu_torch.dataplane`` on a free port with a
    pool of ``workers`` processes x ``threads`` threads, in a process group
    of its own (so :func:`stop_dataplane` can reap the group), its output
    in ``log_path``; returns ``(process, address)`` once it serves."""
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "distribuuuu_tpu_torch.dataplane", "--cfg",
         "config/resnet50.yaml", "TRAIN.DATASET", str(root), "DATA.PORT", str(port),
         "DATA.WORKERS", str(workers), "DATA.WORKER_THREADS", str(threads)],
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
    log.close()
    deadline = time.monotonic() + DP_START_S
    while time.monotonic() < deadline:
        m = re.search(r"serving at (\S+)", log_path.read_text())
        if m:
            return proc, m[1]
        if proc.poll() is not None:
            break
        time.sleep(0.2)
    stop_dataplane(proc, log_path)
    fail(f"the dataplane service did not start:\n{log_path.read_text()[-3000:]}")


def stop_dataplane(proc, log_path: Path, pids=()) -> tuple[str, list]:
    """SIGTERM the service (it stops and reaps its workers), then SIGKILL
    its process group, whatever is left of it; its log, and those of
    ``pids`` (its processes) still running after the SIGTERM's 30 s."""
    import os
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass

    def running(pid):
        try:
            return Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0] != "Z"
        except OSError:
            return False
    left = sorted(p for p in pids if running(p))
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait(timeout=30)
    return log_path.read_text(), left


def service_stats(address: str) -> dict:
    """The dispatcher's counters (cache hits and misses, evictions, lease
    re-issues), from its ``ping`` reply."""
    from distribuuuu_tpu_torch.dataplane import protocol

    sock, f = protocol.connect(address, timeout_s=30)
    try:
        protocol.send_msg(f, {"op": "ping"})
        return protocol.recv_msg(f)[0]
    finally:
        f.close()
        sock.close()


def process_tree(pid: int) -> set:
    """``pid`` and its descendants, from ``/proc``."""
    import os

    parents = {}
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                stat = Path(f"/proc/{d}/stat").read_text()
            except OSError:
                continue
            parents[int(d)] = int(stat.rsplit(")", 1)[1].split()[1])
    tree, grew = {pid}, True
    while grew:
        new = {p for p, pp in parents.items() if pp in tree} - tree
        tree |= new
        grew = bool(new)
    return tree


def cuda_holders(pids: set) -> set:
    """Those of ``pids`` with a ``/dev/nvidia*`` device open (a CUDA context
    holds ``/dev/nvidiactl`` and the card's node)."""
    import os

    held = set()
    for pid in pids:
        try:
            fds = os.listdir(f"/proc/{pid}/fd")
        except OSError:
            continue
        for fd in fds:
            try:
                if os.readlink(f"/proc/{pid}/fd/{fd}").startswith("/dev/nvidia"):
                    held.add(pid)
                    break
            except OSError:
                continue
    return held


class CudaWatch(threading.Thread):
    """While a training subprocess runs, every 2 s: which processes of the
    service's tree, and of this process's other children (the trainer: the
    control that shows the check sees a context), hold a ``/dev/nvidia*``
    device. (``nvidia-smi --query-compute-apps`` is no use here: in a
    container it lists the host namespace's pids.)"""

    def __init__(self, service_pid: int):
        super().__init__(daemon=True)
        self.service_pid, self.done = service_pid, threading.Event()
        self.service_pids, self.service_cuda, self.trainer_cuda = set(), set(), set()

    def run(self) -> None:
        import os

        while not self.done.wait(2.0):
            tree = process_tree(self.service_pid)
            self.service_pids |= tree
            self.service_cuda |= cuda_holders(tree)
            self.trainer_cuda |= cuda_holders(process_tree(os.getpid()) - tree - {os.getpid()})


def jpeg_train_args(root: Path, out: Path) -> list:
    """[train-jpeg]'s ``train_net`` command on the JPEG folder ``root``."""
    return ["distribuuuu_tpu_torch.train_net", "--cfg", "config/resnet50.yaml",
            "TRAIN.DATASET", str(root), "TRAIN.BATCH_SIZE", str(LADDER_BATCH),
            "OPTIM.MAX_EPOCH", "1", "TRAIN.PRINT_FREQ", str(TRAIN_PRINT), "RNG_SEED", "0",
            "OUT_DIR", str(out), "TRAIN.PROFILE", "True", "TRAIN.PROFILE_START",
            str(JPEG_PROFILE[0]), "TRAIN.PROFILE_STEPS", str(JPEG_PROFILE[1])]


def dataplane_train(card: str, tmp: Path, root: Path, bound_ms: dict, pool: tuple,
                    tag: str) -> dict:
    """[train-jpeg]'s command with ``DATA.SERVICE`` on a service of ``pool``
    (processes, threads) and ``DATA.FALLBACK False``: 53/53 launches a step,
    none scalar, the loss finite, the val pass over exactly the 512 val
    images in padded batches through the service, zero fallbacks, no CUDA
    context in the service's processes (``nvidia-smi`` and their open
    devices, polled while the trainer runs), then DP_BITWISE_BATCHES train
    batches pulled through a ``ServiceLoader`` bitwise the local
    ``HostDataLoader``'s, and the service's sustained decode rate
    (:func:`loader_rate`, none of its batches a cache hit); step ms, the
    Data meter, the profile, the service's cache and lease counters. The
    step cannot show the decode rate: the service decodes the first ~16
    batches (the dispatcher's window, the requests in flight and the two
    queues) while the trainer starts, and the timed windows read that lead.
    Stops the service and its workers in any case."""
    import numpy as np
    import torch

    from distribuuuu_tpu_torch.data import loader
    from distribuuuu_tpu_torch.data.dataset import open_image_dataset
    from distribuuuu_tpu_torch.dataplane.client import ServiceLoader

    out = tmp / f"train_dp_{pool[0]}x{pool[1]}"
    svc_log = tmp / f"dataplane_{pool[0]}x{pool[1]}.log"
    proc, address = start_dataplane(root, svc_log, *pool)
    watch = CudaWatch(proc.pid)
    try:
        watch.start()
        tic = time.perf_counter()
        log = run_cli([*jpeg_train_args(root, out), "DATA.SERVICE", address, "DATA.FALLBACK",
                       "False"], f"train_net ResNet-50 on JPEGs through the dataplane {pool}")
        wall = time.perf_counter() - tic
        watch.done.set()
        watch.join(timeout=30)
        prog, counts = train_log(log)
        losses = [p[2] for p in prog]
        steps = JPEG_SPLITS["train"] // LADDER_BATCH
        want = dict(k1=TRAIN_K1 * steps, k1_bwd=TRAIN_K1 * steps, k1_scalar=0, k1_bwd_scalar=0,
                    attention=0, attention_bwd=0, attention_bwd_cluster=0,
                    attention_bwd_blockwise=0, attention_bwd_scalar=0)
        if counts != want or not all(math.isfinite(v) for v in losses):
            fail(f"[{tag}] launches over {steps} steps {counts} (want {want}) or a loss not "
                 f"finite: {losses}")
        n_val, val_batches = JPEG_SPLITS["val"], -(-JPEG_SPLITS["val"] // JPEG_VAL_BATCH)
        svc = re.escape(f"service {address}")
        inp = re.search(rf"Input: train (\d+) images .*?decoder: (\w+); {svc} \((\d+) "
                        rf"DATA.WORKERS x (\d+) threads\); pinned: True", log)
        val = re.search(rf"Input: val {n_val} images \(\d+ in this process's shard, "
                        rf"{val_batches} batches of {JPEG_VAL_BATCH}\) .*{svc}", log)
        acc = re.search(rf"\* Acc@1 (\S+) Acc@5 (\S+) over {n_val} images; input: {svc}, 0 "
                        rf"fallback\(s\)", log)
        wait = re.search(rf"Epoch\[0\] done: .*; data wait (\S+)% of the epoch; input: {svc}, "
                         rf"0 fallback\(s\)", log)
        if None in (inp, val, acc, wait) or int(inp[1]) != JPEG_SPLITS["train"] \
                or "falling back" in log:
            fail(f"[{tag}] the log lacks the service's input lines, the val pass over {n_val} "
                 f"images in {val_batches} padded batches, or zero fallbacks:\n{log[-3000:]}")
        if watch.service_cuda or not watch.trainer_cuda:
            fail(f"[{tag}] the service's processes {sorted(watch.service_pids)} hold a CUDA "
                 f"context (/dev/nvidia* open in {sorted(watch.service_cuda)}), or the check "
                 f"saw none in the trainer ({sorted(watch.trainer_cuda)})")
        # the first batches again, through a ServiceLoader, against local decode
        train_root = str(root / "train")
        kw = dict(host_batch=LADDER_BATCH, train=True, im_size=IM, process_index=0,
                  process_count=1, seed=0)
        remote = ServiceLoader(address, root=train_root, fallback=False, **kw)
        local = loader.HostDataLoader(open_image_dataset(train_root), workers=8, **kw)
        got = list(itertools.islice(remote, DP_BITWISE_BATCHES))
        for b, batch in enumerate(got):
            want_b = local.decode_batch(b)
            for k in ("image", "label", "weight"):
                if not np.array_equal(batch[k].numpy(), want_b[k]):
                    fail(f"[{tag}] train batch {b} {k!r} through the service differs from the "
                         f"local HostDataLoader's")
        before = service_stats(address)
        rate = loader_rate(ServiceLoader(address, root=train_root, fallback=False,
                                         pin_device=torch.device("cuda"), **kw))
        stats = service_stats(address)
        if stats["hits"] != before["hits"] or stats["misses"] - before["misses"] < \
                len(DP_RATE_EPOCHS) * steps:
            fail(f"[{tag}] the rate pass over epochs {DP_RATE_EPOCHS} read the service's cache "
                 f"(hits {before['hits']} -> {stats['hits']}, decodes {before['misses']} -> "
                 f"{stats['misses']})")
    finally:
        watch.done.set()
        svc_text, left = stop_dataplane(proc, svc_log, watch.service_pids)
    if left:
        fail(f"[{tag}] the service's processes {left} outlived its SIGTERM by 30 s")
    if len(got) != DP_BITWISE_BATCHES or not isinstance(got[0]["image"], torch.Tensor):
        fail(f"[{tag}] the ServiceLoader gave {len(got)} batches, want {DP_BITWISE_BATCHES}")
    steady = [t for it, t, _ in prog if TRAIN_PRINT * 2 <= it < JPEG_PROFILE[0]]
    step_ms = 1e3 * statistics.median(steady)
    profile = train_profile(out / "profile" / "train_steps.json", JPEG_PROFILE[1], bound_ms,
                            f"ResNet-50 on JPEGs through the dataplane {pool}", tag)
    res = dict(pool=list(pool), address=address, steps=steps, batch=LADDER_BATCH,
               launches=counts, losses=losses, step_ms=step_ms,
               images_per_s=1e3 * LADDER_BATCH / step_ms, windows=prog, wall_s=wall,
               data_wait_pct=float(wait[1]), decoder=inp[2], val_images=n_val,
               acc1=float(acc[1]), profile=profile, fallbacks=0, bitwise_batches=len(got),
               service_stats={k: stats[k] for k in ("hits", "misses", "evictions", "reissues")},
               service_rate=rate,
               service_pids=sorted(watch.service_pids), trainer_cuda=sorted(watch.trainer_cuda))
    say(f"[{tag}] train_net ResNet-50 {IM}^2 batch {LADDER_BATCH} on {JPEG_SPLITS['train']} "
        f"JPEGs through the dataplane at {address} (DATA.WORKERS {pool[0]} x DATA.WORKER_THREADS "
        f"{pool[1]}, decoder {res['decoder']}, DATA.FALLBACK False), {steps} steps in "
        f"{wall:.1f} s; loss {losses[0]:.4f} -> {losses[-1]:.4f}; launches {counts}; step "
        f"{step_ms:.2f} ms (median of the {len(steady)} windows ending at steps "
        f"{TRAIN_PRINT * 2} to {JPEG_PROFILE[0] - 1}), {res['images_per_s']:.0f} images/s, Data "
        f"meter {res['data_wait_pct']:.1f}% of the epoch, idle share "
        f"{100 * profile.get('idle_share', float('nan')):.1f}%; ms a step by window: "
        + ", ".join(f"{1e3 * t:.0f} ({it})" for it, t, _ in prog)
        + f"; val: {n_val} images in {val_batches} padded batches through the service, Acc@1 "
        f"{acc[1]}; 0 fallbacks; service cache hits {stats['hits']}, decodes (misses) "
        f"{stats['misses']}, evictions {stats['evictions']}, lease re-issues "
        f"{stats['reissues']}; {len(got)} train batches bitwise the local HostDataLoader's; "
        f"the service alone sustains {rate['images_per_s']:.0f} images/s ({rate['batches']} "
        f"uncached batches of epochs {rate['epochs']}, each epoch's first {rate['skip']} "
        f"untimed; the step above cannot show this rate, for its windows read the lead the "
        f"service decoded while the trainer started); "
        f"no CUDA context in the service's {len(watch.service_pids)} processes (no "
        f"/dev/nvidia* open there, against the trainer's {sorted(watch.trainer_cuda)}) "
        f"({card})")
    stopped = re.search(r"stopped; (.*)", svc_text)
    say(f"[{tag}] the service stopped and reaped its workers: "
        f"{stopped[1] if stopped else svc_text[-300:]}")
    return res


def phase_train_dataplane(card: str, tmp: Path, root: Path, bound_ms: dict, jpeg: dict,
                          dummy: dict, local: dict) -> dict:
    """[train-dataplane]: :func:`dataplane_train` at DP_POOL, printed beside
    [train-jpeg] and [train] (dummy input) of the same run, and its decode
    rate beside [input]'s (``local``) and the rate [train] consumes."""
    res = dataplane_train(card, tmp, root, bound_ms, DP_POOL, "train-dataplane")
    rate = res["service_rate"]["images_per_s"]
    say(f"[train-dataplane] decode rate: the service at {DP_POOL} sustains {rate:.0f} images/s "
        f"alone, {rate / dummy['images_per_s']:.2f}x the {dummy['images_per_s']:.0f} images/s "
        f"[train] consumes on the dummy batch; local HostDataLoader ([input], one epoch from a "
        f"cold start) " + ", ".join(f"{v:.0f} images/s at TRAIN.WORKERS {w}"
                                    for w, v in local["images_per_s"].items()) + f" ({card})")
    rows = (("dataplane", res), ("jpeg", jpeg), ("dummy", dummy))
    classes = sorted({k for _, r in rows for k in r.get("profile", {}).get("per_step_us", {})})
    say("[train-dataplane] beside [train-jpeg] and [train] (this run), dataplane / jpeg / dummy: "
        "step " + " / ".join(f"{r['step_ms']:.2f}" for _, r in rows) + " ms, "
        + " / ".join(f"{r['images_per_s']:.0f}" for _, r in rows) + " images/s, Data meter "
        + " / ".join(f"{r.get('data_wait_pct', float('nan')):.1f}" for _, r in rows)
        + "% of the epoch; per step: " + ", ".join(
            f"{k} " + " / ".join(f"{r.get('profile', {}).get('per_step_us', {}).get(k, 0):.0f}"
                                 for _, r in rows) + " us" for k in classes)
        + "; busy " + " / ".join(f"{r.get('profile', {}).get('busy_per_step_us', 0):.0f}"
                                 for _, r in rows)
        + " us, idle share " + " / ".join(
            f"{100 * r.get('profile', {}).get('idle_share', 0):.1f}" for _, r in rows) + "%")
    return res


# [train-preempt]: SIGTERM -> emergency checkpoint -> bitwise resume, and
# the watchdog, on [train]'s ResNet-50 command
PREEMPT_STEPS = 16  # steps an epoch, 2 epochs
PREEMPT_PRINT = 2  # TRAIN.PRINT_FREQ
PREEMPT_MARGIN_S = 30  # the hang run's exit, past the hang and the timeout


def preempt_args(out: Path, *extra) -> list:
    return ["distribuuuu_tpu_torch.train_net", *train_args("config/resnet50.yaml", LADDER_BATCH,
                                                           out),
            "TRAIN.PRINT_FREQ", str(PREEMPT_PRINT), "CUDNN.DETERMINISTIC", "True",
            "OPTIM.MAX_EPOCH", "2", "TRAIN.DUMMY_EPOCH_SAMPLES", str(LADDER_BATCH * PREEMPT_STEPS),
            *extra]


def watch_cli(args: list, what: str, until: str | None = None, timeout: int = 300):
    """``python -m <args>`` as a subprocess, its stderr read line by line,
    each line with the seconds since the start it was read at. With
    ``until``, SIGTERM is sent on reading the first line that matches it.
    Returns ``(exit code, [(s, line)], the matching line's index or None,
    the seconds to the exit)``."""
    tic = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT, stderr=subprocess.PIPE,
                            stdout=subprocess.DEVNULL, text=True)
    lines, hit = [], None
    killer = threading.Timer(timeout, proc.kill)
    killer.start()
    try:
        for line in proc.stderr:
            lines.append((time.perf_counter() - tic, line))
            if until is not None and hit is None and re.search(until, line):
                hit = len(lines) - 1
                proc.send_signal(signal.SIGTERM)
        proc.wait()
        wall = time.perf_counter() - tic
    finally:
        killer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode == -signal.SIGKILL:
        fail(f"{what} passed its {timeout} s limit:\n{''.join(l for _, l in lines)[-3000:]}")
    return proc.returncode, lines, hit, wall


def launch_lines(log: str) -> dict:
    """``{epoch: (K1, K1-bwd, steps-normalised K1 a step, K1-bwd a step)}`` of a log."""
    return {int(m[1]): (int(m[2]), int(m[4]), float(m[3]), float(m[5])) for m in re.finditer(
        r"Epoch\[(\d+)\] K1 launches: (\d+) forward \((\S+) a step\), (\d+) backward "
        r"\((\S+) a step\)", log)}


def final_tensors(out: Path) -> dict:
    import torch

    return torch.load(out / "checkpoints" / "ckpt_ep_002" / "checkpoint.pt", map_location="cpu",
                      weights_only=True)


def phase_train_preempt(card: str, tmp: Path, smi: str) -> dict:
    """[train-preempt]: the uninterrupted run, the SIGTERM run, its
    relaunch and the hang run (module docstring, item 18)."""
    import torch

    from distribuuuu_tpu_torch import checkpoint as ckpt

    tic = time.perf_counter()
    whole = tmp / "whole"
    log = run_cli(preempt_args(whole), "train_net [train-preempt] uninterrupted")
    prog = [(int(m[1]), float(m[2])) for m in re.finditer(
        r"Epoch\[0\] \[\s*(\d+)/\d+\]\s+Time (\S+) \(", log)]
    if not prog:
        fail(f"[train-preempt] the uninterrupted run printed no progress:\n{log[-3000:]}")
    first_window_s = prog[0][1]
    counts = launch_lines(log)
    want = (TRAIN_K1 * PREEMPT_STEPS, TRAIN_K1 * PREEMPT_STEPS, float(TRAIN_K1), float(TRAIN_K1))
    if counts.get(0) != want or counts.get(1) != want:
        fail(f"[train-preempt] uninterrupted launches {counts}; want {want} an epoch")

    # SIGTERM once the log shows a step of epoch 2 (index 1)
    out = tmp / "preempted"
    rc, lines, hit, _ = watch_cli(preempt_args(out), "[train-preempt] SIGTERM run",
                               until=r"Epoch\[1\] \[\s*\d+/")
    text = "".join(l for _, l in lines)
    if hit is None or rc != 143:
        fail(f"[train-preempt] the SIGTERM run exited {rc} (want 143; signal sent: "
             f"{hit is not None}):\n{text[-3000:]}")
    seen_step = int(re.search(r"Epoch\[1\] \[\s*(\d+)/", lines[hit][1])[1])
    m = re.search(r"Preempted at epoch 1 step (\d+): emergency checkpoint (\S+) committed in "
                  r"(\S+) ms \((\d+) bytes\)", text)
    if m is None:
        fail(f"[train-preempt] no emergency checkpoint line:\n{text[-3000:]}")
    stop, mid, save_ms, save_bytes = int(m[1]), m[2], float(m[3]), int(m[4])
    status, errors = ckpt.verify_checkpoint(mid)
    mids = sorted(p.name for p in (out / "checkpoints").iterdir() if p.name.startswith("ckpt_mid"))
    if not Path(mid).name.startswith("ckpt_mid_ep_001_it_") or status != "ok" or \
            mids != [Path(mid).name]:
        fail(f"[train-preempt] emergency checkpoint {mid}: {status} {errors}; mids {mids}")
    pre_counts = launch_lines(text)
    if pre_counts.get(0) != want:
        fail(f"[train-preempt] the SIGTERM run's epoch 0 launches {pre_counts}; want {want}")

    # the relaunch on the same OUT_DIR
    rc, lines, _, _ = watch_cli(preempt_args(out), "[train-preempt] relaunch")
    text = "".join(l for _, l in lines)
    resumed = re.search(rf"Resumed from \S+{Path(mid).name} \(epoch 1, step {stop},", text)
    first = next((t for t, l in lines if re.search(r"Epoch\[1\] \[\s*\d+/", l)), None)
    rest = PREEMPT_STEPS - stop
    rel_counts = launch_lines(text).get(1)
    if rc != 0 or resumed is None or first is None:
        fail(f"[train-preempt] relaunch exited {rc}, resumed {resumed is not None}:\n"
             f"{text[-3000:]}")
    if rel_counts != (TRAIN_K1 * rest, TRAIN_K1 * rest, float(TRAIN_K1), float(TRAIN_K1)):
        fail(f"[train-preempt] the relaunch's epoch 1 launches {rel_counts} over {rest} steps")
    a, b = final_tensors(whole), final_tensors(out)
    diffs = {}
    for part in ("model", "optimizer"):
        for k in a[part]:
            x, y = a[part][k], b[part][k]
            if not torch.equal(x, y):
                diffs[f"{part}.{k}"] = float((x.double() - y.double()).abs().max())
    if diffs:
        worst = max(diffs, key=diffs.get)
        fail(f"[train-preempt] the resumed run's final tensors differ from the uninterrupted "
             f"run's in {len(diffs)} tensor(s), worst {worst} by {diffs[worst]:.3e}")

    # the watchdog: a hang at global step 3 under a timeout just above the first window
    hang_timeout = max(5, math.ceil(2 * first_window_s) + 2)
    hang = tmp / "hang"
    rc, lines, _, end_s = watch_cli(preempt_args(hang, "FAULT.INJECT_HANG_STEP", "3",
                                                 "FAULT.HANG_TIMEOUT_S", str(hang_timeout)),
                                    "[train-preempt] hang run")
    hung_s = next((t for t, l in lines if "FAULT INJECTION: hanging" in l), None)
    rank_log = "".join(p.read_text() for p in hang.glob("*.log"))
    if rc != 124 or hung_s is None or end_s - hung_s > hang_timeout + PREEMPT_MARGIN_S or \
            "stack dump (watchdog" not in rank_log or "in hang_now" not in rank_log:
        fail(f"[train-preempt] the hang run exited {rc} (want 124) "
             f"{end_s - (hung_s or 0):.1f} s after the hang (timeout {hang_timeout} s):\n"
             f"{rank_log[-3000:]}")
    # the SIGTERM run's epoch 0 and the relaunch's rest of epoch 1
    launches = {"k1": pre_counts[0][0] + rel_counts[0], "k1_bwd": pre_counts[0][1] + rel_counts[1]}
    res = dict(steps=PREEMPT_STEPS, batch=LADDER_BATCH, first_window_s=first_window_s,
               launches=launches,
               signal_seen_step=seen_step, stop_step=stop, steps_after_signal=stop - seen_step - 1,
               save_ms=save_ms, save_bytes=save_bytes, relaunch_to_first_step_s=first,
               bitwise=True, hang_timeout_s=hang_timeout, hang_exit_s=end_s - hung_s,
               wall_s=time.perf_counter() - tic)
    say(f"[train-preempt] ResNet-50 b{LADDER_BATCH}, CUDNN.DETERMINISTIC, {PREEMPT_STEPS} steps "
        f"an epoch: SIGTERM on reading step {seen_step}'s line of epoch 1 -> stopped before step "
        f"{stop} ({res['steps_after_signal']} step(s) after the signal), exit 143; emergency save "
        f"{save_ms:.1f} ms, {save_bytes} bytes ({save_bytes / save_ms / 1e6:.2f} GB/s); relaunch "
        f"to its first step {first:.1f} s; final model and optimizer tensors torch.equal to the "
        f"uninterrupted run's; hang at step 3: exit 124 {end_s - hung_s:.1f} s after it "
        f"(HANG_TIMEOUT_S {hang_timeout}, first window {first_window_s:.2f} s a step), stacks "
        f"in the rank log; phase {res['wall_s']:.0f} s ({card}; {smi})")
    return res


def phase_oracle(card: str, tmp: Path) -> dict:
    """[oracle]: the digits recipe of ``tutorial/real_data_oracle.py:main``
    through ``train_net`` on the card (ORACLE_ARGS over
    ``config/resnet18.yaml``; the port's ``digits_imagefolder``): val Acc@1
    and Acc@5 an epoch over exactly ORACLE_VAL images, ORACLE_K1 K1 and
    K1-bwd launches a step; fails below the band ORACLE_MIN_ACC1."""
    from distribuuuu_tpu_torch.data.provision import digits_imagefolder

    root = digits_imagefolder(str(tmp / "digits"))
    tic = time.perf_counter()
    log = run_cli(["distribuuuu_tpu_torch.train_net", "--cfg", "config/resnet18.yaml",
                   "TRAIN.DATASET", root, *ORACLE_ARGS, "OUT_DIR", str(tmp / "oracle")],
                  "train_net digits oracle")
    wall = time.perf_counter() - tic
    curve = [(float(a), float(b), int(n)) for a, b, n in
             re.findall(r"\* Acc@1 (\S+) Acc@5 (\S+) over (\d+) images", log)]
    _, counts = train_log(log)
    dec = re.search(r"Input: train (\d+) images .*?(\d+) batches of \d+\) .*?decoder: (\w+)", log)
    want = dict(k1=ORACLE_K1 * ORACLE_STEPS, k1_bwd=ORACLE_K1 * ORACLE_STEPS)
    if len(curve) != ORACLE_EPOCHS or any(n != ORACLE_VAL for *_, n in curve) or dec is None \
            or int(dec[2]) != ORACLE_STEPS \
            or any(counts[k] != v for k, v in want.items()) or counts["k1_scalar"]:
        fail(f"[oracle] want {ORACLE_EPOCHS} val passes over {ORACLE_VAL} images each and "
             f"{want} launches in epoch 0 of {ORACLE_STEPS} steps; got {curve}, {counts}:\n"
             f"{log[-3000:]}")
    best = max(a for a, _, _ in curve)
    say(f"[oracle] train_net ResNet-18 on the digits ImageFolder ({dec[1]} train JPEGs, "
        f"{ORACLE_VAL} val; decoder {dec[3]}), {ORACLE_EPOCHS} epochs of {ORACLE_STEPS} steps in "
        f"{wall:.1f} s: val Acc@1 / Acc@5 by epoch " + ", ".join(
            f"{a:.3f} / {b:.3f}" for a, b, _ in curve)
        + f"; best Acc@1 {best:.3f} (band >= {ORACLE_MIN_ACC1:.0f}); launches in epoch 0 "
        f"{counts} ({card})")
    if best < ORACLE_MIN_ACC1:
        fail(f"[oracle] best val Acc@1 {best:.3f} is below the oracle's band of "
             f"{ORACLE_MIN_ACC1:.0f}")
    return dict(curve=curve, best_acc1=best, launches=counts, wall_s=wall, decoder=dec[3])


def cuda_ms(fn, runs: int = 25, warmup: int = 3, batch: int = 1) -> float:
    """Median over ``runs`` CUDA-event timings of ``batch`` back-to-back
    calls, per call, after warm-up. ``batch`` 1 times a call from an idle
    stream, host cost included; a larger ``batch`` lets the host enqueue
    ahead, so a call that takes the device longer than the host reads as
    its device time."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def graph_ms(fns, runs: int = 20) -> float:
    """Device time per call of the zero-argument callables ``fns``, captured
    in order in one CUDA graph and replayed (median over ``runs`` replays):
    back to back with no host cost between the launches. Every call's
    output stays allocated until the graph goes, so each writes memory of
    its own; inputs a caller repeats within the L2's 50 MB are read from
    there on a replay (:func:`k1_rotation` avoids that)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # capture wants its warm-up off the default stream
        for fn in (list(fns) * 3)[:3]:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn() for fn in fns]
    ms = cuda_ms(graph.replay, runs=runs) / len(fns)
    del graph, outs
    return ms


def phase_build(names=("epilogue", "attention", "moe")) -> dict:
    """Build every kernel library at once (one nvcc each, in parallel)."""
    from distribuuuu_tpu_torch.ops import _build

    results: dict = {}

    def build(name):
        try:
            results[name] = _build.load(name)[1]
        except Exception as exc:  # reported below; the phase fails
            results[name] = exc

    threads = [threading.Thread(target=build, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out = {}
    for name in names:
        info = results[name]
        if isinstance(info, Exception):
            fail(f"building {name}: {info}")
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", info.ptxas)]
        spills = [ln.strip() for ln in info.ptxas.splitlines()
                  if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        if not regs:
            fail(f"nvcc gave no -Xptxas -v report for {name}:\n{info.ptxas}")
        say(f"[build] {info.path.name}: nvcc {info.wall_s:.2f}s; {len(regs)} instantiations, "
            f"{min(regs)}-{max(regs)} registers/thread, spills: {spills or 'none'}")
        out[name] = dict(build_s=info.wall_s, registers=regs, spills=spills)
    return out


# (name, B, N, L, D, Dv, dtype, mode): the shapes the BoTNet paths give the
# attention kernel (4 heads of 128 at 224^2 batch 128, and at 512^2 batch 8);
# K2's shape with an f32 bias; bf16 and f32 at a small ragged shape (L, D, Dv
# not multiples of the tiles: D and Dv zero-filled to 128 in shared memory, a
# bias row of 140 bytes copied in 4-byte units). mode: "bias" (in q's dtype),
# "f32 bias" or "table".
ATTN_CASES = [
    ("K2", 128, 4, 196, 128, 128, "bfloat16", "bias"),
    ("K3", 128, 4, 196, 128, 128, "bfloat16", "table"),
    ("K4", 8, 4, 1024, 128, 128, "bfloat16", "bias"),
    ("K5", 8, 4, 1024, 128, 128, "bfloat16", "table"),
    ("K2 f32-bias", 128, 4, 196, 128, 128, "bfloat16", "f32 bias"),
    ("bf16 ragged bias", 2, 3, 70, 40, 24, "bfloat16", "bias"),
    ("bf16 ragged table", 2, 3, 70, 40, 24, "bfloat16", "table"),
    ("f32 bias", 2, 3, 70, 40, 24, "float32", "bias"),
    ("f32 table", 2, 3, 70, 40, 24, "float32", "table"),
]
ATTN_BATCH = 10  # back-to-back calls per timing (cuda_ms)


def attention_flops(bn, l, d, dv) -> float:
    """The two products, q.k^T and p.v (the table mode's q.emb^T not counted)."""
    return 2.0 * bn * l * l * (d + dv)


def attention_bound(bn, l, d, dv, dtype, mode, bw) -> tuple[float, str, float]:
    """(bound ms, what bounds it, bytes): q, k, v read once, the output
    written once, plus the [B, N, L, L] bias in its dtype or the [L, D]
    table; the two products (q.k and p.v) at the card's peak for the
    inputs' type."""
    item = 2 if dtype == "bfloat16" else 4
    bias_item = 4 if mode == "f32 bias" else item
    nbytes = bn * l * (2 * d + 2 * dv) * item + (
        l * d * item if mode == "table" else bn * l * l * bias_item)
    flops = attention_flops(bn, l, d, dv)
    peak = BF16_PEAK_FLOPS if dtype == "bfloat16" else F32_PEAK_FLOPS
    by = "bytes" if nbytes / bw >= flops / peak else "operations"
    return 1e3 * max(nbytes / bw, flops / peak), by, nbytes


def phase_attention(card: str):
    """The attention kernel vs its plain version at the paths' shapes."""
    import torch
    import torch.nn.functional as F

    from distribuuuu_tpu_torch.ops import attention as att

    bw = hbm_bytes_per_s(card)
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = {}
    for name, b, n, l, d, dv, dtype, mode in ATTN_CASES:
        dt = getattr(torch, dtype)

        def heads_first(width, scale=1.0):  # the [B, N, L, d] view MHSA hands the kernel
            t = torch.randn(b, l, n * width, generator=gen, device="cuda") * scale
            return t.to(dt).view(b, l, n, width).transpose(1, 2)

        q, k, v = heads_first(d, 0.3), heads_first(d, 0.3), heads_first(dv)
        table = mode == "table"
        if not table:  # bf16 at the model's shapes, as RelPosEmb produces it
            bias_dt = torch.float32 if mode == "f32 bias" else dt
            last = (torch.randn(b, n, l, l, generator=gen, device="cuda") * 0.5).to(bias_dt)

            def kernel():
                return att.fused_attention(q, k, v, last)

            def plain():
                return att.attention_reference(q, k, v, last)

            mask = last.to(dt)  # SDPA takes a float mask in q's dtype

            def library():
                return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0)
        else:
            last = (torch.randn(l, d, generator=gen, device="cuda") * 0.5).to(dt)

            def kernel():
                return att.fused_attention_abs(q, k, v, last)

            def plain():
                return att.attention_table_reference(q, k, v, last)

            def library():  # the q.emb^T product formed first, in q's dtype
                mask = torch.einsum("bnxd,yd->bnxy", q, last)
                return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0)

        got, want = kernel(), plain()
        blockwise = att.attention_blockwise_reference(q, k, v, last, table=table)
        torch.cuda.synchronize()
        if got.dtype != dt or got.shape != (b, n, l, dv):
            fail(f"attention {name}: output {got.dtype} {tuple(got.shape)}")
        scale = max(1.0, want.float().abs().max().item())
        err = (got.float() - want.float()).abs().max().item()
        blk_scale = max(1.0, blockwise.float().abs().max().item())
        blk_err = (got.float() - blockwise.float()).abs().max().item()
        lib_err = (library().float() - want.float()).abs().max().item()
        tol = ATTN_TOL[dtype] * scale
        blk_tol = ATTN_BLOCKWISE_TOL[dtype] * blk_scale
        if not err <= tol:
            fail(f"attention {name} != plain: max|d| {err:.3e} > {tol:.3e}")
        if not blk_err <= blk_tol:
            fail(f"attention {name} != blockwise plain: max|d| {blk_err:.3e} > {blk_tol:.3e}")
        ms, plain_ms, lib_ms = (cuda_ms(fn, batch=ATTN_BATCH) for fn in (kernel, plain, library))
        single_ms = cuda_ms(kernel)
        bound_ms, bound_by, nbytes = attention_bound(b * n, l, d, dv, dtype, mode, bw)
        tflops = attention_flops(b * n, l, d, dv) / (ms * 1e-3) / 1e12
        rows[name] = dict(b=b, n=n, l=l, d=d, dv=dv, dtype=dtype, mode=mode, max_abs_err=err,
                          tol=tol, blockwise_max_abs_err=blk_err, blockwise_tol=blk_tol,
                          library_max_abs_err=lib_err, ms=ms, single_call_ms=single_ms,
                          plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                          bound_by=bound_by, bytes=nbytes, tflops=tflops)
        say(f"[attention] {name}: B*N {b * n}, L {l}, D {d}, Dv {dv}, {dtype} {mode}: max|d| "
            f"{err:.3e} (limit {tol:.1e}), vs blockwise {blk_err:.3e} (limit {blk_tol:.1e}), "
            f"SDPA {lib_err:.3e}; {ms:.4f} ms (single call {single_ms:.4f}; plain {plain_ms:.4f}, "
            f"SDPA {lib_ms:.4f}, bound {bound_ms:.4f} by {bound_by}, "
            f"{100 * bound_ms / ms:.0f}% of bound, {tflops:.1f} TFLOP/s)")
        del q, k, v, last, got, want, blockwise
    torch.cuda.empty_cache()
    return rows


# [attention-bwd]: (name, B, N, L, D, Dv, q/k/v/g dtype, bias dtype or "table",
# timed): the shapes BoTNet-50 training gives the backward (4 heads of 128:
# batch 32 at 224^2, the [train-bot] run; batch 128; batch 8 at 512^2, L
# 1024, K4's shape; batch 32 at 512^2, the [train-bot-512] run), an f32 bias
# under bf16 q/k/v, an f32 model at both L, and
# a small ragged shape in both dtypes (L, D, Dv not multiples of anything);
# the table mode (K3/K5's backward, with demb) at K3's training shapes (B*N
# 128 and 512, L 196), K5's (B*N 32, L 1024), in f32 and ragged. The route
# follows from the dtype and L (ops/attention.backward_route): bf16 at L <= 256
# the cluster kernel, bf16 above it the blockwise kernels, f32 the scalar ones.
ATTN_BWD_CASES = [
    ("K2 train", 32, 4, 196, 128, 128, "bfloat16", "bfloat16", True),
    ("K2 b128", 128, 4, 196, 128, 128, "bfloat16", "bfloat16", True),
    ("K4", 8, 4, 1024, 128, 128, "bfloat16", "bfloat16", True),
    ("K4 b32", 32, 4, 1024, 128, 128, "bfloat16", "bfloat16", True),
    ("K2 f32-bias", 32, 4, 196, 128, 128, "bfloat16", "float32", False),
    ("K2 f32", 32, 4, 196, 128, 128, "float32", "float32", False),
    ("K4 f32", 8, 4, 1024, 128, 128, "float32", "float32", False),
    ("bf16 ragged", 2, 3, 70, 40, 24, "bfloat16", "bfloat16", False),
    ("f32 ragged", 2, 3, 70, 40, 24, "float32", "bfloat16", False),
    ("K3 train", 32, 4, 196, 128, 128, "bfloat16", "table", True),
    ("K3 b128", 128, 4, 196, 128, 128, "bfloat16", "table", True),
    ("K5", 8, 4, 1024, 128, 128, "bfloat16", "table", True),
    ("K3 f32", 32, 4, 196, 128, 128, "float32", "table", False),
    ("bf16 ragged table", 2, 3, 70, 40, 24, "bfloat16", "table", False),
    ("f32 ragged table", 2, 3, 70, 40, 24, "float32", "table", False),
]
# The backward kernel vs attention_backward_reference, relative to
# max(1, max|grad|) of each of dq, dk, dv, dbias, by that gradient's dtype
# (dbias has the bias's): both compute every
# intermediate in f32 and round each gradient once to its input's dtype, so
# f32 differs in summation order only (the forward's 2e-5) and bf16 by at
# most an ulp of the rounded gradient where the two f32 sums straddle a
# rounding boundary (2^-7); 2e-2 is the forward's bf16 bound. The table
# mode's demb the same, against attention_table_backward_reference.
ATTN_BWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# And the error's L2 norm relative to the reference's, by the same dtype,
# which scales with the data where the limit above does not: at L 1024 a
# typical dbias (ds) entry is ~1e-2 and max(1, max|grad|) is 1, so that limit
# alone would pass a ds wrong everywhere but at its few largest entries. bf16:
# rounding each gradient once (2^-9 relative) and p and ds rounded to bf16 as
# `mma` operands; f32: summation order.
ATTN_BWD_REL_L2 = {"float32": 1e-5, "bfloat16": 1e-2}


def grad_errors(x, z) -> tuple[float, float, float]:
    """(max|x - z|, the same over max(1, max|z|), ||x - z||_2 / ||z||_2)."""
    xf, zf = x.float(), z.float()
    err = (xf - zf).abs().max().item()
    return (err, err / max(1.0, zf.abs().max().item()),
            ((xf - zf).norm() / zf.norm().clamp_min(1e-30)).item())


def grads_pass(readings: dict, dtypes: dict) -> bool:
    """Whether every gradient's (_, max-relative, L2-relative) reading is
    within ATTN_BWD_TOL and ATTN_BWD_REL_L2 for its dtype."""
    return all(r[1] <= ATTN_BWD_TOL[dtypes[k]] and r[2] <= ATTN_BWD_REL_L2[dtypes[k]]
               for k, r in readings.items())


def planted_faults(names, got, want, table: bool) -> dict:
    """Two faults planted in the kernel's gradients, each read against the
    plain version as the kernel's own are: ds scaled by 1.1 (dq, dk and
    dbias or demb are linear in ds, so each scales by 1.1) and, in bias
    mode, dbias with its entries below the median |dbias| (estimated from
    every 101st entry) zeroed. Per fault: the largest max-relative and
    L2-relative reading over the gradients, and whether the max check alone
    passes it; fails if both checks together pass it."""
    dtypes = {k: str(z.dtype).removeprefix("torch.") for k, z in zip(names, want)}
    faults = {"ds x1.1": [x if i == 2 else x * 1.1 for i, x in enumerate(got)]}
    if not table:
        mag = got[3].abs()
        median = mag.flatten()[::101].float().median()
        faults["dbias zeroed below its median"] = [*got[:3], got[3].masked_fill(mag < median, 0)]
    out = {}
    for fault, xs in faults.items():
        readings = {k: grad_errors(x, z) for k, x, z in zip(names, xs, want)}
        out[fault] = dict(max_rel=max(r[1] for r in readings.values()),
                          max_rel_l2=max(r[2] for r in readings.values()),
                          passes_max_check=all(r[1] <= ATTN_BWD_TOL[dtypes[k]]
                                               for k, r in readings.items()))
        if grads_pass(readings, dtypes):
            fail(f"attention backward: the planted fault '{fault}' passes the checks ({out[fault]})")
    return out


def attention_bwd_inputs(gen, b, n, l, d, dv, dtype, bias_dtype):
    """q, k, v, the [B, N, L, L] bias (or the [L, D] table) and g of one
    backward call, as the head-split views MHSA and its backward give them:
    q and k N(0, 0.09), v and g N(0, 1), the bias N(0, 0.25)."""
    import torch

    dt = getattr(torch, dtype)
    table = bias_dtype == "table"

    def heads_first(width, scale=1.0):
        t = torch.randn(b, l, n * width, generator=gen, device="cuda") * scale
        return t.to(dt).view(b, l, n, width).transpose(1, 2)

    shape = (l, d) if table else (b, n, l, l)
    last = (torch.randn(*shape, generator=gen, device="cuda") * 0.5).to(
        dt if table else getattr(torch, bias_dtype))
    return heads_first(d, 0.3), heads_first(d, 0.3), heads_first(dv), last, heads_first(dv)


def attention_bwd_bound(bn, l, d, dv, dtype, bias_dtype, bw) -> tuple[float, str, float]:
    """(bound ms, what bounds it, bytes) of one backward call: q, k, v, g
    and the [B, N, L, L] bias (or the [L, D] table) read once, dq, dk, dv
    and dbias (or demb) written once; the five products (q.k^T, g.v^T,
    p^T.g, ds.k, ds^T.q) at the card's peak for the inputs' type. In table
    mode the table folds into q.(k + emb)^T and ds.(k + emb), so the
    products are the same five, and demb = sum over heads of dk adds none."""
    item = 2 if dtype == "bfloat16" else 4
    nbytes = bn * l * (2 * d + 2 * dv) * item + bn * l * (2 * d + dv) * item
    if bias_dtype == "table":
        nbytes += 2 * l * d * item
    else:
        nbytes += 2 * bn * l * l * (2 if bias_dtype == "bfloat16" else 4)
    flops = 2.0 * bn * l * l * (3 * d + 2 * dv)
    peak = BF16_PEAK_FLOPS if dtype == "bfloat16" else F32_PEAK_FLOPS
    by = "bytes" if nbytes / bw >= flops / peak else "operations"
    return 1e3 * max(nbytes / bw, flops / peak), by, nbytes


def phase_attention_bwd(card: str) -> dict:
    """The attention backward kernels (``fused_attention_backward``, and
    ``fused_attention_abs_backward`` in table mode) against the plain
    backward at ATTN_BWD_CASES: every gradient's dtype, shape and error, two
    calls bitwise equal, the route each call took and its launches. The
    timed cases three ways (device time from a CUDA-graph replay cycling
    through input sets past the L2, back to back, a single call), beside the
    plain version, a library yardstick that the port never calls (the
    backward alone of ``F.scaled_dot_product_attention`` with the bias
    needing a gradient; in table mode autograd through ``einsum(q, emb)``
    and SDPA's backward), and the bound."""
    import torch
    import torch.nn.functional as F

    from distribuuuu_tpu_torch.ops import attention as att

    bw = hbm_bytes_per_s(card)
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = {}
    for name, b, n, l, d, dv, dtype, bias_dtype, timed in ATTN_BWD_CASES:
        table = bias_dtype == "table"
        dt = getattr(torch, dtype)
        fn = att.fused_attention_abs_backward if table else att.fused_attention_backward
        plain = att.attention_table_backward_reference if table else att.attention_backward_reference

        def inputs(_=0):
            return attention_bwd_inputs(gen, b, n, l, d, dv, dtype, bias_dtype)

        args = inputs()
        route = att.backward_route(dt, l)
        before = (att.BWD_LAUNCHES, att.TABLE_BWD_LAUNCHES, dict(att.BWD_ROUTE_CALLS))
        got = fn(*args)
        again = fn(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        calls = (att.BWD_LAUNCHES - before[0], att.TABLE_BWD_LAUNCHES - before[1])
        routes = {k: v - before[2][k] for k, v in att.BWD_ROUTE_CALLS.items() if v != before[2][k]}
        if calls != ((0, 2) if table else (2, 0)) or routes != {route: 2}:
            fail(f"attention backward {name}: calls {calls}, by route {routes} for 2 calls; "
                 f"want 2 on the {route} route")
        names = ("dq", "dk", "dv", "demb" if table else "dbias")
        readings, dtypes = {}, {}
        for gname, x, y, z in zip(names, got, again, want):
            if x.dtype != z.dtype or x.shape != z.shape or not x.is_contiguous():
                fail(f"attention backward {name}: {gname} {x.dtype} {tuple(x.shape)}")
            if not torch.equal(x, y):
                fail(f"attention backward {name}: two calls differ in {gname}")
            readings[gname] = grad_errors(x, z)
            dtypes[gname] = str(z.dtype).removeprefix("torch.")
        errs = {k: r[0] for k, r in readings.items()}
        rel = {k: r[1] for k, r in readings.items()}
        rel_l2 = {k: r[2] for k, r in readings.items()}
        if not grads_pass(readings, dtypes):
            fail(f"attention backward {name} != plain: max|d|/max(1, max|grad|) {rel}, "
                 f"||d||/||grad|| {rel_l2}; limits {ATTN_BWD_TOL}, {ATTN_BWD_REL_L2} by dtype "
                 f"{dtypes}")
        faults = planted_faults(names, got, want, table)
        launches = {route: att.ROUTE_LAUNCHES[route], **({"demb": 2} if table else {})}
        bound_ms, bound_by, nbytes = attention_bwd_bound(b * n, l, d, dv, dtype, bias_dtype, bw)
        row = dict(b=b, n=n, l=l, d=d, dv=dv, dtype=dtype, bias_dtype=bias_dtype, route=route,
                   launches_per_call=launches, max_abs_err=max(errs.values()), errors=errs,
                   rel_errors=rel, rel_l2_errors=rel_l2, planted_faults=faults,
                   bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes)
        del got, again, want
        msg = ""
        if timed:
            row.update(rotated_timings(fn, lambda i: args if i == 0 else inputs(), nbytes))
            row["kernels_us"] = kernel_split(lambda: fn(*args))
            row["plain_ms"] = cuda_ms(lambda: plain(*args), runs=10, batch=2)
            q, k, v, last, g = args
            if table:
                leaves = [t.detach().requires_grad_() for t in (q, k, v, last)]
                mask = torch.einsum("bnxd,yd->bnxy", leaves[0], leaves[3])
            else:
                leaves = [t.detach().requires_grad_() for t in (q, k, v, last.to(dt))]
                mask = leaves[3]
            out = F.scaled_dot_product_attention(*leaves[:3], attn_mask=mask, scale=1.0)
            row["library_ms"] = cuda_ms(
                lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), batch=ATTN_BATCH)
            del out, leaves, mask
            msg = (f"; device {row['device_ms']:.4f} ms ({100 * bound_ms / row['device_ms']:.0f}% "
                   f"of bound {bound_ms:.4f} by {bound_by}, {nbytes / 1e6:.1f} MB), back to back "
                   f"{row['back_to_back_ms']:.4f}, single call {row['single_call_ms']:.4f}; by "
                   f"kernel (us a call) " + ", ".join(
                       f"{k} {v:.1f}" for k, v in row["kernels_us"].items()) + "; plain "
                   f"{row['plain_ms']:.4f}, " + ("einsum + SDPA backward" if table else
                                                 "SDPA backward") + f" {row['library_ms']:.4f}")
        rows[name] = row
        say(f"[attention-bwd] {name}: B*N {b * n}, L {l}, D {d}, Dv {dv}, {dtype} q/k/v/g, "
            + ("[L, D] table" if table else f"{bias_dtype} bias")
            + f", {route} route ({row['launches_per_call']} launches a call): "
            f"max|d|/max(1, max|grad|) " + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
            + f" (limits {ATTN_BWD_TOL}), ||d||/||grad|| "
            + ", ".join(f"{k} {v:.2e}" for k, v in rel_l2.items())
            + f" (limits {ATTN_BWD_REL_L2}); planted faults rejected: " + ", ".join(
                f"{f} (max {r['max_rel']:.2e}, L2 {r['max_rel_l2']:.2e}; "
                f"{'passes' if r['passes_max_check'] else 'fails'} the max check alone)"
                for f, r in faults.items())
            + "; two calls bitwise equal" + msg)
        del args
    torch.cuda.empty_cache()
    return rows


def kernel_split(call, calls: int = 10) -> dict:
    """Device µs a call of each CUDA kernel that ``call`` launches, from
    ``torch.profiler`` over ``calls`` calls back to back (names shortened
    to the kernel's own)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = re.sub(r"^void |\(anonymous namespace\)::|<.*$|\(.*$", "", e.key)
            out[name] = out.get(name, 0.0) + e.device_time_total / calls
    return out


def synthetic_state_dict(arch: str = "resnet50", seed: int = 0, im: int = IM):
    """Seeded weights: fan-in normal convs (and SE convs), BN stats and
    affine drawn away from the identity (every BN scale, BoTNet's zero-γ
    ``bn_out`` too), position tables at their init scale, a small fc (the
    last linear); ViT's linears fan-in normal, its class token and position
    table N(0, 0.02), its LayerNorms as the BNs' affine."""
    import numpy as np
    import torch

    from distribuuuu_tpu_torch.models import build_model

    rng = np.random.default_rng(seed)
    model = build_model(arch, num_classes=1000, dtype=torch.float32, im_size=im)
    fc = [n for n, m in model.named_modules() if isinstance(m, torch.nn.Linear)][-1]
    sd = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k == f"{fc}.weight":
            a = rng.standard_normal(shape) / np.sqrt(shape[1])
        elif k == f"{fc}.bias":
            a = rng.standard_normal(shape) * 0.01
        elif k.rsplit(".", 1)[-1] in ("rel_height", "rel_width", "height", "width"):
            a = rng.standard_normal(shape) * shape[1] ** -0.5
        elif v.dim() == 4:
            a = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif v.dim() == 2:  # ViT's linears, the packed qkv among them
            a = rng.standard_normal(shape) / np.sqrt(shape[1])
        elif v.dim() == 3:  # ViT's class token and position table
            a = rng.standard_normal(shape) * 0.02
        elif k.endswith("running_mean") or k.endswith("bias"):
            a = rng.standard_normal(shape) * 0.1
        elif k.endswith("running_var"):
            a = rng.uniform(0.5, 2.0, shape)
        elif k.endswith(".weight"):
            a = rng.uniform(0.5, 1.5, shape)
        else:
            fail(f"unexpected state_dict entry {k}")
        sd[k] = torch.from_numpy(a.astype(np.float32))
    return sd


def calibrate_bn(sd: dict, arch: str, im: int, batch: int = 16) -> dict:
    """``sd`` with the running statistics of the BNs that feed each MHSA
    (``bn_in``) and of the BoTStack's shortcut BN set to the statistics of
    their input over ``batch`` seeded serving-like images (one f32 forward
    on the card). Random statistics leave the trunk's output in the
    thousands, so q.k^T reaches ~1e4, the softmax is one-hot and bf16
    rounding of q and k flips it: the JAX model itself then puts bf16 16 %
    from f32. Calibrated, the MHSA inputs and the BoTStack's residual stream
    are at unit scale, as in a trained network. The other BNs keep their
    random statistics: calibrating ``bn_mid`` would divide the small spread
    of a near-uniform attention output by its own std and amplify bf16
    rounding, and calibrating the trunk makes it chaotic."""
    import numpy as np
    import torch

    from distribuuuu_tpu_torch.data.transforms import device_normalize
    from distribuuuu_tpu_torch.models import build_model, layers
    from distribuuuu_tpu_torch.models.botnet import BoTBlock

    model = build_model(arch, num_classes=1000, dtype=torch.float32, im_size=im)
    model.load_state_dict(sd, strict=True)
    model = model.to("cuda", memory_format=torch.channels_last).eval()
    bns = [bn for blk in model.modules() if isinstance(blk, BoTBlock)
           for bn in (blk.net[1], *([blk.shortcut[1]] if isinstance(blk.shortcut, torch.nn.Sequential)
                                    else []))]
    by_mean = {id(bn.running_mean): bn for bn in bns}
    real = layers.fused_conv_epilogue

    def recalibrating(x, mean, mul, bias, *args, **kw):
        bn = by_mean.get(id(mean))
        if bn is None:
            return real(x, mean, mul, bias, *args, **kw)
        bn.running_mean.copy_(x.float().mean((0, 2, 3)))
        bn.running_var.copy_(x.float().var((0, 2, 3), unbiased=False))
        return real(x, *bn.affine(), *args, **kw)

    imgs = np.random.default_rng(5).integers(0, 256, size=(batch, im, im, 3), dtype=np.uint8)
    try:
        layers.fused_conv_epilogue = recalibrating
        with torch.no_grad():
            model(device_normalize(torch.from_numpy(imgs).cuda()))
    finally:
        layers.fused_conv_epilogue = real
    return {k: v.cpu() for k, v in model.state_dict().items()}


def phase_serve(card: str, tmp: Path, arch: str, k1_bound_us: dict):
    """Serve ``arch`` from config/serve_resnet50.yaml with ``MODEL.ARCH`` and
    ``SERVE.MODELS`` overridden: the user's entry point at full width.
    ``k1_bound_us``: K1's bound per forward at batch 1 and 128, for the
    profile."""
    import numpy as np
    import torch

    from distribuuuu_tpu_torch.config import cfg, load_cfg_fom_args, reset_cfg
    from distribuuuu_tpu_torch.data.transforms import device_normalize
    from distribuuuu_tpu_torch.models import build_model
    from distribuuuu_tpu_torch.ops import attention as att
    from distribuuuu_tpu_torch.ops import epilogue as ep
    from distribuuuu_tpu_torch.serve.engine import parse_model_specs
    from distribuuuu_tpu_torch.serve.frontend import ServeReplica, run_http

    want = SERVED[arch]
    name = want["name"]
    sd = synthetic_state_dict(arch, 0)
    if want["attention"]:
        sd = calibrate_bn(sd, arch, IM)
    weights = tmp / f"{name}.pt"
    torch.save(sd, weights)
    reset_cfg()
    load_cfg_fom_args(argv=["--cfg", str(SERVE_CFG), "MODEL.ARCH", arch, "SERVE.MODELS",
                            f"['{name}={arch}@{weights}']", "SERVE.PORT", "0",
                            "OUT_DIR", str(tmp / "out")])
    cfg.freeze()
    s = cfg.SERVE
    if (int(cfg.MODEL.NUM_CLASSES), str(cfg.MODEL.DTYPE), int(s.IM_SIZE),
            str(s.INPUT_DTYPE), list(s.BATCH_SIZES)) != (
            1000, "bfloat16", 224, "uint8", [1, 8, 32, 128]):
        fail(f"{SERVE_CFG} no longer describes the full-width serving config")

    # --- the main path: counts zeroed just before, read just after ---------
    ep.LAUNCHES = ep.SCALAR_LAUNCHES = att.LAUNCHES = att.TABLE_LAUNCHES = 0
    tic = time.perf_counter()
    replica = ServeReplica(parse_model_specs(list(s.MODELS)))
    startup_s = time.perf_counter() - tic
    engine = replica.engine
    stop, ready = threading.Event(), threading.Event()
    http = threading.Thread(target=run_http, args=(replica, stop, ready), daemon=True)
    http.start()
    try:
        if not ready.wait(30):
            fail("HTTP frontend did not bind")
        rng = np.random.default_rng(1)
        sizes = [1, 3, 8, 20, 128]
        reqs = [rng.integers(0, 256, size=(k, IM, IM, 3), dtype=np.uint8) for k in sizes]
        responses: list = [None] * len(reqs)
        errors: list = []

        def client(i):
            try:
                responses[i] = replica.handle({"model": name, "inputs": {
                    "b64": base64.b64encode(reqs[i].tobytes()).decode(),
                    "shape": list(reqs[i].shape)}})
            except Exception as exc:  # reported below; the phase fails
                errors.append(repr(exc))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        if errors or any(t.is_alive() for t in threads):
            fail(f"serving requests failed: {errors}")
        http_imgs = rng.integers(0, 256, size=(2, IM, IM, 3), dtype=np.uint8)
        body = json.dumps({"model": name, "inputs": {
            "b64": base64.b64encode(http_imgs.tobytes()).decode(),
            "shape": list(http_imgs.shape)}}).encode()
        url = f"http://127.0.0.1:{replica.port}"
        with urllib.request.urlopen(urllib.request.Request(
                url + "/v1/predict", data=body,
                headers={"Content-Type": "application/json"}), timeout=60) as r:
            http_resp = json.loads(r.read())
        with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
            health = json.loads(r.read())
        launches = dict(k1=ep.LAUNCHES, k1_scalar=ep.SCALAR_LAUNCHES, attention=att.LAUNCHES,
                        table=att.TABLE_LAUNCHES)
        forwards = engine.forwards
    finally:
        stop.set()
        http.join(10)
        replica.shutdown()
    # -----------------------------------------------------------------------
    say(f"[serve {name}] startup {startup_s:.2f}s (load + warmup of every ladder size); "
        f"{forwards} forwards, launches {launches}; /healthz {health}")
    # every K1 launch on the vector route: the scalar one would mean a model
    # tensor lost its 16-byte alignment or C % 8 == 0
    expected = dict(k1=want["k1"] * forwards, k1_scalar=0, attention=want["attention"] * forwards,
                    table=0)
    if forwards < len(engine.batch_sizes) + 2 or launches != expected:
        fail(f"{arch}: launches {launches} != {expected} for {forwards} forwards")
    batch_sizes = [r["batch_size"] for r in responses] + [http_resp["batch_size"]]
    say(f"[serve {name}] request sizes {sizes + [2]} ran at ladder sizes {batch_sizes}")
    # each response equals the direct forward of its own images at its size
    all_reqs = reqs + [http_imgs]
    all_resp = [np.asarray(r["logits"], np.float32) for r in responses] + [
        np.asarray(http_resp["logits"], np.float32)]
    for imgs, got, b in zip(all_reqs, all_resp, batch_sizes):
        padded = np.zeros((b, IM, IM, 3), np.uint8)
        padded[: len(imgs)] = imgs
        direct = engine.forward(name, padded)[: len(imgs)]
        if got.shape != (len(imgs), 1000) or not np.isfinite(got).all():
            fail(f"response of {len(imgs)} images: shape {got.shape} or non-finite logits")
        if not np.array_equal(got, direct):
            fail(f"response of {len(imgs)} images != direct forward at batch {b}: "
                 f"max|d|={np.abs(got - direct).max()}")
    if float(np.std(all_resp[-2])) == 0.0:
        fail("logits have no spread")

    latency, profile = latency_and_profile(engine, name, rng, card, k1_bound_us)

    # (a) f32 on the card (kernels) vs f32 on the CPU (plain versions)
    imgs = torch.from_numpy(reqs[2])  # the 8-image request, served at bf16
    with torch.inference_mode():
        m_gpu = build_model(arch, num_classes=1000, dtype=torch.float32, im_size=IM)
        m_gpu.load_state_dict(sd, strict=True)
        m_cpu = build_model(arch, num_classes=1000, dtype=torch.float32, im_size=IM)
        m_cpu.load_state_dict(sd, strict=True)
        m_gpu = m_gpu.to("cuda", memory_format=torch.channels_last).eval()
        m_cpu = m_cpu.to(memory_format=torch.channels_last).eval()
        f32_gpu = m_gpu(device_normalize(imgs.cuda())).cpu().numpy()
        f32_cpu = m_cpu(device_normalize(imgs)).numpy()
    scale = float(np.abs(f32_cpu).max())
    d_a = float(np.abs(f32_gpu - f32_cpu).max())
    say(f"[check a {name}] f32 card vs f32 CPU: max|d| {d_a:.3e}, max|logit| {scale:.4f}, "
        f"ratio {d_a / scale:.3e} (limit {F32_REL_TOL})")
    if not d_a <= F32_REL_TOL * scale:
        fail(f"{arch}: f32 card logits disagree with the CPU reference")
    # (b) bf16 serve logits vs f32 card logits
    served = all_resp[2]
    d_b = float(np.abs(served - f32_gpu).max()) / float(np.abs(f32_gpu).max())
    top1 = float(np.mean(served.argmax(1) == f32_gpu.argmax(1)))
    say(f"[check b {name}] bf16 serve vs f32: max|d|/max|logit| {d_b:.3e} (limit {BF16_REL_TOL}), "
        f"top-1 agreement {top1:.3f} over {len(served)} images")
    if not d_b <= BF16_REL_TOL:
        fail(f"{arch}: bf16 serve logits are outside the stated tolerance of f32")
    return dict(launches=launches, forwards=forwards, latency_ms=latency, profile=profile,
                f32_ratio=d_a / scale, bf16_ratio=d_b, top1=top1, startup_s=startup_s)


def latency_and_profile(engine, name: str, rng, card: str, k1_bound_us: dict | None = None):
    """Per-ladder-size latency through ``engine.forward`` (host clock, result
    fetch included, median of 15), and the profile at batch 1 and 128."""
    import numpy as np

    latency = {}
    for b in engine.batch_sizes:
        batch = rng.integers(0, 256, size=(b, IM, IM, 3), dtype=np.uint8)
        times = [engine.forward_timed(name, batch)[1] for _ in range(15)]
        latency[b] = statistics.median(times)
        say(f"[serve {name}] batch {b}: median forward {latency[b]:.3f} ms, "
            f"{1000.0 * b / latency[b]:.1f} images/s ({card})")
    profile = {b: profile_forward(engine, name, rng, b, (k1_bound_us or {}).get(b))
               for b in (1, LADDER_BATCH)}
    return latency, profile


def kernel_class(name: str) -> str:
    """The class of a device event in [profile]. copy/cast: PyTorch's copy
    kernels (``direct_copy_kernel_cuda`` and kin: dtype casts and strided
    copies); memcpy/memset: the copy engines' transfers and fills."""
    low = name.lower()
    if "epilogue_bwd" in low:
        return "K1-bwd"
    if "attention_bwd" in low:
        return "attention-bwd"
    if re.search(r"epilogue_(vec_|scalar_)?kernel", low):
        return "K1"
    if "attention_kernel" in low or "attention_mma_kernel" in low:
        return "attention"
    if "copy_kernel" in low:
        return "copy/cast"
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset"
    if any(k in low for k in ("xmma", "conv", "gemm", "cutlass", "cudnn")):
        return "conv/gemm"
    return "other"


def profile_forward(engine, name: str, rng, b: int, k1_bound_us: float | None = None,
                    runs: int = 3) -> dict:
    """Device time of ``runs`` forwards of model ``name`` at batch ``b`` (the
    engine's crop) by kernel class (:func:`kernel_class`), with each class's
    events per forward, from a torch.profiler trace, and the device's idle
    share over the window from the first kernel's start to the last
    kernel's end. ``k1_bound_us``: K1's bound per forward, printed beside
    its time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    batch = rng.integers(0, 256, size=(b, engine.im_size, engine.im_size, 3), dtype=np.uint8)
    engine.forward(name, batch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            engine.forward(name, batch)
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end > 0]
    if not spans:
        say(f"[profile {name}] batch {b}: the profiler recorded no device time (not measured)")
        return {}
    by_class: Counter = Counter()
    count: Counter = Counter()
    by_name: Counter = Counter()
    for kname, start, end in spans:
        cls = kernel_class(kname)
        by_class[cls] += end - start
        count[cls] += 1
        by_name[kname[:60]] += end - start
    busy, last = 0.0, None
    for _, start, end in sorted(spans, key=lambda s: s[1]):
        if last is None or start >= last:
            busy += end - start
            last = end
        elif end > last:
            busy += end - last
            last = end
    window = max(e for _, _, e in spans) - min(s for _, s, _ in spans)
    res = {"per_forward_us": {k: v / runs for k, v in by_class.items()},
           "events_per_forward": {k: v / runs for k, v in count.items()},
           "busy_per_forward_us": busy / runs, "idle_share": 1.0 - busy / window,
           "kernels_per_forward": len(spans) / runs, "k1_bound_us": k1_bound_us,
           "top": [(n, t / runs) for n, t in by_name.most_common(8)]}
    k1 = res["per_forward_us"].get("K1", 0.0)
    bound = "" if not k1_bound_us or not k1 else (
        f" (K1 bound {k1_bound_us:.0f} us, {100 * k1_bound_us / k1:.0f}% of bound)")
    say(f"[profile {name}] batch {b} per forward: " + ", ".join(
        f"{k} {v:.0f} us in {res['events_per_forward'][k]:.0f}"
        for k, v in sorted(res["per_forward_us"].items()))
        + f"; device busy {res['busy_per_forward_us']:.0f} us, idle share "
        f"{100 * res['idle_share']:.1f}%, {res['kernels_per_forward']:.0f} kernels" + bound)
    say(f"[profile {name}] batch {b} top kernels: " + "; ".join(
        f"{n} {t:.0f} us" for n, t in res["top"]))
    return res


def phase_profile_only(card: str, tmp: Path, arch: str) -> None:
    """``--profile-only``: ``arch`` on seeded weights through the serving
    engine at the config's ladder: latency and profile, no checks. A copy of
    this script run from another checkout's root measures that checkout's
    port, so two trees compare in one call."""
    import numpy as np
    import torch

    from distribuuuu_tpu_torch.serve.engine import InferenceEngine, ModelSpec

    name = SERVED[arch]["name"]
    weights = tmp / f"{name}.pt"
    torch.save(synthetic_state_dict(arch, 0), weights)
    engine = InferenceEngine(batch_sizes=[1, 8, 32, LADDER_BATCH], im_size=IM, num_classes=1000,
                             compute_dtype="bfloat16")
    engine.load(ModelSpec(name, arch, str(weights)))
    engine.warmup()
    latency_and_profile(engine, name, np.random.default_rng(1), card)


def phase_large_crop(card: str, tmp: Path, im: int = 512, batch: int = 8, n_cpu: int = 2):
    """botnet50 at a 512^2 crop (fmap 32x32, L 1024: the route of the TPU's
    blockwise K4) through the engine: bf16 and f32 on the card, f32 on the
    CPU for ``n_cpu`` of the images."""
    import numpy as np
    import torch

    from distribuuuu_tpu_torch.ops import attention as att
    from distribuuuu_tpu_torch.ops import epilogue as ep
    from distribuuuu_tpu_torch.serve.engine import InferenceEngine, ModelSpec

    weights = tmp / "bot512.pt"
    torch.save(calibrate_bn(synthetic_state_dict("botnet50", 0, im=im), "botnet50", im, batch),
               weights)
    spec = ModelSpec("bot512", "botnet50", str(weights))
    imgs = np.random.default_rng(4).integers(0, 256, size=(batch, im, im, 3), dtype=np.uint8)

    def engine(dtype, sizes, device=None):
        e = InferenceEngine(batch_sizes=sizes, im_size=im, num_classes=1000,
                            compute_dtype=dtype, device=device)
        e.load(spec)
        return e

    # --- this path: counts zeroed just before, read just after -------------
    ep.LAUNCHES = ep.SCALAR_LAUNCHES = att.LAUNCHES = att.TABLE_LAUNCHES = 0
    bf16, f32 = engine("bfloat16", [batch]), engine("float32", [batch])
    served = bf16.forward("bot512", imgs)
    f32_card = f32.forward("bot512", imgs)
    launches = dict(k1=ep.LAUNCHES, k1_scalar=ep.SCALAR_LAUNCHES, attention=att.LAUNCHES,
                    table=att.TABLE_LAUNCHES)
    # -----------------------------------------------------------------------
    want = SERVED["botnet50"]
    if launches != dict(k1=2 * want["k1"], k1_scalar=0, attention=2 * want["attention"], table=0):
        fail(f"botnet50 at {im}^2: launches {launches} != {want['k1']} K1 (all on the vector "
             f"route) and {want['attention']} attention per forward")
    ms = statistics.median(bf16.forward_timed("bot512", imgs)[1] for _ in range(5))
    f32_cpu = engine("float32", [n_cpu], device="cpu").forward("bot512", imgs[:n_cpu])
    scale = float(np.abs(f32_cpu).max())
    d_a = float(np.abs(f32_card[:n_cpu] - f32_cpu).max()) / scale
    d_b = float(np.abs(served - f32_card).max()) / float(np.abs(f32_card).max())
    say(f"[large crop] botnet50 {im}^2 batch {batch}: launches {launches} over 2 forwards; "
        f"f32 card vs CPU {d_a:.3e} (limit {F32_REL_TOL}), bf16 vs f32 {d_b:.3e} "
        f"(limit {BF16_REL_TOL}); bf16 forward {ms:.3f} ms ({card})")
    if not (np.isfinite(served).all() and d_a <= F32_REL_TOL and d_b <= BF16_REL_TOL):
        fail(f"botnet50 at {im}^2 is outside the stated tolerances")
    return dict(launches=launches, f32_ratio=d_a, bf16_ratio=d_b, forward_ms=ms)


def phase_mhsa_table() -> dict:
    """``MHSA(rel_pos_emb=False)`` at BoTNet-50's width (512 in, 4 heads of
    128): the table mode, at fmap 14x14 batch 128 (K3's shape) and fmap
    32x32 batch 8 (K5's). Serving: f32 and bf16 on the card, f32 on the CPU
    for a few of the images. Training: forward + backward of a seeded output
    gradient, f32 on the card against f32 on the CPU on those images (every
    parameter's gradient and the input's within MHSA_F32_GRAD_REL_TOL of its
    max|.|), and bf16 on the card at the full batch (finite, non-zero
    gradients of the position tables and ``to_qk``); one table backward a
    step, on the route of its dtype and L."""
    import torch

    from distribuuuu_tpu_torch.models.botnet import MHSA
    from distribuuuu_tpu_torch.ops import attention as att

    torch.manual_seed(3)
    res = {}
    for kname, side, batch, n_cpu in (("K3", 14, 128, 4), ("K5", 32, 8, 2)):
        ref = MHSA(512, (side, side), 4, 128, 128, rel_pos_emb=False, dtype=torch.float32)
        for conv in (ref.to_qk, ref.to_v):  # fan-in normal: logits of O(1), a peaked softmax
            torch.nn.init.normal_(conv.weight, std=(2.0 / 512) ** 0.5)
        ref.eval()
        x = torch.relu(torch.randn(batch, side, side, 512)).permute(0, 3, 1, 2)
        with torch.inference_mode():
            want = ref(x[:n_cpu])
            # --- this path: counts zeroed just before, read just after -----
            att.LAUNCHES = att.TABLE_LAUNCHES = 0
            card = {}
            for dtype in (torch.float32, torch.bfloat16):
                m = MHSA(512, (side, side), 4, 128, 128, rel_pos_emb=False, dtype=dtype)
                m.load_state_dict(ref.state_dict())
                card[dtype] = m.cuda().eval()(x.cuda()).float().cpu()
            launches = dict(attention=att.LAUNCHES, table=att.TABLE_LAUNCHES)
            # -----------------------------------------------------------------
        if launches != dict(attention=0, table=2):
            fail(f"MHSA table mode at fmap {side}: launches {launches} != 1 per forward")
        d_a = float((card[torch.float32][:n_cpu] - want).abs().max() / want.abs().max())
        d_b = float((card[torch.bfloat16] - card[torch.float32]).abs().max()
                    / card[torch.float32].abs().max())
        say(f"[mhsa table {kname}] fmap {side}x{side} batch {batch}: launches {launches}; "
            f"f32 card vs CPU {d_a:.3e} (limit {MHSA_F32_REL_TOL}), bf16 vs f32 {d_b:.3e} "
            f"(limit {BF16_REL_TOL})")
        if not (d_a <= MHSA_F32_REL_TOL and d_b <= BF16_REL_TOL):
            fail(f"MHSA table mode at fmap {side} is outside the stated tolerances")
        res[kname] = dict(launches=launches["table"], f32_ratio=d_a, bf16_ratio=d_b)
        res[kname].update(mhsa_table_train(ref, x, n_cpu, kname, side))
    return res


# MHSA forward + backward, f32 card (TF32 off) vs f32 CPU, each gradient
# within this of its max|.|: the attention backward (scalar route on the card)
# and the convs' weight gradients differ in f32 summation order only
MHSA_F32_GRAD_REL_TOL = 1e-4


def mhsa_table_train(ref, x, n_cpu: int, kname: str, side: int) -> dict:
    """Forward + backward of ``MHSA(rel_pos_emb=False)`` holding ``ref``'s
    weights for a seeded output gradient: f32 on the CPU and on the card on
    the first ``n_cpu`` images of ``x``, bf16 on the card on all of them.
    The launch counts are zeroed just before the card's two steps and read
    just after: one table forward and one table backward each, the f32 one
    on the scalar route, the bf16 one on the route of its L."""
    import torch

    from distribuuuu_tpu_torch.models.botnet import MHSA
    from distribuuuu_tpu_torch.ops import attention as att

    gout = torch.randn(x.shape[0], 512, side, side, generator=torch.Generator().manual_seed(5))

    def step(dev, dtype, n):
        m = MHSA(512, (side, side), 4, 128, 128, rel_pos_emb=False, dtype=dtype)
        m.load_state_dict(ref.state_dict())
        m.to(dev)
        xx = x[:n].to(dev, dtype).requires_grad_()
        m(xx).backward(gout[:n].to(dev, dtype))
        return {"x": xx.grad, **{k: t.grad for k, t in m.named_parameters()}}

    cpu = step("cpu", torch.float32, n_cpu)
    # --- this path: counts zeroed just before, read just after -------------
    att.TABLE_LAUNCHES = att.TABLE_BWD_LAUNCHES = 0
    att.BWD_ROUTE_CALLS.update(dict.fromkeys(att.BWD_ROUTE_CALLS, 0))
    f32 = step("cuda", torch.float32, n_cpu)
    bf16 = step("cuda", torch.bfloat16, x.shape[0])
    torch.cuda.synchronize()
    launches = dict(forward=att.TABLE_LAUNCHES, backward=att.TABLE_BWD_LAUNCHES,
                    routes={k: v for k, v in att.BWD_ROUTE_CALLS.items() if v})
    # -------------------------------------------------------------------------
    l = side * side
    route = att.backward_route(torch.bfloat16, l)
    want = dict(forward=2, backward=2, routes={"scalar": 1, route: 1})
    errs = {k: float((f32[k].cpu() - g).abs().max() / g.abs().max()) for k, g in cpu.items()}
    bf16_ok = all(torch.isfinite(bf16[k]).all() and float(bf16[k].abs().max()) > 0
                  for k in ("pos_emb.height", "pos_emb.width", "to_qk.weight"))
    say(f"[mhsa table {kname} train] fmap {side}x{side}: forward + backward f32 card vs CPU on "
        f"{n_cpu} images, max|d|/max|grad| " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (limit {MHSA_F32_GRAD_REL_TOL}); bf16 batch {x.shape[0]}: tables and to_qk "
        f"gradients finite and non-zero {bf16_ok}; launches {launches} (bf16 backward on the "
        f"{route} route)")
    if not (all(v <= MHSA_F32_GRAD_REL_TOL for v in errs.values()) and bf16_ok):
        fail(f"MHSA table-mode training at fmap {side} is outside the stated tolerances")
    if launches != want:
        fail(f"MHSA table-mode training at fmap {side}: launches {launches}, want {want}")
    return dict(train_grad_rel_err=errs, bwd_launches=launches["backward"],
                bwd_route_calls=launches["routes"], bwd_route=route)


# ---------------------------------------------------------------------------
# switch MoE: K6 (dispatch) and K7 (combine)
# ---------------------------------------------------------------------------

# (label, N, D, E, C, x dtype). The soak's per-device shard
# (scripts/soak_fused_attn.py --moe: N 8192, D 128, E 8, C = 1.25 N / E)
# and the Switch-Transformer-Base width (d_model 768, arXiv 2101.03961) at
# the same N, E and C; the shard switch_moe gets in [moe-dist]; a ragged N;
# one route tile (N < 64) and N 100 (one TPU tile, two here); capacity 1;
# every token to expert 0 with C = N - 1, so exactly the last one drops.
MOE_CASES = [
    ("soak", 8192, 128, 8, 1280, "float32"),
    ("soak", 8192, 128, 8, 1280, "bfloat16"),
    ("switch-base", 8192, 768, 8, 1280, "float32"),
    ("switch-base", 8192, 768, 8, 1280, "bfloat16"),
    ("moe-dist shard", 4096, 128, 8, 640, "float32"),
    ("ragged", 8191, 128, 8, 1280, "float32"),
    ("one tile", 60, 128, 8, 10, "bfloat16"),
    ("N 100", 100, 128, 8, 16, "float32"),
    ("capacity 1", 8192, 128, 8, 1, "float32"),
    ("overflow", 4096, 128, 8, 4095, "bfloat16"),
]
MOE_TIMED = ("soak", "switch-base", "moe-dist shard")
# w and fp_sum[1] pass through exp, whose CUDA and eager versions may differ
# by an ulp, and fp_sum[1] sums N probabilities in another order than the
# plain version; everything else is exact on the same routing
MOE_W_RTOL = 1e-6
MOE_FP_RTOL = 1e-5
# gradients against autograd through the plain versions, relative to
# max|grad|: the same math in another summation order (f32, ~1e-7)
MOE_GRAD_RTOL = 1e-5
# on continuous inputs a token may route differently only where the plain
# version's top-2 logit gap is below this times max|logit|: the kernel sums
# the logits in another order, a few ulps apart
MOE_NEAR_TIE = 1e-5
# [moe-dist]: 8 ranks, N 4096 tokens each, D 128, the dry run's expert
# tanh(h @ w) @ v with H = 2D, C = ceil(1.25 * 4096 / 8) = 640
MOE_DIST = dict(world=8, n_local=4096, d=128, hidden=256, capacity=640)
MOE_DIST_RTOL = 1e-5
MOE_DIST_DEADLINE_S = 300
MOE_WORKER = ROOT / "tests" / "_torch_moe_worker.py"


def dyadic(shape, k: int, den: int, gen):
    """Integers in [-k, k] over ``den``, on the card. With x in k/8 (|k| <=
    16) and the gate in m/64 (|m| <= 32) every product is a multiple of 2^-9
    of size <= 1, so a sum of D <= 768 of them fits in 19 bits: every f32
    logit is exact in any summation order, and only exact ties can tie."""
    import torch

    return torch.randint(-k, k + 1, shape, generator=gen, device="cuda").float() / den


def moe_inputs(n, d, e, dtype, gen, *, continuous=False, overflow=False):
    """(x in ``dtype``, gate f32): dyadic, or the soak's continuous scales;
    ``overflow``: positive tokens and only expert 0's gate column set."""
    import torch

    if continuous:
        x = torch.randn(n, d, generator=gen, device="cuda") * 0.5
        g = torch.randn(d, e, generator=gen, device="cuda") * 0.1
    else:
        x, g = dyadic((n, d), 16, 8, gen), dyadic((d, e), 32, 64, gen)
    if overflow:
        x = x.abs() + 0.125
        g = torch.zeros(d, e, device="cuda")
        g[:, 0] = 0.5
    return x.to(getattr(torch, dtype)), g


def library_dispatch(x, g, c):
    """The same function from eager index ops, no [n, E, C] mask: softmax,
    argmax, an int32 cumsum over the transposed ``[E, n]`` one-hot (a scan
    along dim 0 of ``[n, E]`` runs one thread per column and takes ~1.4 ms
    at n 8192 on the H100), a gather and one ``index_copy_`` (dropped
    tokens go to a spare row, so nothing waits on the host). A yardstick
    only."""
    import torch

    n, d = x.shape
    e = g.shape[1]
    x32 = x.float()
    probs = torch.softmax(x32 @ g, dim=-1)
    top = probs.argmax(dim=-1)
    top_p = probs.gather(-1, top[:, None])[:, 0]
    oh_t = (top[None, :] == torch.arange(e, device=x.device)[:, None]).int()  # [E, n]
    pos = oh_t.cumsum(1, dtype=torch.int32).gather(0, top[None, :])[0] - 1
    keep = pos < c
    send = torch.zeros(e * c + 1, d, device=x.device)
    send.index_copy_(0, torch.where(keep, top * c + pos, e * c), x32)
    return (send[: e * c].view(e, c, d), top.int(), pos.clamp(max=c - 1), top_p * keep,
            torch.stack([oh_t.sum(1).float(), probs.sum(0)]))


def moe_profile(mk, x, g, c, runs: int = 20) -> dict:
    """One forward + backward through K6 -> K7 (the kernels' autograd path,
    cotangents given) ``runs`` times under ``torch.profiler``: device µs per
    call of each kernel by name, and the launches of each, which must be
    one of each kernel per call (K6 is one kernel; its scratch reset is a
    memset)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fwd_bwd = moe_fwd_bwd(mk, x, g, c)
    fwd_bwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fwd_bwd()
        torch.cuda.synchronize()
    us: Counter = Counter()
    count: Counter = Counter()
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.time_range.end > 0:
            name = next((k for k in ("dispatch_bwd", "combine_bwd", "dispatch", "combine")
                         if f"moe_{k}_kernel" in ev.name),
                        "memset" if "memset" in ev.name.lower() else "other")
            us[name] += ev.time_range.end - ev.time_range.start
            count[name] += 1
    for k in ("dispatch", "combine", "dispatch_bwd", "combine_bwd"):
        if count[k] != runs:
            fail(f"[moe-kernels] profile: {count[k]} moe_{k}_kernel launches in {runs} forward + "
                 f"backward calls; want one each ({dict(count)})")
    return {"device_us": {k: v / runs for k, v in us.items()},
            "events_per_call": {k: v / runs for k, v in count.items()}}


def moe_fwd_bwd(mk, x, g, c):
    """A zero-argument forward + backward through the kernels' autograd path:
    dispatch -> combine(send) -> the gradients of x and the gate for fixed
    cotangents of out and fp_sum (no loss kernels of its own)."""
    import torch

    x, g = x.detach().requires_grad_(), g.detach().requires_grad_()
    gen = torch.Generator(device="cuda").manual_seed(9)
    g_out = torch.randn(x.shape[0], x.shape[1], generator=gen, device="cuda")
    g_fp = torch.randn(2, g.shape[1], generator=gen, device="cuda")

    def call():
        send, top, pos, w, fp = mk.fused_moe_dispatch(x, g, capacity=c)
        out = mk.fused_moe_combine(send, top, pos, w)
        return torch.autograd.grad([out, fp], [x, g], [g_out, g_fp])

    return call


def host_us(fn, runs: int = 20, batches: int = 5) -> float:
    """Host µs per call of ``fn``: the median over ``batches`` of ``runs``
    calls enqueued back to back from an idle stream (no synchronize between
    calls: the wrapper's cost, not the device's)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        tic = time.perf_counter()
        for _ in range(runs):
            fn()
        times.append(1e6 * (time.perf_counter() - tic) / runs)
        torch.cuda.synchronize()
    return statistics.median(times)


def fresh(t, gen):
    """Another input set for a timing: ``t``'s shape and dtype, other values."""
    import torch

    return torch.randn(t.shape, generator=gen, device="cuda").to(t.dtype)


def moe_forward_times(mk, x, g, c, back, top, pos, w, bounds, gen) -> dict:
    """K6 and K7 through the public entry points only (so the same code
    times an older checkout's wrappers, ``--profile-only``): each as
    :func:`rotated_timings` and host µs a call (no grad); and a forward +
    backward (:func:`moe_fwd_bwd`): host µs and ms back to back."""
    import torch

    n, d = x.shape
    e = g.shape[1]
    x_sets = lambda i: (x if i == 0 else moe_inputs(n, d, e, str(x.dtype)[6:], gen)[0], g)  # noqa: E731
    with torch.no_grad():
        times = dict(
            dispatch=dict(**rotated_timings(lambda a, b: mk.fused_moe_dispatch(a, b, capacity=c),
                                            x_sets, bounds["dispatch"]["bytes"]),
                          host_us=host_us(lambda: mk.fused_moe_dispatch(x, g, capacity=c))),
            combine=dict(**rotated_timings(mk.fused_moe_combine,
                                           lambda i: (back if i == 0 else fresh(back, gen), top, pos,
                                                      w),
                                           bounds["combine"]["bytes"]),
                         host_us=host_us(lambda: mk.fused_moe_combine(back, top, pos, w))))
    fwd_bwd = moe_fwd_bwd(mk, x, g, c)
    times["fwd_bwd"] = dict(host_us=host_us(fwd_bwd), back_to_back_ms=cuda_ms(fwd_bwd, batch=K1_BATCH))
    return times


def phase_moe_times(card: str) -> dict:
    """[moe-times] (``--profile-only``): K6/K7 timed by
    :func:`moe_forward_times` at each MOE_TIMED shard on dyadic inputs,
    beside the bytes bound."""
    import torch

    from distribuuuu_tpu_torch.ops import moe_kernel as mk

    bw = hbm_bytes_per_s(card)
    gen = torch.Generator(device="cuda").manual_seed(10)
    out = []
    for label, n, d, e, c, dtype in MOE_CASES:
        if label not in MOE_TIMED:
            continue
        x, g = moe_inputs(n, d, e, dtype, gen)
        back = torch.randn(e, c, d, generator=gen, device="cuda")
        with torch.no_grad():
            _, top, pos, w, _ = mk.fused_moe_dispatch(x, g, capacity=c)
        bounds = moe_bound(n, d, e, c, x.element_size(), int((w != 0).sum()), bw)
        t = moe_forward_times(mk, x, g, c, back, top, pos, w, bounds, gen)
        out.append(dict(label=label, n=n, d=d, e=e, c=c, dtype=dtype, **t,
                        bound_ms={k: bounds[k]["bound_ms"] for k in ("dispatch", "combine")}))
        say(f"[moe-times] {label} (N {n}, D {d}, E {e}, C {c}, x {dtype}): " + "; ".join(
            f"{k} device {t[key]['device_ms'] * 1e3:.2f} us "
            f"({100 * bounds[key]['bound_ms'] / t[key]['device_ms']:.0f}% of "
            f"{bounds[key]['bound_ms'] * 1e3:.2f}), back-to-back "
            f"{t[key]['back_to_back_ms'] * 1e3:.2f}, single call {t[key]['single_call_ms'] * 1e3:.2f}, "
            f"host {t[key]['host_us']:.1f}" for k, key in (("K6", "dispatch"), ("K7", "combine")))
            + f"; forward + backward host {t['fwd_bwd']['host_us']:.1f} us, back-to-back "
            f"{t['fwd_bwd']['back_to_back_ms'] * 1e3:.1f} us")
    return out


def library_combine(back, top, pos, w):
    """``w · back[top, pos]`` as one ``index_select`` and a multiply."""
    e, c, d = back.shape
    return w[:, None] * back.view(e * c, d).index_select(0, top.long() * c + pos.long())


def moe_bound(n, d, e, c, item, kept, bw) -> dict:
    """Bytes bounds (ms) of one call of each kernel, each input read once and
    each output written once (``item``: bytes of one of x's values; ``kept``:
    tokens this run keeps). Dispatch: x, the gate, the whole send buffer
    (zeros too), top/pos/w and fp_sum; its 2nDE f32 flops take ~10 % of the
    bytes' time at D 768. Combine: the kept tokens' rows of back, top/pos/w
    and out.
    Dispatch backward: probs, top/pos/w, d_w, d_fp[1], the gate, the kept
    tokens' rows of d_send; d_x and d_logits. Combine backward: g, every
    token's row of back (d_w), top/pos/w; all of d_back, and d_w."""
    sizes = {
        "dispatch": (n * d * item + d * e * 4 + e * c * d * 4 + 3 * n * 4 + 2 * e * 4, 2.0 * n * d * e),
        "combine": (kept * d * 4 + 3 * n * 4 + n * d * 4, n * d),
        "dispatch_bwd": (n * e * 4 + 4 * n * 4 + e * 4 + d * e * 4 + kept * d * 4 + n * d * item
                         + n * e * 4, 2.0 * n * d * e + 6.0 * n * e),
        "combine_bwd": (2 * n * d * 4 + 3 * n * 4 + e * c * d * 4 + n * 4, 3.0 * n * d),
    }
    by = {}
    for key, (nbytes, flops) in sizes.items():
        by[key] = dict(bytes=nbytes, bound_ms=1e3 * max(nbytes / bw, flops / F32_PEAK_FLOPS),
                       bound_by="bytes" if nbytes / bw >= flops / F32_PEAK_FLOPS else "operations")
    return by


def _rel_ok(got, want, rtol) -> bool:
    return bool(((got - want).abs() <= rtol * want.abs()).all())


def rotated_timings(fn, make_inputs, nbytes: int) -> dict:
    """``fn(*inputs)`` timed three ways, each cycling through enough input
    sets (``make_inputs(i)``) that a set comes round again only after
    K1_ROTATE_BYTES of other traffic (:func:`k1_rotation`): device time
    (the calls replayed from a CUDA graph), back to back and a single call
    from an idle stream (both with the wrapper's host cost)."""
    sets, calls = k1_rotation(nbytes)
    inputs = [make_inputs(i) for i in range(sets)]
    fns = [lambda a=inputs[i % sets]: fn(*a) for i in range(calls)]
    return dict(device_ms=graph_ms(fns), back_to_back_ms=cuda_ms(cycling(fns), batch=K1_BATCH),
                single_call_ms=cuda_ms(cycling(fns)), input_sets=sets, calls=calls)


def moe_backward_check(mk, label, x, g, c, gen) -> tuple[dict, tuple]:
    """K6's and K7's backward kernels against their plain versions on the
    routing of dyadic ``x``: d_back bitwise; d_x, d_gate and d_w within
    MOE_GRAD_RTOL of each max|grad| (a bf16 d_x within 2^-8, one rounding).
    Returns the errors and the arguments each kernel was checked with."""
    import torch

    n, d = x.shape
    e = g.shape[1]
    _, top, pos, w, _, probs = mk._dispatch_cuda(x, g, c, want_probs=True)
    d_send = torch.randn(e, c, d, generator=gen, device="cuda")
    d_w = torch.randn(n, generator=gen, device="cuda")
    d_fp = torch.randn(2, e, generator=gen, device="cuda")
    back = torch.randn(e, c, d, generator=gen, device="cuda")
    out_g = torch.randn(n, d, generator=gen, device="cuda")
    d_x, d_logits = mk._dispatch_bwd_cuda(x, g, probs, top, pos, w, d_send, d_w, d_fp, c, True)
    d_gate = x.float().t() @ d_logits
    want_x, want_gate = mk.dispatch_backward_reference(x, g, top, pos, w, d_send, d_w, d_fp, c)
    d_back, d_wc = mk._combine_bwd_cuda(back, top, pos, w, out_g, True, True)
    want_back, want_wc = mk.combine_backward_reference(back, top, pos, w, out_g)
    torch.cuda.synchronize()
    if d_x.dtype != x.dtype or not torch.equal(d_back, want_back):
        fail(f"[moe-kernels] {label} {x.dtype}: d_x dtype {d_x.dtype} or d_back != plain "
             f"(max|d| {float((d_back - want_back).abs().max())})")
    errs = {}
    x_tol = 2.0**-8 if x.dtype == torch.bfloat16 else MOE_GRAD_RTOL
    for name, a, b, tol in (("d_x", d_x, want_x, x_tol), ("d_gate", d_gate, want_gate, MOE_GRAD_RTOL),
                            ("d_w", d_wc, want_wc, MOE_GRAD_RTOL)):
        errs[name] = float((a.float() - b.float()).abs().max() / b.float().abs().max())
        if not errs[name] <= tol:
            fail(f"[moe-kernels] {label} {x.dtype}: backward {name} {errs[name]:.3e} relative to "
                 f"max|grad| (limit {tol})")
    errs["max_abs"] = dict(dispatch_bwd=float((d_x.float() - want_x.float()).abs().max()),
                           combine_bwd=max(float((d_wc - want_wc).abs().max()),
                                           float((d_back - want_back).abs().max())))
    return errs, ((x, g, probs, top, pos, w, d_send, d_w, d_fp), (back, top, pos, w, out_g))


def moe_case(mk, label, n, d, e, c, dtype, gen, bw) -> dict:
    """K6 and K7 vs their plain versions on dyadic inputs; at a MOE_TIMED
    label also the backward kernels, and every kernel timed: device time
    past the L2, back to back, a single call, host µs, beside the plain
    version, the eager index ops and the bytes bound."""
    import torch

    x, g = moe_inputs(n, d, e, dtype, gen, overflow=label == "overflow")
    with torch.no_grad():
        got = mk.fused_moe_dispatch(x, g, capacity=c)
        want = mk.oracle_dispatch(x, g, c)
    torch.cuda.synchronize()
    send, top, pos, w, fp = got
    for name, a, b in zip(("send", "top", "pos", "w", "fp_sum"), got, want):
        if a.dtype != b.dtype or a.shape != b.shape:
            fail(f"K6 {label} {dtype}: {name} is {a.dtype} {tuple(a.shape)}, plain {b.dtype} "
                 f"{tuple(b.shape)}")
    for name, a, b in (("send", send, want[0]), ("top", top, want[1]), ("pos", pos, want[2]),
                       ("fp_sum[0]", fp[0], want[4][0])):
        if not torch.equal(a, b):
            fail(f"K6 {label} {dtype}: {name} != plain on dyadic inputs "
                 f"({int((a != b).sum())} entries differ)")
    if not (_rel_ok(w, want[3], MOE_W_RTOL) and _rel_ok(fp[1], want[4][1], MOE_FP_RTOL)):
        fail(f"K6 {label} {dtype}: w or fp_sum[1] outside {MOE_W_RTOL} / {MOE_FP_RTOL} relative")
    dropped = w == 0
    if label == "overflow" and dropped.nonzero().flatten().tolist() != [n - 1]:
        fail(f"K6 overflow: dropped tokens {dropped.nonzero().flatten().tolist()[:8]}, want [{n - 1}]")
    k6_err = max(float((a - b).abs().max()) for a, b in zip((send, w, fp), (want[0], want[3], want[4])))
    back = torch.randn(e, c, d, generator=gen, device="cuda")
    with torch.no_grad():
        out = mk.fused_moe_combine(back, top, pos, w)
        out_plain = mk.oracle_combine(back, top, pos, w)
    torch.cuda.synchronize()
    if not torch.equal(out, out_plain):
        fail(f"K7 {label} {dtype}: out != plain (max|d| {float((out - out_plain).abs().max())})")
    if bool((out[dropped] != 0).any()):
        fail(f"K7 {label} {dtype}: a dropped token did not combine to zeros")
    kept = n - int(dropped.sum())
    row = dict(label=label, n=n, d=d, e=e, c=c, dtype=dtype, kept=kept, k6_max_abs_err=k6_err,
               k7_max_abs_err=float((out - out_plain).abs().max()))
    note = ""
    if label in MOE_TIMED:
        bwd_err, (db_args, cb_args) = moe_backward_check(mk, label, x, g, c, gen)
        row["backward_rel_err"] = {k: v for k, v in bwd_err.items() if k != "max_abs"}
        row["k6_bwd_max_abs_err"] = bwd_err["max_abs"]["dispatch_bwd"]
        row["k7_bwd_max_abs_err"] = bwd_err["max_abs"]["combine_bwd"]
        bounds = moe_bound(n, d, e, c, x.element_size(), kept, bw)
        db_fn = lambda *a: mk._dispatch_bwd_cuda(*a, c, True)  # noqa: E731
        cb_fn = lambda *a: mk._combine_bwd_cuda(*a, True, True)  # noqa: E731
        lib = library_dispatch(x, g, c)
        times = moe_forward_times(mk, x, g, c, back, top, pos, w, bounds, gen)
        with torch.no_grad():
            row["dispatch"] = dict(
                **times["dispatch"],
                plain_ms=cuda_ms(lambda: mk.oracle_dispatch(x, g, c), runs=5, warmup=1, batch=2),
                library_ms=cuda_ms(lambda: library_dispatch(x, g, c), runs=10, batch=K1_BATCH),
                library_equal=all(torch.equal(a, b) for a, b in zip(lib[:3], want[:3])),
                **bounds["dispatch"])
            row["combine"] = dict(
                **times["combine"],
                plain_ms=cuda_ms(lambda: mk.oracle_combine(back, top, pos, w), runs=5, warmup=1,
                                 batch=2),
                library_ms=cuda_ms(lambda: library_combine(back, top, pos, w), runs=10,
                                   batch=K1_BATCH),
                **bounds["combine"])
            row["dispatch_bwd"] = dict(
                **rotated_timings(db_fn, lambda i: db_args if i == 0 else
                                  db_args[:6] + (fresh(db_args[6], gen),) + db_args[7:],
                                  bounds["dispatch_bwd"]["bytes"]),
                plain_ms=cuda_ms(lambda: mk.dispatch_backward_reference(
                    *db_args[:2], *db_args[3:], c), runs=10, batch=K1_BATCH),
                library_ms=None, **bounds["dispatch_bwd"])
            row["combine_bwd"] = dict(
                **rotated_timings(cb_fn, lambda i: cb_args if i == 0 else
                                  (fresh(cb_args[0], gen),) + cb_args[1:4] + (fresh(cb_args[4], gen),),
                                  bounds["combine_bwd"]["bytes"]),
                plain_ms=cuda_ms(lambda: mk.combine_backward_reference(*cb_args), runs=10,
                                 batch=K1_BATCH),
                library_ms=None, **bounds["combine_bwd"])
        row["host_us"] = dict(dispatch=row["dispatch"]["host_us"], combine=row["combine"]["host_us"],
                              fwd_bwd=times["fwd_bwd"]["host_us"])
        if dtype == "float32":
            row["profile"] = moe_profile(mk, x, g, c)
            say(f"[moe-kernels] {label} forward + backward profile per call: device " + ", ".join(
                f"{k} {v:.2f} us" for k, v in sorted(row["profile"]["device_us"].items()))
                + "; one launch of each kernel per call")
        note = "; " + "; ".join(
            f"{k} device {r['device_ms'] * 1e3:.2f} us ({100 * r['bound_ms'] / r['device_ms']:.0f}% of "
            f"bound {r['bound_ms'] * 1e3:.2f} by {r['bound_by']}; {r['calls']} calls over "
            f"{r['input_sets']} input sets), back-to-back {r['back_to_back_ms'] * 1e3:.2f}, single "
            f"call {r['single_call_ms'] * 1e3:.2f}, plain {r['plain_ms'] * 1e3:.1f}"
            + ("" if r["library_ms"] is None else f", index ops {r['library_ms'] * 1e3:.1f}")
            for k, r in (("K6", row["dispatch"]), ("K7", row["combine"]),
                         ("K6 bwd", row["dispatch_bwd"]), ("K7 bwd", row["combine_bwd"])))
        note += ("; host us per call: dispatch {dispatch:.1f}, combine {combine:.1f}, forward + "
                 "backward {fwd_bwd:.1f}; backward vs plain, relative to max|grad|: ").format(
            **row["host_us"]) + ", ".join(f"{k} {v:.2e}" for k, v in row["backward_rel_err"].items())
    say(f"[moe-kernels] {label}: N {n}, D {d}, E {e}, C {c}, x {dtype}: top/pos/send/fp[0] and "
        f"K7 out equal plain, w/fp[1] within {MOE_W_RTOL}/{MOE_FP_RTOL}, {n - kept} dropped{note}")
    return row


def moe_near_tie(mk, label, n, d, e, c, dtype, gen) -> dict:
    """Continuous inputs: routing may differ only at near-ties, and send must
    stay bitwise on the experts no differing token touches."""
    import torch

    x, g = moe_inputs(n, d, e, dtype, gen, continuous=True)
    with torch.no_grad():
        send, top, pos, _, _ = mk.fused_moe_dispatch(x, g, capacity=c)
        psend, ptop, ppos, _, _ = mk.oracle_dispatch(x, g, c)
        logits = x.float() @ g
    diff = top != ptop
    n_diff = int(diff.sum())
    top2 = logits.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    limit = MOE_NEAR_TIE * float(logits.abs().max())
    if n_diff and not bool((gap[diff] < limit).all()):
        fail(f"K6 {label} {dtype}: {n_diff} tokens route differently from plain, and not all at "
             f"near-ties (gaps {gap[diff].tolist()[:8]}, limit {limit:.3e})")
    touched = set(top[diff].tolist()) | set(ptop[diff].tolist())
    untouched = [j for j in range(e) if j not in touched]
    mine = torch.isin(ptop, torch.tensor(untouched, dtype=ptop.dtype, device=ptop.device))
    if not (torch.equal(send[untouched], psend[untouched]) and torch.equal(top[mine], ptop[mine])
            and torch.equal(pos[mine], ppos[mine])):
        fail(f"K6 {label} {dtype}: send/top/pos differ on experts no near-tie touched")
    say(f"[moe-kernels] continuous {label} x {dtype}: {n_diff} of {n} tokens route differently "
        f"(near-ties: gap < {limit:.3e}; smallest gap {float(gap.min()):.3e}); send equal on "
        f"{len(untouched)} of {e} experts")
    return dict(label=label, dtype=dtype, differing=n_diff, min_gap=float(gap.min()), limit=limit,
                experts_equal=len(untouched))




def moe_grads(mk, n, d, e, c, gen) -> dict:
    """The soak's loss, sum(out^2) + 0.01 sum(fp[0] fp[1]) through dispatch ->
    tanh(send) + b0 -> combine, f32: value and gradients (x, gate, b0) of
    the kernels' path (one launch of each backward kernel) vs autograd
    through the plain versions; both timed."""
    import torch

    x, g = moe_inputs(n, d, e, "float32", gen)
    x.requires_grad_()
    g.requires_grad_()
    b0 = torch.randn(e, c, d, generator=gen, device="cuda").requires_grad_()

    def loss_grads(dispatch, combine):
        send, top, pos, w, fp = dispatch(x, g)
        out = combine(torch.tanh(send) + b0, top, pos, w)
        loss = (out**2).sum() + 0.01 * (fp[0] * fp[1]).sum()
        return loss.detach(), torch.autograd.grad(loss, (x, g, b0))

    kernel = lambda: loss_grads(lambda a, b: mk.fused_moe_dispatch(a, b, capacity=c),  # noqa: E731
                                mk.fused_moe_combine)
    plain = lambda: loss_grads(lambda a, b: mk.oracle_dispatch(a, b, c), mk.oracle_combine)  # noqa: E731
    before = (mk.DISPATCH_BWD_LAUNCHES, mk.COMBINE_BWD_LAUNCHES)
    (lk, gk), (lp, gp) = kernel(), plain()
    if (mk.DISPATCH_BWD_LAUNCHES - before[0], mk.COMBINE_BWD_LAUNCHES - before[1]) != (1, 1):
        fail(f"K6/K7 gradients at N {n}, D {d}: the backward did not launch each backward kernel "
             f"once")
    errs = {"loss": float((lk - lp).abs() / lp.abs())}
    for name, a, b in zip(("x", "gate", "b0"), gk, gp):
        errs[name] = float((a - b).abs().max() / b.abs().max())
    if not all(v <= MOE_GRAD_RTOL for v in errs.values()):
        fail(f"K6/K7 gradients at N {n}, D {d}: {errs} (limit {MOE_GRAD_RTOL} relative)")
    ms, plain_ms = cuda_ms(kernel, runs=10), cuda_ms(plain, runs=10)
    say(f"[moe-kernels] gradients N {n}, D {d}, E {e}, C {c}: relative to max|grad| " + ", ".join(
        f"{k} {v:.2e}" for k, v in errs.items()) + f" (limit {MOE_GRAD_RTOL}); forward + backward "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
    return dict(n=n, d=d, e=e, c=c, rel_err=errs, fwd_bwd_ms=ms, plain_fwd_bwd_ms=plain_ms)


def moe_graph_and_repeat(mk, label, n, d, e, c, gen) -> dict:
    """Dispatch + combine (forward, no grad) captured in one CUDA graph: one
    K6 and one K7 launch counted at capture, and each replay bitwise equal
    to the eager calls, also after new inputs are copied into the captured
    ones; and two eager dispatches of one input bitwise equal, fp_sum[1]
    (summed across tiles) included. Continuous inputs, f32 and bf16."""
    import torch

    for dtype in ("float32", "bfloat16"):
        x, g = moe_inputs(n, d, e, dtype, gen, continuous=True)
        back = torch.randn(e, c, d, generator=gen, device="cuda")

        def step():
            send, top, pos, w, fp = mk.fused_moe_dispatch(x, g, capacity=c)
            return send, top, pos, w, fp, mk.fused_moe_combine(back, top, pos, w)

        with torch.no_grad():
            first, second = mk.fused_moe_dispatch(x, g, capacity=c), mk.fused_moe_dispatch(x, g, capacity=c)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(first, second)):
                fail(f"[moe-kernels] {label} {dtype}: two dispatches of one input differ")
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                step()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            before = (mk.DISPATCH_LAUNCHES, mk.COMBINE_LAUNCHES)
            with torch.cuda.graph(graph):
                captured = step()
            if (mk.DISPATCH_LAUNCHES - before[0], mk.COMBINE_LAUNCHES - before[1]) != (1, 1):
                fail(f"[moe-kernels] {label}: capture did not count one K6 and one K7 launch")
            for replay in range(2):
                graph.replay()
                eager = step()
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(captured, eager)):
                    fail(f"[moe-kernels] {label} {dtype}: graph replay {replay} != eager")
                x.copy_(moe_inputs(n, d, e, dtype, gen, continuous=True)[0])
        del graph, captured
    say(f"[moe-kernels] {label}: dispatch + combine captured in one CUDA graph, 2 replays (the "
        f"second on new inputs) bitwise equal to eager; two dispatches of one input bitwise "
        f"equal, fp_sum included (f32 and bf16)")
    return dict(label=label, graph_replays_equal=2, repeat_equal=True)


def phase_moe_kernels(card: str) -> dict:
    """[moe-kernels]: K6, K7 and their backward kernels against their plain
    versions on the card; graph capture and run-to-run determinism."""
    import torch

    from distribuuuu_tpu_torch.ops import moe_kernel as mk

    bw = hbm_bytes_per_s(card)
    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = [moe_case(mk, *case, gen, bw) for case in MOE_CASES]
    near = [moe_near_tie(mk, *case, gen) for case in MOE_CASES[:4]]
    grads = [moe_grads(mk, n, d, e, c, gen) for label, n, d, e, c, dt in MOE_CASES[:3:2]]
    graph = [moe_graph_and_repeat(mk, label, n, d, e, c, gen)
             for label, n, d, e, c, dt in MOE_CASES[:3:2]]
    torch.cuda.empty_cache()
    timed = [r for r in cases if "dispatch_bwd" in r]
    return dict(cases=cases, near_tie=near, grads=grads, graph=graph,
                max_abs_err=dict(dispatch=max(r["k6_max_abs_err"] for r in cases),
                                 combine=max(r["k7_max_abs_err"] for r in cases),
                                 dispatch_bwd=max(r["k6_bwd_max_abs_err"] for r in timed),
                                 combine_bwd=max(r["k7_bwd_max_abs_err"] for r in timed)))


def phase_moe_dist(tmp: Path) -> dict:
    """[moe-dist]: switch_moe on 8 ranks sharing the card (gloo; NCCL
    refuses two ranks on one device), then the same ranks on the CPU."""
    import numpy as np

    spec = importlib.util.spec_from_file_location("_torch_moe_worker", MOE_WORKER)
    worker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(worker)
    e, n, d, h, c = (MOE_DIST[k] for k in ("world", "n_local", "d", "hidden", "capacity"))
    rng = np.random.default_rng(8)
    inputs = tmp / "moe_dist.npz"
    np.savez(inputs, x=(rng.integers(-16, 17, (e, n, d)) / 8).astype(np.float32),
             y=rng.standard_normal((e, n, d)).astype(np.float32),
             gate=(rng.integers(-32, 33, (d, e)) / 64).astype(np.float32),
             w=(rng.standard_normal((e, d, h)) / np.sqrt(d)).astype(np.float32),
             v=(rng.standard_normal((e, h, d)) / np.sqrt(h)).astype(np.float32))
    cases = [dict(name=dev, inputs=str(inputs), device=dev, dtype="float32", capacity=c,
                  residual=True, timed_steps=5 if dev == "cuda" else 0) for dev in ("cuda", "cpu")]
    tic = time.perf_counter()
    try:
        ranks = worker.run_ranks(dict(world=e, threads=1, timeout_s=MOE_DIST_DEADLINE_S, cases=cases),
                                 tmp / "moe_dist", MOE_DIST_DEADLINE_S)
    except RuntimeError as exc:
        fail(f"[moe-dist] {exc}")
    wall = time.perf_counter() - tic
    step_ms = statistics.median(float(np.max([r["cuda/step_ms"][i] for r in ranks]))
                                for i in range(len(ranks[0]["cuda/step_ms"])))
    worst: dict = {}
    for r, res in enumerate(ranks):
        for key, what in (("launches", "K6/K7"), ("bwd_launches", "K6/K7 backward")):
            if res[f"cuda/{key}"].tolist() != [1, 1] or res[f"cpu/{key}"].tolist() != [0, 0]:
                fail(f"[moe-dist] rank {r}: {what} launches {res[f'cuda/{key}'].tolist()} on the "
                     f"card and {res[f'cpu/{key}'].tolist()} on the CPU; want [1, 1] and [0, 0]")
        for k in ("top", "pos"):
            if not np.array_equal(res[f"cuda/{k}"], res[f"cpu/{k}"]):
                fail(f"[moe-dist] rank {r}: {k} differs between the card and the CPU")
        for k in ("loss", "aux", "out", "gate_grad", "w_grad", "v_grad"):
            a, b = res[f"cuda/{k}"], res[f"cpu/{k}"]
            err = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
            worst[k] = max(worst.get(k, 0.0), err)
            if not np.isfinite(a).all() or not err <= MOE_DIST_RTOL:
                fail(f"[moe-dist] rank {r}: {k} card vs CPU {err:.3e} (limit {MOE_DIST_RTOL})")
    say(f"[moe-dist] switch_moe on {e} ranks sharing the card (gloo), N {n} per rank, D {d}, "
        f"C {c}, expert tanh(h@w)@v H {h}: loss {float(ranks[0]['cuda/loss']):.6f}; card vs CPU, "
        f"relative to max|.|: " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
        + f" (limit {MOE_DIST_RTOL}); top/pos equal; K6, K7 and their backward kernels launched "
        f"once per rank; "
        f"forward + backward step {step_ms:.2f} ms (median of 5, slowest rank, gloo through "
        f"the host); {wall:.1f} s for both runs, process start included")
    return dict(world=e, n_local=n, d=d, c=c, hidden=h, rel_err=worst, wall_s=wall, step_ms=step_ms,
                launches=dict(dispatch=sum(int(r["cuda/launches"][0]) for r in ranks),
                              combine=sum(int(r["cuda/launches"][1]) for r in ranks),
                              dispatch_bwd=sum(int(r["cuda/bwd_launches"][0]) for r in ranks),
                              combine_bwd=sum(int(r["cuda/bwd_launches"][1]) for r in ranks)),
                loss=float(ranks[0]["cuda/loss"]))


def main() -> None:
    import torch

    wall0 = time.perf_counter()
    args = sys.argv[1:]
    if args not in ([], ["--profile-only"]):
        fail(f"usage: python3 chip_smoke.py [--profile-only]; got {args}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA GPU")
    if not (ROOT / "distribuuuu_tpu_torch").is_dir() or not SERVE_CFG.exists() or not MOE_WORKER.exists():
        fail(f"run from a checkout of the repository: {ROOT} lacks the port, {SERVE_CFG.name} "
             f"or {MOE_WORKER.name}")
    sys.path.insert(0, str(ROOT))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    say(f"[device] {card}; nvidia-smi: {smi}; torch {torch.__version__} CUDA {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False  # f32 on the card is full f32 everywhere
    torch.backends.cuda.matmul.allow_tf32 = False

    laps, tic = {}, [time.perf_counter()]

    def lap(name: str) -> None:  # the wall time since the previous lap, under ``name``
        now = time.perf_counter()
        laps[name] = round(now - tic[0], 1)
        tic[0] = now

    builds = phase_build()
    lap("build")
    if args:
        with tempfile.TemporaryDirectory() as tmp:
            for arch in SERVED:
                phase_profile_only(card, Path(tmp), arch)
        phase_moe_times(card)
        say("[profile-only] latency, profile and MoE timings only; nothing was checked")
        return
    bw = hbm_bytes_per_s(card)
    sites = {arch: {b: epilogue_sites(arch, b) for b in (1, LADDER_BATCH)} for arch in SERVED}
    k1_bound_us = {arch: {b: 1e3 * sum(k1_bound(site, bw)[0] * m for site, m in by_b[b].items())
                          for b in by_b} for arch, by_b in sites.items()}
    for arch, by_b in sites.items():
        if sum(by_b[LADDER_BATCH].values()) != SERVED[arch]["k1"]:
            fail(f"{arch}: {sum(by_b[LADDER_BATCH].values())} K1 sites, want {SERVED[arch]['k1']}")
    rows, scalar, k1_err = phase_k1(card, {arch: by_b[LADDER_BATCH] for arch, by_b in sites.items()})
    lap("k1")
    train_sites = epilogue_sites("resnet50", LADDER_BATCH, bn_dtype=torch.bfloat16)
    if sum(train_sites.values()) != TRAIN_K1:
        fail(f"resnet50 training: {sum(train_sites.values())} K1 sites, want {TRAIN_K1}")
    # bf16 boundaries: modes b and c are the one bf16 tensor of mode a
    train_bound_ms = {
        "k1": sum(k1_bound((*site[:6], "a"), bw, (2, 2, 2, 2))[0] * m
                  for site, m in train_sites.items()),
        "k1_bwd": sum(k1_bwd_bound(site, bw)[0] * m for site, m in train_sites.items())}
    bwd_rows, bwd_step, bwd_err, bwd_worst = phase_k1_bwd(card, train_sites,
                                                          sites["resnet50"][LADDER_BATCH])
    lap("k1-bwd")
    attn = phase_attention(card)
    attn_bwd = phase_attention_bwd(card)
    lap("attention, attention-bwd")
    with tempfile.TemporaryDirectory() as tmp:
        serve = phase_serve(card, Path(tmp), "resnet50", k1_bound_us["resnet50"])
        bot = phase_serve(card, Path(tmp), "botnet50", k1_bound_us["botnet50"])
        large = phase_large_crop(card, Path(tmp))
    table = phase_mhsa_table()
    lap("serve, large crop, mhsa table")
    moe = phase_moe_kernels(card)
    with tempfile.TemporaryDirectory() as tmp:
        moe_dist = phase_moe_dist(Path(tmp))
    lap("moe")
    # the training phases' checkpoints outlive their phases: their test_net
    # runs go together, after the last timed phase (run_test_nets)
    train_tmp = tempfile.TemporaryDirectory()
    evals: list = []
    train = phase_train(card, Path(train_tmp.name), train_bound_ms, evals)
    lap("train")
    bot_sites = epilogue_sites("botnet50", BOT_BATCH, bn_dtype=torch.bfloat16)
    if sum(bot_sites.values()) != TRAIN_K1:
        fail(f"botnet50 training: {sum(bot_sites.values())} K1 sites, want {TRAIN_K1}")
    bot_bound_ms = {
        "k1": sum(k1_bound((*site[:6], "a"), bw, (2, 2, 2, 2))[0] * m
                  for site, m in bot_sites.items()),
        "k1_bwd": sum(k1_bwd_bound(site, bw)[0] * m for site, m in bot_sites.items()),
        "attention": BOT_ATTENTION * attention_bound(BOT_BATCH * 4, 196, 128, 128, "bfloat16",
                                                     "bias", bw)[0],
        "attention_bwd": BOT_ATTENTION * attn_bwd["K2 train"]["bound_ms"]}
    train_bot = phase_train_bot(card, Path(train_tmp.name), bot_bound_ms, evals)
    lap("train-bot")
    l512 = (BOT512_IM // 16) ** 2
    bot512_bound_ms = dict(
        bot_bound_ms,
        attention=BOT_ATTENTION * attention_bound(BOT512_BATCH * 4, l512, 128, 128, "bfloat16",
                                                  "bias", bw)[0],
        attention_bwd=BOT_ATTENTION * attention_bwd_bound(BOT512_BATCH * 4, l512, 128, 128,
                                                          "bfloat16", "bfloat16", bw)[0])
    bot512_sites = epilogue_sites("botnet50", BOT512_BATCH, im=BOT512_IM, bn_dtype=torch.bfloat16)
    if sum(bot512_sites.values()) != TRAIN_K1:
        fail(f"botnet50 at {BOT512_IM}^2: {sum(bot512_sites.values())} K1 sites, want {TRAIN_K1}")
    bot512_bound_ms["k1"] = sum(k1_bound((*site[:6], "a"), bw, (2, 2, 2, 2))[0] * m
                                for site, m in bot512_sites.items())
    bot512_bound_ms["k1_bwd"] = sum(k1_bwd_bound(site, bw)[0] * m
                                    for site, m in bot512_sites.items())
    train_bot_512 = phase_train_bot_512(card, Path(train_tmp.name), bot512_bound_ms, evals)
    lap("train-bot-512")
    with tempfile.TemporaryDirectory() as tmp:
        jpegs = write_jpeg_imagefolder(Path(tmp) / "jpeg")
        say(f"[input] wrote {jpegs['files']} JPEGs ({JPEG_SPLITS}, {JPEG_CLASSES} classes, "
            f"{JPEG_SIZE[0]}x{JPEG_SIZE[1]}, quality {JPEG_QUALITY}) in {jpegs['wall_s']:.1f} s: "
            f"mean {jpegs['mean_bytes'] / 1e3:.1f} KB a file")
        inp = dict(phase_input(card, Path(tmp) / "jpeg", smi), jpegs=jpegs)
        train_jpeg = phase_train_jpeg(card, Path(tmp), Path(tmp) / "jpeg", train_bound_ms, train)
        train_dp = phase_train_dataplane(card, Path(tmp), Path(tmp) / "jpeg", train_bound_ms,
                                         train_jpeg, train, inp)
        oracle = phase_oracle(card, Path(tmp))
    lap("input, train-jpeg, train-dataplane, oracle")
    with tempfile.TemporaryDirectory() as tmp:
        train_preempt = phase_train_preempt(card, Path(tmp), smi)
    lap("train-preempt")
    zoo = phase_train_zoo(card, Path(train_tmp.name), bw, evals)
    lap("train-zoo")
    train_mae = phase_train_mae(card, Path(train_tmp.name), evals)
    lap("train-mae")
    pretrained = phase_pretrained(Path(train_tmp.name), evals)
    lap("pretrained")
    run_test_nets(evals)
    train_tmp.cleanup()
    lap(f"test_net x {len(evals)}, concurrently")
    with tempfile.TemporaryDirectory() as tmp:
        zoo_f32 = phase_zoo_f32(Path(tmp))
    mae_f32 = phase_mae_f32()
    lap("zoo f32, mae f32")
    remat = phase_remat(card)
    lap("remat")

    # K1 per batch-128 forward of each served model: its sites' rows summed
    per_fwd, modes = {}, {}
    for arch in SERVED:
        per_fwd[arch] = {k: sum(r[k] * r["launches_per_forward"][arch] for r in rows)
                         for k in ("device_ms", "ms", "single_call_ms", "plain_ms", "library_ms",
                                   "bound_ms", "bytes")}
        modes[arch] = Counter()
        for site, m in sites[arch][LADDER_BATCH].items():
            modes[arch][site[-1]] += m
    out = ROOT / "smoke_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_k1.json").write_text(json.dumps(
        {"card": smi, "build": builds["epilogue"], "rows": rows, "scalar_route": scalar,
         "max_abs_err": k1_err, "per_forward_b128": per_fwd, "modes_per_forward": modes,
         "k1_bound_us": k1_bound_us, "serve": serve}, indent=1))
    (out / "chip_smoke_attention.json").write_text(json.dumps(
        {"card": smi, "build": builds["attention"], "cases": attn, "backward": attn_bwd,
         "serve_botnet50": bot, "large_crop": large, "mhsa_table": table}, indent=1))
    (out / "chip_smoke_train.json").write_text(json.dumps(
        {"card": smi, "k1_bwd_rows": bwd_rows, "k1_bwd_per_step": bwd_step,
         "k1_bwd_max_abs_err": bwd_err, "k1_bwd_sum_rel_err": bwd_worst,
         "train_sites": [[*site, m] for site, m in sorted(train_sites.items())],
         "train_bound_ms": train_bound_ms, "train": train, "train_bot": train_bot,
         "train_bot_bound_ms": bot_bound_ms,
         "train_bot_sites": [[*site, m] for site, m in sorted(bot_sites.items())],
         "train_bot_512": train_bot_512, "train_bot_512_bound_ms": bot512_bound_ms,
         "input": inp, "train_jpeg": train_jpeg, "train_dataplane": train_dp,
         "oracle": oracle, "train_preempt": train_preempt, "train_zoo": zoo,
         "zoo_f32": zoo_f32, "train_mae": train_mae, "pretrained": pretrained,
         "mae_f32": mae_f32, "remat": remat, "phase_wall_s": laps}, indent=1))
    (out / "chip_smoke_moe.json").write_text(json.dumps(
        {"card": smi, "build": builds["moe"], "kernels": moe, "dist": moe_dist}, indent=1))
    for arch, f in per_fwd.items():
        say(f"[k1] per {arch} forward at batch {LADDER_BATCH} "
            f"({sum(sites[arch][LADDER_BATCH].values())} launches, modes "
            f"{dict(sorted(modes[arch].items()))}; x bf16, boundary f32, cast bf16): device "
            f"{f['device_ms']:.3f} ms ({100 * f['bound_ms'] / f['device_ms']:.0f}% of bound), "
            f"{f['ms']:.3f} ms back-to-back, {f['single_call_ms']:.3f} ms single calls, "
            f"plain {f['plain_ms']:.3f} ms, F.batch_norm {f['library_ms']:.3f} ms, "
            f"bound {f['bound_ms']:.3f} ms, {f['bytes'] / 1e9:.2f} GB")
    rn50, bot50 = per_fwd["resnet50"], per_fwd["botnet50"]
    kernels = [{
        "name": "K1 fused_conv_epilogue",
        "route": "cuda",
        "source": "distribuuuu_tpu_torch/ops/csrc/epilogue.cu",
        "replaces": "distribuuuu_tpu/ops/epilogue.py:153",
        "launches": serve["launches"]["k1"],
        "max_abs_err": k1_err,
        "ms": rn50["device_ms"],
        "plain_ms": rn50["plain_ms"],
        "bound_ms": rn50["bound_ms"],
        "bound_by": "bytes",
        "library_ms": rn50["library_ms"],
        "per": f"one ResNet-50 forward at batch {LADDER_BATCH}, 224x224: the "
               f"{sum(sites['resnet50'][LADDER_BATCH].values())} launches summed in the modes the "
               f"model runs them (x bf16, boundary f32, cast bf16); ms, plain_ms, library_ms: "
               f"device time, calls replayed from a CUDA graph over input sets of at least "
               f"{K1_ROTATE_BYTES >> 20} MiB a replay; launches: the ResNet-50 serving run",
        "back_to_back_ms": rn50["ms"],
        "single_call_ms": rn50["single_call_ms"],
        "botnet50_forward": {
            "launches": bot["launches"]["k1"],
            "ms": bot50["device_ms"],
            "plain_ms": bot50["plain_ms"],
            "bound_ms": bot50["bound_ms"],
            "library_ms": bot50["library_ms"],
            "back_to_back_ms": bot50["ms"],
            "single_call_ms": bot50["single_call_ms"],
            "per": f"one BoTNet-50 forward at batch {LADDER_BATCH}, 224x224, timed as above; "
                   f"launches: the BoTNet-50 serving run",
        },
    }]
    # (kernel, entry point, the Pallas kernel it stands in for, launches on its path)
    for kname, entry, line, launches in (
            ("K2", "fused_attention", 188, bot["launches"]["attention"]),
            ("K3", "fused_attention_abs", 462, table["K3"]["launches"]),
            ("K4", "fused_attention", 278, large["launches"]["attention"]),
            ("K5", "fused_attention_abs", 311, table["K5"]["launches"])):
        r = attn[kname]
        kernels.append({
            "name": f"{kname} {entry}",
            "route": "cuda",
            "source": "distribuuuu_tpu_torch/ops/csrc/attention.cu",
            "replaces": f"distribuuuu_tpu/ops/attention.py:{line}",
            "launches": launches,
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "per": f"one launch: B*N {r['b'] * r['n']}, L {r['l']}, D {r['d']}, Dv {r['dv']}, "
                   f"{r['dtype']} q/k/v, {'bf16 bias' if r['mode'] == 'bias' else '[L, D] table'}; "
                   f"{ATTN_BATCH} back-to-back calls per timing",
            "blockwise_max_abs_err": r["blockwise_max_abs_err"],
            "tflops": r["tflops"],
        })
    soak = next(r for r in moe["cases"] if r["label"] == "soak" and r["dtype"] == "float32")
    base = {dt: next(r for r in moe["cases"] if r["label"] == "switch-base" and r["dtype"] == dt)
            for dt in ("float32", "bfloat16")}
    timing = (f"ms, plain_ms, library_ms: device time (ms: the calls replayed from a CUDA graph, "
              f"cycling through input sets of at least {K1_ROTATE_BYTES >> 20} MiB a replay; "
              f"plain and library back to back)")
    for kname, key, line, what in (
            ("K6 fused_moe_dispatch", "dispatch", 154, "one switch_moe forward"),
            ("K7 fused_moe_combine", "combine", 312, "one switch_moe forward"),
            ("K6 backward", "dispatch_bwd", 269, "one switch_moe backward; it stands in for the "
             "XLA recompute of the Pallas kernel's custom_vjp"),
            ("K7 backward", "combine_bwd", 361, "one switch_moe backward; it stands in for the "
             "XLA recompute of the Pallas kernel's custom_vjp")):
        r = soak[key]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "distribuuuu_tpu_torch/ops/csrc/moe.cu",
            "replaces": f"distribuuuu_tpu/ops/moe_kernel.py:{line}",
            "launches": moe_dist["launches"][key],
            "max_abs_err": moe["max_abs_err"][key],
            "ms": r["device_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "per": f"one call at N {soak['n']}, D {soak['d']}, E {soak['e']}, C {soak['c']}, x f32 "
                   f"(the soak's shard); {timing}; launches: {moe_dist['world']} ranks x {what} in "
                   f"[moe-dist]",
            "back_to_back_ms": r["back_to_back_ms"],
            "single_call_ms": r["single_call_ms"],
            "switch_base": {dt: {k: b[key][k] for k in ("device_ms", "back_to_back_ms",
                                                         "single_call_ms", "plain_ms",
                                                         "library_ms", "bound_ms")}
                            for dt, b in base.items()},
        })
    kernels.insert(1, {
        "name": "K1 backward",
        "route": "cuda",
        "source": "distribuuuu_tpu_torch/ops/csrc/epilogue.cu",
        "replaces": "distribuuuu_tpu/ops/epilogue.py:222",
        "launches": train["launches"]["k1_bwd"],
        "max_abs_err": bwd_err,
        "ms": bwd_step["device_ms"],
        "plain_ms": bwd_step["plain_ms"],
        "bound_ms": bwd_step["bound_ms"],
        "bound_by": "bytes",
        "library_ms": bwd_step["library_ms"],
        "per": f"one ResNet-50 training step at batch {LADDER_BATCH}, 224x224: the "
               f"{TRAIN_K1} launches summed (x, g, residual, d_x, d_identity bf16); ms: device "
               f"time, calls replayed from a CUDA graph over input sets of at least "
               f"{K1_ROTATE_BYTES >> 20} MiB a replay; plain_ms (autograd through "
               f"epilogue_reference) and library_ms (autograd through F.batch_norm + cast + add "
               f"+ relu): back to back; launches: the {TRAIN_STEPS} steps of [train]; "
               f"max_abs_err: over d_x, d_identity (bitwise) and the per-channel sums (within "
               f"{K1_BWD_SUM_RTOL} of sum|terms|) at [k1-bwd]'s and [train-zoo]'s sites",
        "back_to_back_ms": bwd_step["ms"],
        "single_call_ms": bwd_step["single_call_ms"],
        "sum_rel_err": bwd_worst,
    })
    kernels[0]["train_launches"] = train["launches"]["k1"]
    kernels[0]["botnet50_train_launches"] = train_bot["launches"]["k1"]
    kernels[1]["botnet50_train_launches"] = train_bot["launches"]["k1_bwd"]
    for i, key in ((0, "k1"), (1, "k1_bwd")):  # the real-image paths
        kernels[i]["train_jpeg_launches"] = train_jpeg["launches"][key]
        kernels[i]["train_dataplane_launches"] = train_dp["launches"][key]
        kernels[i]["oracle_epoch0_launches"] = oracle["launches"][key]
        kernels[i]["train_preempt_launches"] = train_preempt["launches"][key]
    # the zoo's sites checked too ([train-zoo], zoo_k1_check)
    kernels[0]["max_abs_err"] = max([k1_err, *(r["k1_check"]["k1_max_abs_err"]
                                               for r in zoo.values())])
    kernels[1]["max_abs_err"] = max([bwd_err, *(r["k1_check"]["k1_bwd_max_abs_err"]
                                               for r in zoo.values())])
    kernels[1]["sum_rel_err"] = max([bwd_worst, *(r["k1_check"]["k1_bwd_sum_rel_err"]
                                                 for r in zoo.values())])
    for i, key in ((0, "k1"), (1, "k1_bwd")):  # the zoo: every BN of each family
        kernels[i]["train_zoo"] = {
            arch: {"launches": r["launches"][key], "per_step": r["k1_a_step"],
                   "in_situ_us_per_step": r["profile"].get("per_step_us", {}).get(
                       "K1" if key == "k1" else "K1-bwd"),
                   "bound_ms_per_step": r["bound_ms"].get(key),
                   "per": f"{r['steps']} steps of [train-zoo] at batch {r['batch']}, 224x224, "
                          f"bf16; the profiler's µs a step of the kernel class; the bound "
                          f"from the step's K1 sites"}
            for arch, r in zoo.items()}
    for i, key in ((0, "k1"), (1, "k1_bwd")):  # under MODEL.REMAT, and MAE's none
        kernels[i]["remat_launches"] = {
            arch: {"off": r["launches_off"][key], "on": r["launches_on"][key],
                   "per": f"{REMAT_STEPS} steps of [remat] at batch {r['batch']}, "
                          f"{r['im']}x{r['im']}, bf16, REMAT off and on"}
            for arch, r in remat.items()}
        kernels[i]["train_mae_launches"] = train_mae["launches"][key]
    kernels[0]["zoo_serve_launches"] = {arch: r["serve"]["launches"] for arch, r in zoo_f32.items()}
    kernels[0]["zoo_f32_launches"] = {arch: r["launches"][0] for arch, r in zoo_f32.items()}
    kernels[1]["zoo_f32_launches"] = {arch: r["launches"][1] for arch, r in zoo_f32.items()}
    k2 = next(k for k in kernels if k["name"].startswith("K2 "))
    k2["train_launches"] = train_bot["launches"]["attention"]
    k2["remat_launches"] = {k: remat["botnet50"][f"launches_{k}"]["attention"] for k in ("off", "on")}
    r = attn_bwd["K2 train"]
    kernels.insert(kernels.index(k2) + 1, {
        "name": "K2/K4 backward fused_attention_backward",
        "route": "cuda",
        "source": "distribuuuu_tpu_torch/ops/csrc/attention.cu",
        "replaces": "distribuuuu_tpu/ops/attention.py:241",
        "launches": train_bot["launches"]["attention_bwd"],
        "max_abs_err": max(row["max_abs_err"] for row in attn_bwd.values()
                           if row["bias_dtype"] != "table"),
        "ms": r["device_ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
        "per": f"one call at B*N {r['b'] * r['n']}, L {r['l']}, D {r['d']}, Dv {r['dv']}, bf16 "
               f"q/k/v/g and bias (BoTNet-50 training at 224x224, batch {BOT_BATCH}), on the "
               f"{r['route']} route ({r['launches_per_call']} CUDA launches a call); ms: device "
               f"time, calls replayed from a CUDA graph over input sets of at least "
               f"{K1_ROTATE_BYTES >> 20} MiB a replay; plain_ms (attention_backward_reference) and "
               f"library_ms (the backward of F.scaled_dot_product_attention with the bias needing "
               f"a gradient): back to back; launches: calls in the {BOT_STEPS} steps of "
               f"[train-bot], every one on the cluster route; it stands in for the XLA recompute "
               f"of the custom_vjp of K2 (:241); max_abs_err: over every bias-mode case of "
               f"[attention-bwd]",
        "max_rel_err": max(max(row["rel_errors"].values()) for row in attn_bwd.values()
                           if row["bias_dtype"] != "table"),
        "remat_launches": {k: remat["botnet50"][f"launches_{k}"]["attention_bwd"]
                           for k in ("off", "on")},
        "kernel_route": f"{r['route']} (bf16, L <= 256: one launch, a thread-block cluster a head); "
                        f"blockwise at L > 256 (K4: {attn_bwd['K4']['route']}, the next entry); "
                        f"scalar in f32",
        "back_to_back_ms": r["back_to_back_ms"],
        "single_call_ms": r["single_call_ms"],
        "shapes": {name: {k: row[k] for k in ("route", "device_ms", "back_to_back_ms",
                                             "single_call_ms", "plain_ms", "library_ms",
                                             "bound_ms", "bound_by")}
                   for name, row in attn_bwd.items()
                   if "device_ms" in row and row["bias_dtype"] != "table"},
    })
    r = attn_bwd["K4 b32"]
    bw_rows = {name: row for name, row in attn_bwd.items() if row["route"] == "blockwise"}
    kernels.insert(kernels.index(k2) + 2, {
        "name": "K4/K5 backward, blockwise route (fused_attention_backward at L > 256)",
        "route": "cuda",
        "source": "distribuuuu_tpu_torch/ops/csrc/attention.cu",
        "replaces": "distribuuuu_tpu/ops/attention.py:400",
        "launches": train_bot_512["launches"]["attention_bwd"],
        "max_abs_err": max(row["max_abs_err"] for row in bw_rows.values()
                           if row["bias_dtype"] != "table"),
        "ms": r["device_ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
        "per": f"one call at B*N {r['b'] * r['n']}, L {r['l']}, D {r['d']}, Dv {r['dv']}, bf16 "
               f"q/k/v/g and bias (BoTNet-50 training at {BOT512_IM}x{BOT512_IM}, batch "
               f"{BOT512_BATCH}), on the {r['route']} route ({r['launches_per_call']} CUDA "
               f"launches a call: attention_bwd_stats_kernel, attention_bwd_kv_kernel, "
               f"attention_bwd_dq_kernel); ms: device time, calls replayed from a CUDA graph over "
               f"input sets of at least {K1_ROTATE_BYTES >> 20} MiB a replay; plain_ms "
               f"(attention_backward_reference) and library_ms (the backward of "
               f"F.scaled_dot_product_attention with the bias needing a gradient): back to back; "
               f"launches: calls in the {BOT512_STEPS} steps of [train-bot-512], every one on the "
               f"blockwise route; it stands in for the XLA recompute of the custom_vjp of K4 "
               f"(:400, which is :241) and, in table mode, of K5 (:418, which is :514); "
               f"max_abs_err: over the bias-mode cases on the blockwise route",
        "max_rel_err": max(max(row["rel_errors"].values()) for row in bw_rows.values()),
        "kernels_us": r["kernels_us"],
        "back_to_back_ms": r["back_to_back_ms"],
        "single_call_ms": r["single_call_ms"],
        "shapes": {name: {k: row[k] for k in ("route", "device_ms", "back_to_back_ms",
                                             "single_call_ms", "plain_ms", "library_ms",
                                             "bound_ms", "bound_by", "kernels_us")}
                   for name, row in bw_rows.items() if "device_ms" in row},
    })
    r = attn_bwd["K3 train"]
    kernels.insert(kernels.index(k2) + 3, {
        "name": "K3/K5 backward fused_attention_abs_backward",
        "route": "cuda",
        "source": "distribuuuu_tpu_torch/ops/csrc/attention.cu",
        "replaces": "distribuuuu_tpu/ops/attention.py:514",
        "launches": table["K3"]["bwd_launches"] + table["K5"]["bwd_launches"],
        "max_abs_err": max(row["max_abs_err"] for row in attn_bwd.values()
                           if row["bias_dtype"] == "table"),
        "ms": r["device_ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
        "per": f"one call at B*N {r['b'] * r['n']}, L {r['l']}, D {r['d']}, Dv {r['dv']}, bf16 "
               f"q/k/v/g and [L, D] table (MHSA(rel_pos_emb=False) training at 224x224, batch "
               f"32), on the {r['route']} route plus the demb reduction "
               f"({r['launches_per_call']} CUDA launches a call); ms: device time as the K2/K4 "
               f"backward's; plain_ms (attention_table_backward_reference) and library_ms "
               f"(autograd through einsum(q, emb) and the backward of "
               f"F.scaled_dot_product_attention): back to back; launches: table-mode backward "
               f"calls of the [mhsa table] training steps at fmap 14 and 32; it stands in for the "
               f"XLA recompute of the custom_vjp of K3 (:514) and K5 (:419); max_abs_err (demb "
               f"sums every head, so it is large in absolute terms) and max_rel_err (relative to "
               f"max(1, max|grad|)): over every table-mode case of [attention-bwd]",
        "max_rel_err": max(max(row["rel_errors"].values()) for row in attn_bwd.values()
                           if row["bias_dtype"] == "table"),
        "kernel_route": f"{r['route']} + demb at L <= 256; {attn_bwd['K5']['route']} + demb at "
                        f"L 1024 (K5: the previous entry's kernels in table mode); scalar + demb "
                        f"in f32",
        "back_to_back_ms": r["back_to_back_ms"],
        "single_call_ms": r["single_call_ms"],
        "shapes": {name: {k: row[k] for k in ("route", "device_ms", "back_to_back_ms",
                                             "single_call_ms", "plain_ms", "library_ms",
                                             "bound_ms", "bound_by")}
                   for name, row in attn_bwd.items()
                   if "device_ms" in row and row["bias_dtype"] == "table"},
    })
    say(f"[smoke] the whole run took {time.perf_counter() - wall0:.1f} s; by phase (s): "
        + ", ".join(f"{k} {v}" for k, v in laps.items()))
    say(smi)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
