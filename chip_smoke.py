#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. device: the card's name and power limit (``nvidia-smi``); no CUDA -> fail;
2. build: the fused conv-epilogue kernel (K1) from ``ops/csrc/epilogue.cu``,
   with nvcc's register and spill report;
3. K1 against its plain PyTorch version at every distinct epilogue shape of
   a ResNet-50 forward at batch 128, 224x224 (bitwise, ``torch.equal``),
   x bf16 -> f32 (serving) and bf16 -> bf16, timed with CUDA events beside
   the plain version, a ``F.batch_norm`` composition and the HBM bound;
4. serve: ``config/serve_resnet50.yaml`` at full width (ResNet-50, 224,
   1000 classes, bf16, uint8 wire, ladder [1, 8, 32, 128]) on seeded random
   weights; mixed-size concurrent requests through ``ServeReplica.handle``
   plus one HTTP round trip; every forward must launch K1 49 times; each
   response must equal the direct forward of its images; f32 card vs f32 CPU
   and bf16 serve vs f32 tolerances; per-ladder-size latency;
5. the ``{"kernels": [...]}`` line; 6. the ``{"ok": true, ...}`` last line.

Per-shape K1 numbers are also written to ``smoke_out/chip_smoke_k1.json``.
"""

from __future__ import annotations

import base64
import json
import re
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


def resnet50_epilogue_shapes(n: int, im: int) -> Counter:
    """(N, H, W, C, residual) -> launches, for one ResNet-50 forward."""
    shapes: Counter = Counter()
    h = im // 2
    shapes[(n, h, h, 64, False)] += 1  # stem bn1
    h //= 2  # max-pool
    for stage, blocks in enumerate([3, 4, 6, 3]):
        planes = 64 * 2**stage
        for i in range(blocks):
            stride = 2 if stage > 0 and i == 0 else 1
            shapes[(n, h, h, planes, False)] += 1  # bn1, before the strided 3x3
            h //= stride
            shapes[(n, h, h, planes, False)] += 1  # bn2
            shapes[(n, h, h, planes * 4, True)] += 1  # bn3 + residual
    return shapes


def cuda_ms(fn, runs: int = 25, warmup: int = 3) -> float:
    """Median of ``runs`` single-call CUDA-event timings, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_build():
    from distribuuuu_tpu_torch.ops import _build

    _, info = _build.load("epilogue")
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", info.ptxas)]
    spills = [ln.strip() for ln in info.ptxas.splitlines()
              if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln]
    if not regs:
        fail(f"nvcc gave no -Xptxas -v report:\n{info.ptxas}")
    say(f"[build] {info.path.name}: nvcc {info.wall_s:.2f}s; {len(regs)} instantiations, "
        f"{min(regs)}-{max(regs)} registers/thread, spills: {spills or 'none'}")
    return info.wall_s, regs, spills


def phase_k1(card: str):
    """K1 vs plain at every ResNet-50 epilogue shape; returns per-shape rows."""
    import torch
    import torch.nn.functional as F

    from distribuuuu_tpu_torch.ops import epilogue as ep

    bw = hbm_bytes_per_s(card)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    max_err = 0.0
    combos = [("bf16->f32", torch.float32), ("bf16->bf16", torch.bfloat16)]
    for (n, h, w, c, res), mult in sorted(resnet50_epilogue_shapes(LADDER_BATCH, IM).items()):
        for label, bn_dtype in combos:
            def nhwc(dtype):
                t = torch.randn(n, h, w, c, generator=gen, device="cuda")
                return t.to(dtype).permute(0, 3, 1, 2)  # channels-last NCHW view

            x = nhwc(torch.bfloat16)
            mean = torch.randn(c, generator=gen, device="cuda") * 0.1
            mul = torch.rand(c, generator=gen, device="cuda") + 0.5
            bias = torch.randn(c, generator=gen, device="cuda") * 0.1
            identity = nhwc(bn_dtype) if res else None
            args = (x, mean, mul, bias, identity)
            got = ep.fused_conv_epilogue(*args, relu=True, bn_dtype=bn_dtype)
            want = ep.epilogue_reference(*args, relu=True, bn_dtype=bn_dtype)
            torch.cuda.synchronize()
            if got.dtype != want.dtype or not got.is_contiguous(memory_format=torch.channels_last):
                fail(f"K1 output dtype/layout wrong at {(n, h, w, c, res)} {label}")
            err = (got.float() - want.float()).abs().max().item()
            max_err = max(max_err, err)
            if not torch.equal(got, want):
                fail(f"K1 != plain at (N,H,W,C,res)={(n, h, w, c, res)} {label}: max|d|={err}")
            # yardstick only: var + eps ~ 1, so F.batch_norm applies ~mul
            var = torch.full((c,), 1.0 - 1e-5, device="cuda")

            def library():
                y = F.batch_norm(x.float(), mean, var, mul, bias, False, 0.0, 1e-5)
                y = y.to(bn_dtype)
                if identity is not None:
                    y = y + identity
                return y.relu_()

            ms = cuda_ms(lambda: ep.fused_conv_epilogue(*args, relu=True, bn_dtype=bn_dtype))
            plain_ms = cuda_ms(lambda: ep.epilogue_reference(*args, relu=True, bn_dtype=bn_dtype))
            lib_ms = cuda_ms(library)
            elems = n * h * w * c
            nbytes = elems * (x.element_size() + got.element_size()
                              + (identity.element_size() if res else 0)) + 3 * c * 4
            flops = elems * (5 if res else 4)
            bound_ms = 1e3 * max(nbytes / bw, flops / F32_PEAK_FLOPS)
            rows.append(dict(
                n=n, h=h, w=w, c=c, residual=res, combo=label, launches_per_forward=mult,
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bytes=nbytes, bound_ms=bound_ms,
                bound_by="bytes" if nbytes / bw >= flops / F32_PEAK_FLOPS else "operations",
            ))
            say(f"[k1] N{n} {h}x{w} C{c} res={int(res)} {label} x{mult}: equal, "
                f"{ms:.4f} ms (plain {plain_ms:.4f}, F.batch_norm {lib_ms:.4f}, "
                f"bound {bound_ms:.4f}, {100 * bound_ms / ms:.0f}% of bound)")
            del x, identity, got, want
    torch.cuda.empty_cache()
    return rows, max_err


def synthetic_state_dict(seed: int = 0):
    """Seeded ResNet-50 weights: fan-in normal convs, BN stats and affine
    drawn away from the identity, a small fc."""
    import numpy as np
    import torch

    from distribuuuu_tpu_torch.models import build_model

    rng = np.random.default_rng(seed)
    template = build_model("resnet50", num_classes=1000, dtype=torch.float32).state_dict()
    sd = {}
    for k, v in template.items():
        shape = tuple(v.shape)
        if k == "fc.weight":
            a = rng.standard_normal(shape) / np.sqrt(shape[1])
        elif k == "fc.bias":
            a = rng.standard_normal(shape) * 0.01
        elif v.dim() == 4:
            a = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif k.endswith("running_mean") or k.endswith(".bias"):
            a = rng.standard_normal(shape) * 0.1
        elif k.endswith("running_var"):
            a = rng.uniform(0.5, 2.0, shape)
        elif k.endswith(".weight"):
            a = rng.uniform(0.5, 1.5, shape)
        else:
            fail(f"unexpected state_dict entry {k}")
        sd[k] = torch.from_numpy(a.astype(np.float32))
    return sd


def phase_serve(card: str, tmp: Path):
    import numpy as np
    import torch

    from distribuuuu_tpu_torch.config import cfg, load_cfg_fom_args, reset_cfg
    from distribuuuu_tpu_torch.data.transforms import device_normalize
    from distribuuuu_tpu_torch.models import build_model
    from distribuuuu_tpu_torch.ops import epilogue as ep
    from distribuuuu_tpu_torch.serve.engine import parse_model_specs
    from distribuuuu_tpu_torch.serve.frontend import ServeReplica, run_http

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sd = synthetic_state_dict(0)
    weights = tmp / "rn50.pt"
    torch.save(sd, weights)
    reset_cfg()
    load_cfg_fom_args(argv=["--cfg", str(SERVE_CFG), "SERVE.MODELS",
                            f"['rn50=resnet50@{weights}']", "SERVE.PORT", "0",
                            "OUT_DIR", str(tmp / "out")])
    cfg.freeze()
    s = cfg.SERVE
    if (cfg.MODEL.ARCH, int(cfg.MODEL.NUM_CLASSES), str(cfg.MODEL.DTYPE), int(s.IM_SIZE),
            str(s.INPUT_DTYPE), list(s.BATCH_SIZES)) != (
            "resnet50", 1000, "bfloat16", 224, "uint8", [1, 8, 32, 128]):
        fail(f"{SERVE_CFG} no longer describes the full-width serving config")

    # --- the main path: counts zeroed just before, read just after ---------
    ep.LAUNCHES = 0
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
                responses[i] = replica.handle({"model": "rn50", "inputs": {
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
        body = json.dumps({"model": "rn50", "inputs": {
            "b64": base64.b64encode(http_imgs.tobytes()).decode(),
            "shape": list(http_imgs.shape)}}).encode()
        url = f"http://127.0.0.1:{replica.port}"
        with urllib.request.urlopen(urllib.request.Request(
                url + "/v1/predict", data=body,
                headers={"Content-Type": "application/json"}), timeout=60) as r:
            http_resp = json.loads(r.read())
        with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
            health = json.loads(r.read())
        launches, forwards = ep.LAUNCHES, engine.forwards
    finally:
        stop.set()
        http.join(10)
        replica.shutdown()
    # -----------------------------------------------------------------------
    say(f"[serve] startup {startup_s:.2f}s (load + warmup of every ladder size); "
        f"{forwards} forwards, {launches} K1 launches; /healthz {health}")
    if forwards < len(engine.batch_sizes) + 2 or launches != 49 * forwards:
        fail(f"K1 launches {launches} != 49 x {forwards} forwards")
    batch_sizes = [r["batch_size"] for r in responses] + [http_resp["batch_size"]]
    say(f"[serve] request sizes {sizes + [2]} ran at ladder sizes {batch_sizes}")
    # each response equals the direct forward of its own images at its size
    all_reqs = reqs + [http_imgs]
    all_resp = [np.asarray(r["logits"], np.float32) for r in responses] + [
        np.asarray(http_resp["logits"], np.float32)]
    for imgs, got, b in zip(all_reqs, all_resp, batch_sizes):
        padded = np.zeros((b, IM, IM, 3), np.uint8)
        padded[: len(imgs)] = imgs
        direct = engine.forward("rn50", padded)[: len(imgs)]
        if got.shape != (len(imgs), 1000) or not np.isfinite(got).all():
            fail(f"response of {len(imgs)} images: shape {got.shape} or non-finite logits")
        if not np.array_equal(got, direct):
            fail(f"response of {len(imgs)} images != direct forward at batch {b}: "
                 f"max|d|={np.abs(got - direct).max()}")
    if float(np.std(all_resp[-2])) == 0.0:
        fail("logits have no spread")

    # per-ladder-size latency through engine.forward (host clock, result fetch included)
    latency = {}
    for b in engine.batch_sizes:
        batch = rng.integers(0, 256, size=(b, IM, IM, 3), dtype=np.uint8)
        times = [engine.forward_timed("rn50", batch)[1] for _ in range(15)]
        latency[b] = statistics.median(times)
        say(f"[serve] batch {b}: median forward {latency[b]:.3f} ms, "
            f"{1000.0 * b / latency[b]:.1f} images/s ({card})")

    profile = {b: profile_forward(engine, rng, b) for b in (1, LADDER_BATCH)}

    # (a) f32 on the card (kernel) vs f32 on the CPU (plain epilogue)
    imgs = torch.from_numpy(reqs[2])  # the 8-image request, served at bf16
    with torch.inference_mode():
        m_gpu = build_model("resnet50", num_classes=1000, dtype=torch.float32)
        m_gpu.load_state_dict(sd, strict=True)
        m_cpu = build_model("resnet50", num_classes=1000, dtype=torch.float32)
        m_cpu.load_state_dict(sd, strict=True)
        m_gpu = m_gpu.to("cuda", memory_format=torch.channels_last).eval()
        m_cpu = m_cpu.to(memory_format=torch.channels_last).eval()
        f32_gpu = m_gpu(device_normalize(imgs.cuda())).cpu().numpy()
        f32_cpu = m_cpu(device_normalize(imgs)).numpy()
    scale = float(np.abs(f32_cpu).max())
    d_a = float(np.abs(f32_gpu - f32_cpu).max())
    say(f"[check a] f32 card vs f32 CPU: max|d| {d_a:.3e}, max|logit| {scale:.4f}, "
        f"ratio {d_a / scale:.3e} (limit {F32_REL_TOL})")
    if not d_a <= F32_REL_TOL * scale:
        fail("f32 card logits disagree with the CPU reference")
    # (b) bf16 serve logits vs f32 card logits
    served = all_resp[2]
    d_b = float(np.abs(served - f32_gpu).max()) / float(np.abs(f32_gpu).max())
    top1 = float(np.mean(served.argmax(1) == f32_gpu.argmax(1)))
    say(f"[check b] bf16 serve vs f32: max|d|/max|logit| {d_b:.3e} (limit {BF16_REL_TOL}), "
        f"top-1 agreement {top1:.3f} over {len(served)} images")
    if not d_b <= BF16_REL_TOL:
        fail("bf16 serve logits are outside the stated tolerance of f32")
    return dict(launches=launches, forwards=forwards, latency_ms=latency, profile=profile,
                f32_ratio=d_a / scale, bf16_ratio=d_b, top1=top1, startup_s=startup_s)


def profile_forward(engine, rng, b: int, runs: int = 3) -> dict:
    """Device time of ``runs`` forwards at batch ``b`` by kernel class, from
    a torch.profiler trace, and the device's idle share over the window
    from the first kernel's start to the last kernel's end."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    batch = rng.integers(0, 256, size=(b, IM, IM, 3), dtype=np.uint8)
    engine.forward("rn50", batch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            engine.forward("rn50", batch)
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end > 0]
    if not spans:
        say(f"[profile] batch {b}: the profiler recorded no device time (not measured)")
        return {}
    by_class: Counter = Counter()
    by_name: Counter = Counter()
    for name, start, end in spans:
        low = name.lower()
        cls = ("K1" if "epilogue_kernel" in low else
               "conv/gemm" if any(k in low for k in ("xmma", "conv", "gemm", "cutlass", "cudnn"))
               else "other")
        by_class[cls] += end - start
        by_name[name[:60]] += end - start
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
           "busy_per_forward_us": busy / runs, "idle_share": 1.0 - busy / window,
           "kernels_per_forward": len(spans) / runs,
           "top": [(n, t / runs) for n, t in by_name.most_common(6)]}
    say(f"[profile] batch {b} per forward: " + ", ".join(
        f"{k} {v:.0f} us" for k, v in sorted(res["per_forward_us"].items()))
        + f"; device busy {res['busy_per_forward_us']:.0f} us, idle share "
        f"{100 * res['idle_share']:.1f}%, {res['kernels_per_forward']:.0f} kernels")
    return res


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA GPU")
    if not (ROOT / "distribuuuu_tpu_torch").is_dir() or not SERVE_CFG.exists():
        fail(f"run from a checkout of the repository: {ROOT} lacks the port or {SERVE_CFG.name}")
    sys.path.insert(0, str(ROOT))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    say(f"[device] {card}; nvidia-smi: {smi}; torch {torch.__version__} CUDA {torch.version.cuda}")

    build_s, _, spills = phase_build()
    rows, max_err = phase_k1(card)
    with tempfile.TemporaryDirectory() as tmp:
        serve = phase_serve(card, Path(tmp))

    serving = [r for r in rows if r["combo"] == "bf16->f32"]
    per_fwd = {k: sum(r[k] * r["launches_per_forward"] for r in serving)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes")}
    out = ROOT / "smoke_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_k1.json").write_text(json.dumps(
        {"card": smi, "build_s": build_s, "spills": spills, "rows": rows,
         "per_forward_b128": per_fwd, "serve": serve}, indent=1))
    say(f"[k1] per ResNet-50 forward at batch {LADDER_BATCH} (49 launches, bf16 -> f32): "
        f"{per_fwd['ms']:.3f} ms, plain {per_fwd['plain_ms']:.3f} ms, F.batch_norm "
        f"{per_fwd['library_ms']:.3f} ms, bound {per_fwd['bound_ms']:.3f} ms, "
        f"{per_fwd['bytes'] / 1e9:.2f} GB")
    say(smi)
    say(json.dumps({"kernels": [{
        "name": "K1 fused_conv_epilogue",
        "route": "cuda",
        "source": "distribuuuu_tpu_torch/ops/csrc/epilogue.cu",
        "replaces": "distribuuuu_tpu/ops/epilogue.py:153",
        "launches": serve["launches"],
        "equal": True,
        "max_abs_err": max_err,
        "ms": per_fwd["ms"],
        "plain_ms": per_fwd["plain_ms"],
        "bound_ms": per_fwd["bound_ms"],
        "bound_by": "bytes",
        "library_ms": per_fwd["library_ms"],
        "per": f"one ResNet-50 forward at batch {LADDER_BATCH}, 224x224: the 49 launches "
               f"summed, x bf16 -> f32",
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
