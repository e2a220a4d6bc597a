#!/usr/bin/env python3
"""Per-phase device times of the PyTorch port's bf16 attention backward: its
cluster kernel (``attention_bwd_cluster_kernel``, L <= 256) or the key-column
pass of its blockwise route (``attention_bwd_kv_kernel``, L > 256).

    python3 scripts/torch_attention_bwd_phases.py                # cluster, B*N 128 and 512, L 196
    python3 scripts/torch_attention_bwd_phases.py --shapes 128x256 32x70
    python3 scripts/torch_attention_bwd_phases.py --kernel kv    # B*N 32 and 128, L 1024

Copies ``distribuuuu_tpu_torch/ops/csrc/attention.cu`` into the git-ignored
build directory with ``%globaltimer`` stamps at the chosen kernel's phase
boundaries, builds that copy and runs one bf16 bias-mode backward a shape
through the port's wrapper, after three unstamped calls.

Cluster kernel: thread 0 of each CTA stamps. Prints the kernel's span, the
median CTA life and, per query tile, the median over CTAs of each phase: the
S/dP phase, the first cluster barrier, the statistics' combine, p and ds, the
products, the second cluster barrier, and the dQ sum with the wait for the
next tile; then the resident clusters (``cudaOccupancyMaxActiveClusters``).

Key-column pass: lane 0 of every warp stamps, so each warp's wait at the
block's two barriers a query tile shows. Prints the kernel's span, the
median block life, and the mean and median over (block, warp, query tile) of
each phase of a tile: issuing the rows' statistics and bias loads, the wait
for the tile's Q/G copy and barrier A, the S and dP products, p and ds with
the dbias/ds stores, barrier B, and the dV/dK products; then the kernel's
device time a call from the profiler with the stamps built in and off, to
show what they cost. A stamp reads the warp's issue point: an `mma` or load
still in flight lands in a later phase, where its result is first used.

The stamps resolve what the card's timer does (a few hundred ns on an H100).
Needs a CUDA GPU; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

STAMP = """
__device__ unsigned long long* g_trace;
__device__ __forceinline__ void stamp(int slot) {
  if (g_trace && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_trace[blockIdx.x * 64 + slot] = t;
  }
}
__device__ __forceinline__ void stamp_w(int slot) {
  if (g_trace && (threadIdx.x & 31) == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_trace[((long long)blockIdx.x * KV_WARPS + (threadIdx.x >> 5)) * KV_SLOTS + slot] = t;
  }
}
"""
# (text in the kernel, the same with stamps): slot 0 the CTA's start, 2 + 8 i
# .. 8 + 8 i the phase boundaries of query tile i, 9 + 8 (nk - 1) and 40 the end
MARKS = [
    ("  cg::cluster_group cluster = cg::this_cluster();\n",
     "  stamp(0);\n  cg::cluster_group cluster = cg::this_cluster();\n"),
    ("  // tile i has landed\n    __syncthreads();\n",
     "  // tile i has landed\n    __syncthreads();\n    stamp(2 + 8 * i);\n"),
    ("    cluster.sync();  // every CTA's partials are written\n",
     "    stamp(3 + 8 * i);\n    cluster.sync();\n    stamp(4 + 8 * i);\n"),
    ("      fin[2 * BQ + tid] = delta;\n    }\n    __syncthreads();\n",
     "      fin[2 * BQ + tid] = delta;\n    }\n    __syncthreads();\n    stamp(5 + 8 * i);\n"),
    ("    __syncthreads();\n\n    // ---- dV += P^T.G",
     "    __syncthreads();\n    stamp(6 + 8 * i);\n\n    // ---- dV += P^T.G"),
    ("    cluster.sync();  // every CTA's dQ partial is written, and stage i % 2 is free\n",
     "    stamp(7 + 8 * i);\n    cluster.sync();\n    stamp(8 + 8 * i);\n"),
    ("  cluster.sync();  // no CTA leaves while another may still read its dQ partial\n",
     "  stamp(9 + 8 * (nk - 1));\n  cluster.sync();\n  stamp(40);\n"),
]
PHASES = ["S/dP", "cluster barrier A", "combine", "p/ds", "products", "cluster barrier B",
          "dQ sum + next wait"]
# the key-column pass, per warp: slot 0 the warp's start, 1 + 6 i .. 6 + 6 i
# the phase boundaries of query tile i, 1 + 6 nq the end of the tile loop
KV_WARPS, KV_SLOTS = 16, 128
KV_MARKS = [
    ("  const int nk = (p.L + BK - 1) / BK, nq = (p.L + BQ - 1) / BQ;\n",
     "  stamp_w(0);\n  const int nk = (p.L + BK - 1) / BK, nq = (p.L + BQ - 1) / BQ;\n"),
    ("    const int x0 = i * BQ, xn = min(BQ, p.L - x0);\n    const bool live",
     "    stamp_w(1 + 6 * i);\n    const int x0 = i * BQ, xn = min(BQ, p.L - x0);\n"
     "    const bool live"),
    ('    asm volatile("cp.async.wait_group 0;\\n" ::: "memory");\n    __syncthreads();\n'
     "    load_tile(i + 1);\n",
     '    stamp_w(2 + 6 * i);\n    asm volatile("cp.async.wait_group 0;\\n" ::: "memory");\n'
     "    __syncthreads();\n    stamp_w(3 + 6 * i);\n    load_tile(i + 1);\n"),
    ("    // ---- p = exp2(s - m) / l", "    stamp_w(4 + 6 * i);\n    // ---- p = exp2(s - m) / l"),
    ("    __syncthreads();\n\n    // ---- dV += P^T.G, dK += dS^T.Q",
     "    stamp_w(5 + 6 * i);\n    __syncthreads();\n    stamp_w(6 + 6 * i);\n\n"
     "    // ---- dV += P^T.G, dK += dS^T.Q"),
    ("  if (grp * 16 >= kn) return;\n", "  stamp_w(1 + 6 * nq);\n  if (grp * 16 >= kn) return;\n"),
]
KV_PHASES = ["stats/bias loads issued", "Q/G wait + barrier A", "S, dP", "p, ds + stores",
             "barrier B", "dV, dK products"]


def stamped_source(src: str, kernel: str) -> str:
    """The kernel source with the stamps, and an entry point that sets the
    trace buffer; fails if a phase boundary is no longer where it was."""
    src = src.replace("namespace {\n", "namespace {\n" + STAMP.replace(
        "KV_WARPS", str(KV_WARPS)).replace("KV_SLOTS", str(KV_SLOTS)), 1)
    if kernel == "cluster":
        start, end, marks = ("attention_bwd_cluster_kernel(const BwdParams p, const BwdWidths w) {",
                             "// demb = sum over B*N", MARKS)
    else:
        start, end, marks = ("attention_bwd_kv_kernel(const BwdParams p, const BwdWidths w) {",
                             "struct DqSmem", KV_MARKS)
    k0 = src.index(start)
    k1 = src.index(end, k0)
    body = src[k0:k1]
    for old, new in marks:
        if old not in body:
            sys.exit(f"phase boundary not found in the {kernel} kernel: {old!r}")
        body = body.replace(old, new, 1)
    return (src[:k0] + body + src[k1:] + '\nextern "C" int dtpu_set_trace(void* buf) {\n'
            "  return (int)cudaMemcpyToSymbol(g_trace, &buf, sizeof(buf));\n}\n")


def show_cluster(t, bn: int, l: int, lib) -> None:
    """The cluster kernel's phases from the stamps ``t`` (µs, a row a CTA)."""
    nk = -(-l // 64)

    def med(a, b):
        return statistics.median((t[:, b] - t[:, a]).tolist())

    print(f"B*N {bn}, L {l} ({nk} CTAs a cluster): kernel span "
          f"{float(t[:, 40].max() - t[:, 0].min()):.1f} us, CTA life {med(0, 40):.2f} us, "
          f"start to tile 0 landed {med(0, 2):.2f} us")
    for i in range(nk):
        bounds = [2 + 8 * i + ph for ph in range(7)] + [10 + 8 * i if i < nk - 1 else 9 + 8 * i]
        print(f"  tile {i}: " + ", ".join(
            f"{name} {med(a, b):.2f}" for name, a, b in zip(PHASES, bounds, bounds[1:])))
    print(f"  final cluster barrier {med(9 + 8 * (nk - 1), 40):.2f} us")
    n = ctypes.c_int(0)
    lib.dtpu_attention_backward_cluster_occupancy(1, l, ctypes.byref(n))
    print(f"  resident clusters (cudaOccupancyMaxActiveClusters): {n.value}")


def show_kv(t, bn: int, l: int, us_off: float, us_on: float) -> None:
    """The key-column pass's phases from the stamps ``t`` (µs, a row a warp
    of a block), and its profiled µs a call with the stamps off and on."""
    import torch

    nq = -(-l // 64)
    end = 1 + 6 * nq
    per_block = t.view(-1, KV_WARPS, KV_SLOTS)
    life = per_block[:, :, end].max(1).values - per_block[:, :, 0].min(1).values
    print(f"B*N {bn}, L {l} ({bn * nq} blocks of {KV_WARPS} warps, {nq} query tiles each): "
          f"kernel span {float(t[:, end].max() - t[:, 0].min()):.1f} us, block life median "
          f"{float(life.median()):.2f} us; profiled a call: {us_off:.1f} us with the stamps "
          f"built in and off, {us_on:.1f} us on")
    cols = torch.tensor([1 + 6 * i for i in range(nq)])
    edges = torch.stack([cols + ph for ph in range(6)] + [cols + 6], 1)  # [nq, 7]
    spans = t[:, edges[:, 1:]] - t[:, edges[:, :-1]]  # [warps, nq, 6]
    tile = spans.sum(-1)
    print(f"  a query tile a warp: mean {float(tile.mean()):.3f} us, median "
          f"{float(tile.median()):.3f} (start to tile 0: "
          f"{float((t[:, 1] - t[:, 0]).median()):.2f} us median)")
    for ph, name in enumerate(KV_PHASES):
        x = spans[..., ph]
        print(f"    {name}: mean {float(x.mean()):.3f} us ({100 * float(x.mean() / tile.mean()):.0f}"
              f"% of the tile), median {float(x.median()):.3f}, 90th percentile "
              f"{float(x.flatten().kthvalue(max(1, int(0.9 * x.numel()))).values):.3f}")


def kv_us(fn) -> float:
    """Device µs a call of the key-column pass, over 10 calls of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if "attention_bwd_kv_kernel" in e.key) / 10


def main() -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("cluster", "kv"), default="cluster",
                    help="the cluster kernel (L <= 256) or the blockwise route's key-column pass")
    ap.add_argument("--shapes", nargs="+",
                    help="B*NxL, bf16 q/k/v/g and bias, D = Dv = 128 (default: 128x196 512x196 "
                         "for the cluster kernel, 32x1024 128x1024 for the key-column pass)")
    args = ap.parse_args()
    shapes = args.shapes or (["128x196", "512x196"] if args.kernel == "cluster"
                             else ["32x1024", "128x1024"])
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    from distribuuuu_tpu_torch.ops import _build
    from distribuuuu_tpu_torch.ops import attention as att

    src = (_build.CSRC / "attention.cu").read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        (Path(tmp) / "attention.cu").write_text(stamped_source(src, args.kernel))
        _build.CSRC = Path(tmp)  # the wrapper now loads the stamped copy
        lib = att._library()
    lib.dtpu_set_trace.argtypes = [ctypes.c_void_p]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in shapes:
        bn, l = (int(v) for v in shape.split("x"))
        route = att.backward_route(torch.bfloat16, l)
        if route != ("cluster" if args.kernel == "cluster" else "blockwise"):
            sys.exit(f"L {l} takes the {route} route, not the {args.kernel} kernel")
        if args.kernel == "kv" and 1 + 6 * -(-l // 64) >= KV_SLOTS:
            sys.exit(f"L {l}: more query tiles than the trace has slots for")
        q, k, v, g = (torch.randn(bn, 1, l, 128, generator=gen, device="cuda").bfloat16()
                      for _ in range(4))
        bias = torch.randn(bn, 1, l, l, generator=gen, device="cuda").bfloat16()
        if args.kernel == "cluster":
            buf = torch.zeros(bn * -(-l // 64) * 64, dtype=torch.int64, device="cuda")
        else:
            buf = torch.zeros(bn * -(-l // 64) * KV_WARPS * KV_SLOTS, dtype=torch.int64,
                              device="cuda")

        def call():
            att.fused_attention_backward(q, k, v, bias, g)

        for _ in range(3):
            call()
        us_off = kv_us(call) if args.kernel == "kv" else 0.0
        lib.dtpu_set_trace(buf.data_ptr())
        us_on = kv_us(call) if args.kernel == "kv" else 0.0
        call()  # the stamps read: this call's
        torch.cuda.synchronize()
        lib.dtpu_set_trace(None)
        if args.kernel == "cluster":
            show_cluster(buf.view(-1, 64).cpu().double() / 1e3, bn, l, lib)  # us
        else:
            show_kv(buf.view(-1, KV_SLOTS).cpu().double() / 1e3, bn, l, us_off, us_on)


if __name__ == "__main__":
    main()
