#!/usr/bin/env python3
"""Per-phase device times of the PyTorch port's attention backward on its
cluster route (``attention_bwd_cluster_kernel``, bf16, L <= 256).

    python3 scripts/torch_attention_bwd_phases.py                # B*N 128 and 512, L 196
    python3 scripts/torch_attention_bwd_phases.py --shapes 128x256 32x70

Copies ``distribuuuu_tpu_torch/ops/csrc/attention.cu`` into the git-ignored
build directory with a ``%globaltimer`` stamp (thread 0 of each CTA) at each
phase boundary of the cluster kernel, builds that copy and runs one bf16
bias-mode backward a shape through the port's wrapper, after three unstamped
calls. Prints the kernel's span, the median CTA life and, per query tile, the
median over CTAs of each phase: the S/dP phase, the first cluster barrier, the
statistics' combine, p and ds, the products, the second cluster barrier, and
the dQ sum with the wait for the next tile; then the resident clusters
(``cudaOccupancyMaxActiveClusters``). The stamps resolve what the card's timer
does (a few hundred ns on an H100), and thread 0 reads the CTA's time. Needs
a CUDA GPU; imports no JAX.
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


def stamped_source(src: str) -> str:
    """The kernel source with the stamps, and an entry point that sets the
    trace buffer; fails if a phase boundary is no longer where it was."""
    src = src.replace("namespace {\n", "namespace {\n" + STAMP, 1)
    k0 = src.index("attention_bwd_cluster_kernel(const BwdParams p, const BwdWidths w) {")
    k1 = src.index("// demb = sum over B*N")
    body = src[k0:k1]
    for old, new in MARKS:
        if old not in body:
            sys.exit(f"phase boundary not found in the cluster kernel: {old!r}")
        body = body.replace(old, new, 1)
    return (src[:k0] + body + src[k1:] + '\nextern "C" int dtpu_set_trace(void* buf) {\n'
            "  return (int)cudaMemcpyToSymbol(g_trace, &buf, sizeof(buf));\n}\n")


def main() -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="+", default=["128x196", "512x196"],
                    help="B*NxL, bf16 q/k/v/g and bias, D = Dv = 128")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    from distribuuuu_tpu_torch.ops import _build
    from distribuuuu_tpu_torch.ops import attention as att

    src = (_build.CSRC / "attention.cu").read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        (Path(tmp) / "attention.cu").write_text(stamped_source(src))
        _build.CSRC = Path(tmp)  # the wrapper now loads the stamped copy
        lib = att._library()
    lib.dtpu_set_trace.argtypes = [ctypes.c_void_p]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in args.shapes:
        bn, l = (int(v) for v in shape.split("x"))
        if l > att.CLUSTER_MAX_L:
            sys.exit(f"L {l} takes the two-pass route, not the cluster kernel")
        q, k, v, g = (torch.randn(bn, 1, l, 128, generator=gen, device="cuda").bfloat16()
                      for _ in range(4))
        bias = torch.randn(bn, 1, l, l, generator=gen, device="cuda").bfloat16()
        nk = -(-l // 64)
        buf = torch.zeros(bn * nk * 64, dtype=torch.int64, device="cuda")
        for _ in range(3):
            att.fused_attention_backward(q, k, v, bias, g)
        lib.dtpu_set_trace(buf.data_ptr())
        att.fused_attention_backward(q, k, v, bias, g)
        torch.cuda.synchronize()
        lib.dtpu_set_trace(None)
        t = buf.view(bn * nk, 64).cpu().double() / 1e3  # us

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


if __name__ == "__main__":
    main()
