#!/usr/bin/env python3
"""[train-fsdp]'s in-process determinism check, repeated after other CUDA work.

    python3 scripts/torch_determinism_repro.py [--deterministic] [--runs N]
        [--prior build,k1,k1bwd,attention,serve,moe,f32] [--out DIR]

In one process on the card: the in-process phases of ``chip_smoke.py`` that
come before [train-fsdp] (``--prior``, in the order given: the kernels'
build, [k1], [k1-bwd], [attention] and [attention-bwd], [serve] of ResNet-50
with the large crop and [mhsa table], [moe-kernels] and [moe-dist], the f32
card-vs-CPU training steps of [train] and [train-bot]), each allowed to fail
(its error is reported), then ``--runs`` runs of two ViT-L/16 steps as
``chip_smoke.fsdp_two_steps`` takes them (``config/vit_l16.yaml``, batch 8,
cuDNN deterministic, seeded weights and batches). Each run records a digest
of every module's output in both steps' forwards and of every parameter's
gradient after each step, so a run that parts from the first names the
first module (in call order) and the first gradient (in backward order)
that differ: the op that varies.

``--deterministic`` calls ``configure_determinism(True, False)`` before any
CUDA work (``torch.use_deterministic_algorithms`` and
``CUBLAS_WORKSPACE_CONFIG``); without it the process runs as the smoke ran
before that repair, with cuDNN's two flags set before each run.

Prints one JSON line; ``--out`` also writes it to ``DIR/determinism_*.json``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def digest(t) -> str:
    import torch

    t = t.detach()
    if t.is_floating_point() and t.dtype != torch.float32:
        t = t.float()
    return hashlib.sha1(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def two_steps_traced(mesh: str, deterministic: bool) -> dict:
    """``chip_smoke.fsdp_two_steps`` with digests of every module output and
    parameter gradient, step by step."""
    import torch

    import chip_smoke
    from distribuuuu_tpu_torch.config import cfg, load_cfg_fom_args, reset_cfg
    from distribuuuu_tpu_torch.runtime.mesh import data_mesh
    from distribuuuu_tpu_torch.trainer import TrainState, build_cfg_model, train_step

    reset_cfg()
    load_cfg_fom_args(argv=["--cfg", str(ROOT / chip_smoke.FSDP_CFG), "MESH.FSDP", mesh])
    if not deterministic:  # cuDNN's two flags alone, as the port set them before
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    model = build_cfg_model(torch.Generator().manual_seed(0)).to("cuda")
    st = TrainState(model, None, data_mesh(cfg.MESH.DATA, cfg.MESH.FSDP, 1, 0),
                    cfg.MESH.FSDP_MIN_SIZE)
    outputs: list = []
    hooks = [m.register_forward_hook(
        lambda m, i, o, name=name: outputs.append(
            (name, digest(o if torch.is_tensor(o) else o[0]))))
        for name, m in model.named_modules() if not list(m.children())]
    gen = torch.Generator().manual_seed(1)
    steps = []
    for k in range(2):
        outputs.clear()
        batch = {"image": torch.randint(0, 256, (8, chip_smoke.IM, chip_smoke.IM, 3),
                                        dtype=torch.uint8, generator=gen).cuda(),
                 "label": torch.randint(0, 1000, (8,), generator=gen).cuda()}
        m = train_step(st, batch, 2e-4, dropout_key=(0, 0, k, 0))
        grads = {n: digest(p.grad) for n, p in model.named_parameters()}
        steps.append({"loss": m["loss_sum"], "outputs": list(outputs), "grads": grads})
    for h in hooks:
        h.remove()
    for s, loss in zip(steps, torch.stack([s["loss"] for s in steps]).cpu().tolist()):
        s["loss"] = loss / 8
    params = digest(st.params)
    reset_cfg()
    del st, model
    torch.cuda.empty_cache()
    return {"steps": steps, "params": params,
            "deterministic_algorithms": torch.are_deterministic_algorithms_enabled()}


def first_difference(a: dict, b: dict) -> dict:
    """Where run ``b`` parts from run ``a``: per step, the first module
    output (forward order) and the first gradient (backward order)."""
    out = {"params_equal": a["params"] == b["params"], "steps": []}
    for sa, sb in zip(a["steps"], b["steps"]):
        fwd = next((na for (na, da), (_, db) in zip(sa["outputs"], sb["outputs"]) if da != db),
                   None)
        names = list(sa["grads"])[::-1]
        grads = [n for n in names if sa["grads"][n] != sb["grads"][n]]
        out["steps"].append({"loss": [sa["loss"], sb["loss"]], "first_output": fwd,
                             "first_grad": grads[0] if grads else None,
                             "grads_differing": len(grads)})
    return out


def prior_work(names: list, card: str) -> dict:
    """The smoke's in-process phases before [train-fsdp], each allowed to fail."""
    import torch

    import chip_smoke as cs

    done = {}
    for name in names:
        tic = time.perf_counter()
        try:
            if name == "build":
                cs.phase_build()
            elif name == "k1":
                sites = {arch: cs.epilogue_sites(arch, cs.LADDER_BATCH) for arch in cs.SERVED}
                cs.phase_k1(card, sites)
            elif name == "attention":
                cs.phase_attention(card)
                cs.phase_attention_bwd(card)
            elif name == "k1bwd":
                cs.phase_k1_bwd(card, cs.epilogue_sites("resnet50", cs.LADDER_BATCH,
                                                        bn_dtype=torch.bfloat16),
                                cs.epilogue_sites("resnet50", cs.LADDER_BATCH))
            elif name == "serve":
                bw = cs.hbm_bytes_per_s(card)
                by_b = {b: cs.epilogue_sites("resnet50", b) for b in (1, cs.LADDER_BATCH)}
                bound = {b: 1e3 * sum(cs.k1_bound(s, bw)[0] * m for s, m in c.items())
                         for b, c in by_b.items()}
                with tempfile.TemporaryDirectory() as tmp:
                    cs.phase_serve(card, Path(tmp), "resnet50", bound)
                    cs.phase_large_crop(card, Path(tmp))
                cs.phase_mhsa_table()
            elif name == "moe":
                cs.phase_moe_kernels(card)
                with tempfile.TemporaryDirectory() as tmp:
                    cs.phase_moe_dist(Path(tmp))
            elif name == "f32":
                cs.train_f32_check()
                cs.train_f32_botnet_check()
            else:
                raise ValueError(f"unknown prior phase {name!r}")
            done[name] = {"ok": True}
        except (Exception, SystemExit) as e:  # chip_smoke.fail exits: a reading here
            done[name] = {"ok": False, "error": f"{type(e).__name__}: {e}",
                          "trace": traceback.format_exc()[-1500:]}
        done[name]["wall_s"] = round(time.perf_counter() - tic, 1)
        torch.cuda.synchronize()
    return done


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--runs", type=int, default=4)
    p.add_argument("--prior", default="build,k1,attention,serve")
    p.add_argument("--out", default="")
    a = p.parse_args()
    if a.deterministic:  # before any CUDA work in this process
        from distribuuuu_tpu_torch.runtime.seeding import configure_determinism

        configure_determinism(True, False)
    import subprocess

    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    card = torch.cuda.get_device_name(0)
    torch.backends.cudnn.allow_tf32 = False  # as chip_smoke.main
    torch.backends.cuda.matmul.allow_tf32 = False
    prior = prior_work([n for n in a.prior.split(",") if n], card)
    runs, errors = [], []
    for i in range(a.runs):
        try:
            runs.append(two_steps_traced("-1" if i % 2 == 0 else "1", a.deterministic))
        except (Exception, SystemExit) as e:  # chip_smoke.fail exits: a reading here
            errors.append(f"run {i}: {type(e).__name__}: {e}\n{traceback.format_exc()[-1500:]}")
            break
    diffs = [first_difference(runs[0], r) for r in runs[1:]]
    res = {"card": smi, "deterministic": a.deterministic, "prior": prior,
           "losses": [[s["loss"] for s in r["steps"]] for r in runs],
           "all_equal": all(d["params_equal"] and all(s["first_output"] is None and
                                                     s["first_grad"] is None
                                                     for s in d["steps"]) for d in diffs),
           "differences": diffs, "errors": errors}
    line = json.dumps(res)
    print(line, flush=True)
    if a.out:
        out = Path(a.out)
        out.mkdir(parents=True, exist_ok=True)
        tag = "deterministic" if a.deterministic else "as_before"
        (out / f"determinism_{tag}.json").write_text(line)


if __name__ == "__main__":
    main()
