"""Serving path of the PyTorch port (distribuuuu_tpu_torch/serve/).

- A port ServeReplica on resnet18 (im 32, 8 classes, ladder [1, 4, 8],
  float32, CPU) answers concurrent ``handle`` requests with the logits of
  the JAX serving forward as ``serve/engine.py`` composes it
  (``device_normalize`` -> ``model.apply(train=False)`` -> f32), on the same
  weights, within ``1e-4 * max(1, max|logit|)``.
- The engine refuses non-ladder batches and wrong dtypes.
- ``config/serve_resnet50.yaml`` merges into the port's cfg.
- Without a card, the entry points raise instead of running on the CPU.
- No module of the port, and not chip_smoke.py, imports JAX or the JAX package.
"""

import ast
import threading
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from distribuuuu_tpu.data.transforms import device_normalize as jax_device_normalize
from distribuuuu_tpu.convert import export_state_dict
from distribuuuu_tpu.models import build_model as jax_build_model
from distribuuuu_tpu_torch import config as port_config
from distribuuuu_tpu_torch.convert import load_weights
from distribuuuu_tpu_torch.serve.batcher import MicroBatcher, QueueFullError
from distribuuuu_tpu_torch.serve.engine import InferenceEngine, ModelSpec, parse_model_specs
from distribuuuu_tpu_torch.serve.frontend import BadRequest, ServeReplica, serve_main
from test_torch_resnet import perturbed_variables

# the suite runs several test workers on one host: keep torch's intra-op
# pool small so these CPU forwards do not starve the timing-sensitive tests
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
IM, CLASSES, LADDER = 32, 8, [1, 4, 8]


@pytest.fixture()
def port_cfg():
    port_config.reset_cfg()
    yield port_config.cfg
    port_config.reset_cfg()


@pytest.fixture(scope="module")
def rn18(tmp_path_factory):
    v = perturbed_variables("resnet18", 5, im=IM, classes=CLASSES)
    path = tmp_path_factory.mktemp("w") / "rn18.pt"
    torch.save({k: torch.from_numpy(np.ascontiguousarray(a))
                for k, a in export_state_dict(v, "resnet18").items()}, path)
    return v, str(path)


def _replica(cfg, weights):
    cfg.merge_from_list([
        "SERVE.MODELS", f"['rn18=resnet18@{weights}']", "SERVE.BATCH_SIZES", str(LADDER),
        "SERVE.IM_SIZE", str(IM), "MODEL.NUM_CLASSES", str(CLASSES), "MODEL.DTYPE", "float32",
        "SERVE.MAX_QUEUE_DELAY_MS", "20.0",
    ])
    return ServeReplica(parse_model_specs(list(cfg.SERVE.MODELS)), device="cpu")


def test_served_logits_match_jax_serving_forward(port_cfg, rn18):
    variables, weights = rn18
    replica = _replica(port_cfg, weights)
    try:
        rng = np.random.default_rng(0)
        reqs = [rng.integers(0, 256, size=(n, IM, IM, 3), dtype=np.uint8) for n in (1, 3, 2, 8)]
        out = [None] * len(reqs)

        def client(i):
            out[i] = replica.handle({"model": "rn18", "inputs": reqs[i].tolist()})

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        model = jax_build_model("resnet18", num_classes=CLASSES, dtype=jnp.float32)
        for imgs, resp in zip(reqs, out):
            ref = np.asarray(model.apply(variables, jax_device_normalize(jnp.asarray(imgs)),
                                         train=False).astype(jnp.float32))
            got = np.asarray(resp["logits"], np.float32)
            assert got.shape == (len(imgs), CLASSES)
            assert resp["batch_size"] in LADDER and resp["batch_size"] >= len(imgs)
            assert float(np.abs(got - ref).max()) <= 1e-4 * max(1.0, float(np.abs(ref).max()))
        # a request's rows are the direct forward of its images at its ladder size
        imgs, resp = reqs[1], out[1]
        padded = np.zeros((resp["batch_size"], IM, IM, 3), np.uint8)
        padded[:3] = imgs
        assert np.array_equal(replica.engine.forward("rn18", padded)[:3],
                              np.asarray(resp["logits"], np.float32))
        with pytest.raises(BadRequest):
            replica.handle({"model": "nope", "inputs": reqs[0].tolist()})
        with pytest.raises(BadRequest):
            replica.handle({"model": "rn18", "inputs": (reqs[0] / 255.0).tolist()})
    finally:
        replica.shutdown()


def test_engine_refuses_off_ladder_and_wrong_dtype(rn18):
    _, weights = rn18
    engine = InferenceEngine(batch_sizes=LADDER, im_size=IM, num_classes=CLASSES,
                             compute_dtype="float32", device="cpu")
    engine.load(ModelSpec("rn18", "resnet18", weights))
    assert engine.forward("rn18", np.zeros((4, IM, IM, 3), np.uint8)).dtype == np.float32
    with pytest.raises(ValueError, match="ladder"):
        engine.forward("rn18", np.zeros((3, IM, IM, 3), np.uint8))
    with pytest.raises(ValueError, match="dtype"):
        engine.forward("rn18", np.zeros((4, IM, IM, 3), np.float32))
    with pytest.raises(KeyError):
        engine.forward("missing", np.zeros((1, IM, IM, 3), np.uint8))
    # an ':int8' spec hosts the quantized model (tests/test_torch_quant.py
    # holds it against JAX); its forward keeps the same contract
    engine.quant_cfg.update(gate=False, calib_batches=1, gate_n=4)
    assert engine.load(ModelSpec("q", "resnet18", weights, quant="int8")).spec.quant == "int8"
    assert engine.forward("q", np.zeros((4, IM, IM, 3), np.uint8)).shape == (4, CLASSES)
    with pytest.raises(ValueError, match="ladder"):
        engine.forward("q", np.zeros((3, IM, IM, 3), np.uint8))
    # staging a version keeps the ladder contract on its canary route
    # (tests/test_torch_deploy.py holds the rollout)
    engine.stage("rn18", weights)
    with pytest.raises(ValueError, match="ladder"):
        engine.forward("rn18", np.zeros((3, IM, IM, 3), np.uint8), version="canary")
    with pytest.raises(ValueError, match="already has a staged version"):
        engine.stage("rn18", weights)


def test_load_weights_on_a_directory_names_the_export_route(tmp_path):
    """The shipped serve YAML names an Orbax directory (``rn50=resnet50@./w_rn50``),
    which the port cannot read without JAX: load_weights, and an engine whose
    spec points at a directory, raise a message that names the export route."""
    orbax = tmp_path / "w_rn50"
    orbax.mkdir()
    (orbax / "checkpoint").write_bytes(b"")
    with pytest.raises(ValueError, match="export_state_dict.*torch.save"):
        load_weights(str(orbax))
    engine = InferenceEngine(batch_sizes=LADDER, im_size=IM, num_classes=CLASSES,
                             compute_dtype="float32", device="cpu")
    with pytest.raises(ValueError, match="is a directory"):
        engine.load(ModelSpec("rn50", "resnet18", str(orbax)))
    assert not engine.models


def test_spec_parsing_and_batcher_shed():
    specs = parse_model_specs(["a=resnet50@gs://b/w.pt:int8", "b=resnet18@/w/r.pt"])
    assert specs[0] == ModelSpec("a", "resnet50", "gs://b/w.pt", "int8")
    with pytest.raises(ValueError):
        parse_model_specs(["resnet50"])
    with pytest.raises(ValueError, match="duplicate"):
        parse_model_specs(["a=resnet18@x", "a=resnet18@y"])
    entered, release = threading.Event(), threading.Event()

    def runner(model, batch):
        entered.set()
        release.wait(10)
        return np.zeros((batch.shape[0], 2), np.float32)

    b = MicroBatcher(runner, {"m": [1, 4]}, max_delay_ms=1.0, max_depth=4).start()
    try:
        first = threading.Thread(target=b.submit, args=("m", np.zeros((4, 1))))
        first.start()
        assert entered.wait(10)  # the first batch is out of the queue, running
        second = threading.Thread(target=b.submit, args=("m", np.zeros((3, 1))))
        second.start()
        for _ in range(500):
            if b.queue_depth("m") == 3:
                break
            threading.Event().wait(0.01)
        assert b.queue_depth("m") == 3
        with pytest.raises(QueueFullError):
            b.submit("m", np.zeros((2, 1)))
        release.set()
        first.join(10)
        second.join(10)
        assert not first.is_alive() and not second.is_alive()
    finally:
        b.stop()


def test_serve_yaml_merges(port_cfg):
    port_cfg.merge_from_file(str(REPO / "config" / "serve_resnet50.yaml"))
    assert port_cfg.MODEL.ARCH == "resnet50" and port_cfg.MODEL.DTYPE == "bfloat16"
    assert list(port_cfg.SERVE.BATCH_SIZES) == [1, 8, 32, 128]
    assert port_cfg.SERVE.INPUT_DTYPE == "uint8" and port_cfg.SERVE.IM_SIZE == 224
    assert port_cfg.AGENT.SERVE is True


def test_no_cpu_fallback_without_a_card(monkeypatch, port_cfg, rn18, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(batch_sizes=[1], im_size=IM, num_classes=CLASSES, device=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_main(["SERVE.MODELS", f"['rn18=resnet18@{rn18[1]}']", "SERVE.MODE", "stdin",
                    "OUT_DIR", str(tmp_path)])


_FORBIDDEN_ROOTS = {"jax", "jaxlib", "flax", "optax", "orbax", "distribuuuu_tpu"}


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted((REPO / "distribuuuu_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    live_plane = {f"distribuuuu_tpu_torch/{m}.py" for m in (
        "obs/stream", "obs/alarms", "obs/exporter", "obs/journal", "obs/trace", "obs/__main__",
        "obs/summarize", "serve/batcher", "serve/engine", "serve/frontend", "dataplane/service",
        "dataplane/dispatcher", "dataplane/client", "dataplane/__main__")}
    quant = {f"distribuuuu_tpu_torch/quant/{m}.py" for m in ("__init__", "ptq", "gate")}
    assert live_plane | quant <= {str(f.relative_to(REPO)) for f in files}
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names if n.split(".")[0] in _FORBIDDEN_ROOTS]
    assert bad == []
