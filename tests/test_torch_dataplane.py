"""The port's dataplane against the JAX package's, on the CPU.

Two classes of 16 JPEGs (40x50) written from a numpy seed. Every stream
comparison is bitwise:

- ``LeaseTable`` and ``BatchCache``, one parametrised test each;
- the oracle: an in-process service's stream equals the port's local
  ``HostDataLoader`` and JAX's over 2 epochs x 2 ranks, train and eval
  (weight-0 padding), on PIL and, where both packages build it, the native
  decoder; a resume at ``start_batch`` decodes only the batches after it;
- wire parity: the port's ``ServiceLoader`` reads a JAX service, and the
  port's ``recv_msg`` reads JAX's ``send_msg`` frames (into tensors too);
- failures: a worker that drops its lease has it re-issued; a dead
  dispatcher falls back at the exact next batch (``DATA.FALLBACK``) or
  fails the stream; a fingerprint mismatch fails loudly; a SIGKILLed worker
  process loses no sample;
- ``train_model(device="cpu")`` fed by the service equals local-fed
  training bitwise over 2 epochs;
- ``resilience.retry``'s backoff, re-raise and ``FAULT.RETRY_*`` defaults,
  and the derived dataplane port equal to JAX's.

Every socket has a timeout, every service is stopped in a ``finally``.
"""

import os
import shutil
import signal
import socket
import time

import numpy as np
import pytest
import torch
from PIL import Image

from distribuuuu_tpu.data import dataset as jax_dataset
from distribuuuu_tpu.data import loader as jax_loader
from distribuuuu_tpu.data import native as jax_native
from distribuuuu_tpu.dataplane import protocol as jax_protocol
from distribuuuu_tpu.dataplane.service import DataPlaneService as JaxService
from distribuuuu_tpu.runtime import dist as jax_dist
from distribuuuu_tpu_torch import resilience
from distribuuuu_tpu_torch.config import cfg, load_cfg_fom_args, reset_cfg
from distribuuuu_tpu_torch.data import dataset, loader, native
from distribuuuu_tpu_torch.dataplane import protocol
from distribuuuu_tpu_torch.dataplane.client import ServiceLoader
from distribuuuu_tpu_torch.dataplane.dispatcher import BatchCache, Dispatcher, LeaseTable
from distribuuuu_tpu_torch.dataplane.protocol import StreamSpec
from distribuuuu_tpu_torch.dataplane.service import DataPlaneService
from distribuuuu_tpu_torch.dataplane.worker import _SpecLoaders
from distribuuuu_tpu_torch.runtime import dist

torch.set_num_threads(2)  # the suite runs several test workers on one host

KW = dict(host_batch=4, train=True, im_size=32, process_index=0, process_count=1, seed=3,
          crop_size=32)


@pytest.fixture(scope="module")
def image_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_images")
    rng = np.random.default_rng(0)
    for c in range(2):
        (root / f"class_{c}").mkdir()
        for i in range(16):
            Image.fromarray(rng.integers(0, 255, (40, 50, 3), np.uint8)).save(
                root / f"class_{c}" / f"i{i:02d}.jpg", quality=85)
    return str(root)


@pytest.fixture(autouse=True)
def _cfg(monkeypatch):
    monkeypatch.delenv("DTPU_DATA_SERVICE", raising=False)
    reset_cfg()
    yield
    reset_cfg()


@pytest.fixture(params=["pil", "native"])
def backend(request, monkeypatch):
    """Both packages on one decoder: PIL (the native one switched off) or,
    where both build it, native."""
    if request.param == "pil":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jax_native, "available", lambda: False)
    elif not (native.available() and jax_native.available()):
        pytest.skip(f"the native decoder does not build here: {native.unavailable_reason()}")
    return request.param


@pytest.fixture()
def service():
    svc = DataPlaneService(workers=2, worker_threads=2, in_process=True).start()
    try:
        yield svc
    finally:
        svc.stop()


def _local(root, **over):
    return loader.HostDataLoader(dataset.ImageFolder(root), workers=2, **{**KW, **over})


def _remote(address, root, **over):
    return ServiceLoader(address, root=root, workers=2, **{**KW, **over})


def _assert_streams_equal(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        for key in ("image", "label", "weight"):
            x_k, y_k = (np.asarray(v[key]) for v in (x, y))
            assert x_k.dtype == y_k.dtype and np.array_equal(x_k, y_k), key


# -- units ---------------------------------------------------------------------

def _claim_order(t):
    assert t.claim(range(4), "w1", now=0.0) == 0
    assert t.claim(range(4), "w2", now=0.0) == 1  # 0 is held by w1
    assert t.complete("w1", 0) is True and t.complete("w1", 0) is False  # a duplicate: dropped
    assert t.done(0) and not t.done(1) and t.claim(range(4), "w1", now=0.0) == 2


def _expiry(t):
    assert t.claim(range(2), "w1", now=0.0) == 0
    assert t.claim([0], "w2", now=5.0) is None  # held until its deadline
    assert t.claim([0], "w2", now=11.0) == 0 and t.reissues == 1
    assert t.complete("w1", 0) is True and t.complete("w2", 0) is False  # one copy lands


def _fail_worker(t):
    assert [t.claim(range(4), "w1", now=0.0) for _ in range(2)] == [0, 1]
    assert t.fail_worker("w1") == [0, 1] and t.reissues == 2
    assert t.claim(range(4), "w2", now=0.0) == 0  # without waiting out the timeout


def _reopen(t):
    assert t.claim(range(2), "w1", now=0.0) == 0 and t.complete("w1", 0)
    t.reopen(0)  # delivered and evicted before a lagging client got it
    assert not t.done(0) and t.claim(range(2), "w2", now=0.0) == 0 and t.complete("w2", 0)


def _poison(t):
    for _ in range(2):
        assert t.claim(range(4), "w1", now=0.0) == 0 and t.fail("w1", 0) is True
    assert t.claim(range(4), "w1", now=0.0) == 0 and t.fail("w1", 0) is False


@pytest.mark.parametrize("case", [_claim_order, _expiry, _fail_worker, _reopen, _poison],
                         ids=lambda f: f.__name__.strip("_"))
def test_lease_table(case):
    case(LeaseTable(lease_timeout_s=10.0))


def _lru(c):
    for k in "abc":
        c.put((k,), {"image": np.zeros(100, np.uint8)})
    assert c.get(("a",)) is not None  # a is now the most recent
    c.put(("d",), {"image": np.zeros(100, np.uint8)})  # evicts b, not a
    assert c.get(("b",)) is None and c.get(("a",)) is not None
    assert c.evictions == 1 and c.bytes == 300 and len(c) == 3


def _reput(c):
    c.put(("a",), {"image": np.zeros(100, np.uint8)})
    c.put(("a",), {"image": np.zeros(100, np.uint8)})  # counted once
    assert c.bytes == 100 and len(c) == 1


def _oversize(c):
    c.put(("a",), {"image": np.zeros(500, np.uint8)})  # the newest entry always stays
    assert len(c) == 1 and c.bytes == 500
    c.put(("b",), {"image": np.zeros(10, np.uint8)})
    assert c.get(("a",)) is None and c.stats()["evictions"] == 1


@pytest.mark.parametrize("case", [_lru, _reput, _oversize], ids=lambda f: f.__name__.strip("_"))
def test_batch_cache(case):
    case(BatchCache(max_bytes=300))


def test_stream_spec_fingerprint_and_derived_port_equal_jax(image_root):
    base = dict(root=image_root, train=True, seed=3, epoch=1, im_size=32, crop_size=32,
                host_batch=4, process_index=0, process_count=1, start_batch=0,
                fingerprint="pil:train32")
    spec = StreamSpec(**base)
    assert spec.cache_key(2) == StreamSpec(**{**base, "start_batch": 2}).cache_key(2)
    assert spec.cache_key(2) != StreamSpec(**{**base, "epoch": 2}).cache_key(2)
    assert StreamSpec.from_dict(spec.to_dict()) == spec
    assert spec.cache_key(2) == jax_protocol.StreamSpec(**base).cache_key(2)
    for train, im, crop in ((True, 224, 224), (False, 256, 224)):
        assert loader.transform_fingerprint(train=train, im_size=im, crop_size=crop) == \
            jax_loader.transform_fingerprint(train=train, im_size=im, crop_size=crop)
    assert loader.transform_fingerprint(train=False, im_size=256, crop_size=224).endswith(
        ":eval256c224")
    for job in ("job-x", "/abs/out_dir"):
        assert dist.derive_dataplane_port(job) == jax_dist.derive_dataplane_port(job)
        assert dist.derive_rendezvous_port(job) == jax_dist.derive_rendezvous_port(job)


def test_recv_msg_reads_jax_frames_into_numpy_and_into_tensors():
    arrays = {"image": np.arange(24, dtype=np.uint8).reshape(2, 3, 4),
              "weight": np.array([0.5, 1.0], np.float32)}
    a, b = socket.socketpair()
    a.settimeout(10.0)
    b.settimeout(10.0)
    fa, fb = a.makefile("rwb"), b.makefile("rwb")
    try:
        for alloc in (None, lambda key, dtype, shape: torch.empty(
                shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype)):
            jax_protocol.send_msg(fa, {"op": "done", "batch": 7}, arrays=arrays)
            msg, got = protocol.recv_msg(fb, alloc)
            assert msg == {"op": "done", "batch": 7}
            for key, want in arrays.items():
                assert isinstance(got[key], torch.Tensor) == (alloc is not None)
                assert np.array_equal(np.asarray(got[key]), want)
                assert np.asarray(got[key]).dtype == want.dtype
        protocol.send_msg(fa, {"op": "x"}, arrays={"t": torch.arange(3, dtype=torch.int32)})
        msg, got = jax_protocol.recv_msg(fb)  # and JAX reads the port's
        assert msg == {"op": "x"} and got["t"].tolist() == [0, 1, 2]
        fa.close()
        a.close()
        with pytest.raises(EOFError):
            protocol.recv_msg(fb)
    finally:
        for h in (fa, fb, a, b):
            h.close()


# -- the oracle ----------------------------------------------------------------

@pytest.mark.parametrize("train", [True, False])
def test_service_stream_bitwise_local_and_jax(image_root, service, backend, train):
    over = {} if train else dict(train=False, host_batch=5, im_size=40)
    for rank in range(2):
        kw = dict(over, process_index=rank, process_count=2)
        local, remote = _local(image_root, **kw), _remote(service.address, image_root,
                                                          fallback=False, **kw)
        theirs = jax_loader.HostDataLoader(jax_dataset.ImageFolder(image_root), workers=2,
                                           **{**KW, **kw})
        assert remote.decoder == local.decoder == backend
        assert len(local) == len(remote) == len(theirs) == 4
        for epoch in range(2):
            for ld in (local, remote, theirs):
                ld.set_epoch(epoch)
            got = list(remote)
            _assert_streams_equal(list(local), got)
            _assert_streams_equal([theirs.decode_batch(b) for b in range(len(theirs))], got)
            if not train:  # the padded tail: zero images of weight 0
                pad = got[-1]["weight"].numpy() == 0
                assert pad.sum() == 4 and not got[-1]["image"].numpy()[pad].any()
    assert service.dispatcher.stats()["reissues"] == 0


def test_resume_decodes_only_the_batches_after_start(image_root, service):
    local = _local(image_root)
    local.set_epoch(1)
    full = list(local)
    remote = _remote(service.address, image_root, fallback=False)
    remote.set_epoch(1, start_batch=3)
    _assert_streams_equal(full[3:], remote)
    assert service.dispatcher.stats()["misses"] == len(full) - 3
    second = _remote(service.address, image_root, fallback=False)  # decode-once: all cached
    second.set_epoch(1, start_batch=3)
    _assert_streams_equal(full[3:], second)
    assert service.dispatcher.stats()["misses"] == len(full) - 3


def test_port_client_reads_a_jax_service_bitwise(image_root, monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(jax_native, "available", lambda: False)
    svc = JaxService(workers=2, worker_threads=2, in_process=True).start()
    try:
        remote = _remote(svc.address, image_root, fallback=False)
        local = _local(image_root)
        for epoch in range(2):
            remote.set_epoch(epoch)
            local.set_epoch(epoch)
            _assert_streams_equal(local, remote)
    finally:
        svc.stop()


# -- failures ------------------------------------------------------------------

def _conn(disp, first: dict):
    sock, f = protocol.connect(disp.address, timeout_s=10.0)
    protocol.send_msg(f, first)
    reply, _ = protocol.recv_msg(f)
    assert reply["ok"], reply
    return sock, f


def test_worker_disconnect_reissues_its_lease(image_root):
    disp = Dispatcher()
    spec = StreamSpec(root=image_root, train=True, seed=99, epoch=0, im_size=32, crop_size=32,
                      host_batch=4, process_index=0, process_count=1, start_batch=0,
                      fingerprint="pil:train32")
    handles = []
    try:
        handles += _conn(disp, {"op": "register_stream", "spec": spec.to_dict()})

        def lease(f):
            protocol.send_msg(f, {"op": "lease"})
            return protocol.recv_msg(f)[0]

        s1, f1 = _conn(disp, {"op": "register_worker", "worker": "victim"})
        assert lease(f1)["batch"] == 0
        f1.close()  # the connection drops with the lease held
        s1.close()
        deadline = time.monotonic() + 10.0
        while disp.stats()["reissues"] < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert disp.stats()["reissues"] == 1
        s2, f2 = _conn(disp, {"op": "register_worker", "worker": "survivor"})
        handles += [f2, s2]
        got = lease(f2)
        assert got["batch"] == 0  # the same batch, and its completion lands once
        arrays = {"image": np.zeros((4, 32, 32, 3), np.uint8),
                  "label": np.zeros(4, np.int32), "weight": np.ones(4, np.float32)}
        protocol.send_msg(f2, {"op": "done", "stream": got["stream"], "batch": 0}, arrays=arrays)
        assert protocol.recv_msg(f2)[0]["accepted"] is True
    finally:
        for h in handles:
            h.close()
        disp.close()


@pytest.mark.parametrize("fallback", [True, False])
def test_dead_dispatcher_falls_back_at_the_next_batch_or_raises(image_root, fallback):
    cfg.FAULT.RETRY_BASE_DELAY, cfg.FAULT.RETRY_MAX_DELAY = 0.01, 0.02
    local = _local(image_root)
    local.set_epoch(0)
    expected = list(local)
    svc = DataPlaneService(workers=1, worker_threads=2, in_process=True).start()
    try:
        remote = _remote(svc.address, image_root, fallback=fallback, prefetch_batches=1)
        remote.set_epoch(0)
        got = []
        if not fallback:
            with pytest.raises(RuntimeError) as exc:
                for batch in remote:
                    got.append(batch)
                    svc.stop()
            assert "DATA.FALLBACK is off" in str(exc.value.__cause__)
            return
        for batch in remote:
            got.append(batch)
            if len(got) == 1:  # batch 2 is requested only after the consumer took batch 1
                svc.stop()
        _assert_streams_equal(expected, got)
        assert remote.fallbacks == 1 and remote._local is not None
        # the next epoch probes the service again (still down: local once more)
        remote.set_epoch(1)
        local.set_epoch(1)
        _assert_streams_equal(local, remote)
    finally:
        svc.stop()


def test_fingerprint_mismatch_fails_loudly(image_root, service):
    spec = StreamSpec(root=image_root, train=True, seed=1, epoch=0, im_size=32, crop_size=32,
                      host_batch=4, process_index=0, process_count=1, start_batch=0,
                      fingerprint="native-from-another-box:train32")
    with pytest.raises(RuntimeError, match="fingerprint mismatch"):
        _SpecLoaders().loader_for(spec)
    remote = _remote(service.address, image_root, fallback=True)
    remote.fingerprint = spec.fingerprint
    with pytest.raises(RuntimeError) as exc:
        list(remote)
    assert "undecodable" in str(exc.value.__cause__) and "fingerprint mismatch" in str(
        exc.value.__cause__)
    assert remote.fallbacks == 0  # a poisoned batch is never hidden behind local decode


def test_sigkilled_worker_process_loses_no_sample(image_root):
    svc = DataPlaneService(workers=2, worker_threads=1).start()
    try:
        deadline = time.monotonic() + 60.0
        while len(svc.worker_pids()) < 2 and time.monotonic() < deadline:
            time.sleep(0.1)
        local = _local(image_root)
        local.set_epoch(0)
        remote = _remote(svc.address, image_root, fallback=False)
        remote.set_epoch(0)
        got = []
        for batch in remote:
            got.append(batch)
            if len(got) == 1:
                os.kill(svc.worker_pids()[0], signal.SIGKILL)
        _assert_streams_equal(local, got)
        deadline = time.monotonic() + 30.0
        while svc.restarts < 1 and time.monotonic() < deadline:
            time.sleep(0.1)
        assert svc.restarts == 1
    finally:
        svc.stop()
    assert not svc.worker_pids()


def test_train_model_service_fed_equals_local_fed_bitwise(image_root, tmp_path):
    from distribuuuu_tpu_torch.trainer import train_model

    root = tmp_path / "data"
    for split in ("train", "val"):
        shutil.copytree(image_root, root / split)

    def run(out, service):
        reset_cfg()
        load_cfg_fom_args(argv=[
            "--cfg", os.path.join(os.path.dirname(__file__), "..", "config", "resnet18.yaml"),
            "MODEL.NUM_CLASSES", "2", "MODEL.DTYPE", "float32", "TRAIN.IM_SIZE", "16",
            "TEST.IM_SIZE", "20", "TEST.CROP_SIZE", "16", "TRAIN.BATCH_SIZE", "8",
            "TEST.BATCH_SIZE", "12", "TRAIN.DATASET", str(root), "TRAIN.WORKERS", "2",
            "OPTIM.MAX_EPOCH", "2", "OPTIM.WARMUP_EPOCHS", "0", "RNG_SEED", "7",
            "OUT_DIR", str(out), "DATA.SERVICE", service, "DATA.FALLBACK", "False"])
        state, _ = train_model(device="cpu")
        return state.params.clone()

    svc = DataPlaneService(workers=2, worker_threads=2, in_process=True).start()
    try:
        fed = run(tmp_path / "svc", svc.address)
    finally:
        svc.stop()
    log = "".join(p.read_text() for p in (tmp_path / "svc").glob("*.log"))
    assert f"service {svc.address} (2 DATA.WORKERS x 2 threads)" in log
    assert log.count(f"input: service {svc.address}, 0 fallback(s)") == 4  # 2 epochs, 2 passes
    assert torch.equal(fed, run(tmp_path / "local", ""))


# -- resilience.retry ----------------------------------------------------------

def test_retry_backoff_bounds_reraise_and_config_defaults():
    calls, delays = [], []

    def flaky(n_fail):
        calls.append(1)
        if len(calls) <= n_fail:
            raise OSError(f"transient {len(calls)}")
        return "ok"

    assert resilience.retry(flaky, 2, sleep=delays.append) == "ok" and len(calls) == 3
    assert len(delays) == 2 and all(0 <= d <= 0.1 * 2 ** a for a, d in enumerate(delays))
    cfg.FAULT.RETRY_ATTEMPTS, cfg.FAULT.RETRY_BASE_DELAY, cfg.FAULT.RETRY_MAX_DELAY = 5, 1.0, 1.5
    calls.clear(), delays.clear()
    with pytest.raises(OSError, match="transient 5") as exc:
        resilience.retry(flaky, 10, sleep=delays.append)
    assert type(exc.value) is OSError and len(calls) == 5 and len(delays) == 4
    assert all(d <= min(1.5, 2 ** a) for a, d in enumerate(delays))
    calls.clear()
    with pytest.raises(ValueError):  # not in retry_on: no retry
        resilience.retry(lambda: calls.append(1) or int("x"), sleep=delays.append)
    assert len(calls) == 1
