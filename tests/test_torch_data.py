"""The port's image input path against the JAX package's, on the CPU.

Inputs are JPEGs (and one PNG) written from a numpy seed. Every comparison
is bitwise:

- ``shard_indices`` / ``aug_seed_base`` for train and eval shardings;
- ``train_transform_u8`` / ``eval_transform_u8`` on odd sizes, a grayscale
  image, sizes below the crop and an aspect that takes the center fallback;
- ``ImageFolder`` / ``TarImageFolder`` sample lists and member bytes;
- the port's ``HostDataLoader`` batches (through its producer thread)
  against JAX's ``decode_batch`` at 2 epochs x 2 ranks of a world of 2,
  train and eval, on PIL (``use_native = False`` set on both instances) and,
  where the port's decoder builds, on the native decoder in both;
- drop_last, eval padding at weight 0, a consumer that abandons the epoch,
  a failing producer, a corrupt JPEG (substituted by the next sample under
  ``FAULT.DEGRADE``, raised without it),
  a read retried (``FAULT.RETRY_*``) through two transient failures;
- the committed ``digits.csv.gz`` against ``sklearn.datasets.load_digits``,
  and ``digits_imagefolder``'s files against the JAX package's.
"""

import os
import random
import tarfile

import numpy as np
import pytest
from PIL import Image

from distribuuuu_tpu.data import dataset as jax_dataset
from distribuuuu_tpu.data import loader as jax_loader
from distribuuuu_tpu.data import native as jax_native
from distribuuuu_tpu.data import provision as jax_provision
from distribuuuu_tpu.data import transforms as jax_tf
from distribuuuu_tpu_torch.data import dataset, loader, native, provision
from distribuuuu_tpu_torch.data import transforms as tf

SIZES = [(37, 23), (23, 37), (64, 48), (11, 9), (97, 7)]  # (11, 9): below the crop


def _image(rng, w, h, mode="RGB"):
    ramp = np.linspace(0, 200, w)[None, :]  # a gradient under the noise: crops differ
    if mode == "RGB":
        return Image.fromarray((rng.integers(0, 56, (h, w, 3)) + ramp[..., None]).astype(np.uint8))
    return Image.fromarray((rng.integers(0, 56, (h, w)) + ramp).astype(np.uint8))


@pytest.fixture(scope="module")
def image_root(tmp_path_factory):
    """3 classes x 7 images of assorted sizes; one grayscale JPEG, one PNG."""
    root = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    for c, cls in enumerate(["cat", "dog", "eel"]):
        (root / cls).mkdir()
        for i in range(7):
            w, h = SIZES[(c + i) % len(SIZES)]
            mode = "L" if (c, i) == (1, 3) else "RGB"
            ext = "png" if (c, i) == (2, 5) else "jpg"
            _image(rng, w + 20, h + 20, mode).save(root / cls / f"{i}.{ext}", quality=90)
    return str(root)


@pytest.mark.parametrize("total,seed,epoch,world", [(21, 7, 0, 2), (21, 7, 3, 2), (100, 0, 1, 8),
                                                    (5, 3, 2, 4), (64, 1, 0, 1)])
@pytest.mark.parametrize("train", [True, False])
def test_shard_indices_and_aug_seed_base_equal_jax(total, seed, epoch, world, train):
    for rank in range(world):
        kw = dict(train=train, seed=seed, epoch=epoch, process_index=rank, process_count=world)
        np.testing.assert_array_equal(loader.shard_indices(total, **kw),
                                      jax_loader.shard_indices(total, **kw))
        assert loader.aug_seed_base(seed, epoch, rank) == jax_loader.aug_seed_base(seed, epoch, rank)


@pytest.mark.parametrize("w,h", SIZES)
@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_transforms_bitwise_jax(w, h, mode):
    img = _image(np.random.default_rng(w * h), w, h, mode)
    for seed in range(6):
        got = tf.train_transform_u8(img, 16, rng=random.Random(seed))
        want = jax_tf.train_transform_u8(img, 16, rng=random.Random(seed))
        assert got.shape == (16, 16, 3) and np.array_equal(got, want), seed
    for resize, crop in ((18, 16), (12, 12)):
        np.testing.assert_array_equal(tf.eval_transform_u8(img, resize, crop),
                                      jax_tf.eval_transform_u8(img, resize, crop))


def test_image_folder_and_tar_shards_list_the_same_samples(image_root, tmp_path):
    ours, theirs = dataset.ImageFolder(image_root), jax_dataset.ImageFolder(image_root)
    assert ours.classes == theirs.classes and ours.samples == theirs.samples
    shards = tmp_path / "shards"
    shards.mkdir()
    for k, cls in enumerate(ours.classes):
        with tarfile.open(shards / f"shard-{k}.tar", "w") as t:
            t.add(os.path.join(image_root, cls), arcname=f"./{cls}" if k else cls)
    for manifest in (None, ["ant", "cat", "dog", "eel"]):  # "ant" has no member
        if manifest:
            (shards / "classes.txt").write_text("\n".join(manifest) + "\n")
        ours, theirs = dataset.open_image_dataset(str(shards)), jax_dataset.open_image_dataset(
            str(shards))
        assert isinstance(ours, dataset.TarImageFolder)
        assert ours.classes == theirs.classes and ours.samples == theirs.samples
        assert [ours.read_bytes(i) for i in range(len(ours))] == [
            theirs.read_bytes(i) for i in range(len(theirs))]
    (shards / "classes.txt").write_text("cat\ncat\ndog\neel\n")
    with pytest.raises(ValueError, match="duplicate"):
        dataset.TarImageFolder(str(shards))


def _loaders(root, rank, train, use_native, **kw):
    kw = dict(host_batch=4, train=train, im_size=16 if train else 18, process_index=rank,
              process_count=2, workers=2, seed=7, crop_size=16, **kw)
    ours = loader.HostDataLoader(dataset.ImageFolder(root), **kw)
    theirs = jax_loader.HostDataLoader(jax_dataset.ImageFolder(root), **kw)
    ours.use_native = theirs.use_native = use_native
    return ours, theirs


@pytest.mark.parametrize("backend", ["pil", "native"])
@pytest.mark.parametrize("train", [True, False])
def test_host_loader_batches_bitwise_jax(image_root, train, backend):
    if backend == "native" and not (native.available() and jax_native.available()):
        pytest.skip(f"the native decoder does not build here: {native.unavailable_reason()}")
    for rank in range(2):
        ours, theirs = _loaders(image_root, rank, train, backend == "native")
        assert ours.decoder == backend and len(ours) == len(theirs) == (2 if train else 3)
        for epoch in range(2):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            got = list(ours)
            assert len(got) == len(ours)
            for b, batch in enumerate(got):
                want = theirs.decode_batch(b)
                for k in ("image", "label", "weight"):
                    assert batch[k].dtype == want[k].dtype and np.array_equal(batch[k], want[k])


def test_drop_last_and_eval_padding_count_every_sample_once(image_root):
    seen, weight = [], 0.0
    for rank in range(2):
        train, val = (_loaders(image_root, rank, t, False)[0] for t in (True, False))
        assert [len(b["label"]) for b in train] == [4, 4]  # 11 a shard: 3 dropped
        batches = list(val)
        assert [len(b["label"]) for b in batches] == [4, 4, 4]  # 11 a shard, padded to 12
        for b in batches:
            pad = b["weight"] == 0
            assert not b["image"][pad].any() and not b["label"][pad].any()
            weight += float(b["weight"].sum())
        seen += [int(i) for i in val._shard_indices() if i >= 0]
    assert weight == 21.0 and sorted(seen) == list(range(21))


def test_consumer_abort_stops_and_reaps_the_producer(image_root):
    ours = _loaders(image_root, 0, False, False, prefetch_batches=1)[0]
    it = iter(ours)
    next(it)
    it.close()
    assert ours._producer is not None and not ours._producer.is_alive()


def test_producer_error_surfaces_in_the_consumer(image_root, monkeypatch):
    ours = _loaders(image_root, 0, True, False)[0]

    def boom(idx, seed):
        raise RuntimeError(f"boom {idx}")
    monkeypatch.setattr(ours, "_load_one", boom)
    with pytest.raises(RuntimeError, match="data loader worker failed") as exc:
        list(ours)
    assert "boom" in str(exc.value.__cause__)
    assert not ours._producer.is_alive()


@pytest.mark.parametrize("backend", ["pil", "native"])
def test_corrupt_jpeg_raises_and_names_item_2(image_root, tmp_path, backend):
    """A corrupt JPEG is ROADMAP item 2's FAULT.DEGRADE path: under the
    default the train batch takes the next sample in its slot (same crop
    seed); with DEGRADE off the loader raises, naming the file."""
    if backend == "native" and not native.available():
        pytest.skip(f"the native decoder does not build here: {native.unavailable_reason()}")
    from distribuuuu_tpu_torch.config import cfg, reset_cfg

    root = tmp_path / "bad"
    (root / "cat").mkdir(parents=True)
    for i in range(4):
        _image(np.random.default_rng(i), 20, 20).save(root / "cat" / f"{i}.jpg")
    data = (root / "cat" / "2.jpg").read_bytes()
    (root / "cat" / "2.jpg").write_bytes(data[:40] + b"\0" * 10)
    reset_cfg()
    cfg.FAULT.RETRY_BASE_DELAY = 0.001
    try:
        ours = loader.HostDataLoader(dataset.ImageFolder(str(root)), host_batch=4, train=True,
                                     im_size=16, process_index=0, process_count=1, workers=2,
                                     seed=0)
        ours.use_native = backend == "native"
        (batch,) = list(ours)
        order = list(ours._shard_indices())
        slot = order.index(2)
        seed = loader.aug_seed_base(0, 0, 0) + slot
        assert np.array_equal(batch["image"][slot], ours._load_one_raw(3, seed)[0])
        cfg.FAULT.DEGRADE = False
        with pytest.raises(RuntimeError, match="data loader worker failed") as exc:
            list(ours)
        assert isinstance(exc.value.__cause__, OSError)
        assert "2.jpg" in str(exc.value.__cause__)
        assert "FAULT.DEGRADE is off" in str(exc.value.__cause__)
    finally:
        reset_cfg()


def test_load_one_retries_a_transient_read_and_raises_a_permanent_one(image_root, monkeypatch):
    ours = _loaders(image_root, 0, True, False)[0]
    load, calls = ours._load_one_raw, []

    def flaky(idx, seed):
        calls.append(idx)
        if len(calls) < 3:  # two transient failures, then the read succeeds
            raise OSError("transient read")
        return load(idx, seed)
    monkeypatch.setattr(ours, "_load_one_raw", flaky)
    img, label, weight = ours._load_one(5, 11)
    assert len(calls) == 3 and np.array_equal(img, load(5, 11)[0]) and weight == 1.0
    calls.clear()
    monkeypatch.setattr(ours, "_load_one_raw", lambda idx, seed: calls.append(idx) or int("x"))
    # every attempt fails, then FAULT.DEGRADE's three neighbours, one try each
    with pytest.raises(OSError, match="in 3 attempts .*FAULT.DEGRADE found none"):
        ours._load_one(5, 11)
    assert calls == [5, 5, 5, 6, 7, 8]


def test_digits_csv_equals_sklearn_and_the_folder_equals_jax(tmp_path):
    from sklearn.datasets import load_digits

    want = load_digits()
    images, labels = provision.load_digits()
    assert images.dtype == want.images.dtype and np.array_equal(images, want.images)
    assert np.array_equal(labels, want.target)
    ours = provision.digits_imagefolder(str(tmp_path / "ours"), im_size=24, train_per_class=3)
    theirs = jax_provision.digits_imagefolder(str(tmp_path / "jax"), im_size=24,
                                              train_per_class=3)

    def files(root):
        return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
                for d, _, fs in os.walk(root) for f in fs}
    got = files(ours)
    assert len(got) == 10 * 3 + 300 + 1 and got == files(theirs)  # 300 val, the stamp
    assert provision.digits_imagefolder(ours, im_size=24, train_per_class=3) == ours
    assert files(ours) == got
