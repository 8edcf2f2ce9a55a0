"""The port's data layer against Pillow and the JAX package: PNG decode and
encode, the KITTI parsers, the imdb, the synthetic tree, the dynamic
preprocess, the decode cache, the anchors file and the prefetch."""

import dataclasses
import logging
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp
from groomed_nms_tpu.data import augment as jax_augment
from groomed_nms_tpu.data.imdb import build_imdb as jax_build_imdb
from groomed_nms_tpu.data.kitti import read_kitti_calib as jax_calib
from groomed_nms_tpu.data.kitti import read_kitti_label as jax_label
from groomed_nms_tpu.data.synthetic import \
    make_synthetic_kitti as jax_make_synthetic

from groomed_nms_torch.config import load_config
from groomed_nms_torch.data import augment, pipeline, png
from groomed_nms_torch.data.imdb import build_imdb
from groomed_nms_torch.data.kitti import read_kitti_calib, read_kitti_label
from groomed_nms_torch.data.synthetic import (crop_to_sizes,
                                              make_synthetic_kitti)
from groomed_nms_torch.ops import _build

MEANS = (0.485, 0.456, 0.406)
STDS = (0.229, 0.224, 0.225)


def _frame(rs, h, w, c=3):
    """A smooth gradient with noise, like a KITTI frame (Pillow's encoder
    then picks more than one filter type)."""
    t = np.linspace(0, 1, h)[:, None, None]
    img = 120 * (1 - t) + 85 * t + rs.normal(0, 6, (h, w, c))
    return np.clip(img, 0, 255).astype(np.uint8)


def _pillow(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


# -- PNG ----------------------------------------------------------------------

@pytest.mark.parametrize("mode,h,w", [("RGB", 375, 1242), ("RGB", 7, 13),
                                      ("L", 9, 31), ("RGBA", 6, 11),
                                      ("RGB", 1, 1)])
def test_read_png_matches_pillow_on_pillow_files(tmp_path, mode, h, w):
    rs = np.random.default_rng(h * w)
    c = {"RGB": 3, "L": 1, "RGBA": 4}[mode]
    arr = _frame(rs, h, w, c)
    path = str(tmp_path / "f.png")
    Image.fromarray(arr[..., 0] if c == 1 else arr, mode).save(path)
    got = png.read_png(path)
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, _pillow(path))
    assert png.png_size(path) == (h, w)


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), None])
@pytest.mark.parametrize("c,h,w", [(3, 17, 23), (1, 8, 5), (4, 6, 9)])
def test_write_png_each_filter_reads_back_as_pillow_does(tmp_path, filters,
                                                         c, h, w):
    rs = np.random.default_rng(7)
    arr = rs.integers(0, 256, (h, w, c), dtype=np.uint8)
    path = str(tmp_path / "f.png")
    png.write_png(path, arr[..., 0] if c == 1 else arr, filters=filters)
    want = _pillow(path)
    np.testing.assert_array_equal(want, png.to_rgb(arr))
    np.testing.assert_array_equal(png.read_png(path), want)
    with open(path, "rb") as f:
        shape, idat = png.read_chunks(f.read(), path)
    kinds = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, -1)[:, 0]
    assert set(kinds) == set(filters if filters else range(min(h, 5)))


@pytest.mark.parametrize("c", [1, 3, 4])
def test_cpp_unfilter_matches_plain(c):
    """Random filtered rows of every type (the C++ routine and the plain
    version must reconstruct the same bytes, wrap-arounds included)."""
    rs = np.random.default_rng(c)
    h, w = 40, 37
    rows = rs.integers(0, 256, (h, 1 + w * c), dtype=np.uint8)
    rows[:, 0] = rs.integers(0, 5, h)
    raw = rows.tobytes()
    np.testing.assert_array_equal(png.unfilter(raw, (h, w, c)),
                                  png.unfilter_plain(raw, (h, w, c)))


def test_unfilter_refuses_an_unknown_filter_type():
    rows = np.zeros((3, 1 + 4 * 3), np.uint8)
    rows[1, 0] = 5
    for fn in (png.unfilter, png.unfilter_plain):
        with pytest.raises(ValueError, match="row 1 has filter type 5"):
            fn(rows.tobytes(), (3, 4, 3), "x.png")


def test_a_failed_unfilter_build_raises(tmp_path, monkeypatch):
    """No quiet fall-back to the Python loop: a source that does not
    compile makes ``read_png`` raise."""
    good = str(tmp_path / "good.png")
    png.write_png(good, np.zeros((2, 3, 3), np.uint8))
    (tmp_path / "png_unfilter.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.png_unfilter_lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="failed on"):
            png.read_png(good)
    finally:
        _build.png_unfilter_lib.cache_clear()


def _rewrite_ihdr(data, **fields):
    """PNG bytes with IHDR fields replaced (CRC recomputed)."""
    names = ("w", "h", "depth", "ctype", "comp", "filt", "interlace")
    vals = dict(zip(names, struct.unpack(">IIBBBBB", data[16:29])))
    vals.update(fields)
    payload = struct.pack(">IIBBBBB", *(vals[n] for n in names))
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + payload))
    return data[:16] + payload + crc + data[33:]


def test_read_png_refuses_what_it_does_not_take(tmp_path):
    rs = np.random.default_rng(1)
    arr = rs.integers(0, 256, (6, 5, 3), dtype=np.uint8)
    good = str(tmp_path / "good.png")
    png.write_png(good, arr)
    data = open(good, "rb").read()
    cases = {}
    bad = bytearray(data)
    bad[-20] ^= 0xFF                             # inside the IDAT payload
    cases["crc"] = (bytes(bad), "CRC mismatch")
    cases["interlaced"] = (_rewrite_ihdr(data, interlace=1), "interlace 1")
    cases["truncated"] = (data[:-30], "truncated|no IEND")
    cases["not a png"] = (b"GIF89a" + data[6:], "not a PNG")
    for name, (blob, msg) in cases.items():
        path = str(tmp_path / f"{name}.png")
        with open(path, "wb") as f:
            f.write(blob)
        with pytest.raises(ValueError, match=msg):
            png.read_png(path)
    for name, im in {"16-bit": Image.fromarray(
                         rs.integers(0, 65535, (4, 5), dtype=np.uint16)),
                     "palette": Image.fromarray(arr).convert("P"),
                     "grey-alpha": Image.fromarray(arr).convert("LA")}.items():
        path = str(tmp_path / f"{name}.png")
        im.save(path)
        with pytest.raises(ValueError, match=f"{os.path.basename(path)}.*"
                           "unsupported PNG form"):
            png.read_png(path)


# -- KITTI files, the imdb, the synthetic tree -------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The port's synthetic split of mixed sizes (96x320 and 72x240)."""
    root = str(tmp_path_factory.mktemp("kitti"))
    make_synthetic_kitti(root, "validation", 4, im_h=96, im_w=320, seed=3,
                         classes=("Car", "Pedestrian", "Cyclist"))
    crop_to_sizes(root, "validation", [(96, 320), (72, 240)])
    return root


def test_synthetic_tree_matches_jax(tmp_path):
    """Same seed: label and calib files byte-identical, pixels identical."""
    kw = dict(n_images=3, im_h=40, im_w=150, seed=11, max_objects=4,
              classes=("Car", "Pedestrian"))
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    make_synthetic_kitti(ours, "training", **kw)
    jax_make_synthetic(theirs, "training", **kw)
    for sub in ("calib", "label_2", "image_2"):
        names = sorted(os.listdir(os.path.join(theirs, "training", sub)))
        assert sorted(os.listdir(os.path.join(ours, "training", sub))) == \
            names and len(names) == 3
        for n in names:
            a = os.path.join(ours, "training", sub, n)
            b = os.path.join(theirs, "training", sub, n)
            if sub == "image_2":
                np.testing.assert_array_equal(png.read_png(a), _pillow(b))
            else:
                assert open(a, "rb").read() == open(b, "rb").read(), n


def test_kitti_parsers_match_jax(tree):
    for i in range(4):
        iid = f"{i:06d}"
        calib = os.path.join(tree, "validation", "calib", iid + ".txt")
        p2 = read_kitti_calib(calib)
        np.testing.assert_array_equal(p2, jax_calib(calib))
        label = os.path.join(tree, "validation", "label_2", iid + ".txt")
        for use_3d in (False, True):
            ours, theirs = read_kitti_label(label, p2, use_3d), \
                jax_label(label, p2, use_3d)
            assert ours.keys() == theirs.keys()
            for k in theirs:
                np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def test_build_imdb_matches_jax(tree, tmp_path):
    ours = build_imdb(tree, "validation", use_3d_for_2d=True,
                      cache_file=str(tmp_path / "imdb.pkl"))
    theirs = jax_build_imdb(tree, "validation", use_3d_for_2d=True)
    assert [r.id for r in ours] == [r.id for r in theirs]
    assert {(r.im_h, r.im_w) for r in ours} == {(96, 320), (72, 240)}
    for a, b in zip(ours, theirs):
        assert (a.image_path, a.im_h, a.im_w, a.scale) == \
            (b.image_path, b.im_h, b.im_w, b.scale)
        np.testing.assert_array_equal(a.p2, b.p2)
        np.testing.assert_array_equal(a.p2_inv, b.p2_inv)
        assert a.gts.keys() == b.gts.keys()
        for k in b.gts:
            np.testing.assert_array_equal(a.gts[k], b.gts[k], err_msg=k)
    # the cache is keyed on the build arguments
    again = build_imdb(tree, "validation", use_3d_for_2d=True,
                       cache_file=str(tmp_path / "imdb.pkl"))
    assert [r.id for r in again] == [r.id for r in ours]
    other = build_imdb(tree, "validation", ids=["000001"],
                       use_3d_for_2d=True,
                       cache_file=str(tmp_path / "imdb.pkl"))
    assert [r.id for r in other] == ["000001"]


# -- preprocess ---------------------------------------------------------------

def test_dynamic_preprocess_matches_jax_at_mixed_sizes():
    """Three sizes edge-padded into one buffer; new_w = 208 (pad), 236
    (crop), 160 (pad), 213 (w * s not an integer) at 1e-5 abs."""
    rs = np.random.default_rng(0)
    sizes = [(128, 416), (96, 354), (112, 280), (100, 333)]
    raws = [rs.integers(0, 256, (h, w, 3), np.uint8) for h, w in sizes]
    buf = np.stack([augment.pad_image_edge(r, 128, 416) for r in raws])
    want = np.asarray(jax_augment.preprocess_images_dynamic(
        jnp.asarray(buf), jnp.asarray(sizes, np.float32), jnp.asarray(MEANS),
        jnp.asarray(STDS), target_h=64, crop_w=224))
    got = augment.preprocess_images_dynamic(
        torch.from_numpy(buf), torch.tensor(sizes, dtype=torch.float32),
        MEANS, STDS, target_h=64, crop_w=224)
    assert got.shape == (4, 3, 64, 224)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-5)
    bf16 = augment.preprocess_images_dynamic(
        torch.from_numpy(buf), torch.tensor(sizes, dtype=torch.float32),
        MEANS, STDS, target_h=64, crop_w=224, out_dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    torch.testing.assert_close(bf16, got.to(torch.bfloat16))


@pytest.mark.parametrize("shape,target,atol", [
    pytest.param((2, 128, 416, 3), (64, 224), 1e-4, id="shape0-target0"),
    pytest.param((2, 72, 240, 3), (96, 320), 1e-4, id="shape1-target1"),
    pytest.param((1, 375, 1242, 3), (96, 352), 1e-4, id="shape2-target2"),
    pytest.param((2, 375, 1242, 3), (512, 1760), 6e-4, id="flagship")])
def test_dynamic_preprocess_matches_static_on_a_full_buffer(shape, target,
                                                            atol):
    """Every image fills the buffer: the static path's result, at the
    static resize's own tolerance against JAX (1e-4).  At the flagship's
    width, PyTorch's resize forms a source coordinate with one rounding
    and the JAX-formula weights with two (1023.6374 against 1023.6373 at
    output column 1398), one f32 step apart: 2^-13 / 0.224 (the smallest
    std) = 5.4e-4 of a normalised value at the largest pixel step."""
    rs = np.random.default_rng(1)
    imgs = torch.from_numpy(rs.integers(0, 256, shape, np.uint8))
    hw = torch.tensor([shape[1:3]] * shape[0], dtype=torch.float32)
    want = augment.preprocess_images(imgs, None, MEANS, STDS,
                                     target_h=target[0], crop_w=target[1])
    got = augment.preprocess_images_dynamic(imgs, hw, MEANS, STDS,
                                            target_h=target[0],
                                            crop_w=target[1])
    torch.testing.assert_close(got, want, rtol=0, atol=atol)


def test_dynamic_preprocess_ignores_and_keeps_the_tf32_flags():
    """The resample reads and sets no global matmul precision: with the
    legacy TF32 flag switched on around one call and off before the next,
    both calls give the same result and the flag keeps its value.  A
    save-and-restore of ``torch.set_float32_matmul_precision`` around the
    products would leave the backends mixed, and the next call raise."""
    rs = np.random.default_rng(3)
    imgs = torch.from_numpy(rs.integers(0, 256, (2, 72, 240, 3), np.uint8))
    hw = torch.tensor([[72, 240], [60, 200]], dtype=torch.float32)

    def run():
        return augment.preprocess_images_dynamic(imgs, hw, MEANS, STDS,
                                                 target_h=96, crop_w=320)

    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        first = run()
        assert torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        second = run()
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    torch.testing.assert_close(second, first, rtol=0, atol=0)


def test_pad_image_edge_matches_jax_and_refuses_oversize():
    rs = np.random.default_rng(2)
    img = rs.integers(0, 256, (2, 3, 3), np.uint8)
    out = augment.pad_image_edge(img, 4, 5)
    np.testing.assert_array_equal(out, jax_augment.pad_image_edge(img, 4, 5))
    np.testing.assert_array_equal(out[:2, :3], img)
    np.testing.assert_array_equal(out[3], out[1])
    np.testing.assert_array_equal(out[:, 4], out[:, 2])
    with pytest.raises(ValueError, match="exceeds"):
        augment.pad_image_edge(np.zeros((5, 3, 3), np.uint8), 4, 5)


# -- the decode cache ---------------------------------------------------------

def test_load_image_cached_hit_miss_and_torn(tmp_path):
    rs = np.random.default_rng(3)
    src, cache = str(tmp_path / "a.png"), str(tmp_path / "cache")
    os.makedirs(cache)
    img = rs.integers(0, 256, (10, 12, 3), dtype=np.uint8)
    png.write_png(src, img)
    np.testing.assert_array_equal(pipeline.load_image_cached(src, "a"), img)
    first = pipeline.load_image_cached(src, "a", cache)      # miss: written
    np.testing.assert_array_equal(first, img)
    (entry,) = os.listdir(cache)
    st = os.stat(src)
    assert entry == f"a-{st.st_size}-{st.st_mtime_ns}.npy"
    hit = pipeline.load_image_cached(src, "a", cache)
    assert isinstance(hit, np.memmap)
    np.testing.assert_array_equal(hit, img)
    del first, hit
    path = os.path.join(cache, entry)                        # torn write
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[:len(data) // 2])
    np.testing.assert_array_equal(
        pipeline.load_image_cached(src, "a", cache), img)
    assert os.path.getsize(path) == len(data)


def test_load_image_cached_missing_source_serves_the_newest(tmp_path,
                                                           caplog):
    """The entry with the largest mtime_ns as an integer ('10...' is newer
    than '9...', though it sorts first), a warning on every such read, and
    FileNotFoundError with no entry."""
    cache = str(tmp_path / "cache")
    os.makedirs(cache)
    old = np.full((2, 2, 3), 1, np.uint8)
    new = np.full((2, 2, 3), 2, np.uint8)
    np.save(os.path.join(cache, "k-100-9000000000000000000.npy"), old)
    np.save(os.path.join(cache, "k-100-10000000000000000000.npy"), new)
    np.save(os.path.join(cache, "k2-100-99999999999999999999.npy"), old)
    gone = str(tmp_path / "gone.png")
    for _ in range(2):
        with caplog.at_level(logging.WARNING):
            caplog.clear()
            got = pipeline.load_image_cached(gone, "k", cache)
        np.testing.assert_array_equal(got, new)
        assert any("missing" in r.message for r in caplog.records)
    with pytest.raises(FileNotFoundError):
        pipeline.load_image_cached(gone, "other", cache)
    with pytest.raises(FileNotFoundError):
        pipeline.load_image_cached(gone, "k")


# -- anchors and the prefetch -------------------------------------------------

def test_load_anchors_and_resolve_stats_dir(tmp_path):
    cfg = load_config("groomed_nms")
    run, pre = str(tmp_path / "run"), str(tmp_path / "pre")
    with pytest.raises(ValueError, match="prepare_anchors.*train_torch"):
        pipeline.load_anchors(cfg, run)
    os.makedirs(pre)
    a = np.arange(36 * 11, dtype=np.float32).reshape(36, 11)
    np.savez(os.path.join(pre, "anchors.npz"), anchors=a,
             bbox_means=np.zeros(13), bbox_stds=np.ones(13))
    cfg = dataclasses.replace(cfg, pretrained=pre)
    assert pipeline.resolve_stats_dir(cfg, run) == pre
    anchors, means, stds = pipeline.load_anchors(cfg, pre)
    np.testing.assert_array_equal(anchors, a)
    os.makedirs(run)
    np.savez(os.path.join(run, "anchors.npz"), anchors=a[:, :9],
             bbox_means=np.zeros(11), bbox_stds=np.ones(11))
    assert pipeline.resolve_stats_dir(cfg, run) == run   # its own file wins
    with pytest.raises(ValueError, match="widths 9/11, expected 11/13"):
        pipeline.load_anchors(cfg, run)


def test_device_prefetch_on_the_cpu_passes_items_and_errors():
    items = [(i, (torch.full((2,), i),)) for i in range(5)]
    got = [(m, t[0].tolist()) for m, t in
           pipeline.device_prefetch(iter(items), "cpu")]
    assert got == [(i, [i, i]) for i in range(5)]

    def failing():
        yield 0, (torch.zeros(1),)
        raise RuntimeError("decode failed")

    it = pipeline.device_prefetch(failing(), "cpu")
    assert next(it)[0] == 0
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)

    pulled = []

    def endless():
        i = 0
        while True:
            pulled.append(i)
            yield i, (torch.zeros(1),)
            i += 1

    it = pipeline.device_prefetch(endless(), "cpu", depth=2)
    next(it)
    it.close()                  # stops and joins the worker
    n = len(pulled)
    assert n <= 5 and len(pulled) == n
