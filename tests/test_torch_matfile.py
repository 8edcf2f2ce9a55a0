"""The port's MAT5 reader and split setup against the JAX package's: the
same arrays from the same bytes (each numeric class, compressed and raw),
and ``scripts/setup_split_torch.py`` building the same split tree as
``scripts/setup_split.py`` (split2's ``.mat`` ids and split1's id lists),
run with JAX and the JAX package unimportable."""

import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from groomed_nms_tpu.data.matfile import load_mat_numeric as jax_load

from groomed_nms_torch.data.matfile import load_mat_numeric
from test_matfile import _MI_FOR, _MX_FOR, _element, _mat_bytes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BLOCKED = ("jax", "jaxlib", "flax", "groomed_nms_tpu")
_RUNNER = f"""
import runpy, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {_BLOCKED!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
script = sys.argv[1]
sys.argv = sys.argv[1:]
runpy.run_path(script, run_name="__main__")
"""


def _same(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        np.testing.assert_array_equal(ours[k], v)


@pytest.mark.parametrize("compressed", [False, True],
                         ids=["raw", "compressed"])
@pytest.mark.parametrize("code", sorted(_MI_FOR))
def test_load_mat_numeric_matches_jax(tmp_path, code, compressed):
    rs = np.random.default_rng(len(code) + compressed)
    arr = (rs.normal(size=(3, 5)) * 50).astype("<" + code) \
        if code[0] == "f" else rs.integers(0, 200, (3, 5)).astype(
            "<" + code)
    ids = np.arange(0, 30, 4, dtype="<u2").reshape(1, -1)
    path = tmp_path / "x.mat"
    path.write_bytes(_mat_bytes({"arr": arr, "ids": ids},
                                compress=("arr",) if compressed else ()))
    ours = load_mat_numeric(str(path))
    _same(ours, jax_load(str(path)))
    np.testing.assert_array_equal(ours["arr"], arr)


def test_small_element_name_and_bad_container(tmp_path):
    arr = np.array([[7, 9]], dtype="<i4")
    flags = _element(6, struct.pack("<II", _MX_FOR["i4"], 0))
    dims = _element(5, np.asarray(arr.shape, "<i4").tobytes())
    name_el = struct.pack("<I", (2 << 16) | 1) + b"ab\0\0"
    data = _element(_MI_FOR["i4"], arr.tobytes(order="F"))
    header = b"x".ljust(124) + struct.pack("<H2s", 0x0100, b"IM")
    path = tmp_path / "small.mat"
    path.write_bytes(header + _element(14, flags + dims + name_el + data))
    _same(load_mat_numeric(str(path)), jax_load(str(path)))
    bad = tmp_path / "bad.mat"
    bad.write_bytes(b"\x89HDF\r\n" + b"\0" * 200)
    for load in (load_mat_numeric, jax_load):
        with pytest.raises(ValueError):
            load(str(bad))


def _kitti(root):
    kitti = root / "kitti" / "training"
    for sub, ext in (("image_2", ".png"), ("calib", ".txt"),
                     ("label_2", ".txt")):
        (kitti / sub).mkdir(parents=True)
        for i in range(8):
            (kitti / sub / f"{i:06d}{ext}").write_bytes(b"x")
    (kitti / "prev_2").mkdir()
    (kitti / "prev_2" / "000004_01.png").write_bytes(b"x")
    return root / "kitti"


def _tree(split):
    """{relative path: link target} of a split directory."""
    out = {}
    for dirpath, _, files in os.walk(split):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, split)] = os.readlink(p) \
                if os.path.islink(p) else None
    return out


@pytest.mark.parametrize("style", ["split2_mat", "split1_lists"])
def test_setup_split_torch_matches_setup_split(tmp_path, style):
    """Both scripts on one tiny KITTI layout, each into its own split
    directory: the same files linked to the same sources."""
    kitti = _kitti(tmp_path)
    trees = []
    for script in ("setup_split.py", "setup_split_torch.py"):
        split = tmp_path / script / "kitti_split"
        split.mkdir(parents=True)
        if style == "split2_mat":
            (split / "kitti_ids_new.mat").write_bytes(_mat_bytes(
                {"ids_train": np.array([[1, 4, 7]], "<u2"),
                 "ids_val": np.array([[0, 2]], "<u2")},
                compress=("ids_train",)))
        else:
            (split / "train.txt").write_text("000004\n000005\n")
            (split / "val.txt").write_text("000001\n")
        argv = [os.path.join(ROOT, "scripts", script), "--kitti", str(kitti),
                "--split-dir", str(split)]
        cmd = [sys.executable, *argv] if script == "setup_split.py" else \
            [sys.executable, "-c", _RUNNER, *argv]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                           cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
        assert r.returncode == 0, r.stderr
        trees.append(_tree(split))
    assert trees[0] == trees[1]
    links = [k for k, v in trees[1].items() if v is not None]
    assert len(links) == (16 if style == "split2_mat" else 10)
