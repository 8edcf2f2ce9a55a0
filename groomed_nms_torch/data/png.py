"""PNG decode and encode for the frames of a KITTI tree, without Pillow.

The JAX package reads and writes its PNGs through Pillow, which the port's
GPU machine does not have.  This module covers what a KITTI tree holds:
8-bit, non-interlaced greyscale, RGB or RGBA images.

* ``png_size`` reads the IHDR chunk only.
* ``read_png`` checks every chunk's CRC, inflates the IDAT stream with the
  standard library's ``zlib`` and reverses the five row filters in a small
  C++ routine (``csrc/png_unfilter.cpp``, built with the host compiler and
  called through ``ctypes``, which releases the interpreter lock).  Grey is
  replicated to RGB and alpha dropped, as Pillow's ``convert("RGB")`` does.
  Every other form (16-bit, palette, grey + alpha, interlaced) raises
  ``ValueError`` naming the file.
* ``write_png`` rotates the row filter through all five types, so every
  decode path runs on what it writes.

``unfilter_plain`` is the C++ routine's plain numpy/Python version; only the
tests use it.  A failed build of the routine raises: there is no fall-back
to the Python loop.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ..ops import _build

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels, for the types a KITTI tree holds
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunks(data, path):
    """Yield ``(type, payload)`` of each chunk after the signature, the CRC
    of each checked."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        payload = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"{path}: CRC mismatch in its {kind!r} chunk")
        yield kind, payload
        if kind == b"IEND":
            return
        pos = end + 4
    raise ValueError(f"{path}: no IEND chunk (truncated file?)")


def _header(kind, payload, path):
    """IHDR -> (height, width, channels); raises on a form not covered."""
    if kind != b"IHDR" or len(payload) != 13:
        raise ValueError(f"{path}: the first chunk is not a valid IHDR")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(
        ">IIBBBBB", payload)
    if depth != 8 or ctype not in _CHANNELS or comp or filt or interlace:
        raise ValueError(
            f"{path}: unsupported PNG form (bit depth {depth}, colour type "
            f"{ctype}, compression {comp}, filter {filt}, interlace "
            f"{interlace}); read_png takes 8-bit, non-interlaced grey, RGB "
            "or RGBA")
    if w == 0 or h == 0:
        raise ValueError(f"{path}: empty image ({h}x{w})")
    return h, w, _CHANNELS[ctype]


def png_size(path):
    """(height, width) from the IHDR chunk, which follows the signature."""
    with open(path, "rb") as f:
        head = f.read(8 + 8 + 13 + 4)
    kind, payload = next(_chunks(head, path))
    h, w, _ = _header(kind, payload, path)
    return h, w


def read_chunks(data, path):
    """Parse a PNG file's bytes -> ((height, width, channels), IDAT bytes)."""
    chunks = _chunks(data, path)
    shape = _header(*next(chunks), path)
    idat = b"".join(p for kind, p in chunks if kind == b"IDAT")
    return shape, idat


def inflate(idat, shape, path):
    """The IDAT stream -> its filtered rows, length checked."""
    h, w, c = shape
    try:
        raw = zlib.decompress(idat)
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt IDAT stream ({e})") from None
    if len(raw) != h * (1 + w * c):
        raise ValueError(f"{path}: IDAT holds {len(raw)} bytes, expected "
                         f"{h * (1 + w * c)} for {h}x{w}x{c}")
    return raw


def unfilter(raw, shape, path="<png>"):
    """Filtered rows -> uint8 [H, W, C], by the C++ routine."""
    h, w, c = shape
    src = np.frombuffer(raw, np.uint8)
    if src.size != h * (1 + w * c):
        raise ValueError(f"{path}: {src.size} filtered bytes, expected "
                         f"{h * (1 + w * c)} for {h}x{w}x{c}")
    out = np.empty((h, w, c), np.uint8)
    bad = _build.png_unfilter_lib().png_unfilter(
        src.ctypes.data, out.ctypes.data, h, w * c, c)
    if bad:
        raise ValueError(f"{path}: row {bad - 1} has filter type "
                         f"{src[(bad - 1) * (1 + w * c)]}, not one of 0-4")
    return out


def unfilter_plain(raw, shape, path="<png>"):
    """The plain version of ``unfilter``: numpy per row, a Python loop over
    the bytes of Average and Paeth rows."""
    h, w, c = shape
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + w * c)
    out = np.zeros((h, w * c), np.uint8)
    up = np.zeros(w * c, np.int64)
    for y in range(h):
        kind, x = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if kind == 0:
            cur = x
        elif kind == 1:                   # running sum per channel
            cur = np.cumsum(x.reshape(w, c), axis=0).reshape(-1)
        elif kind == 2:
            cur = x + up
        elif kind in (3, 4):
            cur = np.zeros(w * c, np.int64)
            for i in range(w * c):
                a = cur[i - c] if i >= c else 0
                b = up[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    cc = up[i - c] if i >= c else 0
                    pred = _paeth(a, b, cc)
                cur[i] = (x[i] + pred) & 0xFF
        else:
            raise ValueError(f"{path}: row {y} has filter type {kind}, not "
                             "one of 0-4")
        cur = cur & 0xFF
        out[y] = cur
        up = cur
    return out.reshape(h, w, c)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def to_rgb(px):
    """[H, W, C] of 1, 3 or 4 channels -> [H, W, 3], as Pillow's
    ``convert("RGB")``: grey replicated, alpha dropped."""
    if px.shape[2] == 1:
        return np.repeat(px, 3, axis=2)
    return np.ascontiguousarray(px[..., :3]) if px.shape[2] == 4 else px


def read_png(path):
    """Decode a PNG file -> uint8 [H, W, 3] RGB."""
    with open(path, "rb") as f:
        data = f.read()
    shape, idat = read_chunks(data, path)
    return to_rgb(unfilter(inflate(idat, shape, path), shape, path))


def _chunk(kind, payload):
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


_IEND = _chunk(b"IEND", b"")


def filter_rows(img, filters=None):
    """uint8 [H, W, C] -> the filtered rows (filter byte + bytes), row y
    filtered with ``filters[y % len(filters)]`` (default: all five types in
    turn)."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int16)  # p spans -255..510
    left = np.zeros_like(x)
    left[:, c:] = x[:, :-c]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, c:] = x[:-1, :-c]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    preds = (np.zeros_like(x), left, up, (left + up) >> 1, paeth)
    kinds = np.asarray(filters if filters is not None else range(5))
    kind = kinds[np.arange(h) % len(kinds)]
    pred = np.choose(kind[:, None], preds)
    out = np.empty((h, 1 + w * c), np.uint8)
    out[:, 0] = kind
    out[:, 1:] = (x - pred) & 0xFF
    return out.tobytes()


def write_png(path, img, filters=None):
    """Write uint8 [H, W] grey, [H, W, 3] RGB or [H, W, 4] RGBA as an
    8-bit PNG, the row filters rotating through ``filters`` (default: all
    five types in turn; e.g. ``(4,)`` forces Paeth)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    ctype = {v: k for k, v in _CHANNELS.items()}.get(c)
    if ctype is None:
        raise ValueError(f"write_png takes 1, 3 or 4 channels, got {c}")
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    body = zlib.compress(filter_rows(img, filters), 6)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", body)
                + _IEND)
