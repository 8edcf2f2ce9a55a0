"""Minimal MATLAB v5 (.mat) reader for numeric matrices (the port's copy of
``groomed_nms_tpu/data/matfile.py``, which the port does not import).

The reference ships split2's train/val/test image ids as a MAT5 file
(``data/kitti_split2/kitti_ids_new.mat``, read by its
``data/kitti_split2/setup_split.py:14,46`` via ``scipy.io.loadmat``).
This environment treats scipy as optional, so ``load_mat_numeric`` parses
the subset of the MAT5 container those id arrays need -- zlib-compressed
or raw data elements holding plain (non-sparse, non-cell, non-complex)
numeric matrices -- with no dependency beyond numpy.  Matrices of any of
the standard numeric classes are returned as 2-D numpy arrays keyed by
variable name, matching ``scipy.io.loadmat``'s layout for them
(column-major dims, same dtype).
"""

import struct
import zlib

import numpy as np

# MAT5 data-element type tags -> numpy dtypes (little-endian; the header's
# endian indicator is checked before these are used)
_MI_DTYPES = {
    1: "i1", 2: "u1", 3: "<i2", 4: "<u2", 5: "<i4", 6: "<u4",
    7: "<f4", 9: "<f8", 12: "<i8", 13: "<u8",
}
_MI_COMPRESSED = 15
_MI_MATRIX = 14
# mxClass codes (array-flags byte 0) -> numpy dtypes for the logical array
_MX_CLASSES = {
    6: "<f8", 7: "<f4", 8: "i1", 9: "u1", 10: "<i2", 11: "<u2",
    12: "<i4", 13: "<u4", 14: "<i8", 15: "<u8",
}


def _read_element(buf, off):
    """One tagged data element at ``off``: (mi_type, payload, next_off).

    Handles the small-element format (type and byte count packed into one
    word, data in the following 4 bytes) and the 8-byte padding of
    full-size elements.
    """
    word, = struct.unpack_from("<I", buf, off)
    if word >> 16:          # small data element: nbytes in the high half
        mi, nbytes = word & 0xFFFF, word >> 16
        return mi, buf[off + 4:off + 4 + nbytes], off + 8
    nbytes, = struct.unpack_from("<I", buf, off + 4)
    payload = buf[off + 8:off + 8 + nbytes]
    end = off + 8 + nbytes
    if mi_pads(word):
        end += (8 - nbytes % 8) % 8
    return word, payload, end


def mi_pads(mi):
    """Every element except miCOMPRESSED pads its payload to 8 bytes."""
    return mi != _MI_COMPRESSED


def _parse_matrix(payload):
    """miMATRIX payload -> (name, 2-D array) or (None, None) if unsupported."""
    off = 0
    mi, flags, off = _read_element(payload, off)
    if mi != 6 or len(flags) < 8:           # array flags are miUINT32 x2
        return None, None
    mx_class = flags[0]
    complex_flag = flags[1] & 0x08
    if mx_class not in _MX_CLASSES or complex_flag:
        return None, None                    # sparse/cell/struct/char/complex
    mi, dims_raw, off = _read_element(payload, off)
    dims = np.frombuffer(dims_raw, "<i4")
    mi, name_raw, off = _read_element(payload, off)
    name = bytes(name_raw).decode("ascii")
    mi, data, off = _read_element(payload, off)
    if mi not in _MI_DTYPES:
        return None, None
    arr = np.frombuffer(bytes(data), _MI_DTYPES[mi])
    # MATLAB saves wide classes in the narrowest lossless storage type
    # (e.g. small doubles as uint16); keep the STORAGE dtype, matching
    # scipy.io.loadmat's default (mat_dtype=False).  MAT data is
    # column-major.
    return name, arr.reshape(tuple(int(d) for d in dims), order="F")


def load_mat_numeric(path):
    """Read every plain numeric matrix of a MAT5 file: {name: ndarray}.

    Raises ValueError for non-MAT5 containers (including the pre-v5 and
    v7.3/HDF5 formats); silently skips variables of unsupported classes
    (sparse, cell, struct, char, complex).
    """
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 128:
        raise ValueError(f"{path}: too short for a MAT5 file")
    version, endian = struct.unpack_from("<H2s", buf, 124)
    if endian == b"MI":
        raise ValueError(f"{path}: big-endian MAT files are not supported")
    if endian != b"IM" or version != 0x0100:
        raise ValueError(
            f"{path}: not a MATLAB 5 file (v7.3/HDF5 and v4 unsupported)")
    out = {}
    off = 128
    while off + 8 <= len(buf):
        mi, payload, off = _read_element(buf, off)
        if mi == _MI_COMPRESSED:
            payload = zlib.decompress(bytes(payload))
            mi, payload, _ = _read_element(payload, 0)
        if mi != _MI_MATRIX:
            continue
        name, arr = _parse_matrix(payload)
        if name is not None:
            out[name] = arr
    return out
