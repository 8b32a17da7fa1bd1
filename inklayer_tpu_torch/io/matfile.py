"""A MAT-file level 5 reader for numeric arrays, in numpy (the port imports
no scipy; the InkScenes ground truth is ``.mat``).

:func:`loadmat` reads what ``scipy.io.loadmat`` reads for the label
matrices: the 128-byte header, ``miMATRIX`` elements, ``miCOMPRESSED``
elements (zlib, holding one ``miMATRIX``), the small-element tag form,
either byte order.  A numeric array comes back in its MATLAB class (a
``double`` that MATLAB stored as ``miUINT8`` is float64; a logical is
bool; scipy's ``mat_dtype=True``), with the column-major data reshaped to
its dimensions.  Complex, char, cell, struct, sparse and object arrays are
not read: their variables are left out.  v7.3 files are HDF5 and raise,
as scipy's reader does.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

# miTYPE -> numpy type code
_MI_TYPES = {1: "i1", 2: "u1", 3: "i2", 4: "u2", 5: "i4", 6: "u4",
             7: "f4", 9: "f8", 12: "i8", 13: "u8"}
_MI_MATRIX, _MI_COMPRESSED = 14, 15
# mxCLASS -> numpy type code (numeric classes only)
_MX_CLASSES = {6: "f8", 7: "f4", 8: "i1", 9: "u1", 10: "i2", 11: "u2",
               12: "i4", 13: "u4", 14: "i8", 15: "u8"}
_COMPLEX, _LOGICAL = 0x0800, 0x0200


def _tag(buf: bytes, pos: int, order: str) -> Tuple[int, int, int, int]:
    """(type, nbytes, data start, next element) of the element at pos."""
    mtype, nbytes = struct.unpack_from(order + "II", buf, pos)
    if mtype >> 16:  # small element: type and size in 4 bytes, data in 4
        return mtype & 0xFFFF, mtype >> 16, pos + 4, pos + 8
    start = pos + 8
    end = start + nbytes
    if mtype != _MI_COMPRESSED:
        end += -nbytes % 8  # elements are padded to 8 bytes
    return mtype, nbytes, start, end


def _numeric(buf: bytes, pos: int, order: str) -> Tuple[np.ndarray, int]:
    mtype, nbytes, start, end = _tag(buf, pos, order)
    if mtype not in _MI_TYPES:
        raise ValueError(f"MAT file: data element type {mtype} is not "
                         f"numeric")
    dt = np.dtype(_MI_TYPES[mtype]).newbyteorder(order)
    return np.frombuffer(buf, dt, nbytes // dt.itemsize, start), end


def _matrix(body: bytes, order: str):
    """(name, array) of one miMATRIX body, or (name, None) for a class
    that is not read."""
    flags, pos = _numeric(body, 0, order)
    cls, bits = int(flags[0]) & 0xFF, int(flags[0])
    dims, pos = _numeric(body, pos, order)
    mtype, nbytes, start, pos = _tag(body, pos, order)
    name = body[start:start + nbytes].decode("latin-1")
    if cls not in _MX_CLASSES or bits & _COMPLEX:
        return name, None
    real, _ = _numeric(body, pos, order)
    data = real.astype(bool if bits & _LOGICAL else _MX_CLASSES[cls])
    return name, data.reshape(tuple(int(d) for d in dims), order="F")


def loadmat(path: str) -> Dict[str, np.ndarray]:
    """{variable name: array} of the numeric variables of a level-5 MAT
    file."""
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 128:
        raise ValueError(f"{path}: not a MAT file (shorter than its header)")
    endian = buf[126:128]
    if endian == b"IM":
        order = "<"
    elif endian == b"MI":
        order = ">"
    else:
        raise ValueError(f"{path}: not a level-5 MAT file")
    (version,) = struct.unpack_from(order + "H", buf, 124)
    if version == 0x0200:
        raise NotImplementedError(
            f"{path}: a v7.3 (HDF5) MAT file; this reader takes level 5 "
            f"files only")
    out: Dict[str, np.ndarray] = {}
    pos = 128
    while pos + 8 <= len(buf):
        mtype, nbytes, start, end = _tag(buf, pos, order)
        body = buf[start:start + nbytes]
        if mtype == _MI_COMPRESSED:
            inner = zlib.decompress(body)
            mtype, nbytes, start, _ = _tag(inner, 0, order)
            body = inner[start:start + nbytes]
        if mtype == _MI_MATRIX and body:
            name, arr = _matrix(body, order)
            if arr is not None:
                out[name] = arr
        pos = end
    return out
