"""Minimal reader for R ``.rda`` (RDX2/XDR) workspace files.

A copy of the JAX package's ``utils/rdata.py``, which imports only numpy:
importing it from there would load JAX through that package's root.

The reference loads its three binary datasets (animals, lastfm, paleo) with
``pyreadr`` (``examples/reproduce_magron2022.py:25-38``); that package is not
available here, so this module implements the small subset of R's
serialization format (version 2, big-endian XDR, gzip/bzip2/xz compressed)
needed to read numeric/integer/logical matrices with dim/dimnames attributes.

Format reference: R Internals manual, "Serialization Formats" (public spec).
Only the SEXP types that appear in data workspaces are handled; anything else
raises with the offending type id.
"""

from __future__ import annotations

import bz2
import gzip
import lzma
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np

__all__ = ["read_rda", "load_r_matrix"]

# SEXP type ids (R Internals).
_NILSXP = 0
_SYMSXP = 1
_LISTSXP = 2
_CHARSXP = 9
_LGLSXP = 10
_INTSXP = 13
_REALSXP = 14
_CPLXSXP = 15
_STRSXP = 16
_VECSXP = 19
_ALTREP = 238
_BASEENV = 241
_EMPTYENV = 242
_GLOBALENV = 253
_NILVALUE = 254
_REFSXP = 255

_NA_INT = -2147483648


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0
        self.refs = []  # reference table for REFSXP

    def _take(self, n: int) -> bytes:
        b = self.buf[self.pos : self.pos + n]
        if len(b) != n:
            raise ValueError("truncated RDA stream")
        self.pos += n
        return b

    def u32(self) -> int:
        return struct.unpack(">I", self._take(4))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def f64s(self, n: int) -> np.ndarray:
        return np.frombuffer(self._take(8 * n), dtype=">f8").astype(np.float64)

    def i32s(self, n: int) -> np.ndarray:
        return np.frombuffer(self._take(4 * n), dtype=">i4").astype(np.int64)

    # ------------------------------------------------------------- items
    def item(self) -> Any:
        flags = self.u32()
        typ = flags & 0xFF
        has_attr = bool(flags & 0x200)
        has_tag = bool(flags & 0x400)

        if typ == _REFSXP:
            idx = flags >> 8
            if idx == 0:
                idx = self.u32()
            return self.refs[idx - 1]
        if typ in (_NILSXP, _NILVALUE):
            return None
        if typ in (_GLOBALENV, _BASEENV, _EMPTYENV):
            return f"<env:{typ}>"
        if typ == _SYMSXP:
            name = self.item()  # CHARSXP
            self.refs.append(name)
            return name
        if typ == _CHARSXP:
            n = self.i32()
            return None if n == -1 else self._take(n).decode("utf-8", "replace")
        if typ == _LISTSXP:
            attrs = self.item() if has_attr else None
            tag = self.item() if has_tag else None
            car = self.item()
            cdr = self.item()
            del attrs
            pair: Dict[Any, Any] = {} if cdr is None else dict(cdr)
            out = {tag: car}
            out.update(pair or {})
            return out
        if typ in (_LGLSXP, _INTSXP):
            n = self.i32()
            data = self.i32s(n)
            arr = data.astype(np.float64)
            arr[data == _NA_INT] = np.nan
            return self._with_attrs(arr, has_attr)
        if typ == _REALSXP:
            n = self.i32()
            return self._with_attrs(self.f64s(n), has_attr)
        if typ == _CPLXSXP:
            n = self.i32()
            re = self.f64s(2 * n)
            return self._with_attrs(re[0::2] + 1j * re[1::2], has_attr)
        if typ == _STRSXP:
            n = self.i32()
            vals = [self.item() for _ in range(n)]
            return self._with_attrs(np.asarray(vals, dtype=object), has_attr)
        if typ == _VECSXP:
            n = self.i32()
            vals = [self.item() for _ in range(n)]
            return self._with_attrs(vals, has_attr)
        raise ValueError(f"unsupported SEXP type {typ} in RDA stream")

    def _with_attrs(self, value, has_attr: bool):
        if not has_attr:
            return value
        attrs = self.item() or {}
        dim = attrs.get("dim")
        if dim is not None and hasattr(value, "reshape"):
            shape = tuple(int(d) for d in np.asarray(dim).ravel())
            value = np.asarray(value).reshape(shape, order="F")  # R is col-major
        dimnames = attrs.get("dimnames")
        if dimnames is not None:
            return _RMatrix(value, dimnames)
        return value


class _RMatrix(np.ndarray):
    """ndarray subclass carrying R dimnames (row/col labels)."""

    def __new__(cls, arr, dimnames):
        obj = np.asarray(arr).view(cls)
        obj.dimnames = dimnames
        return obj

    def __array_finalize__(self, obj):
        self.dimnames = getattr(obj, "dimnames", None)


def _decompress(raw: bytes) -> bytes:
    if raw[:2] == b"BZ":
        return bz2.decompress(raw)
    if raw[:2] == b"\x1f\x8b":
        return gzip.decompress(raw)
    if raw[:6] == b"\xfd7zXZ\x00":
        return lzma.decompress(raw)
    return raw


def read_rda(path) -> Dict[str, Any]:
    """Read an ``.rda`` workspace; returns ``{object_name: value}`` with R
    matrices as float64 ndarrays (column-major dims honored, NA -> NaN)."""
    with open(path, "rb") as f:
        data = _decompress(f.read())
    if not data.startswith(b"RDX2\n"):
        raise ValueError(f"{path}: not an RDX2 rda file")
    r = _Reader(data[5:])
    fmt = r._take(2)
    if fmt != b"X\n":
        raise ValueError(f"only XDR serialization supported, got {fmt!r}")
    _version, _writer, _reader_min = r.u32(), r.u32(), r.u32()
    top = r.item()
    if not isinstance(top, dict):
        raise ValueError("expected a named pairlist at top level")
    return {k: v for k, v in top.items() if k is not None}


def load_r_matrix(path, name: Optional[str] = None) -> Tuple[np.ndarray, str]:
    """Load the (single) matrix stored in an ``.rda`` file.

    Returns ``(matrix, object_name)`` with the matrix as a plain float64
    ndarray.
    """
    objs = read_rda(path)
    if name is None:
        mats = {k: v for k, v in objs.items() if isinstance(v, np.ndarray) and v.ndim == 2}
        if len(mats) != 1:
            raise ValueError(f"{path}: expected one matrix, found {list(objs)}")
        name = next(iter(mats))
    return np.asarray(objs[name], dtype=np.float64), name
