"""Checkpoints of the learned solver in the JAX package's file format.

A checkpoint of ``bdd_tpu.learn.train.DogeTrainer.save`` (train.py:441-450)
is a pickle of ``{"config": dataclasses.asdict(TrainConfig),
"params": flax.serialization.to_bytes(variables)}``, where the variables are
``{"params": {...}}``, a tree of maps with array leaves. This module is the
port's own copy of what flax's serialization does for those files, in plain
Python and numpy:

* a msgpack reader and writer of the subset flax writes (maps, arrays, str,
  bin, ints, floats, booleans, nil, and extension type 1, an ndarray packed
  as the msgpack triple (shape, dtype name, C-order buffer); type 3, a numpy
  scalar, packed the same way); maps are written with their keys sorted, as
  flax's trees are, so a tree round trips byte for byte;
* :func:`params_from_flax` / :func:`params_to_flax`: between such a tree and
  a ``state_dict`` of ``learn.model.DogePredictor``, whose modules carry
  flax's names and shapes, so that one is the other's leaves under the same
  dotted paths.

A pickle runs code when loaded: load only checkpoints written by this
package or by the JAX package.
"""
from __future__ import annotations

import pickle
import struct
from typing import Any, Dict

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


# ------------------------------------------------------------------ reader
class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside an object")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: "B", 0xC5: "H", 0xC6: "I"}  # bin 8/16/32
        if b in sized:
            return self.take(self.unpack(sized[b]))
        strs = {0xD9: "B", 0xDA: "H", 0xDB: "I"}
        if b in strs:
            return self.take(self.unpack(strs[b])).decode("utf-8")
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                   0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            code = self.unpack("b")
            return _ext(code, self.take(fixext[b]))
        exts = {0xC7: "B", 0xC8: "H", 0xC9: "I"}
        if b in exts:
            n = self.unpack(exts[b])
            code = self.unpack("b")
            return _ext(code, self.take(n))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack("H" if b == 0xDC else "I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack("H" if b == 0xDE else "I"))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not one flax writes")

    def array(self, n: int):
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def _ndarray(data: bytes) -> np.ndarray:
    r = _Reader(data)
    shape, name, buf = r.obj()
    if isinstance(name, bytes):
        name = name.decode()
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape, order="C")


def _ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"msgpack extension type {code} is not one flax writes for these trees")


def msgpack_restore(data: bytes):
    """The tree of a ``flax.serialization.msgpack_serialize`` byte string:
    dicts with numpy array leaves (read-only views of ``data``'s copy)."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack object")
    return out


# ------------------------------------------------------------------ writer
def _pack_len(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    if n <= fix_max and fix is not None:
        out.append(fix | n)
    elif n < 1 << 8 and codes[0] is not None:
        out += bytes([codes[0]]) + struct.pack(">B", n)
    elif n < 1 << 16:
        out += bytes([codes[1]]) + struct.pack(">H", n)
    else:
        out += bytes([codes[2]]) + struct.pack(">I", n)


def _pack_int(out: bytearray, x: int) -> None:
    if 0 <= x <= 0x7F:
        out.append(x)
    elif -32 <= x < 0:
        out.append(x + 0x100)
    elif x >= 0:
        for code, fmt, top in ((0xCC, "B", 1 << 8), (0xCD, "H", 1 << 16), (0xCE, "I", 1 << 32),
                               (0xCF, "Q", 1 << 64)):
            if x < top:
                out += bytes([code]) + struct.pack(">" + fmt, x)
                return
        raise ValueError(f"integer {x} does not fit msgpack")
    else:
        for code, fmt, low in ((0xD0, "b", -(1 << 7)), (0xD1, "h", -(1 << 15)),
                               (0xD2, "i", -(1 << 31)), (0xD3, "q", -(1 << 63))):
            if x >= low:
                out += bytes([code]) + struct.pack(">" + fmt, x)
                return
        raise ValueError(f"integer {x} does not fit msgpack")


def _pack(out: bytearray, x) -> None:
    if x is None:
        out.append(0xC0)
    elif isinstance(x, bool):
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, int):
        _pack_int(out, x)
    elif isinstance(x, float):
        out += b"\xcb" + struct.pack(">d", x)
    elif isinstance(x, str):
        raw = x.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(x, (bytes, bytearray)):
        _pack_len(out, len(x), None, -1, (0xC4, 0xC5, 0xC6))
        out += x
    elif isinstance(x, (list, tuple)):
        _pack_len(out, len(x), 0x90, 15, (None, 0xDC, 0xDD))
        for v in x:
            _pack(out, v)
    elif isinstance(x, dict):
        _pack_len(out, len(x), 0x80, 15, (None, 0xDE, 0xDF))
        for k in sorted(x):
            _pack(out, k)
            _pack(out, x[k])
    elif isinstance(x, (np.ndarray, np.generic)):
        arr = np.asarray(x)
        inner = bytearray()
        _pack(inner, (list(arr.shape), arr.dtype.name, arr.tobytes("C")))
        code = _EXT_NDARRAY if isinstance(x, np.ndarray) else _EXT_NPSCALAR
        n = len(inner)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            out.append(fixext[n])
        else:
            _pack_len(out, n, None, -1, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", code)
        out += inner
    else:
        raise TypeError(f"cannot write a {type(x).__name__} to a flax checkpoint")


def msgpack_serialize(tree) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize`` writes for a tree of
    dicts with numpy array leaves (no leaf past flax's 2**30-byte chunk
    size)."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


# ----------------------------------------------------- flax tree <-> torch
def params_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``DogePredictor`` state_dict from flax variables ``{"params": ...}``
    (or the params tree itself): the leaves under their dotted paths."""
    tree = tree.get("params", tree)
    out = {}

    def walk(d, prefix):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, prefix + k + ".")
            else:
                out[prefix + k] = torch.from_numpy(np.array(v))

    walk(tree, "")
    return out


def params_to_flax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The flax variables ``{"params": ...}`` of a ``DogePredictor``
    state_dict, numpy leaves."""
    params: Dict[str, Any] = {}
    for key, v in state_dict.items():
        node = params
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.detach().cpu().numpy()
    return {"params": params}


def save(path: str, config: Dict[str, Any], state_dict: Dict[str, torch.Tensor]) -> None:
    """Write a checkpoint that ``bdd_tpu.learn.train.DogeTrainer.load`` and
    :func:`load` read."""
    blob = {"config": dict(config),
            "params": msgpack_serialize(params_to_flax(state_dict))}
    with open(path, "wb") as fh:
        pickle.dump(blob, fh)


def load(path: str):
    """(config dict, DogePredictor state_dict) of a checkpoint file."""
    with open(path, "rb") as fh:
        blob = pickle.load(fh)
    return dict(blob["config"]), params_from_flax(msgpack_restore(blob["params"]))
