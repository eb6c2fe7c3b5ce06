"""Checkpoints in the on-disk format of `repro.train.checkpoint`, so a
directory written by either package restores in the other.

Format: one directory `step_%010d` per step holding
  manifest.msgpack   step, keys, per-leaf shapes and dtypes, user meta
  arrays.npz         leaves keyed by their "/"-joined path in the tree

A tree is a nested dict of tensors (or numpy arrays); its leaf keys are
joined with "/", so {"params": {"set_transformer/in_proj/w": t}} is saved
under "params/set_transformer/in_proj/w", the JAX package's key for the
same leaf. bf16 leaves are stored as their uint16 bits and the manifest
records "bfloat16"; on restore the bits are viewed back. (The JAX writer
records "uint16" for them, and its reader then converts the integers
instead of viewing the bits: the reader here views them whenever the
template leaf is bf16, so both packages' bf16 leaves restore.)

Guarantees, as in the JAX package:
  - ATOMIC: written to `<dir>/tmp.<step>` and published by `os.rename`,
    so restore never picks up a half-written checkpoint;
  - SELF-PRUNING: keeps the newest `keep` checkpoints.

The manifest is msgpack. The machines the port runs on need not have the
`msgpack` package, so this module carries its own encoder and decoder for
the subset a manifest uses (map, array, str, int, float, bool, nil),
giving the bytes `msgpack.packb` gives.
"""
from __future__ import annotations

import os
import shutil
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.log import get_logger

log = get_logger("repro_torch.ckpt")


# ---------------------------------------------------------------------------
# msgpack subset
# ---------------------------------------------------------------------------

def packb(obj: Any) -> bytes:
    """msgpack bytes of obj (dict, list/tuple, str, int, float, bool,
    None), as `msgpack.packb` writes them by default. Like it, raises
    TypeError on numpy integer and bool scalars: callers write plain
    Python values."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack_len(n: int, out: bytearray, fix: int, fix_max: int,
              codes: Tuple[int, ...]) -> None:
    """Header of a str/array/map of length n: fix form below fix_max, else
    the 8-bit (str only), 16-bit or 32-bit form."""
    if n < fix_max:
        out.append(fix | n)
    elif len(codes) == 3 and n < 1 << 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[-2], n)
    else:
        out += struct.pack(">BI", codes[-1], n)


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), out, 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, 0x90, 16, (0xDC, 0xDD))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, 0x80, 16, (0xDE, 0xDF))
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def _pack_int(x: int, out: bytearray) -> None:
    if 0 <= x < 128:
        out.append(x)
    elif -32 <= x < 0:
        out.append(x & 0xFF)
    elif x >= 0:
        for code, fmt, top in ((0xCC, ">BB", 1 << 8), (0xCD, ">BH", 1 << 16),
                               (0xCE, ">BI", 1 << 32),
                               (0xCF, ">BQ", 1 << 64)):
            if x < top:
                out += struct.pack(fmt, code, x)
                return
        raise OverflowError(f"int {x} too large for msgpack")
    else:
        for code, fmt, low in ((0xD0, ">Bb", -(1 << 7)),
                               (0xD1, ">Bh", -(1 << 15)),
                               (0xD2, ">Bi", -(1 << 31)),
                               (0xD3, ">Bq", -(1 << 63))):
            if x >= low:
                out += struct.pack(fmt, code, x)
                return
        raise OverflowError(f"int {x} too small for msgpack")


# fixed-size scalars: code -> struct format
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
# str / array / map with an explicit length: code -> (kind, length format)
_SIZED = {0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


def unpackb(data: bytes) -> Any:
    """Inverse of `packb` (also reads float32, as `msgpack.unpackb`
    does). Raises ValueError on anything else or on trailing bytes."""
    obj, pos = _unpack(memoryview(data), 0)
    if pos != len(data):
        raise ValueError("msgpack: trailing bytes")
    return obj


def _unpack(buf: memoryview, pos: int) -> Tuple[Any, int]:
    code = buf[pos]
    pos += 1
    if code < 0x80:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if 0x80 <= code <= 0x8F:
        return _unpack_map(buf, pos, code & 0x0F)
    if 0x90 <= code <= 0x9F:
        return _unpack_array(buf, pos, code & 0x0F)
    if 0xA0 <= code <= 0xBF:
        return _unpack_str(buf, pos, code & 0x1F)
    if code == 0xC0:
        return None, pos
    if code in (0xC2, 0xC3):
        return code == 0xC3, pos
    if code in _SCALARS:
        fmt = _SCALARS[code]
        return struct.unpack_from(fmt, buf, pos)[0], pos + struct.calcsize(fmt)
    if code in _SIZED:
        kind, fmt = _SIZED[code]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += struct.calcsize(fmt)
        return {"str": _unpack_str, "array": _unpack_array,
                "map": _unpack_map}[kind](buf, pos, n)
    raise ValueError(f"msgpack: unsupported type code 0x{code:02x}")


def _unpack_str(buf: memoryview, pos: int, n: int) -> Tuple[str, int]:
    if pos + n > len(buf):
        raise ValueError("msgpack: truncated str")
    return bytes(buf[pos:pos + n]).decode("utf-8"), pos + n


def _unpack_array(buf: memoryview, pos: int, n: int) -> Tuple[list, int]:
    items = []
    for _ in range(n):
        item, pos = _unpack(buf, pos)
        items.append(item)
    return items, pos


def _unpack_map(buf: memoryview, pos: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        key, pos = _unpack(buf, pos)
        value, pos = _unpack(buf, pos)
        out[key] = value
    return out, pos


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    if isinstance(tree, dict):
        flat: Dict[str, Any] = {}
        for key, value in tree.items():
            flat.update(_flatten(value, f"{prefix}{key}/"))
        return flat
    return {prefix[:-1]: tree}


def unflatten_like(flat: Dict[str, Any], like: Any, prefix: str = "") -> Any:
    """The nested dicts of `like`, each leaf taken from `flat` by its
    "/"-joined key: the inverse of `_flatten` for a tree shaped as
    `like`."""
    if isinstance(like, dict):
        return {k: unflatten_like(flat, v, f"{prefix}{k}/")
                for k, v in like.items()}
    return flat[prefix[:-1]]


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    """(array as stored, dtype name for the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def in_jax_key_order(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A flat dict of leaves with its keys in sorted order, the order in
    which the JAX writer flattens a dict: saved from it, a manifest lists
    its keys as the JAX package's does."""
    return dict(sorted(tree.items()))


def save_checkpoint(directory: str, step: int, tree: Any,
                    meta: Optional[Dict] = None, keep: int = 3) -> str:
    """Writes `tree` as `<directory>/step_<step>` (atomically) and keeps
    the newest `keep` checkpoints. Returns the checkpoint's path."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}")
    final = os.path.join(directory, f"step_{step:010d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat, dtypes = {}, {}
    for key, leaf in _flatten(tree).items():
        flat[key], dtypes[key] = _to_numpy(leaf)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {
        "step": step,
        "keys": list(flat),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": dtypes,
        "meta": meta or {},
    }
    with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
        f.write(packb(manifest))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic publish
    _prune(directory, keep)
    log.info("saved checkpoint step=%d -> %s", step, final)
    return final


def _prune(directory: str, keep: int) -> None:
    ckpts = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    for d in ckpts[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_checkpoint(directory: str) -> Optional[str]:
    """Path of the newest complete checkpoint in `directory`, or None."""
    if not os.path.isdir(directory):
        return None
    ckpts = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    for d in reversed(ckpts):
        path = os.path.join(directory, d)
        if os.path.exists(os.path.join(path, "manifest.msgpack")):
            return path
    return None


def read_manifest(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
        return unpackb(f.read())


def restore_checkpoint(path: str, template: Any) -> Tuple[Any, int, Dict]:
    """Restores into `template`'s structure: every leaf of the template
    is read by its key. A tensor leaf comes back as a tensor of its dtype,
    shape and device; a numpy leaf (the store's and the knowledge base's
    host arrays) as a numpy array of its dtype. Returns (tree, step,
    meta)."""
    manifest = read_manifest(path)
    with np.load(os.path.join(path, "arrays.npz")) as arrays:
        def load(tree: Any, prefix: str) -> Any:
            if isinstance(tree, dict):
                return {k: load(v, f"{prefix}{k}/") for k, v in tree.items()}
            key = prefix[:-1]
            if key not in arrays:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = arrays[key]
            if tuple(arr.shape) != tuple(tree.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape} vs "
                                 f"template shape {tuple(tree.shape)}")
            if isinstance(tree, np.ndarray):
                return np.array(arr, dtype=tree.dtype)
            if arr.dtype == np.uint16 and tree.dtype == torch.bfloat16:
                t = torch.from_numpy(arr.view(np.int16).copy()).view(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(arr))
            return t.to(device=tree.device, dtype=tree.dtype)

        tree = load(template, "")
    return tree, int(manifest["step"]), manifest.get("meta", {})
