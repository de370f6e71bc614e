"""Checkpointing: atomic, compressed, elastic-restorable.

Counterpart of ``repro.checkpoint.store``, writing the same format, so a
checkpoint written by either package restores in the other: one blob
(``RPRC0001``, the leaf count, then per leaf a JSON head with its dtype and
shape and its raw bytes), zstd-compressed under the tag ``ZSTD`` when the
``zstandard`` module is present, else tagged ``RAW0``; and a JSON manifest
(the latest step and the tree's structure). The leaves are listed as
``jax.tree.flatten`` lists them (dict keys sorted, depth first), and
bfloat16 leaves are written and read as raw 16-bit words under the name
``bfloat16``. ``restore`` places the leaves onto *any* target shardings:
restoring onto a different mesh than the one that saved is the
checkpoint-and-reconfigure malleability baseline and the failure-recovery
path.

Async saves run on a host thread (``save_async``), so the training loop
only pays the device-to-host copy, not the compression and IO.
"""
from __future__ import annotations

import json
import os
import pathlib
import struct
import threading
from typing import Any, List, Optional

import torch

from repro_torch.core.sharding import ShardedTensor, gather, place
from repro_torch.models.layers import tree_map

try:
    import zstandard as zstd
except ImportError:                                    # pragma: no cover
    zstd = None

MAGIC = b"RPRC0001"

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
           "int64": torch.int64, "uint8": torch.uint8,
           "uint32": torch.uint32, "bool": torch.bool}
_NAMES = {dt: name for name, dt in _DTYPES.items()}


def tree_flatten(tree) -> List[Any]:
    """The leaves of a tree of nested dicts in ``jax.tree.flatten``'s order:
    keys sorted, depth first."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_flatten(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """``leaves`` (in :func:`tree_flatten`'s order) in the structure of
    ``like``, its dicts' keys in ``like``'s order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            done = {k: build(t[k]) for k in sorted(t)}
            return {k: done[k] for k in t}
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def treedef_str(tree) -> str:
    """The structure as ``str(jax.tree.flatten(tree)[1])`` spells it."""
    def spec(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {spec(t[k])}"
                                   for k in sorted(t)) + "}"
        return "*"
    return f"PyTreeDef({spec(tree)})"


def to_host(x) -> torch.Tensor:
    """A leaf on the CPU: a ShardedTensor gathered, a tensor copied."""
    if isinstance(x, ShardedTensor):
        return gather(x, device="cpu")
    return x.detach().to("cpu", copy=True)


def _serialize(leaves) -> bytes:
    parts = [MAGIC, struct.pack("<I", len(leaves))]
    for t in leaves:
        head = json.dumps({"dtype": _NAMES[t.dtype],
                           "shape": list(t.shape)}).encode()
        parts.append(struct.pack("<I", len(head)))
        parts.append(head)
        raw = t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
        parts.append(struct.pack("<Q", len(raw)))
        parts.append(raw)
    blob = b"".join(parts)
    if zstd is not None:
        return b"ZSTD" + zstd.ZstdCompressor(level=3).compress(blob)
    return b"RAW0" + blob


def _deserialize(data: bytes) -> List[torch.Tensor]:
    tag, body = data[:4], data[4:]
    if tag == b"ZSTD":
        if zstd is None:
            raise RuntimeError("checkpoint is zstd-compressed and the "
                               "zstandard module is not installed")
        body = zstd.ZstdDecompressor().decompress(body)
    elif tag != b"RAW0":
        raise ValueError(f"unknown checkpoint tag {tag!r}")
    if body[:8] != MAGIC:
        raise ValueError("bad checkpoint magic")
    off = 8
    (n,) = struct.unpack_from("<I", body, off)
    off += 4
    leaves = []
    for _ in range(n):
        (hlen,) = struct.unpack_from("<I", body, off)
        off += 4
        head = json.loads(body[off:off + hlen])
        off += hlen
        (rlen,) = struct.unpack_from("<Q", body, off)
        off += 8
        dtype = _DTYPES[head["dtype"]]
        if rlen:
            t = torch.frombuffer(bytearray(body[off:off + rlen]), dtype=dtype)
        else:
            t = torch.empty(0, dtype=dtype)
        off += rlen
        leaves.append(t.reshape(head["shape"]))
    return leaves


class CheckpointStore:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # -- save -------------------------------------------------------------

    def save(self, step: int, state: Any) -> pathlib.Path:
        return self._write(step, tree_map(to_host, state))

    def save_async(self, step: int, state: Any) -> None:
        """Device-to-host copy now; compression and IO on a thread."""
        self.wait()
        host = tree_map(to_host, state)
        self._thread = threading.Thread(target=self._write,
                                        args=(step, host), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_state) -> pathlib.Path:
        blob = _serialize(tree_flatten(host_state))
        path = self.dir / f"ckpt_{step:08d}"
        tmp = path.with_suffix(".tmp")
        tmp.write_bytes(blob)
        os.replace(tmp, path)                       # atomic publish
        (self.dir / "manifest.json").write_text(json.dumps(
            {"latest": step, "treedef": treedef_str(host_state)}))
        self._gc()
        return path

    def _gc(self):
        ckpts = sorted(self.dir.glob("ckpt_*"))
        for old in ckpts[:-self.keep]:
            old.unlink()

    # -- restore ----------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        ckpts = sorted(self.dir.glob("ckpt_*"))
        if not ckpts:
            return None
        return int(ckpts[-1].name.split("_")[1])

    def restore(self, step: int, like: Any, shardings: Any = None) -> Any:
        """Restore onto the structure of ``like`` (CPU tensors); if
        ``shardings`` is given, place the leaves there (elastic restore
        onto any mesh)."""
        path = self.dir / f"ckpt_{step:08d}"
        state = tree_unflatten(like, _deserialize(path.read_bytes()))
        if shardings is not None:
            state = tree_map(place, state, shardings)
        return state
