"""The table of pieces a reshard copies, and its plain executor.

A *piece* copies one box of a source block into one box of a destination
block, bit for bit, whatever the dtype. A table (``TABLE_DTYPE``, the CUDA
kernel's ``Piece`` record field for field) names each piece's blocks by
index into two lists of tensors (``srcs``, ``dsts``) and gives its bytes:
offsets from each block's data pointer, a run of bytes contiguous in both
blocks, and up to ``MAX_DIMS - 1`` outer extents with byte strides on each
side (unused ones extent 1, stride 0). :func:`piece` builds one record from
a box in elements, merging the dims that are contiguous in both blocks
(:func:`merge_dims`); :func:`table_of` also places each piece's tiles, the
kernel's units of work, after the previous piece's (:func:`tiles`).

:func:`box_copy_ref` executes a table on any device, one
``torch.as_strided(...).copy_`` a piece over byte views of the blocks'
storages: the plain version the CUDA kernel (``csrc/box_copy.cu``) is held
against, and the route of CPU blocks and of pieces between devices.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

MAX_DIMS = 4
# bytes of one tile of the kernel: a row's chunk, or short rows packed
TILE_BYTES = 16384

TABLE_DTYPE = np.dtype([
    ("src", "<i8"), ("dst", "<i8"),                # indices into srcs / dsts
    ("src_off", "<i8"), ("dst_off", "<i8"),        # bytes from data_ptr()
    ("run", "<i8"),                 # bytes of each row, contiguous in both
    ("rows_per_tile", "<i8"),       # rows one tile covers (run < TILE_BYTES)
    ("chunks", "<i8"),              # tiles across one row (run >= TILE_BYTES)
    ("tile0", "<i8"),               # the piece's first tile
    ("ext", "<i8", (MAX_DIMS - 1,)),        # outer extents, outermost first
    ("src_stride", "<i8", (MAX_DIMS - 1,)),     # bytes
    ("dst_stride", "<i8", (MAX_DIMS - 1,)),
])


def merge_dims(extents: Sequence[int], src_strides: Sequence[int],
               dst_strides: Sequence[int], itemsize: int) -> list:
    """A box of ``extents`` elements at element strides ``src_strides`` and
    ``dst_strides``, as [(extent, source byte stride, destination byte
    stride)], outermost first: the dims of extent 1 dropped, each dim
    merged into the next where both sides step over it as one run, and
    the innermost a run of bytes at stride 1 on both sides."""
    dims = [(itemsize, 1, 1)]
    for n, s, d in zip(reversed(extents), reversed(src_strides),
                       reversed(dst_strides)):
        if n == 1:
            continue
        inner_n, inner_s, inner_d = dims[0]
        s, d = s * itemsize, d * itemsize
        if s == inner_n * inner_s and d == inner_n * inner_d:
            dims[0] = (n * inner_n, inner_s, inner_d)
        else:
            dims.insert(0, (n, s, d))
    return dims


def piece(src: int, dst: int, src_start: Sequence[int],
          extents: Sequence[int], dst_start: Sequence[int],
          src_strides: Sequence[int], dst_strides: Sequence[int],
          itemsize: int) -> tuple:
    """The table record (a tuple in TABLE_DTYPE's order, its tiles not yet
    placed) of the box of ``extents`` elements at ``src_start`` of block
    ``src`` (element strides ``src_strides``) into ``dst_start`` of block
    ``dst``. Raises where more than MAX_DIMS dims are left after
    merging."""
    dims = merge_dims(extents, src_strides, dst_strides, itemsize)
    if len(dims) > MAX_DIMS:
        raise ValueError(f"a piece of extents {tuple(extents)} at strides "
                         f"{tuple(src_strides)} -> {tuple(dst_strides)} has "
                         f"{len(dims)} dims after merging, above {MAX_DIMS}")
    outer = [(1, 0, 0)] * (MAX_DIMS - len(dims)) + dims[:-1]
    src_off = itemsize * sum(a * s for a, s in zip(src_start, src_strides))
    dst_off = itemsize * sum(a * s for a, s in zip(dst_start, dst_strides))
    return (src, dst, src_off, dst_off, dims[-1][0], 0, 0, 0,
            [n for n, _, _ in outer], [s for _, s, _ in outer],
            [d for _, _, d in outer])


def tiles(table: np.ndarray) -> np.ndarray:
    """Place each piece's tiles (``rows_per_tile``, ``chunks``, ``tile0``)
    after the previous piece's; returns the tiles of each piece. A tile is
    TILE_BYTES of one row, or whole rows packed up to that where the run is
    shorter."""
    run = table["run"]
    short = run < TILE_BYTES
    table["rows_per_tile"] = np.where(short, TILE_BYTES // np.maximum(run, 1),
                                      1)
    table["chunks"] = np.where(short, 1, -(-run // TILE_BYTES))
    rows = table["ext"].prod(axis=1)
    n = -(-rows // table["rows_per_tile"]) * table["chunks"]
    table["tile0"] = np.cumsum(n) - n
    return n


def table_of(records: Sequence[tuple]) -> np.ndarray:
    """A table of ``records`` (from :func:`piece`), its tiles placed."""
    table = np.array(list(records), dtype=TABLE_DTYPE)
    tiles(table)
    return table


def n_tiles(table: np.ndarray) -> int:
    """The tiles of a table whose tiles are placed."""
    last = table[-1]
    rows = int(last["ext"].prod())
    return int(last["tile0"]) + -(-rows // int(last["rows_per_tile"])) \
        * int(last["chunks"])


# the int64 words of a record, and those concat shifts: src, dst, tile0
WORDS = TABLE_DTYPE.itemsize // 8
SHIFTED = [TABLE_DTYPE.fields[name][1] // 8
           for name in ("src", "dst", "tile0")]


def concat(tables: Sequence[tuple]) -> np.ndarray:
    """One table of several: ``tables`` is [(table, the index of its first
    source, of its first destination, its first tile)] in the joint table;
    each piece's blocks and tiles shift by those. Done on the records' int64
    words: concatenating records promotes their fields table by table,
    milliseconds for a TrainState's leaves."""
    if len(tables) == 1 and tuple(tables[0][1:]) == (0, 0, 0):
        return tables[0][0]
    words = np.concatenate([t.view(np.int64) for t, *_ in tables]).reshape(
        -1, WORDS)
    words[:, SHIFTED] += np.repeat(np.array([b for _, *b in tables]),
                                   [len(t) for t, *_ in tables], axis=0)
    return words.reshape(-1).view(TABLE_DTYPE)


def piece_bytes(table: np.ndarray) -> np.ndarray:
    """The bytes each piece copies."""
    return table["ext"].prod(axis=1) * table["run"]


def byte_view(t: torch.Tensor) -> torch.Tensor:
    """A uint8 tensor over the whole of ``t``'s storage, on its device."""
    return torch.empty(0, dtype=torch.uint8, device=t.device).set_(
        t.untyped_storage())


def box_copy_ref(srcs: Sequence[torch.Tensor], dsts: Sequence[torch.Tensor],
                 table: np.ndarray) -> None:
    """Execute ``table``: each piece's bytes from ``srcs[src]`` into
    ``dsts[dst]``, one strided copy_ a piece, in table order. The blocks may
    lie on any device, the two sides of a piece on different ones."""
    views: dict = {}

    def view(t):
        key = id(t)
        if key not in views:
            views[key] = (byte_view(t), t.storage_offset() * t.element_size())
        return views[key]

    for rec in table:
        (sv, sbase), (dv, dbase) = view(srcs[rec["src"]]), \
            view(dsts[rec["dst"]])
        shape = [*rec["ext"].tolist(), int(rec["run"])]
        dv.as_strided(shape, [*rec["dst_stride"].tolist(), 1],
                      dbase + int(rec["dst_off"])).copy_(
            sv.as_strided(shape, [*rec["src_stride"].tolist(), 1],
                          sbase + int(rec["src_off"])))
