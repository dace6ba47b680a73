"""Memory-mapped token storage (``.idx`` + ``.bin``): the port of
``fengshen_tpu/data/megatron_dataloader/indexed_dataset.py``, byte for
byte the same files.

A corpus is built once by :class:`MMapIndexedDatasetBuilder` and read
through ``np.memmap`` by :class:`MMapIndexedDataset`, so a large corpus
never loads into memory. Format (little-endian):

- ``.idx``: magic ``b'FSTPUIDX'`` | version u64 | dtype code u8 |
  n_sequences u64 | n_docs u64 | sizes i32[n_sequences] |
  pointers i64[n_sequences] | doc_idx i64[n_docs + 1]
- ``.bin``: the token arrays back to back.
"""

from __future__ import annotations

import os
import struct
from typing import Optional, Union

import numpy as np

_MAGIC = b"FSTPUIDX"
_VERSION = 1

_DTYPES = {1: np.uint8, 2: np.int8, 3: np.int16, 4: np.int32,
           5: np.int64, 6: np.float32, 7: np.float64, 8: np.uint16}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def data_file_path(prefix: str) -> str:
    return prefix + ".bin"


def index_file_path(prefix: str) -> str:
    return prefix + ".idx"


class MMapIndexedDatasetBuilder:
    """Appends sequences (:meth:`add_item`, or :meth:`add_items` in
    bulk) and document boundaries (:meth:`end_document`,
    :meth:`end_documents`) to ``<out_file>.bin``; :meth:`finalize` writes
    ``<out_file>.idx`` (:45)."""

    def __init__(self, out_file: str, dtype=np.int32):
        self._data = open(data_file_path(out_file), "wb")
        self._prefix = out_file
        self._dtype = np.dtype(dtype)
        self._sizes: list = []
        self._doc_idx: list = [0]

    def add_item(self, tokens) -> None:
        arr = np.asarray(tokens, dtype=self._dtype)
        self._data.write(arr.tobytes(order="C"))
        self._sizes.append(len(arr))

    def end_document(self) -> None:
        self._doc_idx.append(len(self._sizes))

    def add_items(self, tokens, sizes) -> None:
        """Append ``len(sizes)`` sequences at once from ``tokens``, which
        holds them back to back: the bytes of one :meth:`add_item` per
        sequence, for corpora made in bulk."""
        arr = np.ascontiguousarray(tokens, dtype=self._dtype).reshape(-1)
        sizes = np.asarray(sizes, np.int64)
        if int(sizes.sum()) != arr.size:
            raise ValueError(f"sizes add up to {int(sizes.sum())} tokens, "
                             f"tokens holds {arr.size}")
        self._data.write(arr.tobytes(order="C"))
        self._sizes.extend(sizes.tolist())

    def end_documents(self, counts) -> None:
        """Close one document per entry of ``counts``, each of that many
        of the sequences after the last boundary, in order: one
        :meth:`end_document` per document."""
        ends = self._doc_idx[-1] + np.cumsum(np.asarray(counts, np.int64))
        if len(ends) and int(ends[-1]) > len(self._sizes):
            raise ValueError(f"documents end at sequence {int(ends[-1])}, "
                             f"{len(self._sizes)} were added")
        self._doc_idx.extend(ends.tolist())

    def merge_file_(self, another_prefix: str) -> None:
        """Append every sequence and document boundary of the corpus at
        ``another_prefix``."""
        other = MMapIndexedDataset(another_prefix)
        offset = len(self._sizes)
        for i in range(len(other)):
            self.add_item(other[i])
        for d in other.doc_idx[1:]:
            self._doc_idx.append(int(d) + offset)

    def finalize(self) -> None:
        self._data.close()
        sizes = np.asarray(self._sizes, np.int32)
        pointers = np.zeros(len(sizes), np.int64)
        np.cumsum(sizes[:-1] * self._dtype.itemsize, out=pointers[1:])
        with open(index_file_path(self._prefix), "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<Q", _VERSION))
            f.write(struct.pack("<B", _DTYPE_CODES[self._dtype]))
            f.write(struct.pack("<Q", len(sizes)))
            f.write(struct.pack("<Q", len(self._doc_idx) - 1))
            f.write(sizes.tobytes())
            f.write(pointers.tobytes())
            f.write(np.asarray(self._doc_idx, np.int64).tobytes())


class MMapIndexedDataset:
    """Sequence ``i`` of the corpus at ``prefix`` as a read-only array
    view of the mapped ``.bin`` (:83); ``doc_idx`` holds the first
    sequence of each document and the end."""

    def __init__(self, prefix: str):
        with open(index_file_path(prefix), "rb") as f:
            magic = f.read(len(_MAGIC))
            if magic != _MAGIC:
                raise ValueError(f"bad index magic in {prefix}.idx")
            (version,) = struct.unpack("<Q", f.read(8))
            if version != _VERSION:
                raise ValueError(f"unsupported index version {version}")
            (dtype_code,) = struct.unpack("<B", f.read(1))
            (n_seq,) = struct.unpack("<Q", f.read(8))
            (n_docs,) = struct.unpack("<Q", f.read(8))
            self._dtype = np.dtype(_DTYPES[dtype_code])
            offset = f.tell()
        idx_buffer = np.memmap(index_file_path(prefix), mode="r",
                               dtype=np.uint8)
        self.sizes = idx_buffer[offset:offset + 4 * n_seq].view(np.int32)
        offset += 4 * n_seq
        self._pointers = idx_buffer[offset:offset + 8 * n_seq].view(np.int64)
        offset += 8 * n_seq
        self.doc_idx = idx_buffer[offset:offset + 8 * (n_docs + 1)].view(
            np.int64)
        self._data = np.memmap(data_file_path(prefix), mode="r",
                               dtype=np.uint8)
        self._prefix = prefix

    def __len__(self) -> int:
        return len(self.sizes)

    def __getitem__(self, idx: Union[int, slice]):
        if isinstance(idx, slice):
            return [self[i] for i in range(*idx.indices(len(self)))]
        ptr = int(self._pointers[idx])
        size = int(self.sizes[idx])
        return self._data[ptr:ptr + size * self._dtype.itemsize].view(
            self._dtype)

    def get(self, idx: int, offset: int = 0,
            length: Optional[int] = None) -> np.ndarray:
        """A part of sequence ``idx``: ``length`` tokens from
        ``offset`` (to its end when ``length`` is None)."""
        full = self[idx]
        if length is None:
            length = len(full) - offset
        return full[offset:offset + length]

    @staticmethod
    def exists(prefix: str) -> bool:
        return os.path.exists(index_file_path(prefix)) and \
            os.path.exists(data_file_path(prefix))
