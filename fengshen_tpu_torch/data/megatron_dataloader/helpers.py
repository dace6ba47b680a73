"""The host index builders of the Megatron-style datasets: the port of
``fengshen_tpu/data/megatron_dataloader/helpers.py``.

The builders are C++ (``fengshen_tpu_torch/csrc/index_helpers.cpp``, the
port's copy of the JAX package's ``native/index_helpers.cpp``), compiled
at first use by the host C++ compiler (``$CXX``, else ``c++``; flags
:data:`CXX_FLAGS`) into ``fengshen_tpu_torch/_build/`` under a name that
carries a hash of the source, the compiler and the flags, and loaded
with ``ctypes``. A failed compile or load raises
:class:`IndexHelpersError` with the compiler's output; there is no
quiet fallback (the JAX binding falls back to numpy when ``make``
fails).

:func:`build_sample_idx` (GPT sample boundaries),
:func:`build_blending_indices` (weighted corpus interleave),
:func:`build_mapping` (BERT sentence windows) and
:func:`build_blocks_mapping` (sentence blocks) call the library;
:func:`build_sample_idx_plain` and :func:`build_blending_indices_plain`
are the JAX binding's numpy fallbacks, kept to hold the library against
(nothing on a training path calls them).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parents[2]
SOURCE = PACKAGE_DIR / "csrc" / "index_helpers.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_STEM = "libindex_helpers"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: seconds the last compile took (None when the library was found built)
last_build_seconds: Optional[float] = None


class IndexHelpersError(RuntimeError):
    """The index helpers could not be compiled or loaded."""


def compiler() -> str:
    return os.environ.get("CXX") or "c++"


def library_path(source: Path = SOURCE, cxx: Optional[str] = None) -> Path:
    h = hashlib.sha256(" ".join((cxx or compiler(),) + CXX_FLAGS).encode())
    h.update(Path(source).read_bytes())
    return BUILD_DIR / f"{LIB_STEM}-{h.hexdigest()[:16]}.so"


def build(source: Path = SOURCE, cxx: Optional[str] = None,
          force: bool = False) -> Path:
    """Compile ``source`` into the build directory unless this exact
    build exists (or ``force``); returns the library's path. The object
    is written under a temporary name and renamed, so processes that
    build at once never load half a file."""
    global last_build_seconds
    cxx = cxx or compiler()
    source = Path(source)
    if not source.exists():
        raise IndexHelpersError(f"index helper source {source} is missing")
    out = library_path(source, cxx)
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=out.stem + ".",
                               suffix=".tmp.so")
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(source), "-o", tmp],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise IndexHelpersError(
            f"the C++ compiler {cxx!r} could not be run ({e}); set $CXX "
            "to a host C++ compiler") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise IndexHelpersError(
            f"{cxx} failed to compile {source} (exit {proc.returncode}):"
            f"\n{proc.stdout[:8000]}")
    os.replace(tmp, out)
    last_build_seconds = time.perf_counter() - t0
    return out


def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process and
    declare its C functions."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = build()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise IndexHelpersError(f"loading {path} failed: {e}") from e
        _declare(lib)
        _lib = lib
        return lib


def _declare(lib: ctypes.CDLL) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i8p = ctypes.POINTER(ctypes.c_int8)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.build_sample_idx.argtypes = [i32p, i32p, ctypes.c_int64,
                                     ctypes.c_int32, ctypes.c_int32,
                                     ctypes.c_int64, i32p, ctypes.c_int64]
    lib.build_sample_idx.restype = None
    lib.build_blending_indices.argtypes = [i8p, i64p, dp, ctypes.c_int32,
                                           ctypes.c_int64, ctypes.c_int32]
    lib.build_blending_indices.restype = None
    lib.build_mapping.argtypes = [i64p, ctypes.c_int64, i32p,
                                  ctypes.c_int32, ctypes.c_double,
                                  ctypes.c_int32, i64p, ctypes.c_int64]
    lib.build_mapping.restype = ctypes.c_int64
    lib.build_blocks_mapping.argtypes = [i64p, ctypes.c_int64, i32p,
                                         ctypes.c_int32, i64p,
                                         ctypes.c_int64]
    lib.build_blocks_mapping.restype = ctypes.c_int64


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _num_samples(sizes: np.ndarray, doc_idx: np.ndarray,
                 seq_length: int) -> int:
    total_tokens = int(sizes[doc_idx].sum())
    return max((total_tokens - 1) // seq_length, 1)


def build_sample_idx(sizes: np.ndarray, doc_idx: np.ndarray,
                     seq_length: int, num_epochs: int,
                     tokens_per_epoch: int) -> np.ndarray:
    """``[num_samples + 1, 2]`` int32 sample boundaries (position in
    ``doc_idx``, token offset): windows of ``seq_length + 1`` tokens,
    each starting on the last token of the one before."""
    sizes = np.ascontiguousarray(sizes, np.int32)
    doc_idx = np.ascontiguousarray(doc_idx, np.int32)
    num_samples = _num_samples(sizes, doc_idx, seq_length)
    out = np.zeros((num_samples + 1, 2), np.int32)
    load().build_sample_idx(_ptr(sizes, ctypes.c_int32),
                            _ptr(doc_idx, ctypes.c_int32), len(doc_idx),
                            seq_length, num_epochs, tokens_per_epoch,
                            _ptr(out, ctypes.c_int32), num_samples)
    return out


def build_sample_idx_plain(sizes: np.ndarray, doc_idx: np.ndarray,
                           seq_length: int, num_epochs: int,
                           tokens_per_epoch: int) -> np.ndarray:
    """:func:`build_sample_idx` in Python (the JAX binding's fallback,
    walking lists)."""
    del num_epochs, tokens_per_epoch
    sizes = np.ascontiguousarray(sizes, np.int32)
    doc_idx = np.ascontiguousarray(doc_idx, np.int32)
    num_samples = _num_samples(sizes, doc_idx, seq_length)
    out = np.zeros((num_samples + 1, 2), np.int32)
    size_of, order, n_docs = sizes.tolist(), doc_idx.tolist(), len(doc_idx)
    doc_pos, doc_offset = 0, 0
    for s in range(1, num_samples + 1):
        remaining = seq_length + 1
        while remaining > 0 and doc_pos < n_docs:
            doc_len = size_of[order[doc_pos]] - doc_offset
            if doc_len >= remaining:
                doc_offset += remaining - 1
                remaining = 0
            else:
                remaining -= doc_len
                doc_pos += 1
                doc_offset = 0
        out[s] = (doc_pos, doc_offset)
        if doc_pos >= n_docs:
            out[s + 1:] = out[s]
            break
    return out


def _normalized(weights) -> np.ndarray:
    weights = np.ascontiguousarray(weights, np.float64)
    return weights / weights.sum()


def build_blending_indices(weights, size: int, verbose: bool = False
                           ) -> tuple[np.ndarray, np.ndarray]:
    """``(dataset_index int8 [size], dataset_sample_index int64
    [size])``: each step takes the dataset whose share most lags its
    weight (the first on a tie)."""
    weights = _normalized(weights)
    dataset_index = np.zeros((size,), np.int8)
    dataset_sample_index = np.zeros((size,), np.int64)
    load().build_blending_indices(
        _ptr(dataset_index, ctypes.c_int8),
        _ptr(dataset_sample_index, ctypes.c_int64),
        _ptr(weights, ctypes.c_double), len(weights), size, int(verbose))
    return dataset_index, dataset_sample_index


def build_blending_indices_plain(weights, size: int
                                 ) -> tuple[np.ndarray, np.ndarray]:
    """:func:`build_blending_indices` in Python (the JAX binding's
    fallback, in float64 scalars)."""
    w = _normalized(weights).tolist()
    counts = [0] * len(w)
    dataset_index = np.zeros((size,), np.int8)
    dataset_sample_index = np.zeros((size,), np.int64)
    for i in range(size):
        gaps = [wd * (i + 1) - c for wd, c in zip(w, counts)]
        best = gaps.index(max(gaps))
        dataset_index[i] = best
        dataset_sample_index[i] = counts[best]
        counts[best] += 1
    return dataset_index, dataset_sample_index


def _two_pass(fn, docs, sizes, *args) -> np.ndarray:
    """Count with a null buffer, then fill ``[count, 3]`` int64."""
    docs = np.ascontiguousarray(docs, np.int64)
    sizes = np.ascontiguousarray(sizes, np.int32)
    null = ctypes.POINTER(ctypes.c_int64)()
    count = fn(_ptr(docs, ctypes.c_int64), len(docs) - 1,
               _ptr(sizes, ctypes.c_int32), *args, null, 0)
    out = np.zeros((count, 3), np.int64)
    fn(_ptr(docs, ctypes.c_int64), len(docs) - 1,
       _ptr(sizes, ctypes.c_int32), *args, _ptr(out, ctypes.c_int64), count)
    return out


def build_mapping(docs: np.ndarray, sizes: np.ndarray, max_seq_length: int,
                  short_seq_prob: float, seed: int) -> np.ndarray:
    """``[N, 3]`` int64 (start sentence, end sentence, target length)
    windows of two or more whole sentences per document; with
    ``short_seq_prob`` a window's target is drawn shorter."""
    return _two_pass(load().build_mapping, docs, sizes, max_seq_length,
                     short_seq_prob, seed)


def build_blocks_mapping(docs: np.ndarray, sizes: np.ndarray,
                         max_seq_length: int) -> np.ndarray:
    """``[N, 3]`` int64 (start sentence, end sentence, tokens) blocks of
    whole sentences up to ``max_seq_length`` tokens."""
    return _two_pass(load().build_blocks_mapping, docs, sizes,
                     max_seq_length)
