"""Build and load the port's CUDA kernel library.

Every ``fengshen_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for
``sm_90a`` (one ``nvcc`` process per source, all started together), the
objects are linked into one shared library with a plain C interface, and
the library is loaded with ``ctypes``. The library's file name carries a
hash of the sources and flags, so an edited source never loads a stale
build. The build lands in ``fengshen_tpu_torch/_build/`` (listed in
``.gitignore``) at first use; a build or load failure raises
:class:`~fengshen_tpu_torch.ops.kernels.KernelError`.

Nothing here runs at import time: this module is imported on machines
without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_STEM = "libfstpu_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: what the last build printed (ptxas register/shared-memory report)
last_build_log = ""


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _fingerprint() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    from fengshen_tpu_torch.ops.kernels import KernelError
    raise KernelError("nvcc not found (neither on PATH nor under "
                      "torch's CUDA_HOME); the kernels cannot be built")


def library_path() -> Path:
    return BUILD_DIR / f"{LIB_STEM}-{_fingerprint()}.so"


def build() -> Path:
    """Compile and link the library unless this exact build exists.
    Returns its path; raises ``KernelError`` on any compiler failure."""
    global last_build_log
    from fengshen_tpu_torch.ops.kernels import KernelError

    out = library_path()
    if out.exists():
        return out
    srcs = sources()
    if not srcs:
        raise KernelError(f"no CUDA sources under {CSRC_DIR}")
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in srcs:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, obj, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise KernelError(f"nvcc failed on {failed}:\n" +
                              "\n".join(logs)[-8000:])
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp_lib), *(str(obj) for _, obj, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise KernelError(f"linking {out.name} failed:\n{link.stdout}")
        os.replace(tmp_lib, out)
    last_build_log = "\n".join(logs)
    return out


def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process and
    declare its C functions' argument types."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        from fengshen_tpu_torch.ops.kernels import KernelError
        path = build()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise KernelError(f"loading {path} failed: {e}") from e
        _declare(lib)
        _lib = lib
        return lib


def library_loaded() -> bool:
    return _lib is not None


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fstpu_decode_attention.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,          # q k v valid table out
        i32, i32, i32, i32, i32,               # B S H KVH D
        i32, i32, i32, i32,                    # lane_len bs max_blocks nb
        i32, ptr]                              # dtype code, stream
    lib.fstpu_decode_attention.restype = i32
    lib.fstpu_flash_fwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr,     # q k v seg_q seg_k out lse
        i32, i32, i32, i32, i32, i32,          # B Sq Sk H KVH D
        i32, i32, ptr]                         # causal, dtype code, stream
    lib.fstpu_flash_fwd.restype = i32
    lib.fstpu_flash_bwd_dkv.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # q k v dout lse delta segs
        ptr, ptr,                              # dk dv
        i32, i32, i32, i32, i32, i32,          # B Sq Sk H KVH D
        i32, i32, ptr]                         # causal, dtype code, stream
    lib.fstpu_flash_bwd_dkv.restype = i32
    lib.fstpu_flash_bwd_dq.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # q k v dout lse delta segs
        ptr,                                   # dq
        i32, i32, i32, i32, i32, i32,          # B Sq Sk H KVH D
        i32, i32, ptr]                         # causal, dtype code, stream
    lib.fstpu_flash_bwd_dq.restype = i32
    lib.fstpu_error_string.argtypes = [i32]
    lib.fstpu_error_string.restype = ctypes.c_char_p
