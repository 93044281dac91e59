"""Build, load and count the port's hand-written CUDA kernels.

Each CUDA C++ source under ``csrc/`` has plain C entry points (one per
kernel; ``windowed_attn_bwd.cu`` holds two, ``decode_attn.cu`` and
``embedding_bag.cu`` one per mode). At first use it is compiled with
``nvcc`` for ``sm_90a`` into a shared library under the repository's
``build/kernels/`` (git-ignored),
named by a hash of its source and flags, and loaded with ``ctypes``.
Nothing is built at import time: the CPU tests import every module, and
the CPU has no ``nvcc``.

Tile sizes are fixed in each source (the reference's autotune tables are
TPU VMEM heuristics and are re-derived for sm_90 in a later PR).

``LAUNCHES`` counts, per kernel (entry point; the wide geometries of
kernels 1-4, ``windowed_attn_192``, ``windowed_attn_dq_192``,
``windowed_attn_dkv_192`` and ``decode_attn_mla_576``, under keys of their
own), the launches its wrapper made; a run
resets it with ``reset_launches`` to show which kernels a path went
through. The plain-PyTorch versions never count.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("windowed_attn", "windowed_attn_bwd", "decode_attn",
           "embedding_bag")
KERNELS = ("windowed_attn", "windowed_attn_dq", "windowed_attn_dkv",
           "decode_attn", "decode_attn_q8", "decode_attn_mla",
           "decode_attn_mla_q8", "embedding_bag", "embedding_bag_q8",
           "windowed_attn_192", "decode_attn_mla_576",
           "decode_attn_mla_576_q8", "windowed_attn_dq_192",
           "windowed_attn_dkv_192")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile the named sources that are not built yet, one ``nvcc`` per
    source, all started together. Returns each new build's compiler output
    (the ``-Xptxas -v`` report of registers, shared memory and spills);
    raises if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd: List[str] = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                          str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}:\n{logs[name]}")
        else:
            tmp.replace(out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str, argtypes: Dict[str, list]) -> ctypes.CDLL:
    """Build (if needed) and load source ``name``, declaring each entry
    point's argument types (``c_void_p`` for pointers and the stream) and
    its ``int`` return, the ``cudaError_t`` of the launch."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, types in argtypes.items():
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def as_i32(t):
    """An int32 contiguous copy of an index or flag operand (None stays)."""
    return None if t is None else t.to(torch.int32).contiguous()


def ptr(t):
    """A tensor's device address for ctypes; None passes a null pointer."""
    return None if t is None else t.data_ptr()


_SM_COUNT: Dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device (cached)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def check_launch(name: str, rc: int) -> None:
    """Raise on a refused or failed launch, else count it."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1


__all__ = ["CSRC", "BUILD_DIR", "SOURCES", "KERNELS", "LAUNCHES",
           "reset_launches", "library_path", "build", "load", "as_i32", "ptr",
           "sm_count", "check_launch"]
