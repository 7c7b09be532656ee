"""Build the CUDA sources under ``repro_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` (Hopper) into ``build/repro_torch/`` at
the repository root and loaded with ``ctypes``.  A library is built at first
use and keyed on a hash of its source, the headers beside it and the
compiler flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("collide", "flash_attn", "flash_attn_bwd", "nebb_pass", "stream_collide")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then PATH, then
    ``/usr/local/cuda``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns the
    process (or None), its temporary output and the library path."""
    out = library_path(name)
    if out.exists():
        return None, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    return start_nvcc(CSRC / f"{name}.cu", tmp), tmp, out


def start_nvcc(src: Path, out: Path | str) -> subprocess.Popen:
    """Start nvcc on ``src`` with ``NVCC_FLAGS``, writing the library to
    ``out``; the process's stdout is the compiler log."""
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc, tmp: str, out: Path) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)            # atomic: concurrent builders agree
    out.with_suffix(".log").write_text(log)
    return log


def build_all(names=SOURCES) -> dict[str, str]:
    """Build every library that is missing, one nvcc per source, all
    started together.  Returns each source's compiler log (``-Xptxas -v``:
    registers, shared memory and spills per kernel); empty when the library
    was already built."""
    started = {name: _start(name) for name in names}
    logs, errors = {}, []
    for name in names:                # wait for every nvcc before raising
        try:
            logs[name] = _finish(name, *started[name])
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _LOADED:
        _finish(name, *_start(name))
        lib = ctypes.CDLL(str(library_path(name)))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return _LOADED[name]


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


# the C entry points' dtype argument (each entry point takes a subset)
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
LBM_DTYPES = (torch.float32, torch.float64)


def check_tensor(x: torch.Tensor, name: str, device: torch.device,
                 dtype=None, shape=None) -> None:
    """Raise unless ``x`` is a contiguous tensor of ``dtype``/``shape`` on
    ``device`` — what a kernel may be handed as a raw pointer."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if dtype is not None and x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(x: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr() if x is not None else None)


def stream(device: torch.device) -> ctypes.c_void_p:
    """The current CUDA stream of ``device``, for a launch function."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
