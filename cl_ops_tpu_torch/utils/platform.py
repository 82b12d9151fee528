"""Device selection and the CUDA kernel build.

Entry points run on the card unless the caller asks for the CPU:
`default_device(None)` is "cuda" and raises when CUDA is absent. Kernels are
compiled from the package's `csrc/` by `nvcc` at first CUDA use into
`build_dir()`, keyed on a hash of the source and flags, and loaded with
ctypes.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from cl_ops_tpu_torch.core.errors import CloOpsError, ErrorCode

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def has_cuda() -> bool:
    return torch.cuda.is_available()


def default_device(device=None) -> torch.device:
    """`device`, or "cuda" when None; raises when CUDA is asked for and
    absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not has_cuda():
        raise CloOpsError("CUDA device requested but torch.cuda is not "
                          "available", ErrorCode.DEVICE_NOT_FOUND)
    return dev


def launch_stream(device: torch.device) -> int:
    """The handle of `device`'s current CUDA stream, for a library that
    launches on the current device: the caller makes `device` current
    first (`torch.cuda.device`) when it is not. Read through the raw
    accessor that torch.cuda.current_stream wraps, without building a
    Stream object: a few microseconds less per launch."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def build_dir() -> Path:
    """Where built kernels go: $CL_OPS_TORCH_BUILD_DIR, else `_build/` in the
    package."""
    env = os.environ.get("CL_OPS_TORCH_BUILD_DIR")
    return Path(env) if env else _PKG_DIR / "_build"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise CloOpsError("nvcc not found (set CUDA_HOME or PATH)",
                      ErrorCode.LIBRARY)


def build_library(name: str) -> tuple[Path, str]:
    """Compile `csrc/<name>.cu` into a shared library unless a build of the
    same source and flags exists. Returns (library path, compiler log)."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib{name}-{digest}.so"
    log = out_dir / f"lib{name}-{digest}.log"
    if lib.exists():
        return lib, log.read_text() if log.exists() else ""
    tmp = out_dir / f"lib{name}-{digest}.{os.getpid()}.tmp.so"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    text = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise CloOpsError(f"nvcc failed on {src.name}:\n{text}",
                          ErrorCode.LIBRARY)
    log.write_text(text)
    os.replace(tmp, lib)
    return lib, text
