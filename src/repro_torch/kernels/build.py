"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  Libraries land in
``build/torch_kernels/`` at the repository root, named by a hash of the
source and the flags, so an unchanged source is never rebuilt.  Nothing is built at import time:
`load` builds on first use, `build_all` starts one ``nvcc`` per source
at once, and `prefetch` starts one in the background.

A failed build, operands a kernel refuses (`OperandError`), a launch
that returns a CUDA error, or a CUDA error that surfaces later at a copy
or a read-back (`device_faults`) raises `KernelError`; no caller falls
back to the plain version or to another backend.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("aig_sim", "cim_logic", "decode_attn")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
#: Builds `prefetch` started and `load` has not waited for yet.
_PENDING: dict[str, "tuple[Path, subprocess.Popen | None]"] = {}


class KernelError(RuntimeError):
    """A hand kernel failed to build or to launch."""


class OperandError(KernelError, ValueError):
    """A kernel (or, on CPU tensors, its plain version) refuses its
    operands.  The operands are built by the port's packers, never taken
    from a circuit as they are, so a refusal is a fault of the kernel
    path on either device, and like every `KernelError` it is never
    degraded to another backend nor quarantined as a bad circuit."""


BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise KernelError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def _start(name: str) -> "tuple[Path, subprocess.Popen | None]":
    out = _lib_path(name)
    if out.exists():
        return out, None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, proc


def _finish(name: str, out: Path, proc: "subprocess.Popen | None") -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise KernelError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> dict[str, str]:
    """Build every kernel library, one ``nvcc`` per source, all started
    together.  Returns each source's compiler log (``-Xptxas -v``
    register/shared-memory report; empty when the library was cached)."""
    started = {name: _start(name) for name in SOURCES}
    return {name: _finish(name, out, proc) for name, (out, proc) in started.items()}


def prefetch(name: str) -> None:
    """Start building ``csrc/<name>.cu`` in the background unless it is
    built, loaded or building: `load` then waits for that ``nvcc``."""
    if name not in _LIBS and name not in _PENDING:
        _PENDING[name] = _start(name)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use (or
    by the build `prefetch` started)."""
    lib = _LIBS.get(name)
    if lib is None:
        out, proc = _PENDING.pop(name, None) or _start(name)
        _finish(name, out, proc)
        lib = ctypes.CDLL(str(out))
        _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise `KernelError` for a non-zero ``cudaGetLastError`` code."""
    if rc != 0:
        raise KernelError(f"{what}: CUDA error {rc} at launch")


@contextlib.contextmanager
def device_faults(what: str, device):
    """Raise `KernelError` for a CUDA error inside the block.

    A fault inside a running kernel (an illegal address, say) is
    asynchronous: it shows at the next synchronizing call, an upload or a
    read-back, as torch's ``RuntimeError`` (``torch.AcceleratorError``).
    Wrapping the upload-launch-read-back span of every kernel call in this
    turns it into `KernelError`, which no quarantine swallows.  On the CPU
    the block's errors pass through unchanged.
    """
    try:
        yield
    except KernelError:
        raise
    except RuntimeError as e:
        if device.type != "cuda":
            raise
        raise KernelError(f"{what}: {type(e).__name__}: {e}") from e
