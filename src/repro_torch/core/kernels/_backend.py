"""Device resolution and the CUDA kernel library loader.

Devices are explicit: ``None`` means the CUDA device, and asking for CUDA
where there is none raises instead of carrying on on the CPU.  There is
no environment knob that sends a CUDA tensor to a kernel's plain version:
a kernel wrapper takes the plain version only for a tensor on the CPU.

Every ``csrc/<name>.cu`` of the port (``core/kernels/csrc/`` and each
``kernels/<op>/csrc/``) builds with ``nvcc`` into its own shared library
with a plain C interface, ``build/lib<name>.so`` next to its ``csrc/``,
loaded with ``ctypes``.  Each C entry point is named after its file and
returns a ``cudaError_t``; its wrapper names the argument types.  A
library is built at its first use, or by ``build_all()`` (one ``nvcc``
per source, all started together), and is rebuilt when its source is
newer than it.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from ...dist.context import is_dtensor

PACKAGE = Path(__file__).resolve().parents[2]     # src/repro_torch
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_fns: dict[str, ctypes._CFuncPtr] = {}
_linalg_loaded = False


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` -> the CUDA device; raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is "
            "available (pass device='cpu' to run on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}; "
                         "expected 'cuda' or 'cpu'")
    return dev


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build the kernels of " + str(PACKAGE))


def sources() -> dict[str, Path]:
    """Every kernel source of the port, by entry-point name."""
    found: dict[str, Path] = {}
    for src in sorted(PACKAGE.rglob("csrc/*.cu")):
        if src.stem in found:
            raise RuntimeError(f"two kernel sources named {src.stem}: "
                               f"{found[src.stem]} and {src}")
        found[src.stem] = src
    return found


def _source(name: str) -> Path:
    src = sources().get(name)
    if src is None:
        raise RuntimeError(f"no kernel source csrc/{name}.cu in {PACKAGE}")
    return src


def _lib_path(name: str) -> Path:
    return _source(name).parent.parent / "build" / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    return (not lib.exists()
            or _source(name).stat().st_mtime > lib.stat().st_mtime)


def _start_build(name: str) -> tuple[subprocess.Popen, str]:
    """Start one nvcc into a private temp file (renamed on success, so a
    concurrent loader never maps a half-written library)."""
    build = _lib_path(name).parent
    build.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f"lib{name}.", suffix=".so",
                               dir=build)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_source(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish_build(name: str, proc: subprocess.Popen, tmp: str) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, _lib_path(name))


def build_all() -> list[str]:
    """Build every stale kernel library, one nvcc per source, in
    parallel.  Returns the names that were built."""
    names = sorted(sources())
    with _lock:
        stale = [n for n in names if _stale(n)]
        started = [(n, *_start_build(n)) for n in stale]
        for name, proc, tmp in started:
            _finish_build(name, proc, tmp)
    return stale


def load(name: str, argtypes: tuple):
    """The C entry point ``name`` of ``csrc/<name>.cu``, built if stale.
    ``argtypes``: ``ctypes.c_void_p`` for each pointer and the stream
    (a plain int would cut a pointer to 32 bits), ``ctypes.c_int`` or
    ``ctypes.c_int64`` for each integer, ``ctypes.c_float`` for a float,
    in the entry point's order."""
    fn = _fns.get(name)
    if fn is None:
        with _lock:
            fn = _fns.get(name)
            if fn is None:
                if _stale(name):
                    _finish_build(name, *_start_build(name))
                fn = getattr(ctypes.CDLL(str(_lib_path(name))), name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _fns[name] = fn
    return fn


def load_cuda_linalg(device: torch.device) -> None:
    """Load PyTorch's CUDA linear-algebra library with one locked call.
    PyTorch loads it at the first CUDA ``torch.linalg`` call of a process,
    and that first call is not thread-safe: two threads making it at once
    fail with "lazy wrapper should be called at most once" (a GP study's
    request lane and its speculative worker can)."""
    global _linalg_loaded
    if _linalg_loaded:
        return
    with _lock:
        if not _linalg_loaded:
            torch.linalg.cholesky(torch.eye(1, device=device))
            _linalg_loaded = True


def no_dtensor(op: str, *tensors) -> None:
    """Raise ``TypeError`` if a wrapper got a DTensor: it hands its
    kernel raw pointers of one device's memory, and it never runs its
    plain version in place of the kernel for one."""
    if any(is_dtensor(t) for t in tensors):
        raise TypeError(
            f"{op} takes plain tensors (its kernel gets raw pointers), got "
            "a DTensor: run it on each device's shard through "
            "torch.distributed.tensor.experimental.local_map or .to_local()")


def call(name: str, argtypes: tuple, device: torch.device, *args) -> None:
    """Launch kernel ``name`` with ``args`` and then the current stream of
    ``device`` (the last argument of every entry point); raises if the
    launch was refused."""
    fn = load(name, argtypes)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def aligned_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` if every row of it (all but the last dim) starts on a 16-byte
    boundary, as the kernels' 16-byte and TMA loads need, else a
    contiguous copy."""
    if t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:-1]):
        return t
    return torch.empty_like(t, memory_format=torch.contiguous_format).copy_(t)


_count_lock = threading.Lock()


def count_launch(fn) -> None:
    """Add one to a wrapper's plain ``launches`` integer (locked: the
    request lanes and the speculative thread launch concurrently)."""
    with _count_lock:
        fn.launches += 1
