"""Device resolution and the CUDA kernel library loader.

Devices are explicit: ``None`` means the CUDA device, and asking for CUDA
where there is none raises instead of carrying on on the CPU.  There is
no environment knob that sends a CUDA tensor to a kernel's plain version:
a kernel wrapper takes the plain version only for a tensor on the CPU.

Each ``csrc/<name>.cu`` builds with ``nvcc`` into its own shared library
with a plain C interface (``build/lib<name>.so`` next to ``csrc/``),
loaded with ``ctypes``.  A library is built at its first use, or by
``build_all()`` (one ``nvcc`` per source, all started together), and is
rebuilt when its source is newer than it.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_fns: dict[str, ctypes._CFuncPtr] = {}


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
                       "build the kernels in " + str(CSRC))


def _lib_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    src = CSRC / f"{name}.cu"
    return not lib.exists() or src.stat().st_mtime > lib.stat().st_mtime


def _start_build(name: str) -> tuple[subprocess.Popen, str]:
    """Start one nvcc into a private temp file (renamed on success, so a
    concurrent loader never maps a half-written library)."""
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f"lib{name}.", suffix=".so",
                               dir=BUILD)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
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
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with _lock:
        stale = [n for n in names if _stale(n)]
        started = [(n, *_start_build(n)) for n in stale]
        for name, proc, tmp in started:
            _finish_build(name, proc, tmp)
    return stale


# every entry point: (in0, in1, out, rows0, rows1, k, stream) -> cudaError_t
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def load(name: str):
    """The C entry point ``name`` of ``csrc/<name>.cu``, built if stale."""
    fn = _fns.get(name)
    if fn is not None:
        return fn
    with _lock:
        fn = _fns.get(name)
        if fn is None:
            if _stale(name):
                _finish_build(name, *_start_build(name))
            lib = ctypes.CDLL(str(_lib_path(name)))
            fn = getattr(lib, name)
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
            _fns[name] = fn
    return fn


def launch(name: str, in0: torch.Tensor, in1: torch.Tensor,
           out: torch.Tensor) -> None:
    """Launch kernel ``name`` on the current stream of ``out``'s device;
    raises if the launch was refused."""
    fn = load(name)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = fn(in0.data_ptr(), in1.data_ptr(), out.data_ptr(),
                 in0.shape[0], in1.shape[0], in0.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def check_cuda_operand(t: torch.Tensor, name: str, ndim: int) -> None:
    """Raise unless ``t`` is what the CUDA kernels take: a contiguous
    float32 tensor of rank ``ndim`` on a CUDA device."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be on a CUDA device, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_count_lock = threading.Lock()


def count_launch(fn) -> None:
    """Add one to a wrapper's plain ``launches`` integer (locked: the
    request lanes and the speculative thread launch concurrently)."""
    with _count_lock:
        fn.launches += 1
