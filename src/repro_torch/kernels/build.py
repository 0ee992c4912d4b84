"""Build and bind the port's CUDA kernels (``kernels/csrc/*.cu``).

The sources have a plain C interface (no PyTorch headers), so each compiles
in seconds. At first use ``lib()`` compiles every ``.cu`` file with its own
``nvcc`` process, all started together, links the objects into one shared
library for ``sm_90a`` and loads it with ``ctypes``. The library lands in
``kernels/_build/`` under a name derived from the hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is reused.

Every C entry point launches on the stream it is given, on the current
device, and returns ``cudaGetLastError()``. The wrappers go through
``launch``, which makes the operands' card current, passes its current
stream, raises on a non-zero code and then counts the launch: ``LAUNCHES``
counts, per kernel, the launches its wrapper made. The offload plane
launches from several worker threads at once, so the count is taken under a
lock. While a thread captures a CUDA graph (``recording_launches``) its
wrappers record into the capture instead: a captured launch runs only when
the graph is replayed, and each replay credits the recorded counts
(runtime/aot.py).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

KERNELS = ("blind_encode", "limb_matmul", "limb_matmul_fused", "limb_fold",
           "blind", "unblind", "flash_attention", "flash_attention_bwd")
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
_launch_lock = threading.Lock()
_capture = threading.local()

_P = ctypes.c_void_p
_SIGNATURES = {
    # name: argtypes (pointers and the stream as void*, sizes as ints)
    "repro_blind_encode": (_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, _P),
    "repro_limb_matmul": (_P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_int, _P),
    "repro_limb_matmul_fused": (_P, _P, _P, _P, _P, ctypes.c_longlong,
                                ctypes.c_int, ctypes.c_int, _P),
    "repro_limb_fold": (_P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_int, _P),
    "repro_blind": (_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P),
    "repro_unblind": (_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P),
    # q, k, v, out, lse (or None), the decode route's workspace (or None),
    # dtype, B, Sq, Skv, H, KH, D, Dv, causal, the query offset, the
    # window (0: none), the decode route's split count (0 on the prefill
    # route), the (b, s, h) element strides of q, k and v, the score scale,
    # the stream
    "repro_flash_attention": (_P,) * 6 + (ctypes.c_int,) * 12
                             + (ctypes.c_longlong,) * 9
                             + (ctypes.c_float, _P),
    # q, k, v, out, dout, lse, the Drow scratch, dq, dk, dv, then as the
    # forward from dtype to the window (no split count)
    "repro_flash_attention_bwd": (_P,) * 10 + (ctypes.c_int,) * 11
                                 + (ctypes.c_longlong,) * 9
                                 + (ctypes.c_float, _P),
}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
build_seconds: Optional[float] = None


def reset_launches() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def count_launch(name: str, n: int = 1) -> None:
    """Add ``n`` launches of kernel ``name`` (thread-safe); on a thread
    inside ``recording_launches`` they go to its record instead."""
    record = getattr(_capture, "record", None)
    if record is not None:
        record[name] += n
        return
    with _launch_lock:
        LAUNCHES[name] += n


@contextmanager
def recording_launches() -> Iterator[Dict[str, int]]:
    """Record, not count, this thread's launches for the extent of the
    block (a CUDA-graph capture); yields the per-kernel record."""
    prev = getattr(_capture, "record", None)
    record = {name: 0 for name in KERNELS}
    _capture.record = record
    try:
        yield record
    finally:
        _capture.record = prev


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit that builds the port's kernels")
    return found


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (``cuobjdump``, ``cu++filt``) beside
    the nvcc that builds the kernels."""
    path = Path(nvcc_path()).parent / name
    if not path.is_file():
        raise RuntimeError(f"{name} not found beside {nvcc_path()}")
    return str(path)


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (one nvcc each, in parallel) and link them into
    one shared library; reuse it when the sources are unchanged."""
    global build_seconds
    out = BUILD_DIR / f"librepro_kernels_{_digest()}.so"
    if out.is_file():
        build_seconds = 0.0
        return out
    t0 = time.perf_counter()
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        sources = sorted(CSRC.glob("*.cu"))
        procs = [(src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
             str(tmp / (src.stem + ".o"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src in sources]
        failed = []
        for src, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
        lib_tmp = tmp / "lib.so"
        subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib_tmp),
                        *(str(tmp / (s.stem + ".o")) for s in sources)],
                       check=True, capture_output=True, text=True)
        os.replace(lib_tmp, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            handle.repro_cuda_error_string.argtypes = [ctypes.c_int]
            handle.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        msg = lib().repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{code} ({msg})")


def launch(name: str, t: torch.Tensor, *args) -> None:
    """Call the C entry ``repro_<name>`` with ``args`` and the current
    stream of ``t``'s card, that card current (a launch goes to the current
    device, and a kernel's shared-memory limit is set per device); raise on
    a CUDA error, else count one launch of ``name``."""
    other = t.device.index != torch.cuda.current_device()
    with torch.cuda.device(t.device) if other else nullcontext():
        code = getattr(lib(), f"repro_{name}")(
            *args, torch.cuda.current_stream(t.device).cuda_stream)
    check(code, name)
    count_launch(name)


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            device: torch.device, ndim: Optional[int] = None) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{ndim} dimensions")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when a kernel can copy it in 16-byte chunks (the last
    dim unit-stride, the start and every other stride a multiple of 16
    bytes); else a contiguous copy, whose fresh storage is aligned."""
    size = t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s * size % 16 == 0 for s in t.stride()[:-1])):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (the wrapper takes the plain version); raises
    for a device that has no kernel here."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return False
