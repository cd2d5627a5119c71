"""Build and load the port's CUDA kernels.

`nvcc` compiles every source in `csrc/` for `sm_90a` (one process per
source, all started together) and links them into one shared library with
a plain C interface, which `ctypes` loads.  The build runs at first use,
never at import, into `build/torch_kernels/<digest>/` under the repository
root; the digest covers the sources and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.
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

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("ternary_matmul.cu", "fused_transform.cu", "easi_update.cu", "easi_small_32.cu",
           "easi_small_64.cu", "easi_small_128.cu", "flash_attention.cu", "flash_attention_bwd.cu",
           "attributes.cu", "errors.cu")
HEADERS = ("common.cuh", "ternary_encode.cuh", "easi_update.cuh", "easi_small.cuh",
           "flash_tc.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")
LIB_NAME = "libreprotorch_kernels.so"

# dtype codes; csrc/common.cuh holds the same table (enum DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    # name: argtypes (all entries return the cudaError_t as int)
    "repro_ternary_matmul_plan": (_I, _I, _I, _I, _I, _IP),
    "repro_ternary_matmul": (_P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P),
    "repro_fused_transform_tiles": (_I, _I, _I, _I, _I, _IP),
    "repro_fused_transform": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I,
                              _P),
    "repro_easi_apply_plan": (_I, _I, _I, _I, _I, _I, _IP),
    "repro_easi_apply": (_P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _I, _I, _I, _I, _I, _I, _P),
    "repro_flash_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I,
                              _P),
    "repro_flash_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _F, _P),
    "repro_kernel_attributes": (_I, _I, _I, _I, _I, _I, _I, _IP),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds, cwd: Path, verbose: bool) -> None:
    procs = [subprocess.Popen(c, cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
        elif verbose and out.strip():
            print(out.strip())
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def build(verbose: bool = False) -> Path:
    """Compile and link the kernels (if this digest is not built yet);
    returns the library's path."""
    final = BUILD_ROOT / _digest()
    lib = final / LIB_NAME
    if lib.exists():
        return lib
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    try:
        nvcc = nvcc_path()
        ptxas = ("-Xptxas", "-v") if verbose else ()
        objs = [tmp / (Path(s).stem + ".o") for s in SOURCES]
        _run_all([[nvcc, *NVCC_FLAGS, *ptxas, "-I", str(CSRC), "-c", str(CSRC / s),
                   "-o", str(o)] for s, o in zip(SOURCES, objs)], tmp, verbose)
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp / LIB_NAME),
                   *map(str, objs)]], tmp, verbose)
        try:
            os.rename(tmp, final)
        except OSError:        # another process finished the same build first
            if not lib.exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def library(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library (built on first use, once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build(verbose)))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_error_string.argtypes = (ctypes.c_int,)
            lib.repro_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is contiguous and on the current CUDA
    device, and that device is a Hopper card (compute capability 9.x)."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors must lie on a CUDA device or on the CPU, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices ({t.device} and {dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if dev.index is not None and dev.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors lie on {dev}, but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    major, minor = torch.cuda.get_device_capability(dev)
    if major != 9:
        raise RuntimeError(f"{name}: the kernels are built for sm_90a (Hopper); this card "
                           f"has compute capability {major}.{minor}")


def dtype_code(name: str, t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {t.dtype} not supported (float32 or bfloat16)")
    return DTYPE_CODES[t.dtype]


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def raise_on_error(name: str, rc: int) -> None:
    if rc != 0:
        msg = library().repro_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error {rc} ({msg})")
