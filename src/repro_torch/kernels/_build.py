"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for Hopper (`sm_90a`) into a
shared library with a plain C interface and loaded with `ctypes` (no
PyTorch headers, so a file builds in seconds).  Builds happen at first
use, into `<repo>/build/kernels/`, under a name keyed by a hash of the
sources and flags, so a changed source rebuilds and an unchanged one is
reused.  `build_all` starts one `nvcc` per source at once and waits for
all of them.

Nothing here runs at import time: the CPU tests import every module of
the package, and this machine has no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")

#: Every kernel source of the port, by library name.
KERNELS = ("decode_attention", "flash_attention", "moe_gemm", "rglru",
           "rmsnorm", "wkv6")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

#: Arguments of the two prefill-attention entry points (the same C
#: signature: pointers, shapes, strides, mask and scale, stream).
_ATTN = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
         _L, _L, _L, _L, _L, _L, _L, _L, _L, _I, _I, _F, _F, _P]

#: C signature of each entry point, by symbol (all return a cudaError_t).
#: A library's default entry point is `<name>_launch`; flash_attention also
#: has `flash_attention_tc_launch` (the bf16 tensor-core route), moe_gemm
#: `moe_gemm_decode_launch` (bf16 at C <= 8, with its plan),
#: `moe_gemm_dx_launch` and `moe_gemm_dw_launch` (the bf16 backward's
#: products, operands in place) and `moe_transpose_launch` (the fp32
#: backward's transposed operands), rglru `rglru_gated_launch` (the gate
#: arithmetic folded in) and `rglru_gated_bwd_launch` (its backward: the
#: sequence in chunks, two kernel launches, the sums over B and the chunks
#: in the second), rmsnorm `rmsnorm_bwd_launch` (the backward, its column
#: sum in the same launch), wkv6 `wkv6_bwd_launch` (the backward in chunked
#: form, du's sum over the batch in the same launch) and
#: `wkv6_bwd_occupancy` (CTAs of that kernel an SM holds; not a launch).
SIGNATURES = {
    "decode_attention_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _I, _I, _I, _L, _L, _L, _L, _L, _L, _L,
                                _L, _F, _P],
    "flash_attention_launch": _ATTN,
    "flash_attention_tc_launch": _ATTN,
    "moe_gemm_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "moe_gemm_decode_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "moe_gemm_dx_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "moe_gemm_dw_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "moe_transpose_launch": [_P, _P, _I, _I, _I, _I, _I, _P],
    "rglru_launch": [_P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _P],
    "rglru_gated_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _L, _L, _I, _P],
    "rglru_gated_bwd_launch": [_P] * 18 + [_I, _I, _I, _I, _I, _L, _L, _P],
    "rmsnorm_launch": [_P, _P, _P, _I, _I, _I, _L, _I, _I, _I, _F, _P],
    "rmsnorm_bwd_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _L,
                           _I, _I, _I, _I, _I, _I, _F, _P],
    "wkv6_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L,
                    _L, _L, _I, _P],
    "wkv6_bwd_launch": [_P] * 14 + [_I, _I, _I, _I, _I, _L, _L, _L, _I,
                                    _P],
    "wkv6_bwd_occupancy": [_I, _I, _I, _P],
}

_LOADED: Dict[Tuple[str, str], object] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and /usr/local/cuda/bin); the "
            "port's CUDA kernels are built from source at first use")
    return path


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = KERNELS) -> List[Path]:
    """Compile every library in `names` that is not built yet, one `nvcc`
    process per source, all started together.  Returns the library paths.
    The compiler's `-Xptxas -v` report (registers, shared memory, spills)
    is kept beside each library as `<lib>.log`."""
    names = list(names)
    paths = [_library_path(n) for n in names]
    todo = [(n, p) for n, p in zip(names, paths) if not p.exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, path in todo:
        tmp = path.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, path, tmp, proc in procs:
        out, _ = proc.communicate()
        path.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str, symbol: Optional[str] = None):
    """The ctypes entry point `symbol` (default `<name>_launch`) of library
    `name`, building the library if needed."""
    symbol = symbol or f"{name}_launch"
    fn = _LOADED.get((name, symbol))
    if fn is None:
        (path,) = build_all([name])
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = SIGNATURES[symbol]
        fn.restype = ctypes.c_int
        _LOADED[(name, symbol)] = fn
    return fn


def check(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


#: dtype codes of the C entry points (common.cuh).
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor) -> int:
    """The C dtype code of `t`, raising for a type no kernel takes."""
    try:
        return _DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}"
                        ) from None


def records(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a call on `tensors` (a wrapper then goes
    through its kernel's autograd Function)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def stream() -> int:
    """PyTorch's current CUDA stream as a raw handle."""
    return torch.cuda.current_stream().cuda_stream


#: Zeroed ticket counters of the kernels that finish a cross-CTA sum in
#: the same launch (`last_to_arrive`, common.cuh), by (device, stream):
#: each launch leaves the counters it used at zero for the next launch on
#: its stream, and launches on one stream run in order.
_TICKETS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def tickets(device: torch.device, n: int) -> torch.Tensor:
    """At least `n` zeroed int32 ticket counters for a launch on the
    current stream of `device`."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t
