"""Build and load the port's CUDA kernels (posetraj_torch/csrc/*.cu).

Each source is compiled by `nvcc` for `sm_90a` into a shared library with a
plain C interface and loaded with ctypes. The build lands in `build/kernels/`
at the repository root (listed in .gitignore), named by a hash of the
sources and flags, so a changed source is rebuilt and an unchanged one is
reused. `build_all()` starts one `nvcc` per source, all at once.

Every wrapper counts its launches in `LAUNCHES[name]`: one per call that
launched its kernel on the card, none for a call that ran the plain version.
The flash library serves four counters: kernel 5's forward and backward
(`flash_fwd`, `flash_bwd`), kernel 6 (`flash_qkv`) and kernel 7
(`flash_tq`); the groupnorm library serves kernel A's one launch
(`groupnorm`) and its split form's two (`gn_stats`, `gn_apply`). The GEMM of gemm.cuh counts under `gemm` where kernels C and D
launch it (two launches a call) and where ops/gemm.py launches it alone; D's
frame attention counts under `frame_attn` in each D call and where
ops/temporal.frame_attention_kernel launches it alone.

A CUDA graph replays launches that no wrapper sees: `capturing_launches`
takes what a capture counted back out of LAUNCHES and keeps it as the
launches of one replay, and the code that replays the graph adds those with
`add_launches` once a replay. So the counts stay device launches.

A launcher writes into fresh outputs that autograd knows nothing of, so
`check_cuda` refuses a tensor that requires grad while grad mode is on: a
gradient goes through the module's `torch.autograd.Function`, never around
it.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("groupnorm", "mlp", "qkvt", "temporal", "flash", "layernorm")
COUNTERS = ("groupnorm", "gn_stats", "gn_apply", "mlp", "qkvt", "temporal", "gemm", "frame_attn", "flash_fwd",
            "flash_bwd", "flash_qkv", "flash_tq", "layernorm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

LAUNCHES: Dict[str, int] = {name: 0 for name in COUNTERS}
_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[tuple, object] = {}  # (library, entry point) -> the ctypes function, argtypes set once


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def capturing_launches():
    """Around a CUDA graph's capture, which launches nothing: yields a dict
    that holds, on exit, each counter's increase during the block (the
    launches of one replay), and takes that increase back out of LAUNCHES."""
    before = dict(LAUNCHES)
    per_replay: Dict[str, int] = {}
    try:
        yield per_replay
    finally:
        for name, n in before.items():
            per_replay[name] = LAUNCHES[name] - n
            LAUNCHES[name] = n


def add_launches(counts: Dict[str, int]) -> None:
    for name, n in counts.items():
        LAUNCHES[name] += n


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=KERNELS) -> Dict[str, float]:
    """Compile every kernel library that is missing, one nvcc process per
    source, all in parallel. Returns the wall seconds of the whole build per
    library built (0.0 for one already built). Raises with the compiler's
    output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp, out)
    times = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
        times[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return times


def build_log(name: str) -> str:
    path = BUILD_DIR / f"{name}.log"
    return path.read_text(errors="replace") if path.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        lib.pt_error_string.argtypes = [ctypes.c_int]
        lib.pt_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
Fl = ctypes.c_float
D = ctypes.c_double
LP = ctypes.POINTER(ctypes.c_longlong)


def longs(*values) -> ctypes.Array:
    """A C array of long longs (for an LP argument)."""
    return (ctypes.c_longlong * len(values))(*values)


def call(name: str, fn: str, argtypes, *args, count: str = "", also=()) -> None:
    """Call one C entry point of a kernel library on PyTorch's current
    stream (the stream is passed last) and raise if it reports a CUDA error.
    Counts one launch of `count`, by default of `name`, and the launches
    `also` names as (counter, launches) pairs."""
    import torch

    f = _FUNCS.get((name, fn))
    if f is None:
        f = getattr(library(name), fn)
        f.argtypes = list(argtypes) + [P]
        f.restype = ctypes.c_int
        _FUNCS[(name, fn)] = f
    err = f(*args, torch._C._cuda_getCurrentRawStream(torch.cuda.current_device()))
    if err != 0:
        raise RuntimeError(f"{name}.{fn}: CUDA error {err}: {library(name).pt_error_string(err).decode()}")
    LAUNCHES[count or name] += 1
    for key, n in also:
        LAUNCHES[key] += n


def ptr(t) -> P:
    return P(t.data_ptr()) if t is not None else P(0)


def check_cuda(name: str, strided: bool = False, **tensors) -> None:
    """Raise unless every given tensor is a contiguous CUDA tensor whose
    data pointer is 16-byte aligned (the kernels load 16 bytes at a time),
    and, while grad mode is on, none requires grad. With strided=True a
    tensor may be a view whose layout the caller checks itself (the flash
    forward's TMA rule, flash.tma_operand)."""
    import torch

    if torch.is_grad_enabled():
        for key, t in tensors.items():
            if t is not None and t.requires_grad:
                raise RuntimeError(f"{name}: {key} requires grad; the raw kernel would cut the gradient. "
                                   "Call the module's autograd wrapper.")
    for key, t in tensors.items():
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: {key} is on {t.device}, expected a CUDA tensor")
        if strided:
            continue
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.data_ptr() % 16 != 0:
            raise ValueError(f"{name}: {key} data pointer is not 16-byte aligned")


def check_dtype(name: str, dtype, **tensors) -> None:
    for key, t in tensors.items():
        if t is not None and t.dtype != dtype:
            raise ValueError(f"{name}: {key} has dtype {t.dtype}, expected {dtype}")
