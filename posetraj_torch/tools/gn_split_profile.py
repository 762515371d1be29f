"""Phase profile of kernel A's split form on the card, where ncu does not run.

csrc/groupnorm.cu built with -DPT_GN_STAMPS writes %globaltimer at the
phase boundaries of gn_stats and gn_apply (thread 0 of each CTA). This tool
builds that library under build/kernels/, sends ops/groupnorm's split-form
launches to it, runs the statistics and the apply launch at one shape with
L2 cold (a write of FLUSH_BYTES just before the call) and warm (the same
call just before), and prints for each phase boundary its spread over the
CTAs in microseconds from the first CTA's start (min, median, 90th
percentile, max): where the launch's time goes, CTA by CTA.

    python -m posetraj_torch.tools.gn_split_profile [--shape 14,72,32,320] [--frames 0] [--calls 2]
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import subprocess

import numpy as np
import torch

from posetraj_torch.ops import _native, groupnorm

STATS_PHASES = ("start", "first piece in", "rows summed", "partials written", "arrived", "sums written")
APPLY_PHASES = ("start", "first piece in", "last store issued", "end")
STAMP_CTAS = 4096  # csrc/groupnorm.cu kStampCtas
FLUSH_BYTES = 256 * 2**20


def build() -> str:
    """The stamped groupnorm library, built if missing (named by a hash of
    the sources and flags, as ops/_native names its builds)."""
    flags = (*_native.NVCC_FLAGS, "-DPT_GN_STAMPS")
    src = _native.CSRC / "groupnorm.cu"
    h = hashlib.sha256(" ".join(flags).encode())
    for f in sorted(_native.CSRC.glob("*.cuh")) + [src]:
        h.update(f.read_bytes())
    out = _native.BUILD_DIR / f"libgroupnorm_stamps-{h.hexdigest()[:16]}.so"
    if not out.exists():
        _native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_native._nvcc(), *flags, "-o", str(out), str(src)], check=True, capture_output=True)
    return str(out)


@contextlib.contextmanager
def stamped_library():
    """Inside the block, ops/groupnorm launches the stamped library."""
    lib = ctypes.CDLL(build())
    lib.pt_error_string.argtypes = [ctypes.c_int]
    lib.pt_error_string.restype = ctypes.c_char_p
    name = groupnorm.NAME
    saved = (_native._LIBS.get(name), {k: v for k, v in _native._FUNCS.items() if k[0] == name},
             dict(groupnorm._SPLIT_OCCUPANCY))

    def swap(library, funcs, occupancy):
        for k in [k for k in _native._FUNCS if k[0] == name]:
            del _native._FUNCS[k]
        _native._FUNCS.update(funcs)
        if library is None:
            _native._LIBS.pop(name, None)
        else:
            _native._LIBS[name] = library
        groupnorm._SPLIT_OCCUPANCY.clear()
        groupnorm._SPLIT_OCCUPANCY.update(occupancy)
        groupnorm._split_plan.cache_clear()

    swap(lib, {}, {})
    try:
        yield lib
    finally:
        swap(*saved)


def stamps(lib) -> np.ndarray:
    """(kernel, CTA, phase) nanoseconds of the last launch of each kernel."""
    buf = np.zeros((2, STAMP_CTAS, 8), dtype=np.uint64)
    err = lib.pt_group_norm_stamps(ctypes.c_void_p(buf.ctypes.data))
    if err:
        raise RuntimeError(f"pt_group_norm_stamps: CUDA error {err}")
    return buf.astype(np.int64)


def spread(t: np.ndarray, names) -> str:
    """Each phase's stamps over the CTAs: min/median/p90/max microseconds
    from the first CTA's start."""
    rel = (t - t[:, 0].min()) / 1e3
    cols = [f"{n} {'/'.join(f'{np.percentile(rel[:, i], q):.2f}' for q in (0, 50, 90, 100))}"
            for i, n in enumerate(names)]
    return " | ".join(cols)


def profile(shape, frames: int, calls: int) -> list:
    """Prints and returns [(kernel, "cold" or "warm", call, stamps (CTAs,
    phases) in ns)] of `calls` calls of each mode."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    c = shape[-1]
    x = (torch.randn(*shape, generator=g, device=dev) + 0.5).to(torch.bfloat16)
    w = torch.rand(c, generator=g, device=dev) + 0.5
    b = torch.randn(c, generator=g, device=dev) * 0.1
    add_shape = (shape[0], frames, c) if frames else (shape[0], c)
    add = torch.randn(*add_shape, generator=g, device=dev).to(torch.bfloat16)
    n, s = shape[0], x.numel() // (shape[0] * c)
    flush_buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    card = torch.cuda.get_device_name(dev)
    with stamped_library() as lib:
        occ = groupnorm.split_occupancy(dev, x.dtype)
        grids = [groupnorm.split_grid(n, s, c, x.element_size(), o, groupnorm._sms(dev)) for o in occ]
        print(f"{tuple(shape)} bf16 +{'per-frame' if frames else 'per-sample'} addend on {card}: grids {grids} "
              f"(CTAs an SM {occ}); microseconds from the first CTA's start, min/median/p90/max over CTAs")
        stats = lambda: groupnorm.group_norm_stats_kernel(x, 32, add)
        sums = stats()
        apply = lambda: groupnorm.group_norm_apply_kernel(x, w, b, sums, 32, 1e-5, True, add)
        records = []
        for mode in ("cold", "warm"):
            for i in range(calls):
                for kernel, fn, names in ((0, stats, STATS_PHASES), (1, apply, APPLY_PHASES)):
                    fn()
                    torch.cuda.synchronize()
                    if mode == "cold":
                        flush_buf.add_(1.0)
                        torch.cuda.synchronize()
                    fn()
                    torch.cuda.synchronize()
                    t = stamps(lib)[kernel, : min(grids[kernel], STAMP_CTAS), : len(names)]
                    label = ("gn_stats", "gn_apply")[kernel]
                    print(f"  {label} {mode} {i}: {spread(t, names)}", flush=True)
                    records.append((label, mode, i, t))
    return records


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--shape", default="14,72,32,320", help="x's shape, channels last")
    ap.add_argument("--frames", type=int, default=0, help="a per-frame addend of this many frames (0: per sample)")
    ap.add_argument("--calls", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gn_split_profile: needs an NVIDIA GPU")
    profile(tuple(int(v) for v in args.shape.split(",")), args.frames, args.calls)


if __name__ == "__main__":
    main()
