"""Time the Freivalds fold kernel's main loop under several block tilings on
one NVIDIA GPU, at the fold shapes of the port's main paths.

The fold (``src/repro_torch/kernels/csrc/limb_fold.cu``) runs the shared
tensor-core main loop of ``limb_mma.cuh``; its block tiling, a
``limb_mma::Tiles<rows, 8, warps along M, 1, ring stages, warps along k>``,
is a compile-time choice. This script builds one entry per tiling of
``TILINGS`` into a library of its own (beside the port's, in the gitignored
``kernels/_build/``), checks each bit-for-bit against the port's
``limb_fold_planes`` and prints its time per call (CUDA events around 20
launches back to back, median of 5) at each shape of ``SHAPES``: the
VGG-16 tier-1 folds of a batch of 4 and the SmolLM-135M checks.

    python3 scripts/torch_fold_tilings.py
"""
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import build as KB  # noqa: E402
from repro_torch.kernels.limb_matmul.fold import limb_fold_planes  # noqa: E402

# name: (rows, warps along M, ring stages, warps along k)
TILINGS = {
    "128r 4x1 3st": (128, 4, 3, 1),
    "64r 4x1 4st": (64, 4, 4, 1),
    "64r 4x2 3st": (64, 4, 3, 2),      # limb_fold.cu, many rows
    "64r 4x2 2st": (64, 4, 2, 2),
    "32r 2x2 3st": (32, 2, 3, 2),
    "32r 2x4 3st": (32, 2, 3, 4),
    "16r 1x8 3st": (16, 1, 3, 8),      # limb_fold.cu, few rows
}
# (label, M, Kp): [y | x] rows and digits, folded against k = 2 columns
SHAPES = (("vgg l0", 200704, 96), ("vgg l1", 200704, 640),
          ("vgg l3", 50176, 704), ("vgg l4", 50176, 1280),
          ("smollm prefill", 4096, 2112), ("smollm decode", 4, 2112))
BYTES_S = 3.35e12

SOURCE = """#include "limb_mma.cuh"
namespace {
template <class T>
__global__ void __launch_bounds__(T::THREADS)
fold_tiling(const int8_t* __restrict__ y, const int8_t* __restrict__ sT,
            int* __restrict__ out, long long M, int kf, int Kp, int n_tiles) {
  extern __shared__ __align__(128) int8_t smem[];
  limb_mma::field_product<T>(y, sT, out, M, kf, Kp, n_tiles, smem);
}
}  // namespace
"""
ENTRY = """extern "C" int fold_tiling_{i}(const void* y, const void* sT, void* out,
                                long long M, int Kp, int kf, void* stream) {{
  using T = limb_mma::Tiles<{rows}, 8, {wm}, 1, {ring}, {wk}>;
  return limb_mma::launch<T>(fold_tiling<T>, y, sT, M, kf, Kp,
                             static_cast<cudaStream_t>(stream), static_cast<int*>(out));
}}
"""


def build():
    src = KB.BUILD_DIR / "fold_tilings.cu"
    lib = KB.BUILD_DIR / "libfold_tilings.so"
    KB.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(SOURCE + "".join(
        ENTRY.format(i=i, rows=r, wm=wm, ring=ring, wk=wk)
        for i, (r, wm, ring, wk) in enumerate(TILINGS.values())))
    subprocess.run([KB.nvcc_path(), *KB.NVCC_FLAGS, "-shared", "-I",
                    str(KB.CSRC), "-o", str(lib), str(src)], check=True)
    handle = ctypes.CDLL(str(lib))
    fns = []
    for i in range(len(TILINGS)):
        fn = getattr(handle, f"fold_tiling_{i}")
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns.append(fn)
    return fns


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_fold_tilings: CUDA is not available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    fns = build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    totals = {name: 0.0 for name in TILINGS}
    for label, M, Kp in SHAPES:
        y = torch.randint(-128, 128, (3, M, Kp), generator=gen, device=dev,
                          dtype=torch.int8)
        s = torch.randint(-128, 128, (3, Kp, 2), generator=gen, device=dev,
                          dtype=torch.int8)
        want = limb_fold_planes(y, s)
        sT = s.transpose(1, 2).contiguous()
        out = torch.empty((M, 2), dtype=torch.int32, device=dev)
        args = (y.data_ptr(), sT.data_ptr(), out.data_ptr(), M, Kp, 2, stream)
        cells = []
        for (name, fn) in zip(TILINGS, fns):
            out.zero_()
            KB.check(fn(*args), name)
            if not torch.equal(out, want):
                raise AssertionError(f"tiling {name} at {label}: differs from "
                                     f"limb_fold_planes")
            times = []
            for _ in range(5):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    fn(*args)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end) / 20)
            ms = statistics.median(times)
            if label.startswith("vgg"):
                totals[name] += ms
            cells.append(f"{name} {ms * 1e3:.1f} us")
        print(f"{label} ({M}x{Kp}x2, bound {3 * M * Kp / BYTES_S * 1e6:.1f} "
              f"us): " + ", ".join(cells))
    print("summed over the VGG shapes: " + ", ".join(
        f"{name} {ms * 1e3:.1f} us" for name, ms in totals.items()))


if __name__ == "__main__":
    main()
