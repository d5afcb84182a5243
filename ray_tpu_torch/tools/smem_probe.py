"""Measure how fast one SM serves 128-bit shared-memory loads, by how
many distinct addresses a warp's load touches.

    python -m ray_tpu_torch.tools.smem_probe

The simple flash kernels (``ops/csrc/flash_simple.cu``) feed their FMAs
from 128-bit shared loads in which the 32 lanes of a warp read 32, 16, 2
or 1 distinct 16-byte words.  Whether a load costs by the distinct
words it touches (a broadcast is cheap) or by the 512 bytes it delivers
to the lanes (every LDS.128 costs four 128-byte wavefronts) decides how
many loads an FMA can afford.  This probe builds one small kernel with
nvcc, runs 8 independent LDS.128 per step in every warp of 264 blocks of
256 threads for each pattern, and prints the warp-wide loads served per
SM per clock (at the SM clock nvidia-smi reads during the run) and the
implied clocks per load.  It needs one card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from ..ops import _build

SOURCE = r"""
#include <cuda_runtime.h>
// Each thread sums 8 independent LDS.128 a step from a 16 KB shared
// buffer; `mode` picks the word a lane reads: 0 its own (32 distinct a
// warp), 1 lane % 16 (16 distinct, halves identical), 2 lane / 16 (2
// distinct), 3 one word a warp.
__global__ void probe(float* out, int steps, int mode) {
  __shared__ float4 buf[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x)
    buf[i] = make_float4(i, i + 1, i + 2, i + 3);
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int word = mode == 0 ? lane : mode == 1 ? lane % 16
                 : mode == 2 ? lane / 16 : 0;
  int at = warp * 32 + word;
  float4 acc[8];
  for (int j = 0; j < 8; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 v = buf[(at + 256 * j) & 1023];
      acc[j].x += v.x; acc[j].y += v.y; acc[j].z += v.z; acc[j].w += v.w;
    }
    at = (at + 32) & 1023;  // moves on; the warp's pattern stays
  }
  float t = 0.f;
  for (int j = 0; j < 8; ++j) t += acc[j].x + acc[j].y + acc[j].z + acc[j].w;
  out[blockIdx.x * blockDim.x + threadIdx.x] = t;
}
extern "C" int run_probe(float* out, int blocks, int steps, int mode,
                         void* stream) {
  probe<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(out, steps,
                                                               mode);
  return static_cast<int>(cudaGetLastError());
}
"""

MODES = {0: "32 distinct words a warp", 1: "16 distinct (halves equal)",
         2: "2 distinct", 3: "1 word (broadcast)"}


def build():
    src = _build.BUILD_DIR / "smem_probe.cu"
    so = _build.BUILD_DIR / "libsmem_probe.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(SOURCE)
    subprocess.run([_build.nvcc_path(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(so), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    lib.run_probe.restype = ctypes.c_int
    lib.run_probe.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_void_p]
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    lib = build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, steps = 2 * sms, 4096
    out = torch.empty(blocks * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for mode, what in MODES.items():
        lib.run_probe(out.data_ptr(), blocks, 64, mode, stream)
        torch.cuda.synchronize()
        clocks = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
             "nounits", "-lms", "50"], stdout=subprocess.PIPE, text=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rc = lib.run_probe(out.data_ptr(), blocks, steps, mode, stream)
        end.record()
        end.synchronize()
        clocks.terminate()
        mhz = [int(x) for x in clocks.communicate()[0].split() if x.isdigit()]
        if rc:
            print(f"FAIL: launch returned {rc}", flush=True)
            return 1
        ms = start.elapsed_time(end)
        mhz_run = max(mhz) if mhz else 1980
        loads = blocks * 8 * steps * 8  # warp-wide LDS.128
        per_clk = loads / sms / (ms * 1e-3 * mhz_run * 1e6)
        print(f"[smem] LDS.128, {what}: {ms:.3f} ms, {per_clk:.3f} warp "
              f"loads per SM per clock ({1 / per_clk:.2f} clocks a load) "
              f"at {mhz_run} MHz", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
