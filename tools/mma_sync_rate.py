#!/usr/bin/env python3
"""Peak rate of the tensor cores on one CUDA card, for the forms the MoE
tiles use: through ``mma.sync``, TF32 m16n8k8 (``ssd_chunk``'s 3xTF32
products) and bf16 m16n8k16 (the bf16 tiles); through ``wgmma``, TF32
m64nNk8 with A from registers and B from 128-byte-swizzled shared memory
(the float32 many-row tile, three of them per 3xTF32 product, at each of
its widths N), issued through the tile's own wrappers
(``csrc/swiglu_tiles.cuh``).

Each ``mma.sync`` warp issues ``ACC`` independent mma chains back to back
from registers (no memory traffic), at 4, 8, 16 and 32 warps per SM; each
``wgmma`` warpgroup issues groups of ``WG_GROUP`` wgmmas into one
accumulator and waits for each group, at 1, 2 and 4 warpgroups per SM.
The best rate is the ceiling a tile built on that form can approach.
Prints one line per form and count, and the card's name and power limit.
Builds its kernels with ``nvcc`` into ``build/probes/``.

    python3 tools/mma_sync_rate.py
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

#include "swiglu_tiles.cuh"

constexpr int ACC = 16;   // independent accumulators per warp

extern "C" __global__ void tf32_probe(float* out, int iters) {
  float acc[ACC][4] = {};
  const uint32_t a[4] = {0x3a800000u, 0x3a800000u, 0x3a800000u, 0x3a800000u};
  const uint32_t b[2] = {0x3a800000u ^ (threadIdx.x & 1), 0x3a800000u};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int s = 0; s < ACC; ++s)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[s][0]), "+f"(acc[s][1]), "+f"(acc[s][2]),
            "+f"(acc[s][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float sum = 0.f;
  for (int s = 0; s < ACC; ++s) sum += acc[s][0] + acc[s][1] + acc[s][2] +
                                       acc[s][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

extern "C" __global__ void bf16_probe(float* out, int iters) {
  float acc[ACC][4] = {};
  const uint32_t a[4] = {0x3b803b80u, 0x3b803b80u, 0x3b803b80u, 0x3b803b80u};
  const uint32_t b[2] = {0x3b803b80u ^ (threadIdx.x & 1), 0x3b803b80u};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int s = 0; s < ACC; ++s)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[s][0]), "+f"(acc[s][1]), "+f"(acc[s][2]),
            "+f"(acc[s][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float sum = 0.f;
  for (int s = 0; s < ACC; ++s) sum += acc[s][0] + acc[s][1] + acc[s][2] +
                                       acc[s][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

constexpr int WG_GROUP = 16;   // wgmmas per commit group

// wgmma TF32 m64nNk8: A (4 registers) from registers, B (N rows of 128 B)
// from shared memory under the 128-byte swizzle, as the many-row tile
// issues them; one accumulator a warpgroup
template <int N>
__global__ void wgmma_probe(float* out, int iters) {
  using namespace swiglu_tiles;
  extern __shared__ float4 smem4[];
  const uint32_t at = smem_u32(smem4);
  char* b = reinterpret_cast<char*>(smem4) + (((at + 1023) & ~1023u) - at);
  for (int i = threadIdx.x; i < N * 32; i += blockDim.x)
    reinterpret_cast<float*>(b)[i] = (i & 1) ? 0.5f : 0.25f;
  fence_proxy_async();
  __syncthreads();
  float d[N / 2];
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  uint32_t a[4] = {0x3a800000u, 0x3a800000u, 0x3a800000u,
                   0x3a800000u ^ (threadIdx.x & 1)};
  const uint64_t desc = sw128_desc(b);
  for (int it = 0; it < iters; ++it) {
    pin(d);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < WG_GROUP; ++s)
      Wgmma<N>::run(d, a, desc + 2 * (s & 3), 1);
    wgmma_commit();
    wgmma_wait_all();
    pin(d);
  }
  float sum = 0.f;
  for (int i = 0; i < N / 2; ++i) sum += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

// Launches the wgmma probe of width n (32, 64, 96, 128) on ``blocks`` CTAs
// of ``threads`` (whole warpgroups); returns the CUDA error code.
extern "C" int wgmma_launch(int n, int blocks, int threads, float* out,
                            int iters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bytes = n * 128 + 1024;
  switch (n) {
    case 32: wgmma_probe<32><<<blocks, threads, bytes, s>>>(out, iters); break;
    case 64: wgmma_probe<64><<<blocks, threads, bytes, s>>>(out, iters); break;
    case 96: wgmma_probe<96><<<blocks, threads, bytes, s>>>(out, iters); break;
    default: wgmma_probe<128><<<blocks, threads, bytes, s>>>(out, iters);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches the bf16 or the TF32 probe on ``blocks`` CTAs of ``threads``;
// returns the CUDA error code.
extern "C" int probe_launch(int bf16, int blocks, int threads, float* out,
                            int iters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    bf16_probe<<<blocks, threads, 0, s>>>(out, iters);
  else
    tf32_probe<<<blocks, threads, 0, s>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""

# (form, FLOPs of one mma: 2 * M * N * K)
FORMS = (("tf32 m16n8k8", 2 * 16 * 8 * 8), ("bf16 m16n8k16", 2 * 16 * 8 * 16))
ACC = 16
ITERS = 4096
# the float32 many-row tile's wgmma widths, and each wgmma's FLOPs
WGMMA_N = (32, 64, 96, 128)
WG_GROUP = 16
WG_ITERS = 2048
ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"


def build() -> ctypes.CDLL:
    out = ROOT / "build" / "probes"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "mma_sync_rate.cu", out / "mma_sync_rate.so"
    src.write_text(SOURCE)
    nvcc = "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-I", str(CSRC), "-o", str(lib), str(src)], check=True)
    dll = ctypes.CDLL(str(lib))
    for fn in (dll.probe_launch, dll.wgmma_launch):
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return dll


def median_ms(run) -> float:
    """Median of 5 CUDA-event timings of ``run`` after one warm-up."""
    import torch
    run()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mma_sync_rate: no CUDA device is visible", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    dll = build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    for bf16, (form, flops) in enumerate(FORMS):
        for warps in (4, 8, 16, 32):
            threads = 32 * min(warps, 8)
            blocks = sms * max(warps // 8, 1)
            out = torch.empty(blocks * threads, device="cuda")

            def run():
                err = dll.probe_launch(bf16, blocks, threads, out.data_ptr(),
                                       ITERS, stream)
                if err:
                    raise RuntimeError(f"probe launch failed: {err}")
            ms = median_ms(run)
            total = blocks * threads // 32 * ITERS * ACC * flops
            print(f"{form}: {warps} warps per SM: {ms:.3f} ms, "
                  f"{total / ms / 1e9:.1f} TFLOP/s")
    for n in WGMMA_N:
        for wgs in (1, 2, 4):
            threads, blocks = 128 * min(wgs, 2), sms * max(wgs // 2, 1)
            out = torch.empty(blocks * threads, device="cuda")

            def run():
                err = dll.wgmma_launch(n, blocks, threads, out.data_ptr(),
                                       WG_ITERS, stream)
                if err:
                    raise RuntimeError(f"wgmma probe launch failed: {err}")
            ms = median_ms(run)
            total = (blocks * threads // 128 * WG_ITERS * WG_GROUP
                     * 2 * 64 * n * 8)
            print(f"wgmma tf32 m64n{n}k8 (A registers, B shared): {wgs} "
                  f"warpgroups per SM: {ms:.3f} ms, "
                  f"{total / ms / 1e9:.1f} TFLOP/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
