#!/usr/bin/env python3
"""Peak rate of the tensor cores through ``mma.sync`` on one CUDA card, for
the two forms the MoE tiles use: TF32 m16n8k8 (the float32 many-row tile,
three of them per 3xTF32 product) and bf16 m16n8k16 (the bf16 tiles).

Each warp issues ``ACC`` independent mma chains back to back from
registers (no memory traffic), at 4, 8, 16 and 32 warps per SM; the best
rate is the ceiling a tile built on ``mma.sync`` can approach. Prints one
line per form and warp count, and the card's name and power limit. Builds
its kernel with ``nvcc`` into ``build/probes/``.

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


def build() -> ctypes.CDLL:
    out = Path(__file__).resolve().parents[1] / "build" / "probes"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "mma_sync_rate.cu", out / "mma_sync_rate.so"
    src.write_text(SOURCE)
    nvcc = "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(lib),
                    str(src)], check=True)
    dll = ctypes.CDLL(str(lib))
    dll.probe_launch.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p,
                                                     ctypes.c_int,
                                                     ctypes.c_void_p]
    dll.probe_launch.restype = ctypes.c_int
    return dll


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
            ms = sorted(times)[len(times) // 2]
            total = blocks * threads // 32 * ITERS * ACC * flops
            print(f"{form}: {warps} warps per SM: {ms:.3f} ms, "
                  f"{total / ms / 1e9:.1f} TFLOP/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
