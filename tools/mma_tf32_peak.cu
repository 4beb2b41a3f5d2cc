// The tensor cores' rate for mma.sync.m16n8k8 with TF32 inputs and f32
// accumulators on this card: each warp runs 8 independent accumulators
// through `iters` rounds of mma, with no memory traffic. The ceiling that
// src/repro_torch/kernels/csrc/lowrank_flash.cu runs against (it issues only
// this instruction on the tensor cores). Built and run by
// tools/lowrank_flash_profile.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void mma_peak_kernel(float* out, int iters) {
  const uint32_t x = __float_as_uint(1.0f + threadIdx.x * 1e-3f) & 0xffffe000u;
  const uint32_t a[4] = {x, x ^ 0x2000u, x, x}, b[2] = {x, x ^ 0x4000u};
  float c[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) mma(c[j], a, b);
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;   // keeps the products live
}

}  // namespace

// blocks x threads threads, each warp 8 * iters mma of 2 * 16 * 8 * 8 flops;
// out holds blocks * threads floats. Returns a cudaError_t value.
extern "C" int mma_peak_launch(int blocks, int threads, int iters, void* out, void* stream) {
  mma_peak_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters);
  return (int)cudaGetLastError();
}
