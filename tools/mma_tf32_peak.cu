// The tensor cores' rate for the instructions the lowrank_flash kernels issue,
// on this card, with no memory traffic:
//   * mma.sync.m16n8k8 with TF32 inputs and f32 accumulators (the f32 kernel,
//     src/repro_torch/kernels/csrc/lowrank_flash.cu): each warp runs 8
//     independent accumulators through `iters` rounds;
//   * mma.sync.m16n8k16 with bf16 inputs, the same way (the route of the
//     bf16 kernel before it moved to wgmma);
//   * wgmma.m64n128k16 with bf16 inputs, A from registers and B from shared
//     memory, f32 accumulators (the bf16 kernel's P.V pass at dv = 128,
//     src/repro_torch/kernels/csrc/lowrank_flash_bf16.cu): each warpgroup
//     runs `iters` rounds of 16 into one accumulator, committed and waited
//     for per round.
// Built and run by tools/lowrank_flash_profile.py.

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

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d (64 x 128) (+)= A B: A from registers, B from shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
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

__global__ void mma_bf16_peak_kernel(float* out, int iters) {
  const uint32_t x = 0x3f803f80u + threadIdx.x;      // two bf16 values near 1
  const uint32_t a[4] = {x, x ^ 0x10001u, x, x}, b[2] = {x, x ^ 0x20002u};
  float c[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_bf16(c[j], a, b);
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void __launch_bounds__(512) wgmma_bf16_peak_kernel(float* out, int iters) {
  // B: 128 rows of K = 16 bf16 in 128-byte swizzled rows (K-major), 16 KB
  __shared__ __align__(1024) uint32_t b_s[128 * 32];
  for (int i = threadIdx.x; i < 128 * 32; i += blockDim.x) b_s[i] = 0x3f803f80u;
  __syncthreads();
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(b_s));
  const uint64_t desc = (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
                        (1ull << 62);
  const uint32_t x = 0x3f803f80u + (threadIdx.x & 127);
  const uint32_t a[4] = {x, x ^ 0x10001u, x, x};
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  for (int i = 0; i < iters; ++i) {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int j = 0; j < 16; ++j) wgmma_rs_n128(d, a, desc, 1);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) s += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// blocks x threads threads, each warp 8 * iters mma of 2 * 16 * 8 * 8 flops;
// out holds blocks * threads floats. Returns a cudaError_t value.
extern "C" int mma_peak_launch(int blocks, int threads, int iters, void* out, void* stream) {
  mma_peak_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters);
  return (int)cudaGetLastError();
}

// each warp 8 * iters mma of 2 * 16 * 8 * 16 flops
extern "C" int mma_bf16_peak_launch(int blocks, int threads, int iters, void* out, void* stream) {
  mma_bf16_peak_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters);
  return (int)cudaGetLastError();
}

// threads a multiple of 128; each warpgroup 16 * iters wgmma of 2 * 64 *
// 128 * 16 flops
extern "C" int wgmma_bf16_peak_launch(int blocks, int threads, int iters, void* out,
                                      void* stream) {
  wgmma_bf16_peak_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters);
  return (int)cudaGetLastError();
}
