// The backward of low-rank flash attention for f32 inputs on NVIDIA Hopper
// (sm_90a), hand-written CUDA C++, on the f32 CUDA cores.
//
// Replaces no TPU kernel: the Pallas kernel src/repro/kernels/lowrank_flash.py:
// lowrank_flash has no backward, and the reference differentiates its flash
// branch (src/repro/models/attention.py:_attend_chunked, a lax.scan) with
// plain XLA. On the card the port's forward on that branch is the kernel of
// csrc/lowrank_flash.cu, so its gradient is a kernel too
// (kernels/lowrank_flash.py:LowrankFlash). Same function, same masks as the
// forward:
//
//   q (b, hq, sq, r), k (b, hkv, skv, r), v (b, hkv, skv, dv), the forward's
//   out (b, hq, sq, dv) and lse (b, hq, sq) (ln sum_j exp(scale q.k_j), written
//   by csrc/lowrank_flash.cu), dout (b, hq, sq, dv) -> dq, dk, dv in the
//   inputs' shapes, f32. Query i sits at position q_offset + i (q_offset >= 0)
//   and sees key j iff j < skv and, when causal, j <= q_offset + i. GQA: q
//   head h reads kv head h / (hq / hkv), and dk, dv sum over the group's
//   q heads. With P = exp(scale Q K^T - lse) (exact zeros where masked),
//   D = rowsum(dout o out), dP = dout V^T and dS = P o (dP - D):
//     dv = P^T dout,  dk = scale dS^T Q,  dq = scale dS K.
//
// What bounds it on an H100: operations. Per visible (query, key) pair the
// function needs S, dP, dv, dk and dq once each, 2 (3 r + 2 dv) flops; this
// design does 2 (4 r + 3 dv), since its dq pass recomputes S and dP. At
// b = 2, hq = 12, sq = skv = 4096, causal, r = dv = 64 the needed work is
// 1.29e11 flops against about 0.2 GB of f32 inputs and outputs: 0.78 ms as
// three TF32 passes at 495 TFLOP/s (split TF32, as the forward), 1.92 ms on
// the f32 CUDA cores at 67 TFLOP/s.
//
// Design (FlashAttention-2's backward, deterministic, no atomics; simple
// first, plain f32 FMA):
//   * lowrank_flash_bwd_dsum_kernel: D = rowsum(dout o out), one warp per
//     (b hq, query) row;
//   * lowrank_flash_bwd_dkdv_kernel: one block of 256 threads per (b hkv,
//     tile of 64 keys), K and V tiles in shared memory for the block's life; it loops over the
//     group's q heads and over the 64-query tiles from the key tile's causal
//     edge to sq, recomputes S and P for each and accumulates dv += P^T dout
//     and dk += dS^T Q in registers, so the GQA sum happens inside the block
//     and dk, dv are written once;
//   * lowrank_flash_bwd_dq_kernel: one block per (b hq, tile of 64 queries),
//     heaviest causal tiles first, looping over the key tiles up to its
//     causal edge: dq += dS K in registers.
//   Each thread of the 16 x 16 grid (ty, tx) computes a 4 x 4 piece of a
//   64 x 64 score tile (queries ty + 16 i, keys tx + 16 j: float4 reads of
//   rows whose stride is 4 words past a multiple of 32, so the 8 lanes of a
//   quarter warp hit 8 different bank groups) and a 4 x (width / 16) piece
//   of an accumulator (rows 4 tx + j, columns 64 c + 4 ty + e: one float4 of
//   the P or dS tile and one broadcast float4 of the other operand per
//   column group). r pads to 64, 128 or 192 and dv to 64 or 128 with zeros
//   (exact): six instantiations per kernel. The contraction order differs
//   from the plain version's, so the two agree to f32 summation order.
// Left for later: the tensor cores (split TF32, as the forward), a K/V ring.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                 // a 16 x 16 grid of threads
constexpr int kB = 64;                        // queries per query tile, keys per key tile
constexpr int kPS = kB + 4;                   // row stride of the 64 x 64 P and dS tiles
constexpr int kMaxRank = 192;                 // the forward's range
constexpr int kMaxDim = 128;
constexpr float kLog2e = 1.4426950408889634f;

// 2^x (the SFU's approximation, relative error about 2^-22; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Rows [row0, row0 + 64) of a row-major (n_rows x width) array into a 64 x W
// tile of shared memory with row stride W + 4, zeros past n_rows and width.
// vec: width % 4 == 0 and src 16-byte aligned (float4 loads).
template <int W>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int row0, int n_rows,
                                          int width, bool vec) {
  constexpr int kLd = W + 4;
  if (vec) {
    for (int i = threadIdx.x; i < kB * (W / 4); i += kThreads) {
      const int row = i / (W / 4), col = 4 * (i % (W / 4));
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + row < n_rows && col < width)
        x = *reinterpret_cast<const float4*>(src + (size_t)(row0 + row) * width + col);
      *reinterpret_cast<float4*>(dst + row * kLd + col) = x;
    }
  } else {
    for (int i = threadIdx.x; i < kB * W; i += kThreads) {
      const int row = i / W, col = i % W;
      dst[row * kLd + col] =
          row0 + row < n_rows && col < width ? src[(size_t)(row0 + row) * width + col] : 0.f;
    }
  }
}

// acc[i][j] = sum_d a[ty + 16 i][d] b[tx + 16 j][d] over two 64 x W tiles
// (row stride W + 4)
template <int W>
__device__ __forceinline__ void dot_tiles(float (&acc)[4][4], const float* a, const float* b,
                                          int ty, int tx) {
  constexpr int kLd = W + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < W; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * kLd + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
}

// acc[j][4 c + e] += sum_p x[p][4 tx + j] y[p][64 c + 4 ty + e] over a 64 x 64
// tile x (row stride kPS) and a 64 x W tile y (row stride W + 4)
template <int W>
__device__ __forceinline__ void acc_outer(float (&acc)[4][W / 16], const float* x, const float* y,
                                          int ty, int tx) {
  constexpr int kLd = W + 4;
#pragma unroll 4
  for (int p = 0; p < kB; ++p) {
    const float4 xv = *reinterpret_cast<const float4*>(x + p * kPS + 4 * tx);
    const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int c = 0; c < W / 64; ++c) {
      const float4 yv = *reinterpret_cast<const float4*>(y + p * kLd + 64 * c + 4 * ty);
      const float ya[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][4 * c + e] = fmaf(xa[j], ya[e], acc[j][4 * c + e]);
    }
  }
}

template <int W>
__device__ __forceinline__ void zero(float (&acc)[4][W / 16]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int n = 0; n < W / 16; ++n) acc[j][n] = 0.f;
}

// rows row0 + 4 tx + j (< n_rows) of a row-major (n_rows x width) array from
// acc_outer's layout
template <int W>
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[4][W / 16], int row0,
                                           int n_rows, int width, int ty, int tx) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = row0 + 4 * tx + j;
    if (row >= n_rows) continue;
#pragma unroll
    for (int c = 0; c < W / 64; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 64 * c + 4 * ty + e;
        if (col < width) dst[(size_t)row * width + col] = acc[j][4 * c + e];
      }
  }
}

// P and scale dS of one (query tile, key tile) pair from S and dP in
// dot_tiles' layout; masked entries are exact zeros. l2 and dsum hold the
// query tile's lse log2(e) and D.
__device__ __forceinline__ void probs(float (&s)[4][4], float (&dp)[4][4], const float* l2,
                                      const float* dsum, int q0, int k0, int sq, int skv,
                                      int q_offset, int causal, float c, float scale, int ty,
                                      int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = ty + 16 * i, row = q0 + qi;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      const bool vis = row < sq && key < skv && (!causal || key <= q_offset + row);
      const float p = vis ? ex2(fmaf(s[i][j], c, -l2[qi])) : 0.f;
      s[i][j] = p;
      dp[i][j] = scale * (p * (dp[i][j] - dsum[qi]));
    }
  }
}

// the query tile's lse log2(e) and D into shared memory (0 past sq)
__device__ __forceinline__ void load_stats(float* l2, float* ds, const float* lse,
                                           const float* dsum, size_t bh, int q0, int sq) {
  if (threadIdx.x < kB) {
    const int i = q0 + threadIdx.x;
    l2[threadIdx.x] = i < sq ? lse[bh * sq + i] * kLog2e : 0.f;
    ds[threadIdx.x] = i < sq ? dsum[bh * sq + i] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
lowrank_flash_bwd_dsum_kernel(const float* __restrict__ out, const float* __restrict__ dout,
                              float* __restrict__ dsum, int rows, int dv) {
  const int row = (int)((blockIdx.x * (size_t)kThreads + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* o = out + (size_t)row * dv;
  const float* d = dout + (size_t)row * dv;
  float acc = 0.f;
  for (int c = lane; c < dv; c += 32) acc = fmaf(o[c], d[c], acc);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) dsum[row] = acc;
}

template <int RP, int DP>
constexpr size_t dkdv_smem() {
  return sizeof(float) *
         ((size_t)2 * kB * (RP + 4) + (size_t)2 * kB * (DP + 4) + 2 * kB * kPS + 2 * kB);
}

template <int RP, int DP>
constexpr size_t dq_smem() {
  return sizeof(float) *
         ((size_t)2 * kB * (RP + 4) + (size_t)2 * kB * (DP + 4) + kB * kPS + 2 * kB);
}

template <int RP, int DP>
__global__ void __launch_bounds__(kThreads, RP + DP <= 128 ? 2 : 1)
lowrank_flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ dsum,
                              float* __restrict__ dk, float* __restrict__ dv, int hq, int hkv,
                              int sq, int skv, int r, int dvw, int q_offset, int causal,
                              float scale, int vec_qk, int vec_v) {
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                    // 64 x (RP + 4)
  float* q_s = k_s + kB * (RP + 4);     // 64 x (RP + 4)
  float* v_s = q_s + kB * (RP + 4);     // 64 x (DP + 4)
  float* do_s = v_s + kB * (DP + 4);    // 64 x (DP + 4)
  float* p_s = do_s + kB * (DP + 4);    // P [query][key]
  float* ds_s = p_s + kB * kPS;         // scale dS [query][key]
  float* l2_s = ds_s + kB * kPS;        // 64
  float* d_s = l2_s + kB;               // 64

  const int bkv = blockIdx.x;           // b * hkv + kv head
  const int k0 = blockIdx.y * kB;       // key tile 0 sees the most query tiles: first
  const int group = hq / hkv;
  const int b = bkv / hkv, hk = bkv % hkv;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float c = scale * kLog2e;

  load_tile<RP>(k_s, k + (size_t)bkv * skv * r, k0, skv, r, vec_qk);
  load_tile<DP>(v_s, v + (size_t)bkv * skv * dvw, k0, skv, dvw, vec_v);

  float acc_k[4][RP / 16], acc_v[4][DP / 16];
  zero<RP>(acc_k);
  zero<DP>(acc_v);
  // the first query that sees key k0 sits at q_offset + i >= k0
  const int t_first = causal ? max(0, k0 - q_offset) / kB : 0;
  const int n_qt = (sq + kB - 1) / kB;
  for (int hh = 0; hh < group; ++hh) {
    const size_t bh = (size_t)b * hq + (size_t)hk * group + hh;
    for (int qt = t_first; qt < n_qt; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();                  // the last tile's q_s, do_s, p_s, ds_s are consumed
      load_tile<RP>(q_s, q + bh * sq * r, q0, sq, r, vec_qk);
      load_tile<DP>(do_s, dout + bh * sq * dvw, q0, sq, dvw, vec_v);
      load_stats(l2_s, d_s, lse, dsum, bh, q0, sq);
      __syncthreads();
      float s[4][4], dp[4][4];
      dot_tiles<RP>(s, q_s, k_s, ty, tx);
      dot_tiles<DP>(dp, do_s, v_s, ty, tx);
      probs(s, dp, l2_s, d_s, q0, k0, sq, skv, q_offset, causal, c, scale, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p_s[(ty + 16 * i) * kPS + tx + 16 * j] = s[i][j];
          ds_s[(ty + 16 * i) * kPS + tx + 16 * j] = dp[i][j];
        }
      __syncthreads();
      acc_outer<DP>(acc_v, p_s, do_s, ty, tx);   // dv[key][col] += sum_q P[q][key] dout[q][col]
      acc_outer<RP>(acc_k, ds_s, q_s, ty, tx);   // dk[key][d] += sum_q scale dS[q][key] q[q][d]
    }
  }
  store_rows<RP>(dk + (size_t)bkv * skv * r, acc_k, k0, skv, r, ty, tx);
  store_rows<DP>(dv + (size_t)bkv * skv * dvw, acc_v, k0, skv, dvw, ty, tx);
}

template <int RP, int DP>
__global__ void __launch_bounds__(kThreads, RP + DP <= 128 ? 2 : 1)
lowrank_flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ dsum,
                            float* __restrict__ dq, int hq, int hkv, int sq, int skv, int r,
                            int dvw, int q_offset, int causal, float scale, int vec_qk,
                            int vec_v) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                    // 64 x (RP + 4)
  float* k_s = q_s + kB * (RP + 4);     // 64 x (RP + 4)
  float* do_s = k_s + kB * (RP + 4);    // 64 x (DP + 4)
  float* v_s = do_s + kB * (DP + 4);    // 64 x (DP + 4)
  float* dst_s = v_s + kB * (DP + 4);   // scale dS transposed [key][query]
  float* l2_s = dst_s + kB * kPS;       // 64
  float* d_s = l2_s + kB;               // 64

  const size_t bh = blockIdx.x;                       // b * hq + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kB;   // heaviest tiles first
  const size_t kv_row = bh / (hq / hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float c = scale * kLog2e;
  const int n_q = min(kB, sq - q0);
  const int key_hi = causal ? min(skv, q_offset + q0 + n_q) : skv;
  const int n_kt = (key_hi + kB - 1) / kB;

  load_tile<RP>(q_s, q + bh * sq * r, q0, sq, r, vec_qk);
  load_tile<DP>(do_s, dout + bh * sq * dvw, q0, sq, dvw, vec_v);
  load_stats(l2_s, d_s, lse, dsum, bh, q0, sq);

  float acc[4][RP / 16];
  zero<RP>(acc);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();                    // the last tile's k_s, v_s, dst_s are consumed
    load_tile<RP>(k_s, k + kv_row * skv * r, k0, skv, r, vec_qk);
    load_tile<DP>(v_s, v + kv_row * skv * dvw, k0, skv, dvw, vec_v);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tiles<RP>(s, q_s, k_s, ty, tx);
    dot_tiles<DP>(dp, do_s, v_s, ty, tx);
    probs(s, dp, l2_s, d_s, q0, k0, sq, skv, q_offset, causal, c, scale, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dst_s[(tx + 16 * j) * kPS + ty + 16 * i] = dp[i][j];
    __syncthreads();
    acc_outer<RP>(acc, dst_s, k_s, ty, tx);      // dq[q][d] += sum_key scale dS[q][key] k[key][d]
  }
  store_rows<RP>(dq + bh * sq * r, acc, q0, sq, r, ty, tx);
}

template <int RP, int DP>
cudaError_t launch(const float* q, const float* k, const float* v, const float* dout,
                   const float* lse, const float* dsum, float* dq, float* dk, float* dv, int b,
                   int hq, int hkv, int sq, int skv, int r, int dvw, int q_offset, int causal,
                   float scale, int vec_qk, int vec_v, cudaStream_t stream) {
  // r = 192, dv = 128: 203,264 bytes (dk/dv) and 185,856 (dq), under the
  // H100's 227 KB per block
  constexpr size_t kSmemKV = dkdv_smem<RP, DP>(), kSmemQ = dq_smem<RP, DP>();
  cudaError_t err = cudaFuncSetAttribute(lowrank_flash_bwd_dkdv_kernel<RP, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemKV);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(lowrank_flash_bwd_dq_kernel<RP, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemQ);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv(b * hkv, (skv + kB - 1) / kB), grid_q(b * hq, (sq + kB - 1) / kB);
  lowrank_flash_bwd_dkdv_kernel<RP, DP><<<grid_kv, kThreads, kSmemKV, stream>>>(
      q, k, v, dout, lse, dsum, dk, dv, hq, hkv, sq, skv, r, dvw, q_offset, causal, scale, vec_qk,
      vec_v);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  lowrank_flash_bwd_dq_kernel<RP, DP><<<grid_q, kThreads, kSmemQ, stream>>>(
      q, k, v, dout, lse, dsum, dq, hq, hkv, sq, skv, r, dvw, q_offset, causal, scale, vec_qk,
      vec_v);
  return cudaGetLastError();
}

#define LB_ARGS \
  q, k, v, dout, lse, dsum, dq, dk, dv, b, hq, hkv, sq, skv, r, dvw, q_offset, causal, scale, \
      vec_qk, vec_v, s

template <int RP>
cudaError_t by_dv(const float* q, const float* k, const float* v, const float* dout,
                  const float* lse, const float* dsum, float* dq, float* dk, float* dv, int b,
                  int hq, int hkv, int sq, int skv, int r, int dvw, int q_offset, int causal,
                  float scale, int vec_qk, int vec_v, cudaStream_t s) {
  if (dvw <= 64) return launch<RP, 64>(LB_ARGS);
  return launch<RP, 128>(LB_ARGS);
}

}  // namespace

// Plain C entry point (loaded with ctypes). q, k, v, out, lse and dout are
// contiguous f32 tensors on the current device (lse from lowrank_flash_launch
// on the same q, k, v); dq, dk and dv receive the gradients (the inputs'
// shapes) and dsum (b, hq, sq) is scratch for D. Launches three kernels on
// `stream` and does not synchronise. Returns a cudaError_t value (0 =
// launched).
extern "C" int lowrank_flash_bwd_launch(const void* q, const void* k, const void* v,
                                        const void* out, const void* lse, const void* dout,
                                        void* dq, void* dk, void* dv, void* dsum, int b, int hq,
                                        int hkv, int sq, int skv, int r, int dvw, int q_offset,
                                        int causal, float scale, void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || skv < 1 || r < 1 ||
      r > kMaxRank || dvw < 1 || dvw > kMaxDim || q_offset < 0 ||
      (long long)b * hq > 0x7fffffffLL || (sq + kB - 1) / kB > 65535 ||
      (skv + kB - 1) / kB > 65535 || (long long)b * hq * sq > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = b * hq * sq;
  const unsigned dsum_blocks = (unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32));
  lowrank_flash_bwd_dsum_kernel<<<dsum_blocks, kThreads, 0, s>>>(
      static_cast<const float*>(out), static_cast<const float*>(dout), static_cast<float*>(dsum),
      rows, dvw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // float4 loads need rows of a multiple of 4 and aligned base pointers
  const uintptr_t align = 4 * sizeof(float);
  const int vec_qk = r % 4 == 0 && (uintptr_t)q % align == 0 && (uintptr_t)k % align == 0;
  const int vec_v = dvw % 4 == 0 && (uintptr_t)v % align == 0 && (uintptr_t)dout % align == 0;
  const float* q_ = static_cast<const float*>(q);
  const float* k_ = static_cast<const float*>(k);
  const float* v_ = static_cast<const float*>(v);
  const float* do_ = static_cast<const float*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  const float* ds_ = static_cast<const float*>(dsum);
  float* dq_ = static_cast<float*>(dq);
  float* dk_ = static_cast<float*>(dk);
  float* dv_ = static_cast<float*>(dv);
#define LB_CALL(RP)                                                                          \
  by_dv<RP>(q_, k_, v_, do_, lse_, ds_, dq_, dk_, dv_, b, hq, hkv, sq, skv, r, dvw, q_offset, \
            causal != 0, scale, vec_qk, vec_v, s)
  if (r <= 64) return (int)LB_CALL(64);
  if (r <= 128) return (int)LB_CALL(128);
  return (int)LB_CALL(192);
#undef LB_CALL
}

#undef LB_ARGS
