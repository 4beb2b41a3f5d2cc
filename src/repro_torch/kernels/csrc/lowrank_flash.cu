// Low-rank flash attention for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/lowrank_flash.py:lowrank_flash
// (Pallas body _flash_kernel). Same function, same masks:
//
//   q (b, hq, sq, r), k (b, hkv, skv, r), v (b, hkv, skv, dv) -> out
//   (b, hq, sq, dv) in v's type. The score contraction runs over r, which may
//   be a truncated rank (the DR-RL factors) or the full head dim. Query i sits
//   at position q_offset + i (q_offset >= 0) and sees key j iff j < skv and,
//   when causal, j <= q_offset + i; so every query sees key 0 and no row is
//   ever empty. GQA maps row bh = b * hq + h to kv row bh / (hq / hkv), so K
//   and V are never repeated in device memory. f32 arithmetic throughout.
//
// What bounds it on an H100: operations. A causal call does
// 2 b hq (sq (sq + 1) / 2) (r + dv) flops against 4 (q + k + v + out) bytes
// in f32: at b = 2, hq = 12, sq = skv = 4096, r = dv = 64 that is 51.5
// GFLOP against 101 MB, about 510 flop per byte, far above the card's f32
// ridge (67 TFLOP/s over 3.35 TB/s = 20 flop/B). Without TF32 (the parity
// contract holds f32 at 2e-5) the bound is the f32 CUDA-core rate.
//
// Design. The Pallas kernel walks the kv axis as a sequential grid axis and
// keeps m / l / acc in VMEM scratch. Here one block of 128 threads owns one
// (b * hq + h, tile of 64 queries) and loops over 64-key tiles itself, up to
// the tile's causal edge, so blocks above the diagonal are never visited:
//   * Q is staged once, transposed, as f32 (row stride 65); each K/V tile is
//     staged as f32, K with row stride r + 1 (the lane-per-key reads are free
//     of bank conflicts for even r), V zero-padded to 8 * NC columns;
//   * thread (ty, tx), ty < 16, tx < 8, computes the 4 x 8 scores of queries
//     ty + 16 i and keys tx + 8 c as a register tile;
//   * the online softmax runs in registers: a row's 64 scores live in the 8
//     neighbouring lanes of one row group, reduced with three xor shuffles;
//   * P.V reads each probability from its owner lane by shuffle and keeps the
//     4 x NC output columns tx + 8 cc of the thread's queries in registers.
// Heavier query tiles (later in a causal sequence) are scheduled first.
// Left for later: tensor cores (wgmma, bf16 or TF32), TMA and a
// double-buffered tile ring.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kBQ = 64;            // queries per block
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 128;      // 16 row groups x 8 lanes
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;           // queries per thread: ty + 16 i
constexpr int kCols = 8;           // keys per thread and tile: tx + 8 c
constexpr int kQS = kBQ + 1;       // row stride of the transposed Q tile
constexpr int kMaxDim = 128;       // largest r and dv this kernel takes

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// NC: output columns per thread (tx + 8 cc, cc < NC); 8 * NC >= dv.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
lowrank_flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ out, int hq, int hkv, int sq, int skv, int r, int dv,
                     int q_offset, int causal, float scale) {
  constexpr int kDVP = 8 * NC;     // V tile row stride (zero-padded columns)
  extern __shared__ float smem[];
  const int rs = r + 1;            // K tile row stride
  float* q_t = smem;               // r x kQS: Q tile, transposed
  float* k_s = q_t + r * kQS;      // kBK x rs
  float* v_s = k_s + kBK * rs;     // kBK x kDVP

  const int bh = blockIdx.x;                         // b * hq + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ; // heaviest tiles first
  const size_t kv_row = (size_t)bh / (hq / hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int tx = tid & 7, ty = tid >> 3;
  const int grp = lane & ~7;                         // first lane of the row group

  const T* q_bh = q + ((size_t)bh * sq + q0) * r;
  const T* k_bh = k + kv_row * skv * r;
  const T* v_bh = v + kv_row * skv * dv;

  const int n_q = min(kBQ, sq - q0);
  for (int row = warp; row < kBQ; row += kWarps)
    for (int d = lane; d < r; d += 32)
      q_t[d * kQS + row] = row < n_q ? to_f32(q_bh[(size_t)row * r + d]) : 0.f;

  // one past the last key any query of the tile can see
  const int key_hi = causal ? min(skv, q_offset + q0 + n_q) : skv;
  const int n_tiles = (key_hi + kBK - 1) / kBK;

  float m[kRows], l[kRows], o[kRows][NC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) o[i][cc] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();               // the previous tile is consumed
    for (int row = warp; row < kBK; row += kWarps) {
      const bool ok = k0 + row < skv;
      const size_t key = (size_t)(k0 + row);
      for (int d = lane; d < r; d += 32)
        k_s[row * rs + d] = ok ? to_f32(k_bh[key * r + d]) : 0.f;
      for (int d = lane; d < kDVP; d += 32)
        v_s[row * kDVP + d] = ok && d < dv ? to_f32(v_bh[key * dv + d]) : 0.f;
    }
    __syncthreads();

    // scores: a 4 x 8 register tile per thread
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < r; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = q_t[d * kQS + ty + 16 * i];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = k_s[(tx + 8 * c) * rs + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

    // masks and the online softmax; s becomes p (masked entries exactly 0)
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int q_pos = q_offset + q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int key = k0 + tx + 8 * c;
        const bool vis = key < skv && (!causal || key <= q_pos);
        s[i][c] = vis ? s[i][c] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        s[i][c] = s[i][c] == -INFINITY ? 0.f : expf(s[i][c] - m_new);
        sum += s[i][c];
      }
      l[i] = l[i] * corr + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) o[i][cc] *= corr;
    }

    // P.V: key tx' + 8 c's probability lives in lane grp + tx'
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
#pragma unroll
      for (int src = 0; src < 8; ++src) {
        float p[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) p[i] = __shfl_sync(0xffffffffu, s[i][c], grp + src);
        const float* v_row = v_s + (src + 8 * c) * kDVP + tx;
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const float vv = v_row[8 * cc];
#pragma unroll
          for (int i = 0; i < kRows; ++i) o[i][cc] = fmaf(p[i], vv, o[i][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = ty + 16 * i;
    if (row >= n_q) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* o_row = out + ((size_t)bh * sq + q0 + row) * dv;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int col = tx + 8 * cc;
      if (col < dv) store(o_row + col, o[i][cc] / den);
    }
  }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int b, int hq, int hkv,
                   int sq, int skv, int r, int dv, int q_offset, int causal, float scale,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)r * kQS + (size_t)kBK * (r + 1) + (size_t)kBK * 8 * NC);
  cudaError_t err = cudaFuncSetAttribute(lowrank_flash_kernel<T, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * hq, (sq + kBQ - 1) / kBQ);
  lowrank_flash_kernel<T, NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), hq, hkv, sq, skv, r, dv, q_offset, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, int b, int hq,
                     int hkv, int sq, int skv, int r, int dv, int q_offset, int causal,
                     float scale, cudaStream_t s) {
  if (dv <= 16) return launch<T, 2>(q, k, v, out, b, hq, hkv, sq, skv, r, dv, q_offset, causal, scale, s);
  if (dv <= 32) return launch<T, 4>(q, k, v, out, b, hq, hkv, sq, skv, r, dv, q_offset, causal, scale, s);
  if (dv <= 64) return launch<T, 8>(q, k, v, out, b, hq, hkv, sq, skv, r, dv, q_offset, causal, scale, s);
  return launch<T, 16>(q, k, v, out, b, hq, hkv, sq, skv, r, dv, q_offset, causal, scale, s);
}

}  // namespace

// Plain C entry point (loaded with ctypes). q, k, v and out are contiguous
// and on the current device; dtype 0 = float32, 1 = bfloat16 for all four.
// Returns a cudaError_t value (0 = launched).
extern "C" int lowrank_flash_launch(const void* q, const void* k, const void* v, void* out, int b,
                                    int hq, int hkv, int sq, int skv, int r, int dv, int q_offset,
                                    int causal, float scale, int dtype, void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || skv < 1 || r < 1 ||
      r > kMaxDim || dv < 1 || dv > kMaxDim || q_offset < 0 || (long long)b * hq > 0x7fffffffLL ||
      (sq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(q, k, v, out, b, hq, hkv, sq, skv, r, dv, q_offset, causal != 0, scale, s);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(q, k, v, out, b, hq, hkv, sq, skv, r, dv, q_offset, causal != 0,
                                  scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
