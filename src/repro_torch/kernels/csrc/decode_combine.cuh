// The combine step of flash decode, shared by csrc/decode_attn.cu (f32) and
// csrc/decode_attn_bf16.cu (bf16): both split kernels leave, per query row
// and key split, a partial (m, l, acc) in an f32 workspace and each visible
// key's scaled score in the probability row; this kernel merges a row's
// partials in split order and normalises the scores.
//
// Workspace layout (n_part = b * hq * C * n_split, part = row * n_split + s
// for query row (b * hq + h) * C + j and split s): ws_m[n_part] (row maximum
// of the scaled scores, natural units; -inf where the split holds no visible
// key), ws_l[n_part] (sum of exp(score - m)), ws_acc[n_part * dv] (sum of
// exp(score - m) v). The combine reads only the splits below
// ceil(key_end / split_len), each of which holds a visible key.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kCombineRows = 4;      // combine: query rows per block, one warp each
constexpr int kCombineKeys = 512;    // combine: probability columns per warp
constexpr int kCombineDim = 128;     // combine: largest dv

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// one past the last key query j of a row sees (0 when it sees none)
__device__ __forceinline__ int key_end(int j, int len, int qs, int ql, int M) {
  return j < ql ? max(0, min(min(len, qs + j + 1), M)) : 0;
}

// One warp per query row (b * hq + h) * C + j, kCombineRows rows per block;
// blockIdx.y picks the row's kCombineKeys probability columns. Each warp
// merges the row's partials in split order (fixed-order reductions, so the
// result repeats run to run); the first column block writes out, and every
// block turns its columns' scores into probabilities.
template <typename T>
__global__ void __launch_bounds__(32 * kCombineRows)
flash_decode_kernel_combine(const float* __restrict__ ws_m, const float* __restrict__ ws_l,
                            const float* __restrict__ ws_acc, const int* __restrict__ kv_len,
                            const int* __restrict__ q_start, const int* __restrict__ q_lens,
                            T* __restrict__ out, float* __restrict__ probs, int hq, int C, int M,
                            int dv, int split_len, int n_split, size_t n_rows) {
  const int lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * kCombineRows + (threadIdx.x >> 5);
  if (row >= n_rows) return;    // the whole warp
  const int b = (int)(row / ((size_t)hq * C));
  const int j = (int)(row % C);
  const int end = key_end(j, kv_len[b], q_start[b], q_lens[b], M);
  const int n_used = (end + split_len - 1) / split_len;  // each holds a visible key
  const float* pm = ws_m + row * n_split;
  const float* pl = ws_l + row * n_split;

  // lane t merges splits t, t + 32, ... online (the loads of m and l go out
  // together), then the lanes merge in a fixed xor order; lane s keeps its
  // first split's m for that split's weight
  float m_first = -INFINITY, mf = -INFINITY, lf = 0.f;
  for (int s = lane; s < n_used; s += 32) {
    const float ms = pm[s], ls = pl[s];
    if (s == lane) m_first = ms;
    const float mn = fmaxf(mf, ms);
    if (mn != -INFINITY)
      lf = (mf == -INFINITY ? 0.f : lf * expf(mf - mn)) +
           (ms == -INFINITY ? 0.f : ls * expf(ms - mn));
    mf = mn;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, mf, off);
    const float lx = __shfl_xor_sync(0xffffffffu, lf, off);
    const float mn = fmaxf(mf, mo);
    if (mn != -INFINITY)
      lf = (mf == -INFINITY ? 0.f : lf * expf(mf - mn)) +
           (mo == -INFINITY ? 0.f : lx * expf(mo - mn));
    mf = mn;
  }

  if (blockIdx.y == 0) {
    // lane s holds split s's weight exp(m_s - m), 0 for an empty split
    const float w_lane = m_first != -INFINITY ? expf(m_first - mf) : 0.f;
    const float* acc = ws_acc + row * n_split * dv;
    constexpr int kCols = kCombineDim / 32;   // columns per lane: lane + 32 c
    float o[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[c] = 0.f;
#pragma unroll 2
    for (int s = 0; s < n_used; ++s) {
      float a[kCols];      // the split's loads of every column in flight before any is used
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        a[c] = 32 * c + lane < dv ? acc[(size_t)s * dv + 32 * c + lane] : 0.f;
      float w = __shfl_sync(0xffffffffu, w_lane, s & 31);
      if (s >= 32) w = pm[s] != -INFINITY ? expf(pm[s] - mf) : 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) o[c] = fmaf(w, a[c], o[c]);
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (32 * c + lane < dv) store(out + row * dv + 32 * c + lane, lf > 0.f ? o[c] / lf : 0.f);
  }

  if (probs == nullptr) return;
  float* p_row = probs + row * M;
  const int lo = blockIdx.y * kCombineKeys, hi = min(M, lo + kCombineKeys);
  if ((M & 3) == 0) {   // rows start 16-byte aligned: float4 loads and stores
    constexpr int kPer = kCombineKeys / 128;   // float4 groups per lane
    float4 x[kPer];       // all of the lane's scores loaded before any is used
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = lo + 4 * lane + 128 * u;
      x[u] = e < end ? *reinterpret_cast<const float4*>(p_row + e)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = lo + 4 * lane + 128 * u;
      if (e >= hi) break;
      if (e < end) {
        x[u].x = expf(x[u].x - mf) / lf;
        x[u].y = e + 1 < end ? expf(x[u].y - mf) / lf : 0.f;
        x[u].z = e + 2 < end ? expf(x[u].z - mf) / lf : 0.f;
        x[u].w = e + 3 < end ? expf(x[u].w - mf) / lf : 0.f;
      }
      *reinterpret_cast<float4*>(p_row + e) = x[u];
    }
  } else {
    for (int e = lo + lane; e < hi; e += 32)
      p_row[e] = e < end ? expf(p_row[e] - mf) / lf : 0.f;
  }
}

// Launch the combine for b * hq * C query rows on `stream` (out in T)
template <typename T>
cudaError_t launch_combine(const float* ws_m, const float* ws_l, const float* ws_acc,
                           const int* kv_len, const int* q_start, const int* q_lens, T* out,
                           float* probs, int b, int hq, int C, int M, int dv, int split_len,
                           int n_split, cudaStream_t s) {
  const size_t n_rows = (size_t)b * hq * C;
  const dim3 grid((unsigned)((n_rows + kCombineRows - 1) / kCombineRows),
                  probs == nullptr ? 1 : (M + kCombineKeys - 1) / kCombineKeys);
  flash_decode_kernel_combine<T><<<grid, 32 * kCombineRows, 0, s>>>(
      ws_m, ws_l, ws_acc, kv_len, q_start, q_lens, out, probs, hq, C, M, dv, split_len, n_split,
      n_rows);
  return cudaGetLastError();
}

}  // namespace
