// Flash decode for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/decode_attn.py:flash_decode
// (Pallas body _decode_kernel). Same function, same masks:
//
//   q (b, hq, C, r), k (b, hkv, M, r), v (b, hkv, M, dv), per-row int32
//   kv_len / q_start / q_lens. Query j of row b sees key position p iff
//   p < kv_len[b], p <= q_start[b] + j and j < q_lens[b]. GQA maps q head h
//   to kv head h / (hq / hkv). out (b, hq, C, dv) in v's type; optional
//   normalised probability rows probs (b, hq, C, M) in f32. A masked score
//   contributes exactly 0 (never exp(0)); a query with no visible key gives
//   an all-zero output row and an all-zero probability row.
//
// What bounds it on an H100: bytes. A decode call (C = 1) does about
// 2 (r + dv) flops per key against 4 (r + dv) bytes of K and V in f32,
// far below the card's f32 ridge (67 TFLOP/s over 3.35 TB/s = 20 flop/B).
// A prefill chunk (C = 128) with probs writes C * M * 4 bytes of
// probabilities, which then outweigh the K/V reads; its f32 arithmetic
// (no TF32, for parity with the f32 reference) sits near the ridge.
//
// Design. The Pallas kernel walks the kv axis as a sequential grid axis
// and carries m / l / acc and a (C, M) probability strip in VMEM scratch.
// A CUDA block cannot hold that strip (1 MB at C = 128, M = 2048) and
// blocks run in no order, so this kernel has no sequential grid axis:
//   * one block of 4 warps per (row b, q head, tile of 16 queries); the
//     block loops over 128-key tiles itself and stops at the last key any
//     of its queries can see, so keys past kv_len are never read;
//   * warp w takes keys w*32 .. w*32+31 of each tile, one key per lane,
//     staged in its own shared-memory slice as f32 (K rows padded to r+1
//     floats so the lane-per-key reads are free of bank conflicts);
//   * pass 1 streams K and keeps an online max and denominator per query
//     (lane j of a warp holds query j's pair); the four warps' partial
//     (m, l) merge through shared memory;
//   * pass 2 streams K again and V, writes p = exp(s - m) / l straight to
//     probs (32 consecutive keys per warp store) and accumulates P.V into
//     a per-warp f32 accumulator in shared memory (lane-private columns);
//     the warps' partial outputs are summed in a fixed order, so the
//     result does not change from run to run;
//   * probability columns past the streamed tiles are written as zeros.
// Cost of this design: K is read twice, so a decode call moves about
// 1.5x its bound's bytes; a GQA kv head is re-read once per q head; at
// C = 1 three of the four warps' query slots idle. Splitting the keys of
// one (row, head) across blocks and sharing K/V over the q heads of a kv
// group are the obvious next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kQT = 16;            // queries per block
constexpr int kKW = 32;            // keys per warp per tile: one per lane
constexpr int kKT = kWarps * kKW;  // keys per block tile
constexpr int kMaxDim = 128;       // largest r and dv this kernel takes
constexpr int kDvChunks = kMaxDim / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows row0 .. row0 + kKW - 1 of a row-major (rows, width) matrix into
// shared memory as f32 with row stride `stride`; rows >= row_hi become 0
// and are never read from device memory.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int stride, const T* src, int row0,
                                          int row_hi, int width, int lane) {
  const T* base = src + (size_t)row0 * width;
  const int n = kKW * width;
  for (int i = lane; i < n; i += 32) {
    const int row = i / width;
    const int col = i - row * width;
    dst[row * stride + col] = (row0 + row < row_hi) ? to_f32(base[i]) : 0.f;
  }
}

__device__ __forceinline__ float dot(const float* a, const float* b, int n) {
  float s = 0.f;
  for (int d = 0; d < n; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ kv_len, const int* __restrict__ q_start,
                    const int* __restrict__ q_lens, T* __restrict__ out,
                    float* __restrict__ probs, int hq, int hkv, int C, int M, int r, int dv,
                    float scale) {
  extern __shared__ float smem[];
  const int j0 = blockIdx.x * kQT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t bh = (size_t)b * hq + h;
  const size_t bkv = (size_t)b * hkv + h / (hq / hkv);

  const int qs = q_start[b];
  const int n_q = max(0, min(kQT, min(C, q_lens[b]) - j0));  // valid queries of the tile
  const int n_rows = min(kQT, C - j0);                         // query rows the block writes
  // one past the last key any valid query of the tile can see
  int key_hi = n_q > 0 ? min(kv_len[b], qs + j0 + n_q) : 0;
  key_hi = max(0, min(key_hi, M));
  const int n_tiles = (key_hi + kKT - 1) / kKT;

  const int rs = r + 1;
  float* q_s = smem;                                            // kQT x r
  float* k_s = q_s + kQT * r + warp * kKW * (rs + dv);          // this warp: kKW x rs
  float* v_s = k_s + kKW * rs;                                  //            kKW x dv
  float* acc_all = q_s + kQT * r + kWarps * kKW * (rs + dv);    // kWarps x kQT x dv
  float* acc_s = acc_all + warp * kQT * dv;
  float* red_m = acc_all + kWarps * kQT * dv;                   // kWarps x kQT
  float* red_l = red_m + kWarps * kQT;                          // kWarps x kQT

  for (int i = threadIdx.x; i < n_q * r; i += kThreads)
    q_s[i] = to_f32(q[(bh * C + j0) * r + i]);
  for (int i = lane; i < kQT * dv; i += 32) acc_s[i] = 0.f;
  __syncthreads();

  const T* k_bh = k + bkv * M * r;
  const T* v_bh = v + bkv * M * dv;

  // pass 1: online max and denominator per query over this warp's keys;
  // lane qi keeps query qi's running (m, l)
  float m_own = -INFINITY, l_own = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int base = t * kKT + warp * kKW;
    load_rows(k_s, rs, k_bh, base, key_hi, r, lane);
    __syncwarp();
    const int key = base + lane;
#pragma unroll 1
    for (int qi = 0; qi < n_q; ++qi) {
      const bool vis = key < key_hi && key <= qs + j0 + qi;
      const float s = vis ? dot(q_s + qi * r, k_s + lane * rs, r) * scale : -INFINITY;
      const float m_old = __shfl_sync(0xffffffffu, m_own, qi);
      const float m_new = fmaxf(m_old, warp_max(s));
      const float e = vis ? expf(s - m_new) : 0.f;
      const float corr = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
      const float l_tile = warp_sum(e);
      if (lane == qi) {
        l_own = l_own * corr + l_tile;
        m_own = m_new;
      }
    }
    __syncwarp();
  }
  if (lane < kQT) {
    red_m[warp * kQT + lane] = m_own;
    red_l[warp * kQT + lane] = l_own;
  }
  __syncthreads();
  // merge the four warps' (m, l); lane qi holds query qi's final pair
  float m_fin = -INFINITY, l_fin = 0.f;
  if (lane < kQT) {
    for (int w = 0; w < kWarps; ++w) m_fin = fmaxf(m_fin, red_m[w * kQT + lane]);
    for (int w = 0; w < kWarps; ++w) {
      const float mw = red_m[w * kQT + lane];
      l_fin += mw == -INFINITY ? 0.f : red_l[w * kQT + lane] * expf(mw - m_fin);
    }
  }

  // pass 2: normalised probabilities and P.V (this warp's keys)
  for (int t = 0; t < n_tiles; ++t) {
    const int base = t * kKT + warp * kKW;
    load_rows(k_s, rs, k_bh, base, key_hi, r, lane);
    load_rows(v_s, dv, v_bh, base, key_hi, dv, lane);
    __syncwarp();
    const int key = base + lane;
#pragma unroll 1
    for (int qi = 0; qi < n_q; ++qi) {
      const bool vis = key < key_hi && key <= qs + j0 + qi;
      const float m = __shfl_sync(0xffffffffu, m_fin, qi);
      const float l = __shfl_sync(0xffffffffu, l_fin, qi);
      const float p = vis ? expf(dot(q_s + qi * r, k_s + lane * rs, r) * scale - m) / l : 0.f;
      if (probs != nullptr && key < M) probs[(bh * C + j0 + qi) * M + key] = p;
      float acc[kDvChunks];
#pragma unroll
      for (int c = 0; c < kDvChunks; ++c) {
        const int d = lane + 32 * c;
        acc[c] = d < dv ? acc_s[qi * dv + d] : 0.f;
      }
      for (int kk = 0; kk < kKW; ++kk) {
        const float pk = __shfl_sync(0xffffffffu, p, kk);
#pragma unroll
        for (int c = 0; c < kDvChunks; ++c) {
          const int d = lane + 32 * c;
          if (d < dv) acc[c] = fmaf(pk, v_s[kk * dv + d], acc[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < kDvChunks; ++c) {
        const int d = lane + 32 * c;
        if (d < dv) acc_s[qi * dv + d] = acc[c];
      }
    }
    __syncwarp();
  }
  __syncthreads();

  // sum the warps' partial outputs in a fixed order; rows past n_q are
  // exact zeros (their accumulators were never touched)
  for (int i = threadIdx.x; i < n_rows * dv; i += kThreads) {
    float o = 0.f;
    for (int w = 0; w < kWarps; ++w) o += acc_all[w * kQT * dv + i];
    store(out + (bh * C + j0) * dv + i, o);
  }

  if (probs != nullptr) {
    const int streamed = min(n_tiles * kKT, M);
    for (int qi = warp; qi < n_rows; qi += kWarps) {
      float* row = probs + (bh * C + j0 + qi) * M;
      for (int kk = (qi < n_q ? streamed : 0) + lane; kk < M; kk += 32) row[kk] = 0.f;
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* kv_len,
                   const int* q_start, const int* q_lens, void* out, float* probs, int b,
                   int hq, int hkv, int C, int M, int r, int dv, float scale,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kQT * r + (size_t)kWarps * kKW * (r + 1 + dv) +
                       (size_t)kWarps * kQT * dv + 2 * kWarps * kQT);
  cudaError_t err = cudaFuncSetAttribute(flash_decode_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((C + kQT - 1) / kQT, hq, b);
  flash_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kv_len,
      q_start, q_lens, static_cast<T*>(out), probs, hq, hkv, C, M, r, dv, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). All tensors are contiguous and
// on the current device; dtype 0 = float32, 1 = bfloat16 for q, k, v and
// out; probs may be null. Returns a cudaError_t value (0 = launched).
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* kv_len, const void* q_start, const void* q_lens,
                                   void* out, void* probs, int b, int hq, int hkv, int C, int M,
                                   int r, int dv, float scale, int dtype, void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || C < 1 || M < 1 || r < 1 ||
      r > kMaxDim || dv < 1 || dv > kMaxDim || b > 65535 || hq > 65535)
    return (int)cudaErrorInvalidValue;
  const int* lens = static_cast<const int*>(kv_len);
  const int* starts = static_cast<const int*>(q_start);
  const int* qlens = static_cast<const int*>(q_lens);
  float* p = static_cast<float*>(probs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(q, k, v, lens, starts, qlens, out, p, b, hq, hkv, C, M, r, dv, scale, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(q, k, v, lens, starts, qlens, out, p, b, hq, hkv, C, M, r, dv,
                                scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
