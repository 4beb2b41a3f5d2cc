// Flash decode for f32 inputs on NVIDIA Hopper (sm_90a), hand-written CUDA
// C++ on the CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/decode_attn.py:flash_decode
// (Pallas body _decode_kernel) for f32 q, k and v; bf16 inputs go to
// csrc/decode_attn_bf16.cu. Same function, same masks:
//
//   q (b, hq, C, r), k (b, hkv, M, r), v (b, hkv, M, dv), per-row int32
//   kv_len / q_start / q_lens. Query j of row b sees key position p iff
//   p < kv_len[b], p <= q_start[b] + j and j < q_lens[b]; so its visible
//   keys are exactly [0, key_end) with key_end = min(kv_len, q_start + j + 1,
//   M), or none when j >= q_lens. GQA maps q head h to kv head
//   h / (hq / hkv). out (b, hq, C, dv) in f32; optional normalised
//   probability rows probs (b, hq, C, M) in f32. A masked score contributes
//   exactly 0 (never exp(0)); a query with no visible key gives an all-zero
//   output row and an all-zero probability row. r, dv in 1 .. 128.
//
// What bounds it on an H100. At C = 1 (decode): bytes. A query does about
// 2 (r + dv) flops per key against 4 (r + dv) bytes of K and V in f32, far
// below the card's f32 ridge (67 TFLOP/s over 3.35 TB/s = 20 flop/B). At
// C = 128 (the mixed prefill + decode step) with probs: still bytes, now
// the probability rows (C * M * 4 bytes per head, 100 MB at the serving
// shape), which outweigh the K/V reads; the f32 arithmetic (no TF32, for
// parity with the f32 reference) sits just below that bound.
//
// Design: split the keys across blocks, then combine. Blocks run in no
// order and nothing carries over between them, so the Pallas kernel's
// sequential kv grid axis becomes a split of the key axis into n_split
// ranges of split_len keys, chosen on the host from shapes alone (about 8
// blocks per SM in total; the wrapper never reads kv_len). A block whose
// range lies past the last key its queries can see exits at once. Each
// block makes ONE pass over its K and V rows with an online softmax and
// writes its partial (m, l, acc) per query to a workspace; with probs it
// also writes each visible key's scaled score s into the probability row.
// The combine kernel then merges a query's partials in split order (no
// atomics, so results repeat run to run), writes out = sum_s acc_s
// exp(m_s - m) / l, and turns the scores into exp(s - m) / l, writing
// exact zeros past the window. A split in which a query sees no key holds
// m = -inf, l = 0, acc = 0; the combine reads only the splits below
// ceil(key_end / split_len), each of which holds a visible key, and weighs
// an m = -inf partial by 0 all the same.
//   * decode path (C <= 16; flash_decode_kernel_split): one block of 4
//     warps per (key split, b * hkv, tile of query rows). The rows are
//     the (q head of the kv head's group, query) pairs, 1 per block when
//     hq = hkv and C = 1, else 4, so a GQA group's q heads share one read
//     of each K/V row. Eight lanes own one key: each loads its slice of
//     the K row and of the V row with 16-byte vector loads where width and
//     pointer allow (scalar tail otherwise),
//     the next key's slices are loaded before the current key is used,
//     a score is reduced with three xor shuffles, and each 8-lane group
//     keeps its own online (m, l, acc); the 16 groups merge in a fixed
//     order at the end.
//   * chunk path (C > 16; flash_decode_kernel_chunk): the register tile
//     of lowrank_flash.cu, fed by 128-bit shared loads. One block of 128
//     threads per (key split, b * hq, tile of 64 queries) walks 64-key
//     tiles staged as f32 in shared memory, Q and K transposed; thread
//     (ty, tx) computes the 4 x 8 scores of queries ty * 4 + i and keys
//     tx * 4 + c, 32 + tx * 4 + c from three float4 loads per step of r,
//     a query's online softmax reduces its 8 lanes with three xor
//     shuffles, and P.V takes each probability from its owner lane and
//     four V columns per float4 load.
//   * combine (flash_decode_kernel_combine, csrc/decode_combine.cuh, shared
//     with the bf16 kernel): one warp per query row and 512 probability
//     columns.
//   * K and V are read through element strides (batch, head, key; the last
//     dimension unit-stride), so a (b, hkv, kv_len, d) view of a
//     (b, max_len, hkv, d) cache is read in place, uncopied.
// Left for later: tensor cores for the chunk path (a TF32
// tolerance decision), TMA or cp.async rings, and a combine fused into the
// last block of each query.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "decode_combine.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDim = 128;       // largest r and dv this kernel takes
// decode path
constexpr int kSlots = kThreads / 8;  // keys in flight per block: one per 8-lane group
constexpr int kDecodeMaxC = 16;       // larger chunks take the chunk path
constexpr int kRowTile = 4;           // query rows per decode block (unless 1 in all)
// chunk path
constexpr int kBQ = 64;            // queries per block
constexpr int kBK = 64;            // keys per tile
constexpr int kRows = 4;           // queries per thread: ty * 4 + i
constexpr int kCols = 8;           // keys per thread and tile
constexpr int kTS = kBQ + 4;       // row stride of the transposed Q and K tiles
constexpr int kLoads = 4;          // tile loads in flight per thread

// K's and V's element strides: batch, head, key
struct KVStrides {
  long long kb, kh, kk, vb, vh, vk;
};

// Elements e .. e + 3 of a row of `width` as f32, zero past the width. With
// vec (width % 4 == 0 and the row aligned) a full group is one vector load.
__device__ __forceinline__ float4 load4(const float* row, int e, int width, bool vec) {
  if (vec && e + 4 <= width) return __ldg(reinterpret_cast<const float4*>(row + e));
  return make_float4(e < width ? row[e] : 0.f, e + 1 < width ? row[e + 1] : 0.f,
                     e + 2 < width ? row[e + 2] : 0.f, e + 3 < width ? row[e + 3] : 0.f);
}

// ---------------------------------------------------------------- decode path

// NV: 4-element groups per lane (lane li of an 8-lane group owns elements
// 4 (li + 8 c) .. + 3, c < NV), so r, dv <= 32 NV. QR: query rows per block.
template <int NV, int QR>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel_split(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const int* __restrict__ kv_len,
                          const int* __restrict__ q_start, const int* __restrict__ q_lens,
                          float* __restrict__ probs, float* __restrict__ ws_m,
                          float* __restrict__ ws_l, float* __restrict__ ws_acc, int hq, int hkv,
                          int C, int M, int r, int dv, int split_len, int n_split,
                          KVStrides st, int vec_k, int vec_v, float scale) {
  __shared__ float red_m[kWarps][QR], red_l[kWarps][QR];
  __shared__ float red_acc[kWarps][QR][32 * NV];

  const int s = blockIdx.x;
  const int bkv = blockIdx.y;
  const int b = bkv / hkv;
  const int group = hq / hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 3, li = lane & 7;
  const int len = kv_len[b], qs = q_start[b], ql = q_lens[b];

  // this block's query rows: (q head g of the group, query j) pairs
  int end[QR];
  size_t row_id[QR];     // (b * hq + h) * C + j
  int tile_hi = 0;
#pragma unroll
  for (int i = 0; i < QR; ++i) {
    const int ri = blockIdx.z * QR + i;
    const int g = ri / C, j = ri - (ri / C) * C;
    const bool ok = ri < group * C;
    row_id[i] = ok ? ((size_t)b * hq + (size_t)(bkv - b * hkv) * group + g) * C + j : 0;
    end[i] = ok ? key_end(j, len, qs, ql, M) : 0;
    tile_hi = max(tile_hi, end[i]);
  }
  const int k0 = s * split_len;
  const int k1 = min(k0 + split_len, tile_hi);
  if (k0 >= k1) return;  // no query of the tile sees a key of this split

  float qv[QR][NV][4];
#pragma unroll
  for (int i = 0; i < QR; ++i)
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const float4 x = end[i] > 0 ? load4(q + row_id[i] * r, 4 * (li + 8 * c), r, false)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
      qv[i][c][0] = x.x; qv[i][c][1] = x.y; qv[i][c][2] = x.z; qv[i][c][3] = x.w;
    }

  float m[QR], l[QR], acc[QR][NV][4];
#pragma unroll
  for (int i = 0; i < QR; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][c][t] = 0.f;
  }

  const int kvh = bkv - b * hkv;
  const float* k_bh = k + b * st.kb + kvh * st.kh;
  const float* v_bh = v + b * st.vb + kvh * st.vh;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  // warp w takes keys base + grp, base = k0 + 4 w + 16 t: the trip count is
  // uniform across the warp, so full-warp shuffles are safe
  float4 kr[NV], vr[NV];
  {
    const int key = k0 + 4 * warp + grp;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      kr[c] = key < k1 ? load4(k_bh + key * st.kk, 4 * (li + 8 * c), r, vec_k) : zero;
      vr[c] = key < k1 ? load4(v_bh + key * st.vk, 4 * (li + 8 * c), dv, vec_v) : zero;
    }
  }
  for (int base = k0 + 4 * warp; base < k1; base += kSlots) {
    const int key = base + grp;
    const int nxt = key + kSlots;
    float4 kn[NV], vn[NV];   // the next key's slices, loaded before this key is used
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      kn[c] = nxt < k1 ? load4(k_bh + nxt * st.kk, 4 * (li + 8 * c), r, vec_k) : zero;
      vn[c] = nxt < k1 ? load4(v_bh + nxt * st.vk, 4 * (li + 8 * c), dv, vec_v) : zero;
    }
#pragma unroll
    for (int i = 0; i < QR; ++i) {
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        d = fmaf(qv[i][c][0], kr[c].x, d);
        d = fmaf(qv[i][c][1], kr[c].y, d);
        d = fmaf(qv[i][c][2], kr[c].z, d);
        d = fmaf(qv[i][c][3], kr[c].w, d);
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      d += __shfl_xor_sync(0xffffffffu, d, 4);
      if (key < end[i]) {   // uniform within the 8-lane group
        const float sc = d * scale;
        if (probs != nullptr && li == 0) probs[row_id[i] * M + key] = sc;
        const float mn = fmaxf(m[i], sc);
        const float corr = expf(m[i] - mn);   // 0 while m is -inf
        const float p = expf(sc - mn);
        l[i] = fmaf(l[i], corr, p);
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          acc[i][c][0] = fmaf(p, vr[c].x, acc[i][c][0] * corr);
          acc[i][c][1] = fmaf(p, vr[c].y, acc[i][c][1] * corr);
          acc[i][c][2] = fmaf(p, vr[c].z, acc[i][c][2] * corr);
          acc[i][c][3] = fmaf(p, vr[c].w, acc[i][c][3] * corr);
        }
        m[i] = mn;
      }
    }
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      kr[c] = kn[c];
      vr[c] = vn[c];
    }
  }

  // merge the warp's four groups (lanes xor 8, 16), then the four warps
#pragma unroll
  for (int i = 0; i < QR; ++i) {
    float mw = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 8));
    mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, 16));
    const float f = m[i] == -INFINITY ? 0.f : expf(m[i] - mw);
    float lw = l[i] * f;
    lw += __shfl_xor_sync(0xffffffffu, lw, 8);
    lw += __shfl_xor_sync(0xffffffffu, lw, 16);
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float a = acc[i][c][t] * f;
        a += __shfl_xor_sync(0xffffffffu, a, 8);
        a += __shfl_xor_sync(0xffffffffu, a, 16);
        if (grp == 0) red_acc[warp][i][4 * (li + 8 * c) + t] = a;
      }
    if (lane == 0) {
      red_m[warp][i] = mw;
      red_l[warp][i] = lw;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < QR * dv; idx += kThreads) {
    const int i = idx / dv, e = idx - (idx / dv) * dv;
    const int ri = blockIdx.z * QR + i;
    if (ri >= group * C) continue;
    const int g = ri / C, j = ri - (ri / C) * C;
    const size_t row = ((size_t)b * hq + (size_t)(bkv - b * hkv) * group + g) * C + j;
    float mb = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, red_m[w][i]);
    float o = 0.f, lb = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = red_m[w][i] == -INFINITY ? 0.f : expf(red_m[w][i] - mb);
      o = fmaf(f, red_acc[w][i][e], o);
      lb = fmaf(f, red_l[w][i], lb);
    }
    const size_t part = row * n_split + s;
    ws_acc[part * dv + e] = o;
    if (e == 0) {
      ws_m[part] = mb;
      ws_l[part] = lb;
    }
  }
}

// ----------------------------------------------------------------- chunk path

// NC: output columns per thread, c4 * 32 + tx * 4 + t for c4 < NC / 4 and
// t < 4, so 8 * NC >= dv (NC = 4, 8 or 16).
template <int NC>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel_chunk(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const int* __restrict__ kv_len,
                          const int* __restrict__ q_start, const int* __restrict__ q_lens,
                          float* __restrict__ probs, float* __restrict__ ws_m,
                          float* __restrict__ ws_l, float* __restrict__ ws_acc, int hq, int hkv,
                          int C, int M, int r, int dv, int split_len, int n_split,
                          KVStrides st, int vec_k, int vec_v, float scale) {
  constexpr int kVS = 8 * NC;      // V tile row stride (zero-padded columns)
  extern __shared__ __align__(16) float smem[];
  float* q_t = smem;               // r x kTS: Q tile, transposed (query-minor)
  float* k_t = q_t + r * kTS;      // r x kTS: K tile, transposed (key-minor)
  float* v_s = k_t + r * kTS;      // kBK x kVS

  const int s = blockIdx.x;
  const int bh = blockIdx.y;                         // b * hq + h
  const int b = bh / hq;
  const int q0 = blockIdx.z * kBQ;
  const int kvh = (bh - b * hq) / (hq / hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int tx = tid & 7, ty = tid >> 3;
  const int grp = lane & ~7;                         // first lane of the row group
  const int len = kv_len[b], qs = q_start[b], ql = q_lens[b];

  const int n_q = min(kBQ, C - q0);
  // key_end grows with j, so the tile's last valid query bounds it
  const int n_valid = max(0, min(n_q, ql - q0));
  const int tile_hi = n_valid > 0 ? key_end(q0 + n_valid - 1, len, qs, ql, M) : 0;
  const int k0 = s * split_len;
  const int k1 = min(k0 + split_len, tile_hi);
  if (k0 >= k1) return;  // no query of the tile sees a key of this split

  const float* q_bh = q + ((size_t)bh * C + q0) * r;
  const float* k_bh = k + b * st.kb + kvh * st.kh;
  const float* v_bh = v + b * st.vb + kvh * st.vh;
  for (int row = warp; row < kBQ; row += kWarps)
    for (int d = lane; d < r; d += 32)
      q_t[d * kTS + row] = row < n_q ? q_bh[(size_t)row * r + d] : 0.f;

  // thread (ty, tx) owns queries ty * 4 + i and, in each tile, keys
  // tx * 4 + c and 32 + tx * 4 + c (c < 4): all 128-bit shared loads
  int end[kRows];
  float m[kRows], l[kRows], o[kRows][NC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = ty * 4 + i;
    end[i] = row < n_q ? key_end(q0 + row, len, qs, ql, M) : 0;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) o[i][cc] = 0.f;
  }
  float* p_base = probs == nullptr ? nullptr : probs + ((size_t)bh * C + q0 + ty * 4) * M;
  const bool vec_p = (M & 3) == 0;

  const int r4 = (r + 3) / 4;
  for (int t0 = k0; t0 < k1; t0 += kBK) {
    __syncthreads();               // the previous tile is consumed
    // K, then V, kLoads vector loads in flight per thread before their
    // stores. K: lanes take consecutive keys of one 4-element column
    // group, so the transposed stores are free of bank conflicts.
    for (int base = tid; base < kBK * r4; base += kLoads * kThreads) {
      float4 x[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int idx = base + u * kThreads;
        const int key = idx & (kBK - 1), e = 4 * (idx / kBK);
        x[u] = idx < kBK * r4 && t0 + key < k1
                   ? load4(k_bh + (t0 + key) * st.kk, e, r, vec_k)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int idx = base + u * kThreads;
        if (idx >= kBK * r4) break;
        const int key = idx & (kBK - 1), e = 4 * (idx / kBK);
        float* dst = k_t + e * kTS + key;
        dst[0] = x[u].x;
        if (e + 1 < r) dst[kTS] = x[u].y;
        if (e + 2 < r) dst[2 * kTS] = x[u].z;
        if (e + 3 < r) dst[3 * kTS] = x[u].w;
      }
    }
    for (int base = tid; base < kBK * (kVS / 4); base += kLoads * kThreads) {
      float4 x[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int idx = base + u * kThreads;
        const int row = idx / (kVS / 4), e = 4 * (idx - row * (kVS / 4));
        x[u] = idx < kBK * (kVS / 4) && t0 + row < k1
                   ? load4(v_bh + (t0 + row) * st.vk, e, dv, vec_v)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int idx = base + u * kThreads;
        if (idx >= kBK * (kVS / 4)) break;
        *reinterpret_cast<float4*>(v_s + idx * 4) = x[u];   // row * kVS + e
      }
    }
    __syncthreads();

    // scores: a 4 x 8 register tile per thread, three 128-bit loads per d
    float sc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) sc[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < r; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(q_t + d * kTS + ty * 4);
      const float4 ka = *reinterpret_cast<const float4*>(k_t + d * kTS + tx * 4);
      const float4 kb = *reinterpret_cast<const float4*>(k_t + d * kTS + 32 + tx * 4);
      const float qv[kRows] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[kCols] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) sc[i][c] = fmaf(qv[i], kv[c], sc[i][c]);
    }

    // masks, the scores into probs, the online softmax; sc becomes p
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int key = t0 + (c >> 2) * 32 + tx * 4 + (c & 3);
        sc[i][c] = key < end[i] ? sc[i][c] * scale : -INFINITY;
        mx = fmaxf(mx, sc[i][c]);
      }
      if (p_base != nullptr) {
        float* p_row = p_base + (size_t)i * M;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int key = t0 + h * 32 + tx * 4;
          if (vec_p && key + 3 < end[i]) {
            *reinterpret_cast<float4*>(p_row + key) =
                make_float4(sc[i][4 * h], sc[i][4 * h + 1], sc[i][4 * h + 2], sc[i][4 * h + 3]);
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (key + c < end[i]) p_row[key + c] = sc[i][4 * h + c];
          }
        }
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        sc[i][c] = sc[i][c] == -INFINITY ? 0.f : expf(sc[i][c] - m_new);
        sum += sc[i][c];
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) o[i][cc] *= corr;
    }

    // P.V: key (c >> 2) * 32 + src * 4 + (c & 3) is sc[.][c] of lane grp + src
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
#pragma unroll
      for (int src = 0; src < 8; ++src) {
        float p[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) p[i] = __shfl_sync(0xffffffffu, sc[i][c], grp + src);
        const float* v_row = v_s + ((c >> 2) * 32 + src * 4 + (c & 3)) * kVS + tx * 4;
#pragma unroll
        for (int c4 = 0; c4 < NC / 4; ++c4) {
          const float4 vv = *reinterpret_cast<const float4*>(v_row + 32 * c4);
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            o[i][4 * c4] = fmaf(p[i], vv.x, o[i][4 * c4]);
            o[i][4 * c4 + 1] = fmaf(p[i], vv.y, o[i][4 * c4 + 1]);
            o[i][4 * c4 + 2] = fmaf(p[i], vv.z, o[i][4 * c4 + 2]);
            o[i][4 * c4 + 3] = fmaf(p[i], vv.w, o[i][4 * c4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = ty * 4 + i;
    if (row >= n_q) continue;
    const size_t part = ((size_t)bh * C + q0 + row) * n_split + s;
    if (tx == 0) {
      ws_m[part] = m[i];
      ws_l[part] = l[i];
    }
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int col = (cc >> 2) * 32 + tx * 4 + (cc & 3);
      if (col < dv) ws_acc[part * dv + col] = o[i][cc];
    }
  }
}

// ---------------------------------------------------------------- launch

template <int NV, int QR>
cudaError_t launch_split(const float* q, const float* k, const float* v, const int* kv_len,
                         const int* q_start, const int* q_lens, float* probs, float* ws_m,
                         float* ws_l, float* ws_acc, int b, int hq, int hkv, int C, int M, int r,
                         int dv, int split_len, int n_split, KVStrides st, int vec_k, int vec_v,
                         float scale, cudaStream_t stream) {
  const int rows = hq / hkv * C;
  const dim3 grid(n_split, b * hkv, (rows + QR - 1) / QR);
  flash_decode_kernel_split<NV, QR><<<grid, kThreads, 0, stream>>>(
      q, k, v, kv_len, q_start, q_lens, probs, ws_m, ws_l, ws_acc, hq, hkv, C, M, r, dv,
      split_len, n_split, st, vec_k, vec_v, scale);
  return cudaGetLastError();
}

template <int NV>
cudaError_t dispatch_split(const float* q, const float* k, const float* v, const int* kv_len,
                           const int* q_start, const int* q_lens, float* probs, float* ws_m,
                           float* ws_l, float* ws_acc, int b, int hq, int hkv, int C, int M,
                           int r, int dv, int split_len, int n_split, KVStrides st,
                           int vec_k, int vec_v, float scale, cudaStream_t s) {
  if (hq / hkv * C == 1)
    return launch_split<NV, 1>(q, k, v, kv_len, q_start, q_lens, probs, ws_m, ws_l, ws_acc,
                               b, hq, hkv, C, M, r, dv, split_len, n_split, st, vec_k,
                               vec_v, scale, s);
  return launch_split<NV, kRowTile>(q, k, v, kv_len, q_start, q_lens, probs, ws_m, ws_l,
                                    ws_acc, b, hq, hkv, C, M, r, dv, split_len, n_split,
                                    st, vec_k, vec_v, scale, s);
}

template <int NC>
cudaError_t launch_chunk(const float* q, const float* k, const float* v, const int* kv_len,
                         const int* q_start, const int* q_lens, float* probs, float* ws_m,
                         float* ws_l, float* ws_acc, int b, int hq, int hkv, int C, int M, int r,
                         int dv, int split_len, int n_split, KVStrides st, int vec_k, int vec_v,
                         float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)r * kTS + (size_t)kBK * 8 * NC);
  cudaError_t err = cudaFuncSetAttribute(flash_decode_kernel_chunk<NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_split, b * hq, (C + kBQ - 1) / kBQ);
  flash_decode_kernel_chunk<NC><<<grid, kThreads, smem, stream>>>(
      q, k, v, kv_len, q_start, q_lens, probs, ws_m, ws_l, ws_acc, hq, hkv, C, M, r, dv,
      split_len, n_split, st, vec_k, vec_v, scale);
  return cudaGetLastError();
}

cudaError_t run(const void* q_, const void* k_, const void* v_, const int* kv_len,
                const int* q_start, const int* q_lens, void* out_, float* probs, float* ws,
                int b, int hq, int hkv, int C, int M, int r, int dv, int split_len, int n_split,
                KVStrides st, float scale, cudaStream_t s) {
  const float* q = static_cast<const float*>(q_);
  const float* k = static_cast<const float*>(k_);
  const float* v = static_cast<const float*>(v_);
  const size_t n_part = (size_t)b * hq * C * n_split;
  float* ws_m = ws;
  float* ws_l = ws + n_part;
  float* ws_acc = ws + 2 * n_part;
  // vector loads need rows of whole 4-element groups on a vector boundary:
  // the width, the base and every stride a multiple of 4 elements
  const uintptr_t align = 4 * sizeof(float);
  const int vec_k = r % 4 == 0 && reinterpret_cast<uintptr_t>(k) % align == 0 &&
                    (st.kb | st.kh | st.kk) % 4 == 0;
  const int vec_v = dv % 4 == 0 && reinterpret_cast<uintptr_t>(v) % align == 0 &&
                    (st.vb | st.vh | st.vk) % 4 == 0;
  cudaError_t err;
  if (C <= kDecodeMaxC) {
    const int w = max(r, dv);
    if (w <= 32)
      err = dispatch_split<1>(q, k, v, kv_len, q_start, q_lens, probs, ws_m, ws_l, ws_acc, b,
                              hq, hkv, C, M, r, dv, split_len, n_split, st, vec_k, vec_v, scale,
                              s);
    else if (w <= 64)
      err = dispatch_split<2>(q, k, v, kv_len, q_start, q_lens, probs, ws_m, ws_l, ws_acc, b,
                              hq, hkv, C, M, r, dv, split_len, n_split, st, vec_k, vec_v, scale,
                              s);
    else
      err = dispatch_split<4>(q, k, v, kv_len, q_start, q_lens, probs, ws_m, ws_l, ws_acc, b,
                              hq, hkv, C, M, r, dv, split_len, n_split, st, vec_k, vec_v, scale,
                              s);
  } else {
#define CHUNK(NC)                                                                             \
  launch_chunk<NC>(q, k, v, kv_len, q_start, q_lens, probs, ws_m, ws_l, ws_acc, b, hq, hkv, \
                   C, M, r, dv, split_len, n_split, st, vec_k, vec_v, scale, s)
    err = dv <= 32 ? CHUNK(4) : dv <= 64 ? CHUNK(8) : CHUNK(16);
#undef CHUNK
  }
  if (err != cudaSuccess) return err;
  return launch_combine<float>(ws_m, ws_l, ws_acc, kv_len, q_start, q_lens,
                               static_cast<float*>(out_), probs, b, hq, C, M, dv, split_len,
                               n_split, s);
}

}  // namespace

// Plain C entry point (loaded with ctypes). All tensors are on the current
// device; q, out, probs and the lengths are contiguous; k and v are read
// through their element strides (k_sb, k_sh, k_sk: batch, head, key; the
// last dimension unit-stride). q, k, v and out are float32; probs may be
// null. The key axis is cut into n_split ranges of
// split_len keys (a multiple of 16 when C <= 16, of 64 otherwise); the f32
// workspace holds b * hq * C * n_split * (dv + 2) floats. Launches the path
// kernel and the combine on `stream`. Returns a cudaError_t value (0 =
// both launched).
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* kv_len, const void* q_start, const void* q_lens,
                                   void* out, void* probs, void* workspace, int b, int hq, int hkv,
                                   int C, int M, int r, int dv, int split_len, int n_split,
                                   long long k_sb, long long k_sh, long long k_sk, long long v_sb,
                                   long long v_sh, long long v_sk, float scale, void* stream) {
  const int unit = C <= kDecodeMaxC ? kSlots : kBK;
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || C < 1 || M < 1 || r < 1 ||
      r > kMaxDim || dv < 1 || dv > kMaxDim || split_len < unit || split_len % unit != 0 ||
      n_split < 1 || n_split > 65535 || (long long)split_len * n_split < M ||
      (long long)split_len * (n_split - 1) >= M || (long long)b * hq > 65535 ||
      (long long)b * hq * C > 0x7fffffffLL || k_sb < 0 || k_sh < 0 || k_sk < 0 || v_sb < 0 ||
      v_sh < 0 || v_sk < 0)
    return (int)cudaErrorInvalidValue;
  const KVStrides st{k_sb, k_sh, k_sk, v_sb, v_sh, v_sk};
  const int* lens = static_cast<const int*>(kv_len);
  const int* starts = static_cast<const int*>(q_start);
  const int* qlens = static_cast<const int*>(q_lens);
  float* p = static_cast<float*>(probs);
  float* ws = static_cast<float*>(workspace);
  return (int)run(q, k, v, lens, starts, qlens, out, p, ws, b, hq, hkv, C, M, r, dv,
                  split_len, n_split, st, scale, static_cast<cudaStream_t>(stream));
}
