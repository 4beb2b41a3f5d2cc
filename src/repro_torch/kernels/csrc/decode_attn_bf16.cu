// Flash decode for bf16 inputs on NVIDIA Hopper (sm_90a), hand-written CUDA
// C++ on the bf16 tensor cores (mma.sync.m16n8k16, f32 accumulators).
//
// Replaces the TPU kernel src/repro/kernels/decode_attn.py:122 (flash_decode,
// Pallas body _decode_kernel at :58) for bf16 q, k and v; f32 inputs go to
// csrc/decode_attn.cu. Same function, same masks:
//
//   q (b, hq, C, r), k (b, hkv, M, r), v (b, hkv, M, dv), per-row int32
//   kv_len / q_start / q_lens. Query j of row b sees key position p iff
//   p < kv_len[b], p <= q_start[b] + j and j < q_lens[b], so its visible
//   keys are [0, key_end). GQA maps q head h to kv head h / (hq / hkv).
//   out (b, hq, C, dv) in bf16; optional normalised probability rows probs
//   (b, hq, C, M) in f32. A masked score contributes exactly 0; a query with
//   no visible key gives an all-zero output row and probability row. r, dv
//   in 1 .. 128.
//
// Precision. The TPU kernel turns bf16 inputs into f32, keeps P in f32 and
// rounds only the output; this kernel is held to its f32 plain version
// within 2e-5 + 2^-6 |plain| per output and 2e-5 + 2e-5 |plain| per
// probability.
//   * S = Q K^T in one bf16 pass: a product of two bf16 values is exact in
//     f32, so with f32 accumulation S is the f32 score up to the order of the
//     sum, and the scaled scores written to probs are f32-accurate.
//   * P.V in two: P = P_hi + P_lo, P_hi = bf16(P), P_lo = bf16(P - P_hi).
//     P rounded once misses the output tolerance at near-zero outputs;
//     tests/test_torch_decode_bf16.py emulates both designs against the TPU
//     kernel on the CPU, chip_smoke.py's check_bf16_decode_p_case tells them
//     apart on the card.
//
// What bounds it on an H100: bytes. A decode row (C = 1) does 2 (r + dv)
// operations per key and head against 2 (r + dv) bytes of K and V per key
// and kv head, far under the bf16 ridge (about 295 operations a byte); a
// 128-query chunk of qwen2.5-14b (40/8 heads, r = dv = 128) needs 14 GFLOP
// of useful work (21 GFLOP at three passes) against 32 MB of K/V and, with
// probabilities, 335 MB of f32 rows written and rewritten by the combine.
//
// Design: the key split and combine of csrc/decode_attn.cu. The key axis is
// cut into n_split ranges of split_len keys (a multiple of the 64-key
// tile), chosen on the host from shapes alone; a block whose range lies past
// every key its rows see exits at once; each block writes per row a partial
// (m, l, acc) to the f32 workspace and each visible key's scaled score into
// probs; flash_decode_kernel_combine (csrc/decode_combine.cuh) merges the
// splits in fixed order.
//   * One block of four warps per (key split, b * hkv, tile of rows). The
//     rows are the kv head's (query, q head) pairs, query-major (row =
//     j * group + head), so one read of a K/V tile serves every q head of the
//     GQA group. A tile holds 16 MT rows (MT = 1, 2 or 4: 16, 32 or 64 rows,
//     padded to the MMA's 16 with zero queries): at C = 1 a group of 1-16 q
//     heads is one 16-row tile, a 128-query chunk of a group of 5 is ten
//     64-row tiles.
//   * Warp w owns m-tile w % MT and key group w / MT: the 64 keys of each
//     tile are split into 4 / MT groups of 16 MT keys, each warp keeps its
//     own online (m, l, acc) for its 16 rows, and the key groups merge in
//     fixed order through shared memory at the end.
//   * K and V tiles stream through a three-stage cp.async ring (16-byte
//     copies, zero-filled past the split's last needed key and past the
//     width; rows padded by 16 bytes so ldmatrix is free of bank
//     conflicts). K and V are read through element strides (batch, head,
//     key; the last dimension unit-stride), so a (b, hkv, kv_len, d) view
//     of a (b, max_len, hkv, d) cache is read in place. Widths that are not
//     a multiple of 8, or rows off 16 bytes (the base or a stride), are
//     staged by plain loads into the same layout. Q arrives the same way,
//     once, through the last stage, and stays in registers as A fragments.
//   * S = Q K^T: K fragments by ldmatrix, mma.sync.m16n8k16 over r / 16
//     steps. Masks from the per-row vectors; the online softmax runs on the
//     accumulator registers (2^x of the SFU on (s - m) log2 e); masked
//     scores give exact zeros.
//   * P.V: the S accumulator's fragment is P's A fragment (keys 2t, 2t + 1
//     and 2t + 8, 2t + 9 of rows g and g + 8, the FlashAttention-2 layout),
//     packed as P_hi and P_lo; V fragments by ldmatrix.trans; 16 output
//     columns at a time summed over the warp's keys of this tile alone, then
//     joined to the rescaled output with one f32 FMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "decode_combine.cuh"

namespace {

constexpr int kThreads = 128;       // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 64;             // keys per tile; a key split is a multiple of it
constexpr int kStages = 3;          // K/V ring depth
constexpr int kPad = 8;             // bf16 elements (16 bytes) past each shared row
constexpr int kMaxDim = 128;        // largest r and dv this kernel takes
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// 2^x (the SFU's approximation, relative error about 2^-22; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 bytes; src_bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&d)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&d)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr)
               : "memory");
}

// d (16 x 8, f32) += a (16 x 16, bf16, row-major) b (16 x 8, bf16, column-major)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// Stage an N-row tile of padded width W (row stride W + kPad elements) at
// dst in shared memory: row i from src_row(i) (nullptr: a row of zeros),
// `width` valid columns and zeros past them. Thread x always takes the
// 16-byte chunk x % (W / 8) of rows x / (W / 8) + k 128 / (W / 8). With vec
// (width a multiple of 8, the array 16-byte aligned) each chunk is one
// cp.async; otherwise plain loads and one 16-byte shared store.
template <int W, int N, typename RowFn>
__device__ __forceinline__ void stage_rows(uint32_t dst, int width, bool vec, const bf16* any,
                                           RowFn src_row) {
  constexpr int kChunks = W / 8, kRowStep = kThreads / kChunks;
  const int e = 8 * (threadIdx.x % kChunks), i0 = threadIdx.x / kChunks;
#pragma unroll
  for (int u = 0; u < (N + kRowStep - 1) / kRowStep; ++u) {
    const int i = i0 + u * kRowStep;
    if (N % kRowStep != 0 && i >= N) break;
    const uint32_t d = dst + (uint32_t)(i * (W + kPad) + e) * 2;
    const bf16* src = src_row(i);
    if (vec) {
      const bool in = src != nullptr && e < width;
      cp_async16(d, in ? src + e : any, in ? 16 : 0);
    } else {
      const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
      uint32_t w[4];
#pragma unroll
      for (int pair = 0; pair < 4; ++pair) {
        const int col = e + 2 * pair;
        const uint32_t lo = src != nullptr && col < width ? s16[col] : 0u;
        const uint32_t hi = src != nullptr && col + 1 < width ? s16[col + 1] : 0u;
        w[pair] = lo | hi << 16;
      }
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(d), "r"(w[0]), "r"(w[1]),
                   "r"(w[2]), "r"(w[3])
                   : "memory");
    }
  }
}

// Stage rows [0, valid) of a (rows x width) array starting at src0, rows
// `stride` elements apart (N * stride fits an int), into an N-row tile of
// padded width W, as stage_rows does, with zeros past them: with vec, one
// cp.async per chunk at an address the thread advances by a constant, so a
// tile of the K/V ring costs a few instructions a chunk.
template <int W, int N>
__device__ __forceinline__ void stage_tile(uint32_t dst, const bf16* src0, int stride, int width,
                                           int valid, bool vec, const bf16* any) {
  if (!vec) {
    stage_rows<W, N>(dst, width, false, any, [&](int i) -> const bf16* {
      return i < valid ? src0 + i * stride : nullptr;
    });
    return;
  }
  constexpr int kChunks = W / 8, kRowStep = kThreads / kChunks;
  const int e = 8 * (threadIdx.x % kChunks), i0 = threadIdx.x / kChunks;
  const bf16* src = src0 + i0 * stride + e;
  const uint32_t d = dst + (uint32_t)(i0 * (W + kPad) + e) * 2;
  const bool col = e < width;
#pragma unroll
  for (int u = 0; u < (N + kRowStep - 1) / kRowStep; ++u) {
    if (N % kRowStep != 0 && i0 + u * kRowStep >= N) break;
    cp_async16(d + u * kRowStep * (W + kPad) * 2, src + u * kRowStep * stride,
               col && i0 + u * kRowStep < valid ? 16 : 0);
  }
}

// K's and V's element strides: batch, head, key
struct KVStrides {
  long long kb, kh, kk, vb, vh, vk;
};

// Shared memory a launch of <KR, DV> asks for: the ring, or the key groups'
// merge (which reuses it), whichever is larger
template <int KR, int DV>
constexpr size_t smem_bytes() {
  constexpr size_t ring = (size_t)kStages * kBK * (KR + kPad + DV + kPad) * 2;
  constexpr size_t merge = ((size_t)kWarps * 16 * (DV + kPad) + 2 * kWarps * 16) * 4;
  return ring > merge ? ring : merge;
}

// MT: 16-row m-tiles per block (1, 2 or 4); KR, DV: r and dv padded to 64
// or 128. Narrower widths are staged as zero columns: they cost tensor work
// and shared memory, not device-memory bytes, and keep the build to 12
// instantiations
template <int MT, int KR, int DV>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel_split_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const int* __restrict__ kv_len,
                               const int* __restrict__ q_start, const int* __restrict__ q_lens,
                               float* __restrict__ probs, float* __restrict__ ws_m,
                               float* __restrict__ ws_l, float* __restrict__ ws_acc, int hq,
                               int hkv, int C, int M, int r, int dv, int split_len, int n_split,
                               KVStrides st, int vec_q, int vec_k, int vec_v, float scale) {
  constexpr int RT = 16 * MT;          // rows per block
  constexpr int NK = 16 * MT;          // keys per warp and tile (4 / MT key groups)
  constexpr int NS = NK / 8;           // S n-tiles per warp
  constexpr int KS = KR + kPad, VS = DV + kPad;   // shared row strides (elements)
  constexpr uint32_t kStageBytes = kBK * (KS + VS) * 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t ring = smem_u32(smem);

  // row tiles vary fastest, so the blocks that share a K/V range run together
  const int s = blockIdx.y, bkv = blockIdx.z;
  const int b = bkv / hkv, kvh = bkv - b * hkv;
  const int group = hq / hkv, rows = group * C;
  const int row0 = blockIdx.x * RT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = warp % MT, kg = warp / MT;
  const int g = lane >> 2, t = lane & 3;
  const int len = kv_len[b], qs = q_start[b], ql = q_lens[b];

  // the block's rows hold queries j_lo .. j_hi; key_end grows with j below
  // ql, so the last of them that is valid bounds the block's keys
  const int n_rows = min(RT, rows - row0);
  const int j_lo = row0 / group, j_hi = (row0 + n_rows - 1) / group;
  const int block_end = j_lo < ql ? key_end(min(j_hi, ql - 1), len, qs, ql, M) : 0;
  const int k0 = s * split_len;
  const int k1 = min(k0 + split_len, block_end);
  if (k0 >= k1) return;  // no row of the block sees a key of this split
  const int n_tiles = (k1 - k0 + kBK - 1) / kBK;

  // (b * hq + h) * C + j of block row rr
  const auto row_of = [&](int rr) {
    const int ri = row0 + rr, j = ri / group;
    return ((size_t)b * hq + (size_t)kvh * group + (ri - j * group)) * C + j;
  };
  // this thread's rows: g and g + 8 of its warp's m-tile
  size_t row_id[2];
  int end[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = 16 * mt + g + 8 * h;
    const bool ok = rr < n_rows;
    row_id[h] = ok ? row_of(rr) : 0;
    end[h] = ok ? key_end((row0 + rr) / group, len, qs, ql, M) : 0;
  }
  // the most and the fewest keys a (valid) row of the warp sees
  int warp_end = max(end[0], end[1]);
  int warp_min = min(16 * mt + g < n_rows ? end[0] : M, 16 * mt + g + 8 < n_rows ? end[1] : M);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    warp_end = max(warp_end, __shfl_xor_sync(0xffffffffu, warp_end, off));
    warp_min = min(warp_min, __shfl_xor_sync(0xffffffffu, warp_min, off));
  }

  const bf16* k_bh = k + b * st.kb + kvh * st.kh;
  const bf16* v_bh = v + b * st.vb + kvh * st.vh;
  // Q into the last stage: its first K/V tile is loaded after the loop's
  // first barrier, which every thread passes after reading Q
  stage_rows<KR, RT>(ring + (kStages - 1) * kStageBytes, r, vec_q, q,
                     [&](int i) -> const bf16* { return i < n_rows ? q + row_of(i) * r : nullptr; });
  cp_async_commit();
  const auto load_tile = [&](int tile) {
    if (tile < n_tiles) {
      const uint32_t dst = ring + (tile % kStages) * kStageBytes;
      const int t0 = k0 + tile * kBK;
      stage_tile<KR, kBK>(dst, k_bh + t0 * st.kk, (int)st.kk, r, k1 - t0, vec_k, k);
      stage_tile<DV, kBK>(dst + kBK * KS * 2, v_bh + t0 * st.vk, (int)st.vk, dv, k1 - t0, vec_v,
                          v);
    }
    cp_async_commit();   // an empty group past the last tile keeps the count
  };
#pragma unroll
  for (int tile = 0; tile < kStages - 1; ++tile) load_tile(tile);
  cp_async_wait<kStages - 1>();    // Q's group, the oldest
  __syncthreads();
  // Q's A fragments: rows (lane & 7) + 8 ((lane >> 3) & 1), columns 8 (lane >> 4)
  uint32_t qa[KR / 16][4];
  {
    const uint32_t base = ring + (kStages - 1) * kStageBytes +
                          ((16 * mt + (lane & 7) + ((lane >> 3) & 1) * 8) * KS + (lane >> 4) * 8) * 2;
#pragma unroll
    for (int kk = 0; kk < KR / 16; ++kk) ldmatrix_x4(qa[kk], base + 32 * kk);
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float* p_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) p_row[h] = probs == nullptr || end[h] == 0 ? nullptr : probs + row_id[h] * M;
  const bool vec_p = (M & 1) == 0;

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<kStages - 2>();   // tile `tile` has landed
    __syncthreads();                // ... for every thread, and tile - 1 is consumed
    load_tile(tile + kStages - 1);
    const int key0 = k0 + tile * kBK + kg * NK;     // this warp's first key
    if (key0 >= warp_end) continue;                  // warp-uniform: all masked
    const uint32_t k_t = ring + (tile % kStages) * kStageBytes + kg * NK * KS * 2;
    const uint32_t v_t = ring + (tile % kStages) * kStageBytes + (kBK * KS + kg * NK * VS) * 2;

    // S = Q K^T: element (n, i) at row g + 8 (i >> 1), key key0 + 8 n + 2 t + (i & 1)
    float sc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] = 0.f;
    {
      // K rows (lane & 7) + 8 (lane >> 4), columns 8 ((lane >> 3) & 1)
      const uint32_t base = k_t + (((lane & 7) + ((lane >> 4) << 3)) * KS + ((lane >> 3) & 1) * 8) * 2;
#pragma unroll
      for (int kk = 0; kk < KR / 16; ++kk)
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t kb[4];
          ldmatrix_x4(kb, base + (16 * np * KS + 16 * kk) * 2);
          mma_bf16(sc[2 * np], qa[kk], kb[0], kb[1]);
          mma_bf16(sc[2 * np + 1], qa[kk], kb[2], kb[3]);
        }
    }

    // the scaled scores; the visible ones into probs
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] *= scale;
    if (probs != nullptr) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (p_row[h] == nullptr) continue;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const int key = key0 + 8 * n + 2 * t;
          if (vec_p && key + 1 < end[h]) {
            *reinterpret_cast<float2*>(p_row[h] + key) = make_float2(sc[n][2 * h], sc[n][2 * h + 1]);
          } else {
            if (key < end[h]) p_row[h][key] = sc[n][2 * h];
            if (key + 1 < end[h]) p_row[h][key + 1] = sc[n][2 * h + 1];
          }
        }
      }
    }
    // masks (none where every row of the warp sees all of its keys), then
    // the online softmax; sc becomes p
    if (key0 + NK > warp_min) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (key0 + 8 * n + 2 * t + (i & 1) >= end[i >> 1]) sc[n][i] = -INFINITY;
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NS; ++n) mx = fmaxf(mx, fmaxf(sc[n][2 * h], sc[n][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;   // no key yet: exp(-inf) = 0
      const float m2 = m_use * kLog2e;
      corr[h] = ex2(fmaf(m[h], kLog2e, -m2));
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          sc[n][e] = ex2(fmaf(sc[n][e], kLog2e, -m2));
          sum += sc[n][e];
        }
      l[h] = fmaf(l[h], corr[h], sum);   // this lane's share of the row sum
      m[h] = m_new;
    }

    // P = P_hi + P_lo as A fragments: key step kk packs n-tiles 2 kk, 2 kk + 1
    uint32_t p_hi[NS / 2][4], p_lo[NS / 2][4];
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x0 = sc[2 * kk + (i >> 1)][2 * (i & 1)];
        const float x1 = sc[2 * kk + (i >> 1)][2 * (i & 1) + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        p_hi[kk][i] = *reinterpret_cast<const uint32_t*>(&hi);
        p_lo[kk][i] = pack_bf16(x0 - __low2float(hi), x1 - __high2float(hi));
      }

    // P.V, 16 output columns at a time, summed over this tile's keys apart
    // from o; V rows (lane & 7) + 8 ((lane >> 3) & 1), columns 8 (lane >> 4)
    const uint32_t vbase = v_t + (((lane & 7) + ((lane >> 3) & 1) * 8) * VS + (lane >> 4) * 8) * 2;
#pragma unroll
    for (int dn = 0; dn < DV / 16; ++dn) {
      float pv[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vbase + (16 * kk * VS + 16 * dn) * 2);
        mma_bf16(pv[0], p_lo[kk], vb[0], vb[1]);
        mma_bf16(pv[0], p_hi[kk], vb[0], vb[1]);
        mma_bf16(pv[1], p_lo[kk], vb[2], vb[3]);
        mma_bf16(pv[1], p_hi[kk], vb[2], vb[3]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[2 * dn + u][i] = fmaf(o[2 * dn + u][i], corr[i >> 1], pv[u][i]);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  if constexpr (MT == kWarps) {
    // one key group: each warp writes its rows' partials from its registers
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (16 * mt + g + 8 * h >= n_rows) continue;
      const size_t part = row_id[h] * n_split + s;
      if (t == 0) {
        ws_m[part] = m[h];
        ws_l[part] = l[h];
      }
      float* dst = ws_acc + part * dv;
#pragma unroll
      for (int n = 0; n < DV / 8; ++n) {
        const int col = 8 * n + 2 * t;
        if (col + 1 < dv && (dv & 1) == 0) {
          *reinterpret_cast<float2*>(dst + col) = make_float2(o[n][2 * h], o[n][2 * h + 1]);
        } else {
          if (col < dv) dst[col] = o[n][2 * h];
          if (col + 1 < dv) dst[col + 1] = o[n][2 * h + 1];
        }
      }
    }
  } else {
    // 4 / MT key groups: merged in fixed order through shared memory (free
    // once every copy has landed and every warp has left the loop), one
    // warp per row, its lanes over the columns
    constexpr int KG = kWarps / MT;
    cp_async_wait<0>();
    __syncthreads();
    float* red_o = reinterpret_cast<float*>(smem);     // [warp][16][VS]
    float* red_m = red_o + kWarps * 16 * VS;           // [warp][16]
    float* red_l = red_m + kWarps * 16;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (t == 0) {
        red_m[warp * 16 + g + 8 * h] = m[h];
        red_l[warp * 16 + g + 8 * h] = l[h];
      }
#pragma unroll
      for (int n = 0; n < DV / 8; ++n)
        *reinterpret_cast<float2*>(red_o + (warp * 16 + g + 8 * h) * VS + 8 * n + 2 * t) =
            make_float2(o[n][2 * h], o[n][2 * h + 1]);
    }
    __syncthreads();
    for (int rr = warp; rr < n_rows; rr += kWarps) {
      const int w0 = rr / 16, r16 = rr % 16;           // warp kg * MT + w0 holds group kg
      float mb = -INFINITY;
#pragma unroll
      for (int kgi = 0; kgi < KG; ++kgi) mb = fmaxf(mb, red_m[(kgi * MT + w0) * 16 + r16]);
      float f[KG], lb = 0.f;
#pragma unroll
      for (int kgi = 0; kgi < KG; ++kgi) {
        const float mw = red_m[(kgi * MT + w0) * 16 + r16];
        f[kgi] = mw == -INFINITY ? 0.f : expf(mw - mb);
        lb = fmaf(f[kgi], red_l[(kgi * MT + w0) * 16 + r16], lb);
      }
      const size_t part = row_of(rr) * n_split + s;
      if (lane == 0) {
        ws_m[part] = mb;
        ws_l[part] = lb;
      }
#pragma unroll
      for (int e = lane; e < DV; e += 32) {
        if (e >= dv) break;
        float acc = 0.f;
#pragma unroll
        for (int kgi = 0; kgi < KG; ++kgi)
          acc = fmaf(f[kgi], red_o[((kgi * MT + w0) * 16 + r16) * VS + e], acc);
        ws_acc[part * dv + e] = acc;
      }
    }
  }
}

template <int MT, int KR, int DV>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const int* kv_len,
                   const int* q_start, const int* q_lens, float* probs, float* ws_m, float* ws_l,
                   float* ws_acc, int b, int hq, int hkv, int C, int M, int r, int dv,
                   int split_len, int n_split, KVStrides st, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<KR, DV>();
  cudaError_t err = cudaFuncSetAttribute(flash_decode_kernel_split_bf16<MT, KR, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // 16-byte copies need rows of a multiple of 8 elements on a 16-byte
  // boundary: the width, the base and every stride a multiple of 8 elements
  const auto vec = [](const void* p, int width, long long strides) {
    return (int)(width % 8 == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0 &&
                 strides % 8 == 0);
  };
  const int rows = hq / hkv * C;
  const dim3 grid((rows + 16 * MT - 1) / (16 * MT), n_split, b * hkv);
  flash_decode_kernel_split_bf16<MT, KR, DV><<<grid, kThreads, smem, stream>>>(
      q, k, v, kv_len, q_start, q_lens, probs, ws_m, ws_l, ws_acc, hq, hkv, C, M, r, dv,
      split_len, n_split, st, vec(q, r, 0), vec(k, r, st.kb | st.kh | st.kk),
      vec(v, dv, st.vb | st.vh | st.vk), scale);
  return cudaGetLastError();
}

#define FD_ARGS \
  q, k, v, kv_len, q_start, q_lens, probs, ws_m, ws_l, ws_acc, b, hq, hkv, C, M, r, dv, split_len, \
      n_split, st, scale, s

template <int MT, int KR>
cudaError_t by_dv(const bf16* q, const bf16* k, const bf16* v, const int* kv_len,
                  const int* q_start, const int* q_lens, float* probs, float* ws_m, float* ws_l,
                  float* ws_acc, int b, int hq, int hkv, int C, int M, int r, int dv,
                  int split_len, int n_split, KVStrides st, float scale, cudaStream_t s) {
  if (dv <= 64) return launch<MT, KR, 64>(FD_ARGS);
  return launch<MT, KR, 128>(FD_ARGS);
}

template <int MT>
cudaError_t by_r(const bf16* q, const bf16* k, const bf16* v, const int* kv_len,
                 const int* q_start, const int* q_lens, float* probs, float* ws_m, float* ws_l,
                 float* ws_acc, int b, int hq, int hkv, int C, int M, int r, int dv,
                 int split_len, int n_split, KVStrides st, float scale, cudaStream_t s) {
  if (r <= 64) return by_dv<MT, 64>(FD_ARGS);
  return by_dv<MT, 128>(FD_ARGS);
}

// the m-tiles of a block: 16, 32 or 64 rows, the fewest that hold the
// group's rows (past 64, tiles of 64)
cudaError_t dispatch(const bf16* q, const bf16* k, const bf16* v, const int* kv_len,
                     const int* q_start, const int* q_lens, float* probs, float* ws_m,
                     float* ws_l, float* ws_acc, int b, int hq, int hkv, int C, int M, int r,
                     int dv, int split_len, int n_split, KVStrides st, float scale,
                     cudaStream_t s) {
  const int rows = hq / hkv * C;
  if (rows <= 16) return by_r<1>(FD_ARGS);
  if (rows <= 32) return by_r<2>(FD_ARGS);
  return by_r<4>(FD_ARGS);
}

#undef FD_ARGS

}  // namespace

// Plain C entry point (loaded with ctypes). All tensors are on the current
// device; q, out, probs and the lengths are contiguous; k and v are read
// through their element strides (k_sb, k_sh, k_sk: batch, head, key; the
// last dimension unit-stride; a tile's 64 key rows addressed in 32 bits, so
// k_sk, v_sk <= INT_MAX / 64). q, k, v and out are bfloat16; probs may be
// null.
// The key axis is cut into n_split ranges of split_len keys (a multiple of
// 64); the f32 workspace holds b * hq * C * n_split * (dv + 2) floats.
// Launches the split kernel and the combine on `stream`. Returns a
// cudaError_t value (0 = both launched).
extern "C" int flash_decode_bf16_launch(const void* q, const void* k, const void* v,
                                        const void* kv_len, const void* q_start,
                                        const void* q_lens, void* out, void* probs,
                                        void* workspace, int b, int hq, int hkv, int C, int M,
                                        int r, int dv, int split_len, int n_split,
                                        long long k_sb, long long k_sh, long long k_sk,
                                        long long v_sb, long long v_sh, long long v_sk, float scale,
                                        void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || C < 1 || M < 1 || r < 1 || r > kMaxDim ||
      dv < 1 || dv > kMaxDim || split_len < kBK || split_len % kBK != 0 || n_split < 1 ||
      (long long)split_len * n_split < M ||
      (long long)split_len * (n_split - 1) >= M || n_split > 65535 || (long long)b * hkv > 65535 ||
      (long long)b * hq * C > 0x7fffffffLL || k_sb < 0 || k_sh < 0 || k_sk < 0 || v_sb < 0 ||
      v_sh < 0 || v_sk < 0 || k_sk > 0x7fffffffLL / kBK || v_sk > 0x7fffffffLL / kBK)
    return (int)cudaErrorInvalidValue;
  const KVStrides st{k_sb, k_sh, k_sk, v_sb, v_sh, v_sk};
  const int* lens = static_cast<const int*>(kv_len);
  const int* starts = static_cast<const int*>(q_start);
  const int* qlens = static_cast<const int*>(q_lens);
  float* p = static_cast<float*>(probs);
  float* ws = static_cast<float*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n_part = (size_t)b * hq * C * n_split;
  cudaError_t err = dispatch(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                             static_cast<const bf16*>(v), lens, starts, qlens, p, ws, ws + n_part,
                             ws + 2 * n_part, b, hq, hkv, C, M, r, dv, split_len, n_split, st,
                             scale, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_combine<bf16>(ws, ws + n_part, ws + 2 * n_part, lens, starts, qlens,
                                   static_cast<bf16*>(out), p, b, hq, C, M, dv, split_len,
                                   n_split, s);
}
