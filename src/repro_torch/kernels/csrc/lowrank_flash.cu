// Low-rank flash attention for f32 inputs on NVIDIA Hopper (sm_90a),
// hand-written CUDA C++, on the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/lowrank_flash.py:lowrank_flash
// (Pallas body _flash_kernel) for f32 q, k, v; bf16 inputs go to
// csrc/lowrank_flash_bf16.cu. Same function, same masks:
//
//   q (b, hq, sq, r), k (b, hkv, skv, r), v (b, hkv, skv, dv) -> out
//   (b, hq, sq, dv) in f32. The score contraction runs over r, which may
//   be a truncated rank (the DR-RL factors) or the full head dim, up to 192
//   (MLA's q.k: qk_nope 128 + qk_rope 64); dv is at most 128. Query i sits
//   at position q_offset + i (q_offset >= 0) and sees key j iff j < skv and,
//   when causal, j <= q_offset + i; so every query sees key 0 and no row is
//   ever empty. GQA maps row bh = b * hq + h to kv row bh / (hq / hkv), so K
//   and V are never repeated in device memory. f32 accuracy throughout.
//   Optionally also lse (b, hq, sq), each row's ln sum_j exp(scale q.k_j),
//   the statistic csrc/lowrank_flash_bwd.cu rebuilds P from; out is the
//   same with or without it.
//
// What bounds it on an H100: operations. A causal call does
// 2 b hq (sq (sq + 1) / 2) (r + dv) flops against 4 (q + k + v + out) bytes
// in f32: at b = 2, hq = 12, sq = skv = 4096, r = dv = 64 that is 51.5
// GFLOP against 101 MB, far above the card's ridge. Plain TF32 keeps a
// 10-bit mantissa and misses the f32 contract (2e-5 against the plain
// version), so the products use split TF32: each f32 operand is x = hi + lo
// with hi = tf32(x) (round to nearest) and lo = x - hi, which goes to the
// tensor core as it is (it reads lo's top 19 bits: |error| <= 2^-21 |x|);
// a product is a_lo b_hi + a_hi b_lo + a_hi b_hi (a_lo b_lo lies below
// f32's rounding), the accuracy of f32 at three times the work. At 495
// TFLOP/s of TF32 that bounds the call above at 0.31 ms (0.77 ms on the f32
// CUDA cores); mma.sync reaches about 300 TFLOP/s of it on an H100
// (tools/lowrank_flash_profile.py).
//
// Design. One block of four warps owns one (b * hq + h, tile of 64
// queries) and loops over 64-key tiles itself, up to the tile's
// causal edge, heaviest query tiles first. Each warp owns 16 queries and
// runs mma.sync.m16n8k8 (TF32 in, f32 accumulate; fragments per the PTX
// ISA, g = lane / 4, t = lane % 4: A a0 (g, t) a1 (g+8, t) a2 (g, t+4)
// a3 (g+8, t+4); B b0 (t, g) b1 (t+4, g); C c0 c1 (g, 2t) (g, 2t+1),
// c2 c3 (g+8, 2t) (g+8, 2t+1)). A contraction does not depend on the
// order of its terms, so k indices are mapped to make reads cheap:
//   * Q, K and V tiles are copied to shared memory as they are (cp.async;
//     K/V in a two-stage ring, the next tile landing while this one is
//     computed on), r and dv padded with zeros to the kernel's width
//     (exact);
//   * S = Q K^T, a 16 x 64 warp tile (8 mma columns of 8 keys): k index t
//     of step kk stands for dim 8 kk + 2t and t + 4 for 8 kk + 2t + 1, so
//     each lane reads its two A and two B elements as neighbouring pairs
//     (row stride 8 (mod 32) words: no bank conflicts); K is split as it is
//     read, Q's split fragments stay in registers for r, dv <= 64 and are
//     re-read and split above that;
//   * the online softmax runs in base 2 on S's accumulator fragments: a
//     row's scores lie in the 4 lanes of a quad (two xor shuffles for the
//     maximum; the row sums stay per lane until the end); masked scores are
//     exact zeros;
//   * P.V takes S's accumulator fragment as its A fragment with no shuffle:
//     inside each 8-key group k index t stands for key 2t and t + 4 for key
//     2t + 1, so a = (c0, c2, c1, c3); n index i of mma column n stands for
//     output column i ND + n, so each lane reads V's B fragments as runs of
//     neighbouring columns of rows 2t and 2t + 1 (swizzled: v_pos). P.V is
//     summed in registers of its own for each tile and joins O with one f32
//     FMA, so the tensor cores' accumulation (not IEEE round-to-nearest)
//     never runs over more than one tile, whatever skv.
// Warps whose rows all lie past sq, or whose causal edge ends before a
// tile, skip that tile's work. Left for later: TMA, then wgmma.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                    // warps per block, 16 queries each
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;             // queries per block
constexpr int kBK = 64;                      // keys per tile
constexpr int kNT = kBK / 8;                 // mma columns of 8 keys per tile
constexpr int kQRegSteps = 8;                // Q fragments stay in registers up to r = 64 ...
constexpr int kQRegCols = 8;                 // ... when dv <= 64
constexpr int kPVCols = 8;                   // mma columns per pass over V's fragments
constexpr int kMaxRank = 192;                // largest r this kernel takes (MLA: 128 + 64)
constexpr int kMaxDim = 128;                 // largest dv this kernel takes

// cp.async of N bytes (4, 8 or 16) from device to shared memory; src_bytes = 0
// fills the N bytes with zeros and reads nothing
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(d), "l"(src), "n"(N),
                 "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }

// wait until at most `kPending` of this thread's newest groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending));
}

// two neighbouring elements (8-byte aligned)
__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  a = x.x, b = x.y;
}

// four neighbouring elements (16-byte aligned)
__device__ __forceinline__ void load4(const float* p, float* x) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
}

// Where element (row, col) of a V tile lives in shared memory. For ND >= 4
// rows are 8 ND elements long and their 4-column chunks are XOR-swizzled by
// (row % 8) / 2: the 8 lanes of a quarter warp read the same chunk offset of
// rows 2t (t = 0..3) in columns g ND + ... (g = 0, 1), and the swizzle moves
// the two chunk-index bits that g ND / 4 leaves alone, so they hit 8
// different bank groups. For ND = 2 a row stride of 20 does the same for
// 8-byte reads.
template <int ND>
__device__ __forceinline__ int v_pos(int row, int col) {
  if constexpr (ND >= 4) {
    constexpr int kG = ND / 4;                  // the chunk-index bit g moves
    constexpr int kB0 = kG == 1 ? 2 : 1, kB1 = kG == 4 ? 2 : 4;
    const int u = (row >> 1) & 3;
    const int f = (u & 1) * kB0 + (u >> 1) * kB1;
    return row * 8 * ND + (((col >> 2) ^ f) << 2) + (col & 3);
  } else {
    return row * (8 * ND + 4) + col;
  }
}

// N neighbouring elements of row `row` of a V tile from column col (N = 2,
// or a multiple of 4 from a multiple of 4)
template <int ND, int N>
__device__ __forceinline__ void load_v(const float* v_t, int row, int col, float (&x)[N]) {
  if constexpr (N >= 4) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) load4(v_t + v_pos<ND>(row, col + 4 * i), x + 4 * i);
  } else {
    load2(v_t + v_pos<ND>(row, col), x[0], x[1]);
  }
}

// 2^x (the SFU's approximation, relative error about 2^-22; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

// x = hi + lo: hi = tf32(x), lo = x - hi exactly (the tensor core reads its
// top 19 bits)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b on the tensor cores: m16n8k8, TF32 inputs, f32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The lane's A fragment of a 16 x 8 tile of a row-major array in shared
// memory, k index t standing for column 2t and t + 4 for 2t + 1; p points
// at (g, 2t) of the tile, ld is the row stride.
__device__ __forceinline__ void load_a(const float* p, int ld, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  float x[4];
  load2(p, x[0], x[2]);
  load2(p + 8 * ld, x[1], x[3]);
#pragma unroll
  for (int i = 0; i < 4; ++i) split(x[i], hi[i], lo[i]);
}

// Queue the copy of rows [0, n_rows) of a row-major (rows x width) array
// into shared memory, element (row, col) to dst + pos(row, col) for the W
// >= width columns, zero past `valid` rows and `width` columns. vec
// (width % 4 == 0 and src aligned to 4 elements; pos keeps runs of 4
// columns from a multiple of 4 together): cp.async of 4 elements at a time,
// which the caller commits and waits for; else plain loads and stores.
template <int W, typename Pos>
__device__ __forceinline__ void stage(float* dst, Pos pos, const float* src, int width, int valid,
                                      int n_rows, bool vec) {
  if (vec) {
    constexpr int kV = W / 4, kBytes = 16;
    for (int i = threadIdx.x; i < n_rows * kV; i += kThreads) {
      const int row = i / kV, col = 4 * (i % kV);
      const bool in = row < valid && col < width;
      cp_async<kBytes>(dst + pos(row, col), in ? src + (size_t)row * width + col : src,
                       in ? kBytes : 0);
    }
  } else {
    for (int i = threadIdx.x; i < n_rows * W; i += kThreads) {
      const int row = i / W, col = i % W;
      dst[pos(row, col)] = row < valid && col < width ? src[(size_t)row * width + col] : 0.f;
    }
  }
}

// KR: mma steps of 8 over r (r <= 8 KR); ND: mma columns of 8 over dv (dv <= 8 ND)
template <int KR, int ND>
__global__ void __launch_bounds__(kThreads)
lowrank_flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse,
                     int hq, int hkv, int sq, int skv, int r, int dv, int q_offset, int causal,
                     float scale, int vec_qk, int vec_v) {
  constexpr bool kQRegs = KR <= kQRegSteps && ND <= kQRegCols;
  constexpr int kNC = ND < kPVCols ? ND : kPVCols;
  constexpr int kQS = 8 * KR + 8;    // Q and K row stride (8 mod 32 words in f32)
  constexpr int kVTile = kBK * (ND >= 4 ? 8 * ND : 8 * ND + 4);  // see v_pos
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // kBQ x kQS
  float* k_s = q_s + kBQ * kQS;                     // two stages of kBK x kQS
  float* v_s = k_s + 2 * kBK * kQS;                 // two stages of kVTile

  const int bh = blockIdx.x;                          // b * hq + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest tiles first
  const size_t kv_row = (size_t)bh / (hq / hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const int n_q = min(kBQ, sq - q0);
  const int w0 = 16 * warp;                           // the warp's first row in the tile
  const int w_rows = min(16, n_q - w0);               // <= 0: the warp has no query
  // one past the last key any query of the block, or of the warp, can see
  const int key_hi = causal ? min(skv, q_offset + q0 + n_q) : skv;
  const int w_key_hi = w_rows <= 0 ? 0 : causal ? min(skv, q_offset + q0 + w0 + w_rows) : skv;
  const int n_tiles = (key_hi + kBK - 1) / kBK;

  const float* k_bh = k + kv_row * skv * r;
  const float* v_bh = v + kv_row * skv * dv;
  const auto qk_pos = [](int row, int col) { return row * kQS + col; };
  const auto v_at = [](int row, int col) { return v_pos<ND>(row, col); };
  // the ring: tile i goes to stage i % 2 and lands while tile i - 1 is computed on
  auto stage_tile = [&](int tile) {
    const int k0 = tile * kBK, st = tile & 1;
    stage<8 * KR>(k_s + st * kBK * kQS, qk_pos, k_bh + (size_t)k0 * r, r, skv - k0, kBK, vec_qk);
    stage<8 * ND>(v_s + st * kVTile, v_at, v_bh + (size_t)k0 * dv, dv, skv - k0, kBK, vec_v);
  };
  stage<8 * KR>(q_s, qk_pos, q + ((size_t)bh * sq + q0) * r, r, n_q, kBQ, vec_qk);
  cp_async_commit();
  stage_tile(0);
  cp_async_commit();
  cp_async_wait<1>();              // Q has landed
  __syncthreads();

  const float* q_w = q_s + (w0 + g) * kQS + 2 * t;        // the lane's A fragment of Q
  uint32_t qh[kQRegs ? KR : 1][4], ql[kQRegs ? KR : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < KR; ++kk) load_a(q_w + 8 * kk, kQS, qh[kk], ql[kk]);
  }

  const float c = scale * 1.4426950408889634f;             // scale log2(e)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBK;
    __syncthreads();               // tile - 1 is consumed: its stage may be refilled
    if (tile + 1 < n_tiles) stage_tile(tile + 1);
    cp_async_commit();             // possibly empty: one group per tile
    cp_async_wait<1>();            // this tile has landed
    __syncthreads();
    if (k0 >= w_key_hi) continue;  // warp-uniform: no key of the tile is visible to the warp
    const float* k_t = k_s + (tile & 1) * kBK * kQS;
    const float* v_t = v_s + (tile & 1) * kVTile;

    // S = Q K^T, 16 x 64 per warp
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KR; ++kk) {
      uint32_t ah[4], al[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) ah[i] = qh[kk][i], al[i] = ql[kk][i];
      } else {
        load_a(q_w + 8 * kk, kQS, ah, al);
      }
      uint32_t kh[kNT][2], kl[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        float b0, b1;
        load2(k_t + (8 * j + g) * kQS + 8 * kk + 2 * t, b0, b1);
        split(b0, kh[j][0], kl[j][0]);
        split(b1, kh[j][1], kl[j][1]);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) mma(s[j], al, kh[j]);
#pragma unroll
      for (int j = 0; j < kNT; ++j) mma(s[j], ah, kl[j]);
#pragma unroll
      for (int j = 0; j < kNT; ++j) mma(s[j], ah, kh[j]);
    }

    // masks and the online softmax in base 2 (s becomes s scale log2 e, then
    // p; masked entries exactly 0)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= c;
    if (k0 + kBK > skv || (causal && k0 + kBK - 1 > q_offset + q0 + w0)) {
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int q_pos = q_offset + q0 + w0 + g + 8 * (e >> 1);
          if (key >= skv || (causal && key > q_pos)) s[j][e] = -INFINITY;
        }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kNT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      corr[h] = m_new == -INFINITY ? 1.f : ex2(m[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[j][e] = ex2(s[j][e] - m_new);
          sum += s[j][e];
        }
      l[h] = l[h] * corr[h] + sum;  // this lane's share of the row sum
      m[h] = m_new;
    }

    // O = O corr + P V, P V summed in registers of its own for this tile;
    // S's fragment of keys 8 kk .. 8 kk + 7 is P's A fragment
    float pv[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kNT; ++kk) {
      uint32_t ah[4], al[4];
      split(s[kk][0], ah[0], al[0]);
      split(s[kk][2], ah[1], al[1]);
      split(s[kk][1], ah[2], al[2]);
      split(s[kk][3], ah[3], al[3]);
#pragma unroll
      for (int n0 = 0; n0 < ND; n0 += kNC) {   // kNC mma columns at a time
        uint32_t vh[kNC][2], vl[kNC][2];
        float v0[kNC], v1[kNC];    // keys 2t and 2t + 1, columns g ND + n0 ...
        load_v<ND>(v_t, 8 * kk + 2 * t, g * ND + n0, v0);
        load_v<ND>(v_t, 8 * kk + 2 * t + 1, g * ND + n0, v1);
#pragma unroll
        for (int n = 0; n < kNC; ++n) {
          split(v0[n], vh[n][0], vl[n][0]);
          split(v1[n], vh[n][1], vl[n][1]);
        }
#pragma unroll
        for (int n = 0; n < kNC; ++n) mma(pv[n0 + n], al, vh[n]);
#pragma unroll
        for (int n = 0; n < kNC; ++n) mma(pv[n0 + n], ah, vl[n]);
#pragma unroll
        for (int n = 0; n < kNC; ++n) mma(pv[n0 + n], ah, vh[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = fmaf(o[n][e], corr[e >> 1], pv[n][e]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  if (w_rows <= 0) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = w0 + g + 8 * h;
    if (row >= n_q) continue;
    const float den = fmaxf(l[h], 1e-30f);
    // the row's log-sum-exp in natural units, ln sum_j exp(scale q.k_j): m
    // and l are in base 2 with the scale folded in (m = max of scale log2(e)
    // q.k_j, l = sum of 2^(scale log2(e) q.k_j - m))
    if (lse != nullptr && t == 0)
      lse[(size_t)bh * sq + q0 + row] = (m[h] + log2f(l[h])) * 0.6931471805599453f;
    float* o_row = out + ((size_t)bh * sq + q0 + row) * dv;
#pragma unroll
    for (int n = 0; n < ND; ++n) {   // mma column n, n index i is column i ND + n
      const int col = 2 * t * ND + n;
      if (col < dv) o_row[col] = o[n][2 * h] / den;
      if (col + ND < dv) o_row[col + ND] = o[n][2 * h + 1] / den;
    }
  }
}

template <int KR, int ND>
cudaError_t launch(const float* q, const float* k, const float* v, float* out, float* lse, int b,
                   int hq, int hkv, int sq, int skv, int r, int dv, int q_offset, int causal,
                   float scale, int vec_qk, int vec_v, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)(kBQ + 2 * kBK) * (8 * KR + 8) +
                                       (size_t)2 * kBK * (ND >= 4 ? 8 * ND : 8 * ND + 4));
  cudaError_t err = cudaFuncSetAttribute(lowrank_flash_kernel<KR, ND>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * hq, (sq + kBQ - 1) / kBQ);
  lowrank_flash_kernel<KR, ND><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, lse, hq, hkv, sq, skv, r, dv, q_offset, causal, scale, vec_qk, vec_v);
  return cudaGetLastError();
}

// the kernel's padded widths: r 16, 32, 64, 128 or 192; dv 16, 32, 64 or 128
#define LF_ARGS q, k, v, out, lse, b, hq, hkv, sq, skv, r, dv, q_offset, causal, scale, vec_qk, vec_v, s

template <int KR>
cudaError_t by_dv(const float* q, const float* k, const float* v, float* out, float* lse, int b,
                  int hq, int hkv, int sq, int skv, int r, int dv, int q_offset, int causal,
                  float scale, int vec_qk, int vec_v, cudaStream_t s) {
  if (dv <= 16) return launch<KR, 2>(LF_ARGS);
  if (dv <= 32) return launch<KR, 4>(LF_ARGS);
  if (dv <= 64) return launch<KR, 8>(LF_ARGS);
  return launch<KR, 16>(LF_ARGS);
}

cudaError_t dispatch(const float* q, const float* k, const float* v, float* out, float* lse,
                     int b, int hq, int hkv, int sq, int skv, int r, int dv, int q_offset,
                     int causal, float scale, cudaStream_t s) {
  // 4-element loads need rows of a multiple of 4 and aligned base pointers
  const uintptr_t align = 4 * sizeof(float);
  const int vec_qk = r % 4 == 0 && (uintptr_t)q % align == 0 && (uintptr_t)k % align == 0;
  const int vec_v = dv % 4 == 0 && (uintptr_t)v % align == 0;
  if (r <= 16) return by_dv<2>(LF_ARGS);
  if (r <= 32) return by_dv<4>(LF_ARGS);
  if (r <= 64) return by_dv<8>(LF_ARGS);
  if (r <= 128) return by_dv<16>(LF_ARGS);
  // MLA's q.k (qk_nope 128 + qk_rope 64): f32 with dv = 128 takes 4 ((64 +
  // 128) 200 + 2 x 64 x 128) = 219,136 bytes of shared memory, under the
  // H100's 227 KB per block
  return by_dv<24>(LF_ARGS);
}

#undef LF_ARGS

}  // namespace

// Plain C entry point (loaded with ctypes). q, k, v and out are contiguous
// f32 tensors on the current device; lse, when not null, an f32 (b, hq, sq)
// tensor that receives each row's log-sum-exp of its scaled scores in
// natural units (the backward's P = exp(scale q.k - lse)). Returns a
// cudaError_t value (0 = launched).
extern "C" int lowrank_flash_launch(const void* q, const void* k, const void* v, void* out,
                                    void* lse, int b, int hq, int hkv, int sq, int skv, int r,
                                    int dv, int q_offset, int causal, float scale, void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || skv < 1 || r < 1 ||
      r > kMaxRank || dv < 1 || dv > kMaxDim || q_offset < 0 || (long long)b * hq > 0x7fffffffLL ||
      (sq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch(static_cast<const float*>(q), static_cast<const float*>(k),
                       static_cast<const float*>(v), static_cast<float*>(out),
                       static_cast<float*>(lse), b, hq, hkv, sq, skv, r, dv, q_offset, causal != 0,
                       scale, static_cast<cudaStream_t>(stream));
}
