// Low-rank flash attention for bf16 inputs on NVIDIA Hopper (sm_90a),
// hand-written CUDA C++ on the bf16 tensor cores (wgmma), with TMA.
//
// Replaces the TPU kernel src/repro/kernels/lowrank_flash.py:82
// (lowrank_flash, Pallas body _flash_kernel) for bf16 q, k and v; f32 inputs
// go to csrc/lowrank_flash.cu. Same function, same masks:
//
//   q (b, hq, sq, r), k (b, hkv, skv, r), v (b, hkv, skv, dv) -> out
//   (b, hq, sq, dv) in bf16, r <= 192 and dv <= 128; optionally also lse
//   (b, hq, sq) in f32, each row's ln sum_j exp(scale q.k_j), which the
//   backward (csrc/lowrank_flash_bwd_bf16.cu) rebuilds P from. Query i sits at position
//   q_offset + i (q_offset >= 0) and sees key j iff j < skv and, when causal,
//   j <= q_offset + i; so every query sees key 0. GQA maps row bh = b * hq + h
//   to kv row bh / (hq / hkv): K and V are never repeated in device memory.
//
// Precision. The TPU kernel turns bf16 inputs into f32, keeps P in f32 for
// P.V and rounds only the output; this kernel is held to its f32 plain
// version within 2e-5 + 2^-6 |plain| per element.
//   * S = Q K^T in one wgmma pass: a product of two bf16 values is exact in
//     f32, so with f32 accumulation S is the f32 score up to the order of the
//     sum.
//   * P.V in two: P = P_hi + P_lo with P_hi = bf16(P), P_lo = bf16(P - P_hi)
//     (|P - P_hi - P_lo| <= 2^-18 P). P rounded once to bf16, the route of
//     FlashAttention and cuDNN, misses the tolerance: an output near zero is a
//     sum of terms far larger than itself, each off by up to 2^-9 of its size.
//     tests/test_torch_flash_bf16.py emulates both against the TPU kernel on
//     the CPU (its causal 1 x 4 x 256 case at r = dv = 64: one term, 3,071 of
//     65,536 outputs miss, the worst by 29 times; two terms, none does), and
//     chip_smoke.py's check_bf16_p_case tells the two apart on the card.
//
// What bounds it on an H100: operations. A visible query-key pair costs
// 2 (r + 2 dv) bf16 operations at this contract (one pass for Q K^T, two for
// P.V): qwen2.5-14b's causal 2 x 4096 call, 40 heads at r = dv = 128, needs
// 0.521 ms at 989 TFLOP/s and moves its 201 MB (q, k, v, out once) in 0.060 ms.
//
// Design. A block of two warpgroups owns (b * hq + h, a tile of 128 queries),
// heaviest causal tiles first; warpgroup w owns queries 64 w .. 64 w + 63 and
// runs over 64-key tiles up to its own causal edge.
//   * Shared memory holds each operand as wgmma reads it: rows padded with
//     zeros to 16, 32, 64, 128 or 192 elements (exact), cut into slabs whose
//     rows are 32, 64 or 128 bytes, each slab swizzled in 16-byte chunks (the
//     chunk index XOR row bits: the TMA and wgmma swizzle of that width).
//   * Q (once per block) and K and V tiles, in a ring of kStages stages,
//     arrive by TMA: one thread issues the copies, an mbarrier counts their
//     bytes, and the out-of-bound fill supplies the zero padding and the
//     rows past sq or skv. Rows that are not a multiple of 16 bytes (r = 4,
//     6, 12; dv = 10), or pointers off 16 bytes, are staged by the issuing
//     warp with cp.async into the same layout.
//   * S (64 x 64 per warpgroup) = Q K^T: wgmma.m64n64k16, both operands
//     K-major from shared memory, r / 16 steps.
//   * The online softmax runs in base 2 on S's accumulator (scale log2 e
//     folded into one FMA): each thread holds 16 scores of rows g and g + 8 of
//     its warp's 16 (g = lane / 4), a row's maximum takes two xor shuffles,
//     masked scores are exact zeros, the row max and sum stay in f32.
//   * P.V: S's accumulator fragment is P's A fragment as it stands (keys
//     16 kk + 2t, +1 and 16 kk + 8 + 2t, +1 of rows g and g + 8, t = lane % 4),
//     packed twice, as P_lo and P_hi; wgmma.m64n<dv>k16 with A from registers
//     and B the V tile, MN-major (transposed), 4 key steps of two terms into a
//     per-tile accumulator that joins O with one f32 FMA after the rescale.
//     So the tensor cores' accumulation never runs over more than one tile,
//     whatever skv, at 64 more registers per thread than accumulating into O
//     (at dv = 128: S 32, P 32, O 64, the tile's 64).
//   * The ring: each warp releases a stage (an mbarrier of 8 arrivals) once
//     its wgmmas on it are done; the issuing warp, the first of the last
//     warpgroup (which runs every tile of the block), refills the stage of
//     tile t - 1 with tile t - 1 + kStages after its warpgroup has finished
//     tile t, so a load has one tile's compute to land in.

#include <math.h>

#include "hopper_bf16.cuh"   // TMA, mbarriers, wgmma, the swizzled layout

namespace {

constexpr int kWG = 2;                       // warpgroups per block, 64 queries each
constexpr int kThreads = 128 * kWG;
constexpr int kBQ = 64 * kWG;                // queries per block
constexpr int kBK = 64;                      // keys per tile
constexpr int kStages = 3;                   // K/V ring depth
constexpr int kIssuer = 4 * (kWG - 1);       // the warp that fills the ring
constexpr int kMaxRank = 192;                // largest r this kernel takes (MLA: 128 + 64)
constexpr int kMaxDim = 128;                 // largest dv this kernel takes

// KR, DV: r and dv padded to the kernel's widths
template <int KR, int DV>
__global__ void __launch_bounds__(kThreads, 1)
lowrank_flash_kernel_bf16(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, int hq, int hkv, int sq, int skv, int r, int dv, int q_offset,
                          int causal, float scale, int tma_qk, int tma_v) {
  constexpr int kSBK = slab_bytes(KR), kSCK = slab_cols(KR);   // Q and K rows
  constexpr int kSBV = slab_bytes(DV), kSCV = slab_cols(DV);   // V rows
  constexpr int kQBytes = kBQ * KR * 2, kKBytes = kBK * KR * 2, kVBytes = kBK * DV * 2;
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles start on 1024 bytes (the launch asks for 1024 more)
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023) & ~1023u;
  const uint32_t k_s = q_s + kQBytes;                     // kStages K tiles
  const uint32_t v_s = k_s + kStages * kKBytes;           // kStages V tiles
  const uint32_t bars = v_s + kStages * kVBytes;          // full[kStages], empty[kStages], Q
  const auto full = [&](int st) { return bars + 8 * st; };
  const auto empty = [&](int st) { return bars + 8 * (kStages + st); };
  const uint32_t q_full = bars + 16 * kStages;

  const int bh = blockIdx.x;                              // b * hq + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;      // heaviest tiles first
  const int kv_row = bh / (hq / hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wl = warp & 3;                // warpgroup, warp in it
  const int g = lane >> 2, t = lane & 3;
  const bool issuer = warp == kIssuer;

  const int n_q = min(kBQ, sq - q0);
  const int wg_rows = min(64, n_q - 64 * wg);             // <= 0: no query
  // one past the last key any query of the block, or of the warpgroup, sees
  const int key_hi = causal ? min(skv, q_offset + q0 + n_q) : skv;
  const int wg_key_hi = wg_rows <= 0 ? 0 : causal ? min(skv, q_offset + q0 + 64 * wg + wg_rows) : skv;
  const int n_tiles = (key_hi + kBK - 1) / kBK;
  const int wg_tiles = (wg_key_hi + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 4 * kWG);                      // one arrival per warp
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the issuing warp fills stage tile % kStages with K and V tile `tile`
  const auto load_tile = [&](int tile) {
    const int st = tile % kStages, k0 = tile * kBK;
    const size_t row0 = (size_t)kv_row * skv + k0;
    if (!tma_qk) stage<KR, kBK>(k_s + st * kKBytes, k + row0 * r, r, skv - k0, lane);
    if (!tma_v) stage<DV, kBK>(v_s + st * kVBytes, v + row0 * dv, dv, skv - k0, lane);
    if (lane == 0) {
      const uint32_t tx = (tma_qk ? kKBytes : 0) + (tma_v ? kVBytes : 0);
      if (tx == 0) {
        mbar_arrive(full(st));
      } else {
        mbar_arrive_tx(full(st), tx);
        if (tma_qk)
          for (int sl = 0; sl < KR / kSCK; ++sl)
            tma_load(k_s + st * kKBytes + sl * kBK * kSBK, &tm_k, sl * kSCK, k0, kv_row, full(st));
        if (tma_v)
          for (int sl = 0; sl < DV / kSCV; ++sl)
            tma_load(v_s + st * kVBytes + sl * kBK * kSBV, &tm_v, sl * kSCV, k0, kv_row, full(st));
      }
    }
    __syncwarp();
  };
  if (issuer) {
    if (!tma_qk) stage<KR, kBQ>(q_s, q + ((size_t)bh * sq + q0) * r, r, n_q, lane);
    if (lane == 0) {
      if (tma_qk) {
        mbar_arrive_tx(q_full, kQBytes);
        for (int sl = 0; sl < KR / kSCK; ++sl)
          tma_load(q_s + sl * kBQ * kSBK, &tm_q, sl * kSCK, q0, bh, q_full);
      } else {
        mbar_arrive(q_full);
      }
    }
    __syncwarp();
    for (int tile = 0; tile < min(kStages, n_tiles); ++tile) load_tile(tile);
  }

  const float c = scale * 1.4426950408889634f;            // scale log2(e)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8, m in base 2
  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  const int w_pos = q_offset + q0 + 64 * wg + 16 * wl;    // the warp's first query position
  mbar_wait(q_full, 0);

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = tile % kStages, k0 = tile * kBK;
    mbar_wait(full(st), (tile / kStages) & 1);
    if (tile < wg_tiles) {                                // warpgroup-uniform
      const uint32_t k_t = k_s + st * kKBytes, v_t = v_s + st * kVBytes;
      // S = Q K^T: 64 x 64, thread element i at row g + 8 ((i >> 1) & 1) of
      // the warp's 16, key 8 (i >> 2) + 2t + (i & 1)
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KR / 16; ++kk) {
        const uint32_t sl = 16 * kk / kSCK, col = 16 * kk % kSCK * 2;
        const uint64_t da = make_desc(q_s + sl * kBQ * kSBK + wg * 64 * kSBK + col, 16, 8 * kSBK, kSBK);
        const uint64_t db = make_desc(k_t + sl * kBK * kSBK + col, 16, 8 * kSBK, kSBK);
        wgmma_ss_n64(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);

      // masks, then the online softmax in base 2 (masked p exactly 0)
      if (k0 + kBK > skv || (causal && k0 + kBK - 1 > w_pos)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
          if (key >= skv || (causal && key > w_pos + g + 8 * ((i >> 1) & 1))) s[i] = -INFINITY;
        }
      }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx * c);
        corr[h] = m_new == -INFINITY ? 1.f : ex2(m[h] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 4 * j + 2 * h; e < 4 * j + 2 * h + 2; ++e) {
            s[e] = ex2(fmaf(s[e], c, -m_new));
            sum += s[e];
          }
        l[h] = l[h] * corr[h] + sum;   // this lane's share of the row sum
        m[h] = m_new;
      }

      // P = P_hi + P_lo, as A fragments: register i of key step kk packs
      // elements 8 kk + 2i and 8 kk + 2i + 1
      uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x0 = s[8 * kk + 2 * i], x1 = s[8 * kk + 2 * i + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
          const __nv_bfloat162 lo =
              __floats2bfloat162_rn(x0 - __low2float(hi), x1 - __high2float(hi));
          p_hi[kk][i] = *reinterpret_cast<const uint32_t*>(&hi);
          p_lo[kk][i] = *reinterpret_cast<const uint32_t*>(&lo);
        }

      // this tile's P.V in an accumulator of its own: key step kk reads V rows
      // 16 kk .. 16 kk + 15 (8-row groups 8 rows apart, column slabs a tile apart)
      float pv[DV / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = make_desc(v_t + 16 * kk * kSBV, kBK * kSBV, 8 * kSBV, kSBV);
        wgmma_rs<DV>(pv, p_lo[kk], db, kk > 0);
        wgmma_rs<DV>(pv, p_hi[kk], db, 1);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(pv);
      fence_regs(p_hi);
      fence_regs(p_lo);
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] = fmaf(o[i], corr[(i >> 1) & 1], pv[i]);
    }
    // this warp is done with the stage; the issuing warp refills the one
    // before it, which both warpgroups have most likely left by now
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
    if (issuer && tile >= 1 && tile - 1 + kStages < n_tiles) {
      mbar_wait(empty((tile - 1) % kStages), ((tile - 1) / kStages) & 1);
      load_tile(tile - 1 + kStages);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  if (wg_rows <= 0) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 64 * wg + 16 * wl + g + 8 * h;
    if (row >= n_q) continue;
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
    // the row's log-sum-exp in natural units: m is in base 2 with the scale
    // folded in (the max of scale log2(e) q.k_j), l the sum of 2^(that - m)
    if (lse != nullptr && t == 0)
      lse[(size_t)bh * sq + q0 + row] = (m[h] + log2f(l[h])) * 0.6931471805599453f;
    __nv_bfloat16* o_row = out + ((size_t)bh * sq + q0 + row) * dv;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float x0 = o[4 * j + 2 * h] * inv, x1 = o[4 * j + 2 * h + 1] * inv;
      if (col + 1 < dv && dv % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(o_row + col) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < dv) o_row[col] = __float2bfloat16(x0);
        if (col + 1 < dv) o_row[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}


template <int KR, int DV>
cudaError_t launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                   __nv_bfloat16* out, float* lse, int b, int hq, int hkv, int sq, int skv, int r,
                   int dv, int q_offset, int causal, float scale, cudaStream_t stream) {
  // TMA needs 16-byte aligned bases and rows of a multiple of 16 bytes
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int tma_qk = r % 8 == 0 && aligned(q) && aligned(k);
  const int tma_v = dv % 8 == 0 && aligned(v);
  CUtensorMap tm_q{}, tm_k{}, tm_v{};
  if (tma_qk && !(make_map<KR>(&tm_q, q, r, sq, b * hq, kBQ) &&
                  make_map<KR>(&tm_k, k, r, skv, b * hkv, kBK)))
    return cudaErrorNotSupported;
  if (tma_v && !make_map<DV>(&tm_v, v, dv, skv, b * hkv, kBK)) return cudaErrorNotSupported;
  const size_t smem = 1024 + (size_t)kBQ * KR * 2 + (size_t)kStages * kBK * (KR + DV) * 2 +
                      8 * (2 * kStages + 1);
  cudaError_t err = cudaFuncSetAttribute(lowrank_flash_kernel_bf16<KR, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * hq, (sq + kBQ - 1) / kBQ);
  lowrank_flash_kernel_bf16<KR, DV><<<grid, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, q, k, v, out, lse, hq, hkv, sq, skv, r, dv, q_offset, causal, scale, tma_qk,
      tma_v);
  return cudaGetLastError();
}

// the kernel's padded widths: r 16, 32, 64, 128 or 192; dv 16, 32, 64 or 128
#define LF_ARGS q, k, v, out, lse, b, hq, hkv, sq, skv, r, dv, q_offset, causal, scale, s

template <int KR>
cudaError_t by_dv(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                  __nv_bfloat16* out, float* lse, int b, int hq, int hkv, int sq, int skv, int r,
                  int dv, int q_offset, int causal, float scale, cudaStream_t s) {
  if (dv <= 16) return launch<KR, 16>(LF_ARGS);
  if (dv <= 32) return launch<KR, 32>(LF_ARGS);
  if (dv <= 64) return launch<KR, 64>(LF_ARGS);
  return launch<KR, 128>(LF_ARGS);
}

cudaError_t dispatch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                     __nv_bfloat16* out, float* lse, int b, int hq, int hkv, int sq, int skv,
                     int r, int dv, int q_offset, int causal, float scale, cudaStream_t s) {
  if (r <= 16) return by_dv<16>(LF_ARGS);
  if (r <= 32) return by_dv<32>(LF_ARGS);
  if (r <= 64) return by_dv<64>(LF_ARGS);
  if (r <= 128) return by_dv<128>(LF_ARGS);
  // MLA's q.k (qk_nope 128 + qk_rope 64): 1024 + 128 x 192 x 2 + 3 x 64 x
  // (192 + 128) x 2 + 56 = 173,112 bytes of shared memory at dv = 128
  return by_dv<192>(LF_ARGS);
}

#undef LF_ARGS

}  // namespace

// Plain C entry point (loaded with ctypes). q, k, v and out are contiguous
// bf16 tensors on the current device; lse, when not null, an f32 (b, hq, sq)
// tensor that receives each row's log-sum-exp of its scaled scores in
// natural units (the backward's P = exp(scale q.k - lse)). Returns a cudaError_t value (0 =
// launched; cudaErrorNotSupported when the driver could not encode a TMA
// tensor map).
extern "C" int lowrank_flash_bf16_launch(const void* q, const void* k, const void* v, void* out,
                                         void* lse, int b, int hq, int hkv, int sq, int skv, int r,
                                         int dv, int q_offset, int causal, float scale,
                                         void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || skv < 1 || r < 1 ||
      r > kMaxRank || dv < 1 || dv > kMaxDim || q_offset < 0 || (long long)b * hq > 0x7fffffffLL ||
      (sq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch(static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                       static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
                       static_cast<float*>(lse), b, hq, hkv, sq, skv, r, dv, q_offset,
                       causal != 0, scale, static_cast<cudaStream_t>(stream));
}
