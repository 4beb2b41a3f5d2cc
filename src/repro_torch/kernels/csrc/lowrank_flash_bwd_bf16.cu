// The backward of low-rank flash attention for bf16 inputs on NVIDIA Hopper
// (sm_90a), hand-written CUDA C++ on the bf16 tensor cores (wgmma), with TMA.
//
// Replaces no TPU kernel: the Pallas kernel src/repro/kernels/lowrank_flash.py:
// lowrank_flash has no backward, and the reference differentiates its flash
// branch (src/repro/models/attention.py:_attend_chunked, a lax.scan) with
// plain XLA in any type. On the card the port's bf16 forward on that branch
// is csrc/lowrank_flash_bf16.cu, so its gradient is a kernel too
// (kernels/lowrank_flash.py:LowrankFlash); f32 inputs go to
// csrc/lowrank_flash_bwd.cu. Same function, same masks as the forward:
//
//   q (b, hq, sq, r), k (b, hkv, skv, r), v (b, hkv, skv, dv), the forward's
//   out (b, hq, sq, dv) and dout (b, hq, sq, dv), all bf16, and lse
//   (b, hq, sq) in f32 (ln sum_j exp(scale q.k_j), written by
//   csrc/lowrank_flash_bf16.cu) -> dq, dk, dv in the inputs' shapes, bf16.
//   Query i sits at position q_offset + i (q_offset >= 0) and sees key j iff
//   j < skv and, when causal, j <= q_offset + i. GQA: q head h reads kv head
//   h / (hq / hkv), and dk, dv sum over the group's q heads. With
//   P = exp(scale Q K^T - lse) (exact zeros where masked), D = rowsum(dout o
//   out), dP = dout V^T and dS = P o (dP - D):
//     dv = P^T dout,  dk = scale dS^T Q,  dq = scale dS K.
//
// Precision: the exact gradient of the function on the bf16 inputs, in f32,
// rounded to bf16 once. Q, K, V and dout are bf16, so S = Q K^T and
// dP = dout V^T are products of bf16 values, exact in f32, summed in f32:
// one pass each. P and dS are computed in f32 and enter their products as
// two bf16 terms, x = x_hi + x_lo with x_hi = bf16(x) and x_lo = bf16(x -
// x_hi) (|x - x_hi - x_lo| <= 2^-18 |x|), the argument of
// csrc/lowrank_flash_bf16.cu's P.V: so dv, dk and dq take two passes each.
// One bf16 term misses the contract: a gradient element is a sum of terms
// far larger than itself, each off by up to 2^-9 of its size.
// tests/test_torch_flash_bf16_grad.py emulates both against a float64
// gradient on the CPU at chip_smoke.py's tolerance (2e-5 of each gradient's
// largest magnitude + 2^-6 of each element): two terms meet it at every
// case, one term misses it at every case. The gradients are rounded to bf16
// once, in the epilogue, after the scale.
//
// What bounds it on an H100: operations. Per visible (query, key) pair the
// function needs S, dP, dv, dk and dq once each, 2 (3 r + 2 dv) flops. At
// qwen2.5-14b's 2 x 4096, 40 / 8 heads, r = dv = 128, causal (671.25 M
// visible pairs) that is 1.34e12 flops, 0.869 ms at the bf16 tensor cores'
// 989 TFLOP/s (0.478 ms at r = 32, dv = 128), against about 0.37 GB of
// inputs and outputs (0.11 ms at 3.35 TB/s). This design issues 12 r + 8 dv
// flops per pair (S and dP twice, since the dq pass recomputes them; two
// terms of P and dS in dv, dk and dq): 1.74 ms at 989 TFLOP/s.
//
// Design: FlashAttention-2's backward, deterministic (no atomics), every
// product on wgmma (bf16 in, f32 accumulate), every operand tile delivered
// into shared memory by TMA. The layout, the descriptors, the mbarrier ring
// and the wgmma wrappers are the forward's (hopper_bf16.cuh).
//   * lowrank_flash_bwd_bf16_dsum_kernel: D = rowsum(dout o out) in f32, one
//     warp per (b hq, query) row.
//   * lowrank_flash_bwd_bf16_dkdv_kernel: one block of two warpgroups per
//     (b hkv, tile of 128 keys), lowest keys (the heaviest under causality)
//     first; warpgroup w owns keys 64 w .. 64 w + 63, whose K and V rows sit
//     in shared memory for the block's life. The block runs over the GQA
//     group's q heads and, in each, over the 64-query tiles from the key
//     tile's causal edge to sq; each tile's Q and dout arrive by TMA through
//     a ring of kStages stages, its lse and D beside them. Per tile a
//     warpgroup computes S^T = K Q^T and dP^T = V dout^T with its keys as
//     wgmma's 64 M rows (m64n64k16, all operands K-major from shared memory),
//     turns the accumulators into P^T and dS^T in registers, and hands them
//     over as register A operands: dv += P^T dout and dk += dS^T Q
//     (m64n64k16, or m64n32k16 at r = 32), dout and Q read MN-major
//     (transposed) from the same swizzled tiles that S^T and dP^T read
//     K-major. The GQA sum stays in registers; dk and dv are written once.
//   * lowrank_flash_bwd_bf16_dq_kernel: the forward's skeleton with one more
//     product. One block of two warpgroups per (b hq, tile of 128 queries),
//     heaviest causal tiles first; Q and dout of the tile arrive by TMA once,
//     K and V tiles of 64 keys through the ring, up to each warpgroup's
//     causal edge. Per key tile: S = Q K^T and dP = dout V^T (m64n64k16,
//     K-major), P and dS = P o (dP - D) in the accumulators, then dq += dS K
//     (m64n<r>k16, three m64n64k16 at r = 192) with dS as the register A
//     operand and K read MN-major from the tile S read K-major.
// The accumulator fragment of an m64nN product is the A fragment of the
// next one as it stands: thread element i of a warp's 16 rows sits at row
// g + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2t + (i & 1) (g = lane / 4,
// t = lane % 4), so register j of k-step kk packs elements 8 kk + 2j and
// 8 kk + 2j + 1, twice (the hi and the lo term).
// Masks. The exponent is taken only where the pair is visible; elsewhere
// P = 0 exactly and so dS = 0 (dP - D is finite: rows past sq and skv and
// columns past r and dv are zeros from TMA's out-of-bound fill, and lse and
// D are 0 past sq). A warpgroup skips a tile none of whose pairs it sees;
// the per-element mask runs only on tiles that cross an edge.
// The ring (the forward's): a stage's full mbarrier counts the TMA bytes, its
// empty mbarrier one arrival per consumer warp once that warp's wgmmas on it
// are done; the issuing warp, the first of the warpgroup that runs every
// tile (dK/dV: the low keys; dQ: the high queries), refills the stage of tile
// t - 1 with tile t - 1 + kStages after its warpgroup has finished tile t.
// Rows that are not a multiple of 16 bytes, or pointers off 16 bytes, are
// staged by that warp with cp.async into the same layout (the forward's
// stage); lse and D it copies with plain loads.
// Accumulation. The tensor cores do not round their f32 sums to nearest:
// with dv, dk and dq summed on the accumulators across all tiles (the choice
// of FlashAttention-3 and cuDNN), the gradients reached 2.3 times the
// tolerance at chip_smoke.py's 16384-key case (131,072 summands per dk / dv
// row) and 0.63 of it at qwen2.5-14b's shape, against 0.48 and 0.49 for the
// sums below (tools/bwd_bf16_variants.py, on an H100; PERF.md). So each
// product sums one tile (64 queries or keys, both terms) in a partial
// accumulator of its own and joins its accumulator with one f32 add: the
// long sums are IEEE adds, whatever sq, skv and the group. The partial costs registers: dK/dV forms dv and dk in chunks of 64
// columns (32 registers beside dk 64 + dv 64 + S^T 32 + dP^T 32 at
// r = dv = 128: ptxas uses 244), each waited for; dQ, with registers to
// spare, joins up to 128 columns at once. At r = 192 one launch would hold
// dk 96 + dv 64 + the tile's operands and spilled, so dK/dV runs twice: dv
// with dk's first 128 columns, then dk's last 64, each recomputing S^T and
// dP^T. The scale multiplies dk and dq once, on the way out, before the one
// rounding to bf16.
// No producer warpgroup: beside a third warpgroup setmaxnreg could give the
// two consumer warpgroups at most 240 registers a thread, under dK/dV's 244;
// two warpgroups of 128 threads keep 255.
// r pads to 32, 64, 128 or 192 with zeros and dv to 64 or 128 (exact): six
// instantiations of dQ, seven of dK/dV (r = 192's two launches).

#include <math.h>

#include "hopper_bf16.cuh"   // TMA, mbarriers, wgmma, the swizzled layout

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWG = 2;                        // warpgroups per block
constexpr int kThreads = 128 * kWG;
constexpr int kBT = 64;                       // rows of a warpgroup and of a ring tile
constexpr int kBB = kBT * kWG;                // rows a block owns: 128 keys or queries
constexpr int kStages = 3;                    // ring depth
constexpr int kMaxRank = 192;                 // the forward's range
constexpr int kMaxDim = 128;
constexpr float kLog2e = 1.4426950408889634f;

// (x0, x1) as two bf16 pairs, hi = bf16(x) and lo = bf16(x - hi); x0 in the
// low half (the lower column of a fragment)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The 64 x 64 accumulator x as the A operand of four k-steps of 16, twice
__device__ __forceinline__ void pack(const float (&x)[32], uint32_t (&hi)[4][4],
                                     uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) split2(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1], hi[kk][j], lo[kk][j]);
}

// d = X Y^T over W columns: X the warpgroup's 64 rows of an XR-row tile, Y a
// 64-row tile, both of width W in tile_off's layout, K-major (issued, not
// waited for)
template <int W, int XR>
__device__ __forceinline__ void row_product(float (&d)[32], uint32_t x, uint32_t y, int wg) {
  constexpr int kSB = slab_bytes(W), kSC = slab_cols(W);
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    const uint32_t sl = 16 * kk / kSC, col = 16 * kk % kSC * 2;
    const uint64_t da = make_desc(x + sl * XR * kSB + wg * 64 * kSB + col, 16, 8 * kSB, kSB);
    const uint64_t db = make_desc(y + sl * kBT * kSB + col, 16, 8 * kSB, kSB);
    wgmma_ss_n64(d, da, db, kk > 0);
  }
}

// acc += (lo + hi) Y over a tile's 64 contraction rows (4 k-steps of 16): Y
// a 64-row tile of width W (one row per contraction index), read MN-major.
// Each chunk of C columns (C = W, or a multiple of 64 dividing it) is summed
// over the tile, both terms, in a partial accumulator of its own on the
// tensor cores and joined to acc with one f32 add: the long sums are IEEE
// adds, whatever sq, skv and the group. The wgmmas are waited for.
template <int W, int C>
__device__ __forceinline__ void col_product(float (&acc)[W / 2], uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4], uint32_t y) {
  constexpr int kC = C, kSB = slab_bytes(W);
  static_assert(W % C == 0 && (C == W || C % 64 == 0), "chunks of whole slabs");
#pragma unroll
  for (int c = 0; c < W / kC; ++c) {
    float part[kC / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = make_desc(y + c * (kC / 64) * kBT * kSB + 16 * kk * kSB, kBT * kSB,
                                    8 * kSB, kSB);
      wgmma_rs<kC>(part, lo[kk], db, kk > 0);
      wgmma_rs<kC>(part, hi[kk], db, 1);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(part);
    fence_regs(hi);
    fence_regs(lo);
#pragma unroll
    for (int e = 0; e < kC / 2; ++e) acc[c * kC / 2 + e] += part[e];
  }
}

// dK/dV's partials: 64 columns (all of a narrower W), 32 registers beside
// dk and dv's accumulators
template <int W>
constexpr int kChunk = W < 64 ? W : 64;

// Rows row and row + 8 (h = 0, 1; < n_rows) of a row-major (n_rows x width)
// bf16 array, columns col0 .. col0 + W - 1 (< width), from a W-wide
// accumulator, times `mul`, rounded to bf16 once
template <int W>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[W / 2], int row,
                                           int n_rows, int width, int col0, float mul, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row + 8 * h >= n_rows) continue;
    bf16* d = dst + (size_t)(row + 8 * h) * width;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const int col = col0 + 8 * j + 2 * t;
      const float x0 = mul * acc[4 * j + 2 * h], x1 = mul * acc[4 * j + 2 * h + 1];
      if (col + 1 < width && width % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(d + col) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < width) d[col] = __float2bfloat16(x0);
        if (col + 1 < width) d[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

// Copy `rows` rows (64 or 128) of a W-wide tile from plane `plane`, row
// `row0`, of a tensor map into shared memory at dst: one 64-row box per slab
// and half, counted on bar
template <int W>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, int rows, int row0,
                                         int plane, int tile_rows, uint32_t bar) {
  constexpr int kSB = slab_bytes(W), kSC = slab_cols(W);
  for (int sl = 0; sl < W / kSC; ++sl)
    for (int h = 0; h < rows; h += kBT)
      tma_load(dst + sl * tile_rows * kSB + h * kSB, map, sl * kSC, row0 + h, plane, bar);
}

// Shared memory of both kernels: the block's two tiles (128 rows of r and of
// dv: K and V, or Q and dout), kStages ring stages of 64-row tiles (Q and
// dout, or K and V), kStages x (lse, D) of 64 floats (dK/dV), mbarriers
template <int KR, int DV>
struct Smem {
  static constexpr uint32_t kBlockR = kBB * KR * 2, kBlockD = kBB * DV * 2;
  static constexpr uint32_t kTileR = kBT * KR * 2, kTileD = kBT * DV * 2;
  static constexpr uint32_t kRing = kBlockR + kBlockD;          // from the 1024-aligned base
  static constexpr uint32_t kRingD = kRing + kStages * kTileR;
  static constexpr uint32_t kRows = kRingD + kStages * kTileD;  // lse, D
  static constexpr uint32_t kBars = kRows + kStages * 2 * kBT * 4;
  static constexpr size_t bytes() { return 1024 + kBars + 8 * (2 * kStages + 1); }
};

__global__ void __launch_bounds__(256)
lowrank_flash_bwd_bf16_dsum_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                                   float* __restrict__ dsum, int rows, int dv) {
  const int row = (int)((blockIdx.x * (size_t)256 + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const bf16* o = out + (size_t)row * dv;
  const bf16* d = dout + (size_t)row * dv;
  float acc = 0.f;
  for (int c = lane; c < dv; c += 32) acc = fmaf(__bfloat162float(o[c]), __bfloat162float(d[c]), acc);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) dsum[row] = acc;
}

// NK: the dk columns kc0 .. kc0 + NK - 1 this launch sums (kc0 a multiple
// of 64); NV: dv's width, or 0 when another launch sums dv
template <int KR, int DV, int NK, int NV>
__global__ void __launch_bounds__(kThreads, 1)
lowrank_flash_bwd_bf16_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                                   const __grid_constant__ CUtensorMap tm_k,
                                   const __grid_constant__ CUtensorMap tm_v,
                                   const __grid_constant__ CUtensorMap tm_do,
                                   const bf16* __restrict__ q, const bf16* __restrict__ k,
                                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                   const float* __restrict__ lse, const float* __restrict__ dsum,
                                   bf16* __restrict__ dk, bf16* __restrict__ dv, int hq, int hkv,
                                   int sq, int skv, int r, int dvw, int q_offset, int causal,
                                   float scale, int tma_qk, int tma_v, int kc0) {
  using L = Smem<KR, DV>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t k_s = base, v_s = base + L::kBlockR;          // the block's keys
  const uint32_t q_s = base + L::kRing, o_s = base + L::kRingD;  // kStages Q, dout tiles
  float* rows_s = reinterpret_cast<float*>(smem_raw + (base - raw) + L::kRows);
  const uint32_t bars = base + L::kBars;
  const auto full = [&](int st) { return bars + 8 * st; };
  const auto empty = [&](int st) { return bars + 8 * (kStages + st); };
  const uint32_t kv_full = bars + 16 * kStages;

  const int bkv = blockIdx.x;                       // b * hkv + kv head
  const int k0 = blockIdx.y * kBB;                  // low keys see the most queries: first
  const int group = hq / hkv;
  const size_t bh0 = (size_t)(bkv / hkv) * hq + (size_t)(bkv % hkv) * group;  // its first q head
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const bool issuer = warp == 0;                    // warpgroup 0 runs every tile
  const int n_k = min(kBB, skv - k0);
  const int wg_k0 = k0 + 64 * wg;                   // the warpgroup's first key
  const int w_k0 = wg_k0 + 16 * wl;                 // the warp's
  const bool wg_live = 64 * wg < n_k;
  // the first query tile that sees key k0 (position q_offset + i >= k0)
  const int t_first = causal ? max(0, k0 - q_offset) / kBT : 0;
  const int nt = max(0, (sq + kBT - 1) / kBT - t_first);
  const int n_it = group * nt;                      // (q head, query tile) pairs

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 4 * kWG);                // one arrival per warp
    }
    mbar_init(kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the issuing warp fills stage it % kStages with iteration it's query
  // tile: q head bh0 + it / nt, queries from (t_first + it % nt) 64
  const auto load_tile = [&](int it) {
    const int st = it % kStages, q0 = (t_first + it % nt) * kBT;
    const size_t bh = bh0 + it / nt;
    const uint32_t qd = q_s + st * L::kTileR, od = o_s + st * L::kTileD;
    if (!tma_qk) stage<KR, kBT>(qd, q + (bh * sq + q0) * r, r, sq - q0, lane);
    if (!tma_v) stage<DV, kBT>(od, dout + (bh * sq + q0) * dvw, dvw, sq - q0, lane);
    float* rl = rows_s + st * 2 * kBT;
    for (int i = lane; i < kBT; i += 32) {
      const bool in = q0 + i < sq;
      rl[i] = in ? lse[bh * sq + q0 + i] * kLog2e : 0.f;
      rl[kBT + i] = in ? dsum[bh * sq + q0 + i] : 0.f;
    }
    __syncwarp();
    if (lane == 0) {
      const uint32_t tx = (tma_qk ? L::kTileR : 0) + (tma_v ? L::kTileD : 0);
      if (tx == 0) {
        mbar_arrive(full(st));
      } else {
        mbar_arrive_tx(full(st), tx);
        if (tma_qk) tma_tile<KR>(qd, &tm_q, kBT, q0, (int)bh, kBT, full(st));
        if (tma_v) tma_tile<DV>(od, &tm_do, kBT, q0, (int)bh, kBT, full(st));
      }
    }
    __syncwarp();
  };
  if (issuer) {
    // the block's K and V: 128 rows, or 64 when no key lies past the first 64
    const int rows = n_k > kBT ? kBB : kBT;
    const size_t row0 = (size_t)bkv * skv + k0;
    if (!tma_qk) stage<KR, kBB>(k_s, k + row0 * r, r, n_k, lane);
    if (!tma_v) stage<DV, kBB>(v_s, v + row0 * dvw, dvw, n_k, lane);
    if (lane == 0) {
      const uint32_t tx = (tma_qk ? rows * KR * 2 : 0) + (tma_v ? rows * DV * 2 : 0);
      if (tx == 0) {
        mbar_arrive(kv_full);
      } else {
        mbar_arrive_tx(kv_full, tx);
        if (tma_qk) tma_tile<KR>(k_s, &tm_k, rows, k0, bkv, kBB, kv_full);
        if (tma_v) tma_tile<DV>(v_s, &tm_v, rows, k0, bkv, kBB, kv_full);
      }
    }
    __syncwarp();
    for (int it = 0; it < min(kStages, n_it); ++it) load_tile(it);
  }

  const float c = scale * kLog2e;
  float acc_k[NK / 2], acc_v[NV > 0 ? NV / 2 : 1];
#pragma unroll
  for (int i = 0; i < NK / 2; ++i) acc_k[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) acc_v[i] = 0.f;
  mbar_wait(kv_full, 0);

  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages, q0 = (t_first + it % nt) * kBT;
    mbar_wait(full(st), (it / kStages) & 1);
    // warpgroup-uniform: the last query of the tile sees the warpgroup's first key
    if (wg_live && (!causal || q_offset + q0 + kBT - 1 >= wg_k0)) {
      const uint32_t q_t = q_s + st * L::kTileR, o_t = o_s + st * L::kTileD;
      const float* rl = rows_s + st * 2 * kBT;      // lse log2(e), then D
      // S^T = K Q^T, dP^T = V dout^T: the warpgroup's 64 keys x the tile's 64
      // queries; thread element i at key g + 8 ((i >> 1) & 1) of the warp's
      // 16, query 8 (i >> 2) + 2t + (i & 1)
      float s[32], dp[32];
      wgmma_fence();
      row_product<KR, kBB>(s, k_s, q_t, wg);
      row_product<DV, kBB>(dp, v_s, o_t, wg);
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);
      fence_regs(dp);
      const bool edge = w_k0 + 16 > skv || q0 + kBT > sq || (causal && w_k0 + 15 > q_offset + q0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(rl + 8 * j + 2 * t);
        const float2 dd = *reinterpret_cast<const float2*>(rl + kBT + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const int key = w_k0 + g + 8 * (e >> 1), query = q0 + 8 * j + 2 * t + (e & 1);
          const bool vis = !edge || (key < skv && query < sq && (!causal || key <= q_offset + query));
          const float p = vis ? ex2(fmaf(s[i], c, -(e & 1 ? l2.y : l2.x))) : 0.f;
          s[i] = p;                                   // P^T
          dp[i] = p * (dp[i] - (e & 1 ? dd.y : dd.x));  // dS^T
        }
      }
      uint32_t p_hi[4][4], p_lo[4][4], d_hi[4][4], d_lo[4][4];
      if constexpr (NV > 0) pack(s, p_hi, p_lo);
      pack(dp, d_hi, d_lo);
      // dv += P^T dout, dk[kc0 ..] += dS^T Q[kc0 ..]: k-step kk reads the
      // tile's queries 16 kk .. 16 kk + 15
      if constexpr (NV > 0) col_product<DV, kChunk<DV>>(acc_v, p_hi, p_lo, o_t);
      col_product<NK, kChunk<NK>>(acc_k, d_hi, d_lo, q_t + kc0 / 64 * kBT * slab_bytes(KR));
    }
    // this warp is done with the stage; the issuing warp refills the one
    // before it, which both warpgroups have most likely left by now
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
    if (issuer && it >= 1 && it - 1 + kStages < n_it) {
      mbar_wait(empty((it - 1) % kStages), ((it - 1) / kStages) & 1);
      load_tile(it - 1 + kStages);
    }
  }
  if (!wg_live) return;
  store_rows<NK>(dk + (size_t)bkv * skv * r, acc_k, w_k0 + g, skv, r, kc0, scale, t);
  if constexpr (NV > 0)
    store_rows<NV>(dv + (size_t)bkv * skv * dvw, acc_v, w_k0 + g, skv, dvw, 0, 1.f, t);
}

template <int KR, int DV>
__global__ void __launch_bounds__(kThreads, 1)
lowrank_flash_bwd_bf16_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                                 const __grid_constant__ CUtensorMap tm_k,
                                 const __grid_constant__ CUtensorMap tm_v,
                                 const __grid_constant__ CUtensorMap tm_do,
                                 const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                 const float* __restrict__ lse, const float* __restrict__ dsum,
                                 bf16* __restrict__ dq, int hq, int hkv, int sq, int skv, int r,
                                 int dvw, int q_offset, int causal, float scale, int tma_qk,
                                 int tma_v) {
  using L = Smem<KR, DV>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base, o_s = base + L::kBlockR;          // the block's queries
  const uint32_t k_s = base + L::kRing, v_s = base + L::kRingD;  // kStages K, V tiles
  const uint32_t bars = base + L::kBars;
  const auto full = [&](int st) { return bars + 8 * st; };
  const auto empty = [&](int st) { return bars + 8 * (kStages + st); };
  const uint32_t q_full = bars + 16 * kStages;

  const int bh = blockIdx.x;                             // b * hq + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBB;     // heaviest tiles first
  const int kv_row = bh / (hq / hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const bool issuer = warp == 4 * (kWG - 1);             // the last warpgroup runs every tile

  const int n_q = min(kBB, sq - q0);
  const int wg_rows = min(64, n_q - 64 * wg);            // <= 0: no query
  // one past the last key any query of the block, or of the warpgroup, sees
  const int key_hi = causal ? min(skv, q_offset + q0 + n_q) : skv;
  const int wg_key_hi = wg_rows <= 0 ? 0 : causal ? min(skv, q_offset + q0 + 64 * wg + wg_rows) : skv;
  const int n_tiles = (key_hi + kBT - 1) / kBT;
  const int wg_tiles = (wg_key_hi + kBT - 1) / kBT;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 4 * kWG);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the issuing warp fills stage tile % kStages with K and V tile `tile`
  const auto load_tile = [&](int tile) {
    const int st = tile % kStages, k0 = tile * kBT;
    const size_t row0 = (size_t)kv_row * skv + k0;
    const uint32_t kd = k_s + st * L::kTileR, vd = v_s + st * L::kTileD;
    if (!tma_qk) stage<KR, kBT>(kd, k + row0 * r, r, skv - k0, lane);
    if (!tma_v) stage<DV, kBT>(vd, v + row0 * dvw, dvw, skv - k0, lane);
    if (lane == 0) {
      const uint32_t tx = (tma_qk ? L::kTileR : 0) + (tma_v ? L::kTileD : 0);
      if (tx == 0) {
        mbar_arrive(full(st));
      } else {
        mbar_arrive_tx(full(st), tx);
        if (tma_qk) tma_tile<KR>(kd, &tm_k, kBT, k0, kv_row, kBT, full(st));
        if (tma_v) tma_tile<DV>(vd, &tm_v, kBT, k0, kv_row, kBT, full(st));
      }
    }
    __syncwarp();
  };
  if (issuer) {
    // the block's Q and dout: 128 rows, or 64 when no query lies past the first 64
    const int rows = n_q > kBT ? kBB : kBT;
    const size_t row0 = (size_t)bh * sq + q0;
    if (!tma_qk) stage<KR, kBB>(q_s, q + row0 * r, r, n_q, lane);
    if (!tma_v) stage<DV, kBB>(o_s, dout + row0 * dvw, dvw, n_q, lane);
    if (lane == 0) {
      const uint32_t tx = (tma_qk ? rows * KR * 2 : 0) + (tma_v ? rows * DV * 2 : 0);
      if (tx == 0) {
        mbar_arrive(q_full);
      } else {
        mbar_arrive_tx(q_full, tx);
        if (tma_qk) tma_tile<KR>(q_s, &tm_q, rows, q0, bh, kBB, q_full);
        if (tma_v) tma_tile<DV>(o_s, &tm_do, rows, q0, bh, kBB, q_full);
      }
    }
    __syncwarp();
    for (int tile = 0; tile < min(kStages, n_tiles); ++tile) load_tile(tile);
  }

  // rows g and g + 8 of the warp's 16: lse log2(e) and D (0 past sq)
  const int w_row = 64 * wg + 16 * wl;                   // the warp's first row in the block
  const int w_pos = q_offset + q0 + w_row;               // and its position
  float l2[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = w_row + g + 8 * h;
    l2[h] = row < n_q ? lse[(size_t)bh * sq + q0 + row] * kLog2e : 0.f;
    dd[h] = row < n_q ? dsum[(size_t)bh * sq + q0 + row] : 0.f;
  }
  const float c = scale * kLog2e;
  float acc[KR / 2];
#pragma unroll
  for (int i = 0; i < KR / 2; ++i) acc[i] = 0.f;
  mbar_wait(q_full, 0);

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = tile % kStages, k0 = tile * kBT;
    mbar_wait(full(st), (tile / kStages) & 1);
    if (tile < wg_tiles) {                               // warpgroup-uniform
      const uint32_t k_t = k_s + st * L::kTileR, v_t = v_s + st * L::kTileD;
      // S = Q K^T, dP = dout V^T: the warpgroup's 64 queries x the tile's 64
      // keys; thread element i at query g + 8 ((i >> 1) & 1) of the warp's
      // 16, key 8 (i >> 2) + 2t + (i & 1)
      float s[32], dp[32];
      wgmma_fence();
      row_product<KR, kBB>(s, q_s, k_t, wg);
      row_product<DV, kBB>(dp, o_s, v_t, wg);
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);
      fence_regs(dp);
      // rows past sq are never stored: only keys need masks
      const bool edge = k0 + kBT > skv || (causal && k0 + kBT - 1 > w_pos);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1), h = (i >> 1) & 1;
        const bool vis = !edge || (key < skv && (!causal || key <= w_pos + g + 8 * h));
        const float p = vis ? ex2(fmaf(s[i], c, -l2[h])) : 0.f;
        dp[i] = p * (dp[i] - dd[h]);                     // dS
      }
      uint32_t d_hi[4][4], d_lo[4][4];
      pack(dp, d_hi, d_lo);
      // dq += dS K: k-step kk reads the tile's keys 16 kk .. 16 kk + 15
      col_product<KR, (KR <= 128 ? KR : 64)>(acc, d_hi, d_lo, k_t);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
    if (issuer && tile >= 1 && tile - 1 + kStages < n_tiles) {
      mbar_wait(empty((tile - 1) % kStages), ((tile - 1) / kStages) & 1);
      load_tile(tile - 1 + kStages);
    }
  }
  if (wg_rows <= 0) return;
  store_rows<KR>(dq + ((size_t)bh * sq + q0) * r, acc, w_row + g, n_q, r, 0, scale, t);
}

// One dK/dV launch: dk columns kc0 .. kc0 + NK - 1, and dv when NV > 0
template <int KR, int DV, int NK, int NV>
cudaError_t launch_dkdv(const CUtensorMap (&tm)[4], const bf16* q, const bf16* k, const bf16* v,
                        const bf16* dout, const float* lse, const float* dsum, bf16* dk, bf16* dv,
                        int b, int hq, int hkv, int sq, int skv, int r, int dvw, int q_offset,
                        int causal, float scale, int tma_qk, int tma_v, int kc0,
                        cudaStream_t stream) {
  constexpr size_t kSmem = Smem<KR, DV>::bytes();
  cudaError_t err = cudaFuncSetAttribute(lowrank_flash_bwd_bf16_dkdv_kernel<KR, DV, NK, NV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * hkv, (skv + kBB - 1) / kBB);
  lowrank_flash_bwd_bf16_dkdv_kernel<KR, DV, NK, NV><<<grid, kThreads, kSmem, stream>>>(
      tm[0], tm[1], tm[2], tm[3], q, k, v, dout, lse, dsum, dk, dv, hq, hkv, sq, skv, r, dvw,
      q_offset, causal, scale, tma_qk, tma_v, kc0);
  return cudaGetLastError();
}

template <int KR, int DV>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                   const float* lse, const float* dsum, bf16* dq, bf16* dk, bf16* dv, int b,
                   int hq, int hkv, int sq, int skv, int r, int dvw, int q_offset, int causal,
                   float scale, cudaStream_t stream) {
  // TMA needs 16-byte aligned bases and rows of a multiple of 16 bytes
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int tma_qk = r % 8 == 0 && aligned(q) && aligned(k);
  const int tma_v = dvw % 8 == 0 && aligned(v) && aligned(dout);
  CUtensorMap tm[4] = {};                                  // q, k, v, dout
  if (tma_qk && !(make_map<KR>(&tm[0], q, r, sq, b * hq, kBT) &&
                  make_map<KR>(&tm[1], k, r, skv, b * hkv, kBT)))
    return cudaErrorNotSupported;
  if (tma_v && !(make_map<DV>(&tm[2], v, dvw, skv, b * hkv, kBT) &&
                 make_map<DV>(&tm[3], dout, dvw, sq, b * hq, kBT)))
    return cudaErrorNotSupported;
  // r = 192 with dv = 128: 207,416 bytes, under the H100's 227 KB per block
  constexpr size_t kSmem = Smem<KR, DV>::bytes();
  static_assert(kSmem <= 232448, "shared memory per block");
  cudaError_t err;
  if constexpr (KR + DV <= 256) {
    err = launch_dkdv<KR, DV, KR, DV>(tm, q, k, v, dout, lse, dsum, dk, dv, b, hq, hkv, sq, skv,
                                      r, dvw, q_offset, causal, scale, tma_qk, tma_v, 0, stream);
  } else {
    // r = 192: dk 96 + dv 64 accumulators and a tile's operands spill past
    // 255 registers, so one launch sums dv and dk's first 128 columns and a
    // second dk's last 64, each recomputing S^T and dP^T
    err = launch_dkdv<KR, DV, 128, DV>(tm, q, k, v, dout, lse, dsum, dk, dv, b, hq, hkv, sq, skv,
                                       r, dvw, q_offset, causal, scale, tma_qk, tma_v, 0, stream);
    if (err == cudaSuccess)
      err = launch_dkdv<KR, DV, KR - 128, 0>(tm, q, k, v, dout, lse, dsum, dk, dv, b, hq, hkv, sq,
                                             skv, r, dvw, q_offset, causal, scale, tma_qk, tma_v,
                                             128, stream);
  }
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(lowrank_flash_bwd_bf16_dq_kernel<KR, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid_q(b * hq, (sq + kBB - 1) / kBB);
  lowrank_flash_bwd_bf16_dq_kernel<KR, DV><<<grid_q, kThreads, kSmem, stream>>>(
      tm[0], tm[1], tm[2], tm[3], q, k, v, dout, lse, dsum, dq, hq, hkv, sq, skv, r, dvw, q_offset,
      causal, scale, tma_qk, tma_v);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). q, k, v, out and dout are
// contiguous bf16 tensors on the current device, lse an f32 (b, hq, sq)
// tensor from lowrank_flash_bf16_launch on the same q, k, v; dq, dk and dv
// (bf16) receive the gradients (the inputs' shapes) and dsum (f32,
// (b, hq, sq)) is scratch for D. Launches three kernels on `stream` and does
// not synchronise. Returns a cudaError_t value (0 = launched;
// cudaErrorNotSupported when the driver could not encode a TMA tensor map).
extern "C" int lowrank_flash_bwd_bf16_launch(const void* q, const void* k, const void* v,
                                             const void* out, const void* lse, const void* dout,
                                             void* dq, void* dk, void* dv, void* dsum, int b,
                                             int hq, int hkv, int sq, int skv, int r, int dvw,
                                             int q_offset, int causal, float scale,
                                             void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || skv < 1 || r < 1 ||
      r > kMaxRank || dvw < 1 || dvw > kMaxDim || q_offset < 0 ||
      (long long)b * hq > 0x7fffffffLL || (sq + kBB - 1) / kBB > 65535 ||
      (skv + kBB - 1) / kBB > 65535 || (long long)b * hq * sq > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = b * hq * sq;
  const unsigned dsum_blocks = (unsigned)((rows + 256 / 32 - 1) / (256 / 32));
  lowrank_flash_bwd_bf16_dsum_kernel<<<dsum_blocks, 256, 0, s>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), static_cast<float*>(dsum),
      rows, dvw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
#define LB_CALL(KR, DV)                                                                       \
  (int)launch<KR, DV>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),               \
                      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),            \
                      static_cast<const float*>(lse), static_cast<const float*>(dsum),        \
                      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), \
                      b, hq, hkv, sq, skv, r, dvw, q_offset, causal != 0, scale, s)
  // r pads to 32, 64, 128 or 192 and dv to 64 or 128: six instantiations
  // (drrl-paper's r = 32 / 64 at dv = 64, qwen's r = 32 / 128 at dv = 128,
  // MLA's r = 192)
  if (dvw <= 64) {
    if (r <= 32) return LB_CALL(32, 64);
    if (r <= 64) return LB_CALL(64, 64);
    if (r <= 128) return LB_CALL(128, 64);
  } else {
    if (r <= 32) return LB_CALL(32, 128);
    if (r <= 128) return LB_CALL(128, 128);
  }
  return LB_CALL(192, 128);
#undef LB_CALL
}
