// The backward of low-rank flash attention for f32 inputs on NVIDIA Hopper
// (sm_90a), hand-written CUDA C++, on the tensor cores.
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
// three TF32 passes at 495 TFLOP/s, 1.92 ms on the f32 CUDA cores at 67
// TFLOP/s. Plain TF32 misses the f32 contract (2e-5 of each gradient's
// largest magnitude against the plain version), so every product runs in
// split TF32, as the forward's: x = hi + lo with hi = tf32(x) (round to
// nearest) and lo = x - hi, and a product is a_lo b_hi + a_hi b_lo +
// a_hi b_hi, the accuracy of f32 at three times the tensor-core work.
//
// Design (FlashAttention-2's backward, deterministic, no atomics), every
// product on mma.sync.m16n8k8 (TF32 in, f32 accumulate; fragments per the
// PTX ISA, g = lane / 4, t = lane % 4: A a0 (g, t) a1 (g+8, t) a2 (g, t+4)
// a3 (g+8, t+4); B b0 (t, g) b1 (t+4, g); C c0 c1 (g, 2t) (g, 2t+1),
// c2 c3 (g+8, 2t) (g+8, 2t+1)):
//   * lowrank_flash_bwd_dsum_kernel: D = rowsum(dout o out), one warp per
//     (b hq, query) row;
//   * lowrank_flash_bwd_dkdv_kernel: one block of four warps per (b hkv,
//     tile of 64 keys), each warp owning 16 keys, K and V tiles in shared
//     memory for the block's life. It loops over the group's q heads and
//     over the 64-query tiles from the key tile's causal edge to sq, the Q,
//     dout, lse and D tiles arriving through a two-stage cp.async ring (the
//     next landing while this one is computed on; one stage at r > 128 with
//     dv > 64, MLA's, for shared memory). Per step of 8 kQC queries a warp
//     computes S^T = K Q^T and dP^T = V dout^T with its keys as the M rows,
//     turns them into P^T and dS^T in the accumulator fragments, and feeds
//     those straight in as the A fragments of dv += P^T dout and
//     dk += dS^T Q: P and dS never touch shared memory. The GQA sum stays in
//     registers and dk, dv are written once;
//   * lowrank_flash_bwd_dq_kernel: one block of four warps per (b hq, tile
//     of 64 queries), heaviest causal tiles first, each warp owning 16
//     queries; Q and dout stay in shared memory, K and V tiles arrive up to
//     the tile's causal edge through a cp.async ring of two stages, or of one
//     where three blocks share an SM (r + dv <= 128) and at MLA's widths.
//     Per step of 8 kKC keys: S = Q K^T, dP = dout V^T, dS, then dq += dS K
//     with dS's accumulator fragment as the A fragment.
// The fragments. A contraction does not depend on the order of its terms,
// so its k indices are mapped to make reads cheap and the C-as-A hand-over
// free:
//   * the S-like products (X Y^T over r or dv: S, dP and their transposes)
//     read X's A fragment and Y's B fragment as they are, k index t standing
//     for column 8 kk + t and t + 4 for 8 kk + t + 4;
//   * their accumulator's columns 2t and 2t + 1 are rows 2t and 2t + 1 of
//     Y's group of 8, so in the products that contract over them (dv, dk,
//     dq) k index t stands for row 2t and t + 4 for row 2t + 1: the A
//     fragment is (c0, c2, c1, c3), no shuffle; n index i of mma column n is
//     output column 8 n + i;
//   * every tile lies in shared memory row-major with a row stride of
//     8 (width) + 4 words (4 mod 32): the lanes of a warp read rows g at
//     columns t (the S-like products) or rows 2t at columns g (the others),
//     32 different banks either way.
// Masks. The exponent is taken only where the pair is visible; elsewhere
// P = 0 exactly and so dS = 0 (dP - D is finite: rows and columns past sq,
// skv, r and dv are zeros, and lse and D are 0 past sq). Steps where no key
// of the warp is visible to any query of the step are skipped whole.
// Accumulation. The tensor cores' f32 accumulation is not IEEE
// round-to-nearest, and dk, dv sum over up to group x sq queries. So each
// product sums one step (8 kQC queries, or 8 kKC keys: 3 kQC or 3 kKC mma
// accumulations) in registers of its own and joins its accumulator with one
// f32 add, as the forward joins P V: the long sums are IEEE adds, whatever
// sq and the group. The scale multiplies dk and dq once, on the way out.
// r pads to a multiple of 8 with zeros (32, 64, 128 or 192) and dv to 64 or
// 128 (exact): six instantiations per kernel. The contraction order differs
// from the plain version's, so the two agree to f32 summation order.
// Left for later: wgmma (TF32 wgmma takes only K-major shared-memory
// operands, so the three outer products would need transposed copies of
// P, dS, Q, dout or K), and a layout that reads B fragments 16 bytes at a
// time.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                     // 16 keys (dK/dV) or queries (dQ) each
constexpr int kThreads = 32 * kWarps;
constexpr int kB = 16 * kWarps;               // rows of every tile: 64 keys or 64 queries
constexpr int kMaxRank = 192;                 // the forward's range
constexpr int kMaxDim = 128;
constexpr float kLog2e = 1.4426950408889634f;

// cp.async of N bytes (4 or 16) from device to shared memory; src_bytes = 0
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

// c += a b in split TF32, for kN mma columns sharing one A fragment
template <int kN>
__device__ __forceinline__ void mma3(float (&c)[kN][4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[kN][2],
                                     const uint32_t (&bl)[kN][2]) {
#pragma unroll
  for (int n = 0; n < kN; ++n) mma(c[n], al, bh[n]);
#pragma unroll
  for (int n = 0; n < kN; ++n) mma(c[n], ah, bl[n]);
#pragma unroll
  for (int n = 0; n < kN; ++n) mma(c[n], ah, bh[n]);
}

// Queue the copy of rows [0, kB) of a row-major (rows x width) array into a
// kB x W tile (row stride W + 4: 4 mod 32 words for W a multiple of 8,
// which every read below needs), zero past `valid` rows and `width`
// columns. vec (width % 4 == 0 and src aligned to 4 elements): cp.async of 4
// elements at a time, which the caller commits and waits for; else plain
// loads and stores.
template <int W>
__device__ __forceinline__ void stage(float* dst, const float* src, int width, int valid, bool vec) {
  constexpr int kL = W + 4;
  if (vec) {
    for (int i = threadIdx.x; i < kB * (W / 4); i += kThreads) {
      const int row = i / (W / 4), col = 4 * (i % (W / 4));
      const bool in = row < valid && col < width;
      cp_async<16>(dst + row * kL + col, in ? src + (size_t)row * width + col : src,
                   in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kB * W; i += kThreads) {
      const int row = i / W, col = i % W;
      dst[row * kL + col] = row < valid && col < width ? src[(size_t)row * width + col] : 0.f;
    }
  }
}

// Queue the copy of kB floats from src (zero past `valid`) into dst
__device__ __forceinline__ void stage_row(float* dst, const float* src, int valid) {
  for (int i = threadIdx.x; i < kB; i += kThreads)
    cp_async<4>(dst + i, i < valid ? src + i : src, i < valid ? 4 : 0);
}

// c[j] = X Y_j^T over 8 KK columns: X the warp's 16 rows of one tile, Y_j
// rows 8 j .. 8 j + 7 of another (row strides LX, LY), both split as they
// are read. x points at (row g, column t) of the warp's rows, y at (g, t)
// of the step's first row.
template <int KK, int NJ, int LX, int LY>
__device__ __forceinline__ void row_product(float (&c)[NJ][4], const float* x, const float* y) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    uint32_t ah[4], al[4];
    const float* xa = x + 8 * kk;
    split(xa[0], ah[0], al[0]);
    split(xa[8 * LX], ah[1], al[1]);
    split(xa[4], ah[2], al[2]);
    split(xa[8 * LX + 4], ah[3], al[3]);
    uint32_t bh[NJ][2], bl[NJ][2];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* yb = y + 8 * j * LY + 8 * kk;
      split(yb[0], bh[j][0], bl[j][0]);
      split(yb[4], bh[j][1], bl[j][1]);
    }
    mma3<NJ>(c, ah, al, bh, bl);
  }
}

// acc[n] += sum over kk < KK of C_kk Y_kk: C_kk the accumulator fragment
// c[kk] (the warp's 16 rows x 8 contraction rows) as the A fragment, Y_kk
// rows 8 kk .. 8 kk + 7 of a tile of NN mma columns (row stride LY; y points
// at (row 2t, column g) of the step's first row). The step's sum runs in
// registers of its own, kG mma columns at a time, and joins acc with one
// f32 add.
template <int KK, int NN, int kG, int LY>
__device__ __forceinline__ void col_product(float (&acc)[NN][4], const float (&c)[KK][4],
                                            const float* y) {
#pragma unroll
  for (int n0 = 0; n0 < NN; n0 += kG) {
    float part[kG][4];
#pragma unroll
    for (int n = 0; n < kG; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      uint32_t ah[4], al[4];
      split(c[kk][0], ah[0], al[0]);
      split(c[kk][2], ah[1], al[1]);
      split(c[kk][1], ah[2], al[2]);
      split(c[kk][3], ah[3], al[3]);
      uint32_t bh[kG][2], bl[kG][2];
#pragma unroll
      for (int n = 0; n < kG; ++n) {
        const float* yb = y + 8 * kk * LY + 8 * (n0 + n);
        split(yb[0], bh[n][0], bl[n][0]);
        split(yb[LY], bh[n][1], bl[n][1]);
      }
      mma3<kG>(part, ah, al, bh, bl);
    }
#pragma unroll
    for (int n = 0; n < kG; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + n][e] += part[n][e];
  }
}

// Rows row0 + g and row0 + g + 8 (< n_rows) of a row-major (n_rows x width)
// array from an accumulator of NN mma columns, times `mul`
template <int NN>
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[NN][4], int row0,
                                           int n_rows, int width, float mul, int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= n_rows) continue;
    float* d = dst + (size_t)row * width;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < width) d[col] = mul * acc[n][2 * h];
      if (col + 1 < width) d[col + 1] = mul * acc[n][2 * h + 1];
    }
  }
}

// Per kernel instantiation: ring stages, blocks per SM, 8-row steps per
// product and mma columns per partial sum. The steps and columns are the
// largest that ptxas (CUDA 12.8) fits in 255 registers with no spill; r = 64,
// dv = 64 takes 4 query groups per step, not 8, as it ran faster
template <int KR, int ND>
struct Plan {
  static constexpr int kW = KR + ND;
  static constexpr int kLR = 8 * KR + 4, kLD = 8 * ND + 4;  // row strides: see stage
  // dK/dV: queries / 8 per step
  static constexpr int kQC = kW <= 12 ? 8 : kW == 16 ? 4 : kW == 24 ? (KR == 16 ? 4 : 2) : 1;
  static constexpr int kKC = KR <= 8 ? 8 : KR <= 16 ? 4 : 2;  // dQ: keys / 8 per step
  static constexpr int kG = KR == 16 && ND == 8 ? 4 : 8;
  // dK/dV: K and V, then a ring of (Q, dout, lse, D), two stages up to
  // r + dv = 256 (shared memory)
  static constexpr int kStagesKV = kW <= 32 ? 2 : 1;
  static constexpr int kStageKV = kB * (kLR + kLD) + 2 * kB;  // floats
  static constexpr size_t dkdv_smem() {
    return sizeof(float) * ((size_t)kB * (kLR + kLD) + (size_t)kStagesKV * kStageKV);
  }
  // dQ: Q and dout, then a ring of (K, V). Up to r + dv = 128 (under 170
  // registers) three one-stage blocks share an SM and hide each other's
  // loads; then two stages up to r + dv = 256, one beyond (shared memory)
  static constexpr int kMinBlocksQ = kW <= 16 ? 3 : 1;
  static constexpr int kStagesQ = kW <= 16 || kW > 32 ? 1 : 2;
  static constexpr size_t dq_smem() {
    return sizeof(float) * (size_t)kB * (kLR + kLD) * (1 + kStagesQ);
  }
};

// dK/dV: queue a query tile (rows row0 .. row0 + kB - 1 of (b hq sq)'s rows,
// `valid` of them before sq) into a ring stage: Q, dout, lse, D
template <int KR, int ND>
__device__ __forceinline__ void stage_queries(float* st, const float* q, const float* dout,
                                              const float* lse, const float* dsum, size_t row0,
                                              int valid, int r, int dvw, bool vec_qk, bool vec_v) {
  constexpr int kLR = Plan<KR, ND>::kLR, kLD = Plan<KR, ND>::kLD;
  stage<8 * KR>(st, q + row0 * r, r, valid, vec_qk);
  stage<8 * ND>(st + kB * kLR, dout + row0 * dvw, dvw, valid, vec_v);
  stage_row(st + kB * (kLR + kLD), lse + row0, valid);
  stage_row(st + kB * (kLR + kLD) + kB, dsum + row0, valid);
}

// dQ: queue the key tile from key k0 into a ring stage: K, V
template <int KR, int ND>
__device__ __forceinline__ void stage_keys(float* st, const float* k_bh, const float* v_bh, int k0,
                                           int skv, int r, int dvw, bool vec_qk, bool vec_v) {
  stage<8 * KR>(st, k_bh + (size_t)k0 * r, r, skv - k0, vec_qk);
  stage<8 * ND>(st + kB * Plan<KR, ND>::kLR, v_bh + (size_t)k0 * dvw, dvw, skv - k0, vec_v);
}

__global__ void __launch_bounds__(256)
lowrank_flash_bwd_dsum_kernel(const float* __restrict__ out, const float* __restrict__ dout,
                              float* __restrict__ dsum, int rows, int dv) {
  const int row = (int)((blockIdx.x * (size_t)256 + threadIdx.x) >> 5);
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

// KR: mma steps of 8 over r (r <= 8 KR); ND: mma columns of 8 over dv (dv <= 8 ND)
template <int KR, int ND>
__global__ void __launch_bounds__(kThreads)
lowrank_flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ dsum,
                              float* __restrict__ dk, float* __restrict__ dv, int hq, int hkv,
                              int sq, int skv, int r, int dvw, int q_offset, int causal,
                              float scale, int vec_qk, int vec_v) {
  using P = Plan<KR, ND>;
  constexpr int kLR = P::kLR, kLD = P::kLD, kQC = P::kQC, kS = P::kStagesKV;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                   // kB x kLR
  float* v_s = k_s + kB * kLR;         // kB x kLD
  float* ring = v_s + kB * kLD;        // kS stages of Q, dout, lse, D

  const int bkv = blockIdx.x;          // b * hkv + kv head
  const int k0 = blockIdx.y * kB;      // key tile 0 sees the most query tiles: first
  const int group = hq / hkv;
  const int b = bkv / hkv, hk = bkv % hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_k = min(kB, skv - k0);
  const int wk = k0 + 16 * warp;       // the warp's first key
  const bool live = 16 * warp < n_k;   // the warp has a key
  const float c = scale * kLog2e;

  stage<8 * KR>(k_s, k + ((size_t)bkv * skv + k0) * r, r, n_k, vec_qk);
  stage<8 * ND>(v_s, v + ((size_t)bkv * skv + k0) * dvw, dvw, n_k, vec_v);
  cp_async_commit();

  // the first query that sees key k0 sits at q_offset + i >= k0
  const int t_first = causal ? max(0, k0 - q_offset) / kB : 0;
  const int nt = max(0, (sq + kB - 1) / kB - t_first);
  const int n_it = group * nt;         // (q head, query tile) pairs
  const size_t bh0 = (size_t)b * hq + (size_t)hk * group;  // the group's first q head
  // iteration it: q head bh0 + it / nt, query tile t_first + it % nt, ring stage it % kS
#define LB_STAGE_Q(it)                                                                       \
  stage_queries<KR, ND>(ring + ((it) % kS) * P::kStageKV, q, dout, lse, dsum,                \
                        (bh0 + (it) / nt) * sq + (t_first + (it) % nt) * kB,                 \
                        sq - (t_first + (it) % nt) * kB, r, dvw, vec_qk, vec_v)
  if constexpr (kS == 2) {
    if (n_it > 0) LB_STAGE_Q(0);
    cp_async_commit();
  }

  float acc_k[KR][4], acc_v[ND][4];
#pragma unroll
  for (int n = 0; n < KR; ++n) acc_k[n][0] = acc_k[n][1] = acc_k[n][2] = acc_k[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < ND; ++n) acc_v[n][0] = acc_v[n][1] = acc_v[n][2] = acc_v[n][3] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    __syncthreads();                   // iteration it - 1 is consumed: its stage may be refilled
    if constexpr (kS == 2) {
      if (it + 1 < n_it) LB_STAGE_Q(it + 1);
      cp_async_commit();               // possibly empty: one group per iteration
      cp_async_wait<1>();              // K, V and this iteration's tiles have landed
    } else {
      LB_STAGE_Q(it);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    if (!live) continue;
    const int q0 = (t_first + it % nt) * kB;
    const float* q_t = ring + (it % kS) * P::kStageKV;
    const float* do_t = q_t + kB * kLR;
    const float* l_t = do_t + kB * kLD;
    const float* d_t = l_t + kB;
#pragma unroll 1
    for (int qa = 0; qa < kB; qa += 8 * kQC) {
      if (q0 + qa >= sq) break;
      // warp-uniform: no key of the warp is visible to any query of the step
      if (causal && wk > q_offset + q0 + qa + 8 * kQC - 1) continue;
      float s[kQC][4], dp[kQC][4];     // S^T, dP^T: the warp's keys x the step's queries
      row_product<KR, kQC, kLR, kLR>(s, k_s + (16 * warp + g) * kLR + t, q_t + (qa + g) * kLR + t);
      row_product<ND, kQC, kLD, kLD>(dp, v_s + (16 * warp + g) * kLD + t,
                                     do_t + (qa + g) * kLD + t);
      const bool edge = wk + 16 > skv || q0 + qa + 8 * kQC > sq ||
                        (causal && wk + 15 > q_offset + q0 + qa);
#pragma unroll
      for (int j = 0; j < kQC; ++j) {
        const int qi = qa + 8 * j + 2 * t;   // the tile's query of columns 2t, 2t + 1
        const float2 lq = *reinterpret_cast<const float2*>(l_t + qi);
        const float2 dq2 = *reinterpret_cast<const float2*>(d_t + qi);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = wk + g + 8 * (e >> 1), query = q0 + qi + (e & 1);
          const float l2 = (e & 1 ? lq.y : lq.x) * kLog2e, dd = e & 1 ? dq2.y : dq2.x;
          const bool vis =
              !edge || (key < skv && query < sq && (!causal || key <= q_offset + query));
          const float p = vis ? ex2(fmaf(s[j][e], c, -l2)) : 0.f;
          s[j][e] = p;                         // P^T
          dp[j][e] = p * (dp[j][e] - dd);      // dS^T
        }
      }
      col_product<kQC, ND, ND < P::kG ? ND : P::kG, kLD>(acc_v, s, do_t + (qa + 2 * t) * kLD + g);
      col_product<kQC, KR, KR < P::kG ? KR : P::kG, kLR>(acc_k, dp, q_t + (qa + 2 * t) * kLR + g);
    }
  }
#undef LB_STAGE_Q
  cp_async_wait<0>();                  // nothing in flight at exit (n_it = 0: K and V)
  if (!live) return;
  store_rows<KR>(dk + (size_t)bkv * skv * r, acc_k, wk, skv, r, scale, g, t);
  store_rows<ND>(dv + (size_t)bkv * skv * dvw, acc_v, wk, skv, dvw, 1.f, g, t);
}

template <int KR, int ND>
__global__ void __launch_bounds__(kThreads, Plan<KR, ND>::kMinBlocksQ)
lowrank_flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ dsum,
                            float* __restrict__ dq, int hq, int hkv, int sq, int skv, int r,
                            int dvw, int q_offset, int causal, float scale, int vec_qk,
                            int vec_v) {
  using P = Plan<KR, ND>;
  constexpr int kLR = P::kLR, kLD = P::kLD, kKC = P::kKC, kS = P::kStagesQ;
  constexpr int kStage = kB * (kLR + kLD);
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                   // kB x kLR
  float* do_s = q_s + kB * kLR;        // kB x kLD
  float* ring = do_s + kB * kLD;       // kS stages of K, V

  const size_t bh = blockIdx.x;                       // b * hq + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kB;   // heaviest tiles first
  const size_t kv_row = bh / (hq / hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float c = scale * kLog2e;
  const int n_q = min(kB, sq - q0);
  const int w0 = 16 * warp;                           // the warp's first row in the tile
  const int w_rows = min(16, n_q - w0);               // <= 0: the warp has no query
  // one past the last key any query of the block, or of the warp, can see
  const int key_hi = causal ? min(skv, q_offset + q0 + n_q) : skv;
  const int w_key_hi = w_rows <= 0 ? 0 : causal ? min(skv, q_offset + q0 + w0 + w_rows) : skv;
  const int n_tiles = (key_hi + kB - 1) / kB;

  const float* k_bh = k + kv_row * skv * r;
  const float* v_bh = v + kv_row * skv * dvw;
  stage<8 * KR>(q_s, q + (bh * sq + q0) * r, r, n_q, vec_qk);
  stage<8 * ND>(do_s, dout + (bh * sq + q0) * dvw, dvw, n_q, vec_v);
  cp_async_commit();
  if constexpr (kS == 2) {
    stage_keys<KR, ND>(ring, k_bh, v_bh, 0, skv, r, dvw, vec_qk, vec_v);
    cp_async_commit();
  }

  // rows w0 + g and w0 + g + 8: lse log2(e) and D (0 past sq)
  float l2[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = w0 + g + 8 * h;
    l2[h] = row < n_q ? lse[bh * sq + q0 + row] * kLog2e : 0.f;
    dd[h] = row < n_q ? dsum[bh * sq + q0 + row] : 0.f;
  }
  float acc[KR][4];
#pragma unroll
  for (int n = 0; n < KR; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kB;
    __syncthreads();                   // tile - 1 is consumed: its stage may be refilled
    if constexpr (kS == 2) {
      if (tile + 1 < n_tiles)
        stage_keys<KR, ND>(ring + ((tile + 1) % kS) * kStage, k_bh, v_bh, k0 + kB, skv, r, dvw,
                           vec_qk, vec_v);
      cp_async_commit();               // possibly empty: one group per tile
      cp_async_wait<1>();              // Q, dout and this tile have landed
    } else {
      stage_keys<KR, ND>(ring, k_bh, v_bh, k0, skv, r, dvw, vec_qk, vec_v);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* k_t = ring + (tile % kS) * kStage;
    const float* v_t = k_t + kB * kLR;
#pragma unroll 1
    for (int ka = 0; ka < kB; ka += 8 * kKC) {
      // warp-uniform: no key of the step is visible to the warp
      if (k0 + ka >= w_key_hi) break;
      float s[kKC][4], dp[kKC][4];     // S, dP: the warp's queries x the step's keys
      row_product<KR, kKC, kLR, kLR>(s, q_s + (w0 + g) * kLR + t, k_t + (ka + g) * kLR + t);
      row_product<ND, kKC, kLD, kLD>(dp, do_s + (w0 + g) * kLD + t, v_t + (ka + g) * kLD + t);
      // rows past sq are never stored: only keys need masks
      const bool edge = k0 + ka + 8 * kKC > skv ||
                        (causal && k0 + ka + 8 * kKC - 1 > q_offset + q0 + w0);
#pragma unroll
      for (int j = 0; j < kKC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + ka + 8 * j + 2 * t + (e & 1);
          const int q_pos = q_offset + q0 + w0 + g + 8 * (e >> 1);
          const bool vis = !edge || (key < skv && (!causal || key <= q_pos));
          const float p = vis ? ex2(fmaf(s[j][e], c, -l2[e >> 1])) : 0.f;
          dp[j][e] = p * (dp[j][e] - dd[e >> 1]);   // dS
        }
      col_product<kKC, KR, KR < P::kG ? KR : P::kG, kLR>(acc, dp, k_t + (ka + 2 * t) * kLR + g);
    }
  }
  cp_async_wait<0>();
  if (w_rows <= 0) return;
  store_rows<KR>(dq + (bh * sq + q0) * r, acc, w0, n_q, r, scale, g, t);
}

template <int KR, int ND>
cudaError_t launch(const float* q, const float* k, const float* v, const float* dout,
                   const float* lse, const float* dsum, float* dq, float* dk, float* dv, int b,
                   int hq, int hkv, int sq, int skv, int r, int dvw, int q_offset, int causal,
                   float scale, int vec_qk, int vec_v, cudaStream_t stream) {
  // r = 192 with dv = 128 (one stage): 168,448 bytes (dk/dv) and 167,936
  // (dq); r = 128, dv = 128 (two stages): 203,776 and 202,752; all under the
  // H100's 227 KB per block
  constexpr size_t kSmemKV = Plan<KR, ND>::dkdv_smem(), kSmemQ = Plan<KR, ND>::dq_smem();
  static_assert(kSmemKV <= 232448 && kSmemQ <= 232448, "shared memory per block");
  cudaError_t err = cudaFuncSetAttribute(lowrank_flash_bwd_dkdv_kernel<KR, ND>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemKV);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(lowrank_flash_bwd_dq_kernel<KR, ND>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemQ);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv(b * hkv, (skv + kB - 1) / kB), grid_q(b * hq, (sq + kB - 1) / kB);
  lowrank_flash_bwd_dkdv_kernel<KR, ND><<<grid_kv, kThreads, kSmemKV, stream>>>(
      q, k, v, dout, lse, dsum, dk, dv, hq, hkv, sq, skv, r, dvw, q_offset, causal, scale, vec_qk,
      vec_v);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  lowrank_flash_bwd_dq_kernel<KR, ND><<<grid_q, kThreads, kSmemQ, stream>>>(
      q, k, v, dout, lse, dsum, dq, hq, hkv, sq, skv, r, dvw, q_offset, causal, scale, vec_qk,
      vec_v);
  return cudaGetLastError();
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
  const unsigned dsum_blocks = (unsigned)((rows + 256 / 32 - 1) / (256 / 32));
  lowrank_flash_bwd_dsum_kernel<<<dsum_blocks, 256, 0, s>>>(
      static_cast<const float*>(out), static_cast<const float*>(dout), static_cast<float*>(dsum),
      rows, dvw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // 16-byte copies need rows of a multiple of 4 and aligned base pointers
  const uintptr_t align = 4 * sizeof(float);
  const int vec_qk = r % 4 == 0 && (uintptr_t)q % align == 0 && (uintptr_t)k % align == 0;
  const int vec_v = dvw % 4 == 0 && (uintptr_t)v % align == 0 && (uintptr_t)dout % align == 0;
#define LB_CALL(KR, ND)                                                                       \
  (int)launch<KR, ND>(static_cast<const float*>(q), static_cast<const float*>(k),             \
                      static_cast<const float*>(v), static_cast<const float*>(dout),          \
                      static_cast<const float*>(lse), static_cast<const float*>(dsum),        \
                      static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), \
                      b, hq, hkv, sq, skv, r, dvw, q_offset, causal != 0, scale, vec_qk, vec_v, s)
  // r pads to 32, 64, 128 or 192 and dv to 64 or 128: six instantiations
  if (dvw <= 64) {
    if (r <= 32) return LB_CALL(4, 8);
    if (r <= 64) return LB_CALL(8, 8);
    if (r <= 128) return LB_CALL(16, 8);
  } else {
    if (r <= 64) return LB_CALL(8, 16);
    if (r <= 128) return LB_CALL(16, 16);
  }
  return LB_CALL(24, 16);
#undef LB_CALL
}
