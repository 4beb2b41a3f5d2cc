// The backward of low-rank flash attention for bf16 inputs on NVIDIA Hopper
// (sm_90a), hand-written CUDA C++ on the bf16 tensor cores (mma.sync).
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
// once, in the epilogue.
//
// What bounds it on an H100: operations. Per visible (query, key) pair the
// function needs S, dP, dv, dk and dq once each, 2 (3 r + 2 dv) flops. At
// qwen2.5-14b's 2 x 4096, 40 / 8 heads, r = dv = 128, causal (671.25 M
// visible pairs) that is 1.34e12 flops, 0.869 ms at the bf16 tensor cores'
// 989 TFLOP/s (0.478 ms at r = 32, dv = 128), against about 0.37 GB of
// inputs and outputs (0.11 ms at 3.35 TB/s). This design issues 12 r + 8 dv
// flops per pair (S and dP twice, since the dq pass recomputes them; two
// terms of P and dS in dv, dk and dq): 1.74 ms at 989 TFLOP/s, 2.69 ms at
// the 638.6 TFLOP/s that mma.sync bf16 reached on the card (PERF.md).
// A first right kernel, it will take longer: each warp reads its own copy of
// every B fragment from shared memory (ldmatrix), one read per two mma.
// wgmma is later work.
//
// Design (FlashAttention-2's backward, csrc/lowrank_flash_bwd.cu's design
// on bf16 operands, deterministic, no atomics), every product on
// mma.sync.m16n8k16 (bf16 in, f32 accumulate; fragments per the PTX ISA,
// g = lane / 4, t = lane % 4: A a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g,
// 2t+8..), a3 (g+8, 2t+8..); B b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g);
// C c0 c1 (g, 2t) (g, 2t+1), c2 c3 (g+8, 2t) (g+8, 2t+1)):
//   * lowrank_flash_bwd_bf16_dsum_kernel: D = rowsum(dout o out) in f32, one
//     warp per (b hq, query) row;
//   * lowrank_flash_bwd_bf16_dkdv_kernel: one block of four warps per (b hkv,
//     tile of 64 keys), each warp owning 16 keys, K and V tiles in shared
//     memory for the block's life. It loops over the group's q heads and over
//     the 64-query tiles from the key tile's causal edge to sq, the Q, dout,
//     lse and D tiles arriving through a two-stage cp.async ring. Per step of
//     16 queries a warp computes S^T = K Q^T and dP^T = V dout^T with its keys
//     as the M rows, turns them into P^T and dS^T in the accumulator
//     fragments, and hands those over as the A fragments of dv += P^T dout and
//     dk += dS^T Q: two accumulator tiles of 8 queries are one A fragment of
//     16 (a0 a1 from the first's c0 c1 and c2 c3, a2 a3 from the second's), so
//     P and dS never touch shared memory. The GQA sum stays in registers and
//     dk, dv are written once;
//   * lowrank_flash_bwd_bf16_dq_kernel: one block of four warps per (b hq,
//     tile of 64 queries), heaviest causal tiles first, each warp owning 16
//     queries; Q and dout stay in shared memory, K and V tiles arrive up to
//     the tile's causal edge through a two-stage cp.async ring. Per step of
//     16 keys: S = Q K^T, dP = dout V^T, dS, then dq += dS K with dS's
//     accumulator fragments as the A fragment.
// Operands come from shared memory through ldmatrix: the S-like products
// (X Y^T over r or dv) read X's A fragment and Y's B fragment with
// ldmatrix.x4 as they lie (rows of X, rows of Y); the products that contract
// over the step's queries or keys (dv, dk, dq) read their B operand, which
// lies MN-major (a row per query or key), with ldmatrix.x4.trans. Every tile
// lies row-major with a row stride of its padded width + 8 elements (16
// bytes), so the eight 16-byte rows of an 8 x 8 matrix fall in eight
// different bank groups.
// Masks. The exponent is taken only where the pair is visible; elsewhere
// P = 0 exactly and so dS = 0 (dP - D is finite: rows and columns past sq,
// skv, r and dv are zeros, and lse and D are 0 past sq). Steps where no key
// of the warp is visible to any query of the step are skipped whole.
// Accumulation. The tensor cores' f32 accumulation is not IEEE
// round-to-nearest, and dk, dv sum over up to group x sq queries. So each
// product sums one step (16 queries or keys, both terms) in registers of its
// own and joins its accumulator with one f32 add: the long sums are IEEE
// adds, whatever sq and the group. The scale multiplies dk and dq once, on
// the way out, before the one rounding to bf16.
// r pads to 32, 64, 128 or 192 with zeros and dv to 64 or 128 (exact): six
// instantiations per kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;                     // 16 keys (dK/dV) or queries (dQ) each
constexpr int kThreads = 32 * kWarps;
constexpr int kB = 16 * kWarps;               // rows of every tile: 64 keys or 64 queries
constexpr int kMaxRank = 192;                 // the forward's range
constexpr int kMaxDim = 128;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of N bytes (4 or 16) from device to shared memory; src_bytes = 0
// fills the N bytes with zeros and reads nothing
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  const uint32_t d = smem_u32(dst);
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

// four 8 x 8 bf16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; r[i] holds matrix i's row lane / 4, columns
// 2 (lane % 4) and + 1 (.trans: column lane / 4, rows 2 (lane % 4) and + 1)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a b on the tensor cores: m16n8k16, bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}

// (x0, x1) as two bf16 pairs, hi = bf16(x) and lo = bf16(x - hi); x0 in the
// low half (the lower column of an mma fragment)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h)));
}

// The A fragments (hi and lo terms) of a 16 x 16 operand held as two
// accumulator tiles of 8 columns: a0 a1 from c[0], a2 a3 from c[1]
__device__ __forceinline__ void c_to_a(const float (&c)[2][4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split2(c[0][0], c[0][1], hi[0], lo[0]);
  split2(c[0][2], c[0][3], hi[1], lo[1]);
  split2(c[1][0], c[1][1], hi[2], lo[2]);
  split2(c[1][2], c[1][3], hi[3], lo[3]);
}

// Queue the copy of rows [0, kB) of a row-major (rows x width) bf16 array
// into a kB x W tile (row stride W + 8), zero past `valid` rows and `width`
// columns. vec (width % 8 == 0 and src aligned to 8 elements): cp.async of 8
// elements at a time, which the caller commits and waits for; else plain
// loads and stores.
template <int W>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, int width, int valid, bool vec) {
  constexpr int kL = W + 8;
  if (vec) {
    for (int i = threadIdx.x; i < kB * (W / 8); i += kThreads) {
      const int row = i / (W / 8), col = 8 * (i % (W / 8));
      const bool in = row < valid && col < width;
      cp_async<16>(dst + row * kL + col, in ? src + (size_t)row * width + col : src,
                   in ? 16 : 0);
    }
  } else {
    uint16_t* d16 = reinterpret_cast<uint16_t*>(dst);
    const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
    for (int i = threadIdx.x; i < kB * W; i += kThreads) {
      const int row = i / W, col = i % W;
      d16[row * kL + col] = row < valid && col < width ? s16[(size_t)row * width + col] : 0;
    }
  }
}

// Queue the copy of kB floats from src (zero past `valid`) into dst
__device__ __forceinline__ void stage_row(float* dst, const float* src, int valid) {
  for (int i = threadIdx.x; i < kB; i += kThreads)
    cp_async<4>(dst + i, i < valid ? src + i : src, i < valid ? 4 : 0);
}

// c[j] (j = 0, 1) = X Y_j^T over KK steps of 16 columns: X the warp's 16
// rows of one tile, Y_j rows 8 j .. 8 j + 7 of the step's 16 rows of
// another (row strides LX, LY). x: this lane's ldmatrix address in X (row
// lane % 8 + 8 ((lane / 8) % 2), column 8 (lane / 16)); y: in Y (row lane %
// 8 + 8 (lane / 16), column 8 ((lane / 8) % 2)).
template <int KK>
__device__ __forceinline__ void row_product(float (&c)[2][4], uint32_t x, uint32_t y) {
#pragma unroll
  for (int j = 0; j < 2; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    uint32_t a[4], b[4];
    ldsm_x4(a, x + 32 * kk);            // 16 bf16 = 32 bytes per step
    ldsm_x4(b, y + 32 * kk);
    mma(c[0], a, b[0], b[1]);
    mma(c[1], a, b[2], b[3]);
  }
}

// acc[n] += (hi + lo) Y over the step's 16 contraction rows, for NN output
// tiles of 8 columns: Y the step's 16 rows of a tile (row-major, one row
// per contraction index), read with ldmatrix.trans; y: this lane's address
// (row lane % 8 + 8 ((lane / 8) % 2), column 8 (lane / 16)). Each pair of
// output tiles sums both terms in registers of its own and joins acc with
// one f32 add.
template <int NN>
__device__ __forceinline__ void col_product(float (&acc)[NN][4], const uint32_t (&hi)[4],
                                            const uint32_t (&lo)[4], uint32_t y) {
#pragma unroll
  for (int n = 0; n < NN; n += 2) {
    uint32_t b[4];
    ldsm_x4_t(b, y + 16 * n);           // 8 bf16 = 16 bytes per output tile
    float part[2][4] = {};
    mma(part[0], lo, b[0], b[1]);
    mma(part[0], hi, b[0], b[1]);
    mma(part[1], lo, b[2], b[3]);
    mma(part[1], hi, b[2], b[3]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[n][e] += part[0][e];
      acc[n + 1][e] += part[1][e];
    }
  }
}

// Rows row0 + g and row0 + g + 8 (< n_rows) of a row-major (n_rows x width)
// bf16 array from an accumulator of NN tiles of 8 columns, times `mul`,
// rounded to bf16 once
template <int NN>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[NN][4], int row0,
                                           int n_rows, int width, float mul, int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= n_rows) continue;
    bf16* d = dst + (size_t)row * width;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int col = 8 * n + 2 * t;
      const float x0 = mul * acc[n][2 * h], x1 = mul * acc[n][2 * h + 1];
      if (col + 1 < width && width % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(d + col) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < width) d[col] = __float2bfloat16(x0);
        if (col + 1 < width) d[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

// KR: steps of 16 over r (r <= 16 KR); ND: tiles of 8 over dv (dv <= 8 ND)
template <int KR, int ND>
struct Plan {
  static constexpr int kR = 16 * KR, kD = 8 * ND;           // padded widths
  static constexpr int kLR = kR + 8, kLD = kD + 8;          // row strides: see stage
  static constexpr size_t kTile = (size_t)kB * (kLR + kLD) * sizeof(bf16);  // an (r, dv) pair
  // dK/dV: K and V, then two stages of (Q, dout, lse, D)
  static constexpr size_t kStageKV = kTile + 2 * kB * sizeof(float);
  static constexpr size_t dkdv_smem() { return kTile + 2 * kStageKV; }
  // dQ: Q and dout, then two stages of (K, V)
  static constexpr size_t dq_smem() { return 3 * kTile; }
};

// dK/dV: queue a query tile (rows row0 .. row0 + kB - 1 of (b hq sq)'s rows,
// `valid` of them before sq) into a ring stage: Q, dout, lse, D
template <int KR, int ND>
__device__ __forceinline__ void stage_queries(unsigned char* st, const bf16* q, const bf16* dout,
                                              const float* lse, const float* dsum, size_t row0,
                                              int valid, int r, int dvw, bool vec_qk, bool vec_v) {
  using P = Plan<KR, ND>;
  bf16* q_t = reinterpret_cast<bf16*>(st);
  bf16* do_t = q_t + kB * P::kLR;
  float* l_t = reinterpret_cast<float*>(do_t + kB * P::kLD);
  stage<P::kR>(q_t, q + row0 * r, r, valid, vec_qk);
  stage<P::kD>(do_t, dout + row0 * dvw, dvw, valid, vec_v);
  stage_row(l_t, lse + row0, valid);
  stage_row(l_t + kB, dsum + row0, valid);
}

// dQ: queue the key tile from key k0 into a ring stage: K, V
template <int KR, int ND>
__device__ __forceinline__ void stage_keys(unsigned char* st, const bf16* k_bh, const bf16* v_bh,
                                           int k0, int skv, int r, int dvw, bool vec_qk,
                                           bool vec_v) {
  using P = Plan<KR, ND>;
  bf16* k_t = reinterpret_cast<bf16*>(st);
  stage<P::kR>(k_t, k_bh + (size_t)k0 * r, r, skv - k0, vec_qk);
  stage<P::kD>(k_t + kB * P::kLR, v_bh + (size_t)k0 * dvw, dvw, skv - k0, vec_v);
}

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

template <int KR, int ND>
__global__ void __launch_bounds__(kThreads)
lowrank_flash_bwd_bf16_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                   const float* __restrict__ lse, const float* __restrict__ dsum,
                                   bf16* __restrict__ dk, bf16* __restrict__ dv, int hq, int hkv,
                                   int sq, int skv, int r, int dvw, int q_offset, int causal,
                                   float scale, int vec_qk, int vec_v) {
  using P = Plan<KR, ND>;
  constexpr int kLR = P::kLR, kLD = P::kLD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);         // kB x kLR
  bf16* v_s = k_s + kB * kLR;                        // kB x kLD
  unsigned char* ring = smem + P::kTile;             // two stages of Q, dout, lse, D

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
  // ldmatrix rows and columns of this lane: A and .trans B, then B
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
  const int b_row = (lane & 7) + 8 * (lane >> 4), b_col = 8 * ((lane >> 3) & 1);

  stage<P::kR>(k_s, k + ((size_t)bkv * skv + k0) * r, r, n_k, vec_qk);
  stage<P::kD>(v_s, v + ((size_t)bkv * skv + k0) * dvw, dvw, n_k, vec_v);
  cp_async_commit();

  // the first query that sees key k0 sits at q_offset + i >= k0
  const int t_first = causal ? max(0, k0 - q_offset) / kB : 0;
  const int nt = max(0, (sq + kB - 1) / kB - t_first);
  const int n_it = group * nt;         // (q head, query tile) pairs
  const size_t bh0 = (size_t)b * hq + (size_t)hk * group;  // the group's first q head
  // iteration it: q head bh0 + it / nt, query tile t_first + it % nt, ring stage it % 2
#define LB_STAGE_Q(it)                                                                       \
  stage_queries<KR, ND>(ring + ((it) % 2) * P::kStageKV, q, dout, lse, dsum,                 \
                        (bh0 + (it) / nt) * sq + (t_first + (it) % nt) * kB,                 \
                        sq - (t_first + (it) % nt) * kB, r, dvw, vec_qk, vec_v)
  if (n_it > 0) LB_STAGE_Q(0);
  cp_async_commit();

  float acc_k[2 * KR][4], acc_v[ND][4];
#pragma unroll
  for (int n = 0; n < 2 * KR; ++n) acc_k[n][0] = acc_k[n][1] = acc_k[n][2] = acc_k[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < ND; ++n) acc_v[n][0] = acc_v[n][1] = acc_v[n][2] = acc_v[n][3] = 0.f;
  const uint32_t k_a = smem_u32(k_s + (16 * warp + a_row) * kLR + a_col);
  const uint32_t v_a = smem_u32(v_s + (16 * warp + a_row) * kLD + a_col);

  for (int it = 0; it < n_it; ++it) {
    __syncthreads();                   // iteration it - 1 is consumed: its stage may be refilled
    if (it + 1 < n_it) LB_STAGE_Q(it + 1);
    cp_async_commit();                 // possibly empty: one group per iteration
    cp_async_wait<1>();                // K, V and this iteration's tiles have landed
    __syncthreads();
    if (!live) continue;
    const int q0 = (t_first + it % nt) * kB;
    const bf16* q_t = reinterpret_cast<const bf16*>(ring + (it % 2) * P::kStageKV);
    const bf16* do_t = q_t + kB * kLR;
    const float* l_t = reinterpret_cast<const float*>(do_t + kB * kLD);
    const float* d_t = l_t + kB;
#pragma unroll 1
    for (int qa = 0; qa < kB; qa += 16) {
      if (q0 + qa >= sq) break;
      // warp-uniform: no key of the warp is visible to any query of the step
      if (causal && wk > q_offset + q0 + qa + 15) continue;
      float s[2][4], dp[2][4];         // S^T, dP^T: the warp's keys x the step's 16 queries
      row_product<KR>(s, k_a, smem_u32(q_t + (qa + b_row) * kLR + b_col));
      row_product<ND / 2>(dp, v_a, smem_u32(do_t + (qa + b_row) * kLD + b_col));
      const bool edge = wk + 16 > skv || q0 + qa + 16 > sq ||
                        (causal && wk + 15 > q_offset + q0 + qa);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
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
      uint32_t hi[4], lo[4];
      c_to_a(s, hi, lo);
      col_product<ND>(acc_v, hi, lo, smem_u32(do_t + (qa + a_row) * kLD + a_col));
      c_to_a(dp, hi, lo);
      col_product<2 * KR>(acc_k, hi, lo, smem_u32(q_t + (qa + a_row) * kLR + a_col));
    }
  }
#undef LB_STAGE_Q
  cp_async_wait<0>();                  // nothing in flight at exit (n_it = 0: K and V)
  if (!live) return;
  store_rows<2 * KR>(dk + (size_t)bkv * skv * r, acc_k, wk, skv, r, scale, g, t);
  store_rows<ND>(dv + (size_t)bkv * skv * dvw, acc_v, wk, skv, dvw, 1.f, g, t);
}

template <int KR, int ND>
__global__ void __launch_bounds__(kThreads)
lowrank_flash_bwd_bf16_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                 const float* __restrict__ lse, const float* __restrict__ dsum,
                                 bf16* __restrict__ dq, int hq, int hkv, int sq, int skv, int r,
                                 int dvw, int q_offset, int causal, float scale, int vec_qk,
                                 int vec_v) {
  using P = Plan<KR, ND>;
  constexpr int kLR = P::kLR, kLD = P::kLD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);         // kB x kLR
  bf16* do_s = q_s + kB * kLR;                       // kB x kLD
  unsigned char* ring = smem + P::kTile;             // two stages of K, V

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
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
  const int b_row = (lane & 7) + 8 * (lane >> 4), b_col = 8 * ((lane >> 3) & 1);

  const bf16* k_bh = k + kv_row * skv * r;
  const bf16* v_bh = v + kv_row * skv * dvw;
  stage<P::kR>(q_s, q + (bh * sq + q0) * r, r, n_q, vec_qk);
  stage<P::kD>(do_s, dout + (bh * sq + q0) * dvw, dvw, n_q, vec_v);
  cp_async_commit();
  stage_keys<KR, ND>(ring, k_bh, v_bh, 0, skv, r, dvw, vec_qk, vec_v);
  cp_async_commit();

  // rows w0 + g and w0 + g + 8: lse log2(e) and D (0 past sq)
  float l2[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = w0 + g + 8 * h;
    l2[h] = row < n_q ? lse[bh * sq + q0 + row] * kLog2e : 0.f;
    dd[h] = row < n_q ? dsum[bh * sq + q0 + row] : 0.f;
  }
  float acc[2 * KR][4];
#pragma unroll
  for (int n = 0; n < 2 * KR; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const uint32_t q_a = smem_u32(q_s + (w0 + a_row) * kLR + a_col);
  const uint32_t do_a = smem_u32(do_s + (w0 + a_row) * kLD + a_col);

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kB;
    __syncthreads();                   // tile - 1 is consumed: its stage may be refilled
    if (tile + 1 < n_tiles)
      stage_keys<KR, ND>(ring + ((tile + 1) % 2) * P::kTile, k_bh, v_bh, k0 + kB, skv, r, dvw,
                         vec_qk, vec_v);
    cp_async_commit();                 // possibly empty: one group per tile
    cp_async_wait<1>();                // Q, dout and this tile have landed
    __syncthreads();
    const bf16* k_t = reinterpret_cast<const bf16*>(ring + (tile % 2) * P::kTile);
    const bf16* v_t = k_t + kB * kLR;
#pragma unroll 1
    for (int ka = 0; ka < kB; ka += 16) {
      // warp-uniform: no key of the step is visible to the warp
      if (k0 + ka >= w_key_hi) break;
      float s[2][4], dp[2][4];         // S, dP: the warp's queries x the step's 16 keys
      row_product<KR>(s, q_a, smem_u32(k_t + (ka + b_row) * kLR + b_col));
      row_product<ND / 2>(dp, do_a, smem_u32(v_t + (ka + b_row) * kLD + b_col));
      // rows past sq are never stored: only keys need masks
      const bool edge = k0 + ka + 16 > skv || (causal && k0 + ka + 15 > q_offset + q0 + w0);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + ka + 8 * j + 2 * t + (e & 1);
          const int q_pos = q_offset + q0 + w0 + g + 8 * (e >> 1);
          const bool vis = !edge || (key < skv && (!causal || key <= q_pos));
          const float p = vis ? ex2(fmaf(s[j][e], c, -l2[e >> 1])) : 0.f;
          dp[j][e] = p * (dp[j][e] - dd[e >> 1]);   // dS
        }
      uint32_t hi[4], lo[4];
      c_to_a(dp, hi, lo);
      col_product<2 * KR>(acc, hi, lo, smem_u32(k_t + (ka + a_row) * kLR + a_col));
    }
  }
  cp_async_wait<0>();
  if (w_rows <= 0) return;
  store_rows<2 * KR>(dq + (bh * sq + q0) * r, acc, w0, n_q, r, scale, g, t);
}

template <int KR, int ND>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                   const float* lse, const float* dsum, bf16* dq, bf16* dk, bf16* dv, int b,
                   int hq, int hkv, int sq, int skv, int r, int dvw, int q_offset, int causal,
                   float scale, int vec_qk, int vec_v, cudaStream_t stream) {
  // r = 192 with dv = 128: 130,048 bytes (dk/dv) and 129,024 (dq), under
  // the H100's 227 KB per block
  constexpr size_t kSmemKV = Plan<KR, ND>::dkdv_smem(), kSmemQ = Plan<KR, ND>::dq_smem();
  static_assert(kSmemKV <= 232448 && kSmemQ <= 232448, "shared memory per block");
  cudaError_t err = cudaFuncSetAttribute(lowrank_flash_bwd_bf16_dkdv_kernel<KR, ND>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemKV);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(lowrank_flash_bwd_bf16_dq_kernel<KR, ND>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemQ);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv(b * hkv, (skv + kB - 1) / kB), grid_q(b * hq, (sq + kB - 1) / kB);
  lowrank_flash_bwd_bf16_dkdv_kernel<KR, ND><<<grid_kv, kThreads, kSmemKV, stream>>>(
      q, k, v, dout, lse, dsum, dk, dv, hq, hkv, sq, skv, r, dvw, q_offset, causal, scale, vec_qk,
      vec_v);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  lowrank_flash_bwd_bf16_dq_kernel<KR, ND><<<grid_q, kThreads, kSmemQ, stream>>>(
      q, k, v, dout, lse, dsum, dq, hq, hkv, sq, skv, r, dvw, q_offset, causal, scale, vec_qk,
      vec_v);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). q, k, v, out and dout are
// contiguous bf16 tensors on the current device, lse an f32 (b, hq, sq)
// tensor from lowrank_flash_bf16_launch on the same q, k, v; dq, dk and dv
// (bf16) receive the gradients (the inputs' shapes) and dsum (f32,
// (b, hq, sq)) is scratch for D. Launches three kernels on `stream` and does
// not synchronise. Returns a cudaError_t value (0 = launched).
extern "C" int lowrank_flash_bwd_bf16_launch(const void* q, const void* k, const void* v,
                                             const void* out, const void* lse, const void* dout,
                                             void* dq, void* dk, void* dv, void* dsum, int b,
                                             int hq, int hkv, int sq, int skv, int r, int dvw,
                                             int q_offset, int causal, float scale,
                                             void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || skv < 1 || r < 1 ||
      r > kMaxRank || dvw < 1 || dvw > kMaxDim || q_offset < 0 ||
      (long long)b * hq > 0x7fffffffLL || (sq + kB - 1) / kB > 65535 ||
      (skv + kB - 1) / kB > 65535 || (long long)b * hq * sq > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = b * hq * sq;
  const unsigned dsum_blocks = (unsigned)((rows + 256 / 32 - 1) / (256 / 32));
  lowrank_flash_bwd_bf16_dsum_kernel<<<dsum_blocks, 256, 0, s>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), static_cast<float*>(dsum),
      rows, dvw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // 16-byte copies need rows of a multiple of 8 elements and aligned base pointers
  const uintptr_t align = 16;
  const int vec_qk = r % 8 == 0 && (uintptr_t)q % align == 0 && (uintptr_t)k % align == 0;
  const int vec_v = dvw % 8 == 0 && (uintptr_t)v % align == 0 && (uintptr_t)dout % align == 0;
#define LB_CALL(KR, ND)                                                                       \
  (int)launch<KR, ND>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),               \
                      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),            \
                      static_cast<const float*>(lse), static_cast<const float*>(dsum),        \
                      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), \
                      b, hq, hkv, sq, skv, r, dvw, q_offset, causal != 0, scale, vec_qk, vec_v, s)
  // r pads to 32, 64, 128 or 192 and dv to 64 or 128: six instantiations
  // (drrl-paper's r = 32 / 64 at dv = 64, qwen's r = 32 / 128 at dv = 128,
  // MLA's r = 192)
  if (dvw <= 64) {
    if (r <= 32) return LB_CALL(2, 8);
    if (r <= 64) return LB_CALL(4, 8);
    if (r <= 128) return LB_CALL(8, 8);
  } else {
    if (r <= 32) return LB_CALL(2, 16);
    if (r <= 128) return LB_CALL(8, 16);
  }
  return LB_CALL(12, 16);
#undef LB_CALL
}
