// Flash attention backward for Hopper, sm_90a, plain C interface.
//
// Replaces: valley_tpu/ops/flash_attention.py `_bwd_kernel` (the Pallas TPU
// kernel launched by `_flash_bwd_impl`), the backward of every decoder
// layer's attention in training.  Same formulas: P = exp(S*scale - lse)
// recomputed from the forward's logsumexp, with the mask applied as a
// predicate (P = 0 where a key is masked, causal or past the edge, so a
// fully masked row, whose lse is near -1e9, gives 0 and never inf * 0);
// dV = P^T dO; dP = dO V^T; dS = P * (dP - delta) * scale; dQ = dS K;
// dK = dS^T Q; delta = rowsum(dO * O) comes in from the wrapper (computed
// by flash_bwd_delta_bf16 below).  Every sum is fp32; P and dS are rounded
// to bf16 for the products they feed; dq, dk and dv are written in bf16.
//
// What bounds it on the H100: the operations.  At the training shapes
// (B16 S512 and B1 S2048, H32, D128, causal) the attended pairs need 2 D
// operations each in five products (dQ's pass recomputes S and dP: seven
// are run), 86 GFLOP a layer at B16 S512 (87 us at the bf16 peak), against
// some 30 MB of q/k/v/o/dO/dq/dk/dv (9 us at 3.35 TB/s).
//
// Design.  The Pallas kernel carries dQ in fp32 across a sequential grid
// of K tiles; Hopper's blocks run in parallel and in no order, so the work
// is split into two deterministic passes (no atomics: two runs give the
// same bits), each recomputing P from the lse, launched as one grid so
// that pass 2's blocks fill the tail of pass 1's.  Each block is a producer
// warpgroup (setmaxnreg 24) whose one thread loads by TMA (4-D maps over
// (B, S, H, D), boxes of 64 rows by 64 columns in the 128-byte swizzle,
// rows past S as zeros) through a ring of STAGES stages under mbarriers,
// and two consumer warpgroups (240 registers) of 64 rows each; every
// product is wgmma m64nNk16, bf16 in, fp32 sums:
//   pass 1, a block per (128-key tile, batch, head): K and V are loaded
//     once; Q, dO, lse and delta tiles of BQS = 64 queries stream past
//     (the lse and delta copied into the stage by a second producer warp:
//     a row of them is 4 bytes a query, below TMA's 16-byte strides).
//     S^T = K Q^T and dP^T = V dO^T with both operands from shared memory
//     (K-major: D is the reduction); P^T and dS^T in registers; dV += P^T
//     dO and dK += dS^T Q with A = P^T, dS^T from registers (packed from
//     the sums, as K1's P) and B = dO, Q read MN-major by the transpose
//     flag (no transposed copies); dV's product runs while dS^T is made.
//     Causal: query tiles wholly before the key tile are skipped; a key
//     tile with no attended key loads nothing and writes its zero dK and
//     dV.
//   pass 2, a block per (128-query tile, batch, head): Q and dO are loaded
//     once; K and V tiles of BKS = 64 keys stream past (a tile with no
//     attended key is never loaded, nor one past the causal diagonal: the
//     producer and the consumers read the same mask bit words); S = Q K^T,
//     dP = dO V^T, dQ += dS K (K MN-major by the transpose flag).
// A tile fully attended and off a warpgroup's diagonal takes no
// per-element predicate; a warpgroup skips (and releases) a tile that
// causality leaves it nothing of.  D 16 and 32 are read as one 64-column box whose
// columns past D are zeros.  delta = rowsum(dO * O) has a kernel of its
// own here (flash_bwd_delta_bf16, one pass over dO and O in fp32): the
// eager PyTorch reduction writes and rereads fp32 copies of both.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BR = 128;       // a block's rows: keys (pass 1), queries (2)
constexpr int BT = 64;        // rows of a streamed tile
constexpr int BOX = 64;       // rows of a TMA box
constexpr int WORDS1 = BR / 32;  // mask words of pass 1's key tile
constexpr int WORDS2 = BT / 32;  // mask words of pass 2's key tiles
constexpr int CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int STAGES = 2;
constexpr int ROW = 128;      // bytes of a swizzled row: 64 bf16

// Shared memory, offsets from a 1024-byte aligned base.  A tile of R rows
// is NH column boxes of [R][64] bf16, box c at c * R * ROW.
template <int D>
struct Layout {
  static constexpr int NH = D <= 64 ? 1 : D / 64;
  static constexpr int BIG = NH * BR * ROW;    // the block's own tile
  static constexpr int SMALL = NH * BT * ROW;  // a streamed tile
  // pass 1: K, V, then per stage Q, dO, lse and delta
  static constexpr int K1 = 0;
  static constexpr int V1 = BIG;
  static constexpr int Q1 = 2 * BIG;
  static constexpr int O1 = Q1 + STAGES * SMALL;
  static constexpr int L1 = O1 + STAGES * SMALL;  // lse, then delta
  static constexpr int END1 = L1 + STAGES * 2 * BT * 4;
  // pass 2: Q, dO, then per stage K and V
  static constexpr int Q2 = 0;
  static constexpr int O2 = BIG;
  static constexpr int K2 = 2 * BIG;
  static constexpr int V2 = K2 + STAGES * SMALL;
  static constexpr int END2 = V2 + STAGES * SMALL;
  static constexpr int BARS = END1 > END2 ? END1 : END2;  // own, full, empty
  static constexpr int BITS = BARS + 8 * (1 + 2 * STAGES);
  static size_t bytes(int n_words) { return BITS + 4 * n_words + 1024; }
};

struct BwdArgs {
  const uint8_t* kv_mask;  // (B, Sk) bytes, row b at + b * mask_stride
  long long mask_stride;
  const float* lse;        // (B*H, Sq) fp32
  const float* delta;
  __nv_bfloat16* dq;       // (B, Sq, H, D)
  __nv_bfloat16* dk;       // (B, Sk, H, D)
  __nv_bfloat16* dv;
  int H, Sq, Sk, causal, fault;
  float scale, scale_log2;
};

// The kernel's tensor maps: pointers to its __grid_constant__ parameters.
struct Maps {
  const CUtensorMap *q, *k, *v, *dout;
};

struct Ring {
  uint32_t own, full0, empty0;
  int stage = 0;
  uint32_t phase = 0;
  __device__ uint32_t full() const { return full0 + 8 * stage; }
  __device__ uint32_t empty() const { return empty0 + 8 * stage; }
  __device__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// Rows [r0, r0 + n_boxes * BOX) of a (B, S, H, D) map, NH column boxes
// each, into a tile of n_boxes * BOX rows at dst.
template <int NH>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* m,
                                          uint32_t bar, int n_boxes, int h,
                                          int r0, int b, int shift) {
  for (int c = 0; c < NH; ++c)
    for (int x = 0; x < n_boxes; ++x)
      tma_load_4d(dst + (c * n_boxes + x) * BOX * ROW, m, bar,
                  64 * c + shift, h, r0 + x * BOX, b);
}

// D (64 x N sums of one warpgroup) = A B^T over KS k16 steps, both from
// shared memory, K-major: a at a tile of A_ROWS rows (the warpgroup's
// first row), b at a tile of B_ROWS rows.
template <int N, int KS, int A_ROWS, int B_ROWS>
__device__ __forceinline__ void product_ss(float (&d)[N / 2], uint32_t a,
                                           uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int c = ks / 4, off = (ks % 4) * 32;
    wgmma_bf16_ss<N, 0>(d, sw128_desc(a + c * A_ROWS * ROW + off, 16, 1024),
                        sw128_desc(b + c * B_ROWS * ROW + off, 16, 1024),
                        ks > 0);
  }
}

// D (64 x DP) += A (64 x 64, registers) B, B a tile of 64 rows (the
// reduction) by DP columns in shared memory, read MN-major.
template <int DP>
__device__ __forceinline__ void product_rs(float (&d)[DP / 2],
                                           const uint32_t (&a)[BT / 16][4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk)
    wgmma_bf16_rs<DP, 1>(d, a[kk], sw128_desc(b + kk * 2048, BT * ROW, 1024),
                         1);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// Writes the warpgroup's 64 rows x D sums (rows row0 and row0 + 8 of each
// thread) in bf16 to a (B, S, H, D) array, rows below S.
template <int D, int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float
                                           (&d)[DP / 2], int b, int h, int H,
                                           int S, int row0, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* p =
        dst + ((long long)b * S + row) * H * D + (long long)h * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * j) =
          __floats2bfloat162_rn(d[4 * j + 2 * r], d[4 * j + 2 * r + 1]);
  }
}

// Pass 1, dK and dV of the 128-key tile kt of (batch, head) bh.  The
// producer thread: K and V once, then the Q, dO, lse and delta tiles of the
// queries that can see the keys.
template <int D>
__device__ __forceinline__ void dkdv_producer(const BwdArgs& a, const Maps& m,
                                              int bh, int kt, uint32_t base,
                                              Ring ring) {
  using L = Layout<D>;
  constexpr int NH = L::NH;
  const int b = bh / a.H, h = bh % a.H;
  const int k0 = kt * BR;
  const int n_qt = (a.Sq + BT - 1) / BT;
  const int shift = a.fault == flash::FAULT_BOX ? 64 : 0;
  mbar_expect_tx(ring.own, 2 * L::BIG);
  load_rows<NH>(base + L::K1, m.k, ring.own, BR / BOX, h, k0, b, shift);
  load_rows<NH>(base + L::V1, m.v, ring.own, BR / BOX, h, k0, b, 0);
  // causal: query tiles wholly before k0 see none of this tile's keys
  for (int qt = a.causal ? k0 / BT : 0; qt < n_qt; ++qt) {
    mbar_wait(ring.empty(), ring.phase ^ 1);
    const uint32_t full = ring.full();
    const int st = ring.stage;
    mbar_expect_tx(full, 2 * L::SMALL);
    load_rows<NH>(base + L::Q1 + st * L::SMALL, m.q, full, 1, h, qt * BT, b,
                  0);
    load_rows<NH>(base + L::O1 + st * L::SMALL, m.dout, full, 1, h, qt * BT,
                  b, 0);
    ring.advance();
  }
}

// Pass 1's second producer warp: the lse and delta of each query tile into
// its stage (zeros past Sq); each lane arrives on the stage's full barrier
// after its stores.
template <int D>
__device__ __forceinline__ void dkdv_rows(const BwdArgs& a, int bh, int kt,
                                          uint8_t* smem, Ring ring) {
  using L = Layout<D>;
  const int lane = threadIdx.x % 32;
  const int Sq = a.Sq;
  const int n_qt = (Sq + BT - 1) / BT;
  for (int qt = a.causal ? kt * BR / BT : 0; qt < n_qt; ++qt) {
    mbar_wait(ring.empty(), ring.phase ^ 1);
    float* dst = reinterpret_cast<float*>(smem + L::L1 +
                                          ring.stage * 2 * BT * 4);
    for (int i = lane; i < 2 * BT; i += 32) {
      const int q = qt * BT + i % BT;
      const float* src = i < BT ? a.lse : a.delta;
      dst[i] = q < Sq ? src[(long long)bh * Sq + q] : 0.f;
    }
    mbar_arrive(ring.full());
    ring.advance();
  }
}

// Pass 1's consumer warpgroup wg: keys k0 + 64 wg .. + 63.  bits: the
// tile's mask words (relative to k0).
template <int D>
__device__ __forceinline__ void dkdv_consumer(const BwdArgs& a, int bh,
                                              int kt, int wg,
                                              const uint8_t* smem,
                                              uint32_t base,
                                              const uint32_t* bits,
                                              bool live, Ring ring) {
  using L = Layout<D>;
  constexpr int DP = 64 * L::NH;
  const int b = bh / a.H, h = bh % a.H;
  const int k0 = kt * BR;
  const int Sq = a.Sq;
  const int n_qt = (Sq + BT - 1) / BT;
  const int tw = threadIdx.x % 128;
  const int warp = tw / 32, lane = tw % 32;
  const int t = lane & 3;
  const int kw = wg * 64;                              // the warpgroup's keys
  const int key0 = k0 + kw + warp * 16 + (lane >> 2);  // keys key0, +8
  const bool kok[2] = {flash::key_bit(bits, key0 - k0),
                       flash::key_bit(bits, key0 + 8 - k0)};
  // every key of the warpgroup attended
  const bool all_kw = flash::all_keys<2>(bits + kw / 32);
  float dk[DP / 2], dv[DP / 2];
  zero(dk);
  zero(dv);
  if (live) {
    const uint32_t ka = base + L::K1 + kw * ROW;
    const uint32_t va = base + L::V1 + kw * ROW;
    mbar_wait(ring.own, 0);
    for (int qt = a.causal ? k0 / BT : 0; qt < n_qt; ++qt) {
      mbar_wait(ring.full(), ring.phase);
      const int q0 = qt * BT;
      if (a.causal && k0 + kw > q0 + BT - 1) {
        // no query of the tile sees the warpgroup's keys
        mbar_arrive(ring.empty());
        ring.advance();
        continue;
      }
      const int st = ring.stage;
      const uint32_t tq = base + L::Q1 + st * L::SMALL;
      const uint32_t to = base + L::O1 + st * L::SMALL;
      const float* tl =
          reinterpret_cast<const float*>(smem + L::L1 + st * 2 * BT * 4);
      const float* td = tl + BT;

      // S^T = K Q^T and dP^T = V dO^T: the warpgroup's 64 keys x BT queries
      float s[BT / 2], dp[BT / 2];
      zero(s);
      zero(dp);
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      product_ss<BT, D / 16, BR, BT>(s, ka, tq);
      product_ss<BT, D / 16, BR, BT>(dp, va, to);
      wgmma_commit();
      wgmma_wait_n<0>();
      fence_regs(s);
      fence_regs(dp);

      // P^T = exp(S^T scale - lse), masked; dS^T = P^T (dP^T - delta) scale
      const bool pred = !all_kw || q0 + BT > Sq ||
                        (a.causal && q0 < k0 + kw + 63);
#pragma unroll
      for (int i = 0; i < BT / 2; ++i) {
        const int qi = 8 * (i / 4) + 2 * t + (i & 1);
        const int r = (i >> 1) & 1;
        const bool ok = !pred || (kok[r] && q0 + qi < Sq &&
                                  (!a.causal || key0 + 8 * r <= q0 + qi));
        s[i] = ok ? exp2f(s[i] * a.scale_log2 - tl[qi] * flash::LOG2E)
                  : 0.f;
      }
      // dV += P^T dO over the tile's queries, running while dS^T is made
      uint32_t pa[BT / 16][4], sa[BT / 16][4];
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        flash::c_to_a(pa[kk], s + 8 * kk);
        fence_regs(pa[kk]);
      }
      fence_regs(dv);
      wgmma_fence();
      product_rs<DP>(dv, pa, to);
      wgmma_commit();
#pragma unroll
      for (int i = 0; i < BT / 2; ++i) {
        const int qi = 8 * (i / 4) + 2 * t + (i & 1);
        dp[i] = s[i] * (dp[i] - td[qi]) * a.scale;
      }
      // dK += dS^T Q
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        flash::c_to_a(sa[kk], dp + 8 * kk);
        fence_regs(sa[kk]);
      }
      fence_regs(dk);
      wgmma_fence();
      product_rs<DP>(dk, sa, tq);
      wgmma_commit();
      wgmma_wait_n<0>();
      fence_regs(dv);
      fence_regs(dk);
      mbar_arrive(ring.empty());
      ring.advance();
    }
  }
  store_rows<D, DP>(a.dk, dk, b, h, a.H, a.Sk, key0, t);
  store_rows<D, DP>(a.dv, dv, b, h, a.H, a.Sk, key0, t);
}

// Pass 2, dQ of the 128-query tile qt of (batch, head) bh.  The producer
// thread: Q and dO once, then the live K and V tiles of 64 keys up to
// n_kt (bits: the mask words from key 0).
template <int D>
__device__ __forceinline__ void dq_producer(const BwdArgs& a, const Maps& m,
                                            int bh, int qt, int n_kt,
                                            uint32_t base,
                                            const uint32_t* bits,
                                            Ring ring) {
  using L = Layout<D>;
  constexpr int NH = L::NH;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = qt * BR;
  const int shift = a.fault == flash::FAULT_BOX ? 64 : 0;
  mbar_expect_tx(ring.own, 2 * L::BIG);
  load_rows<NH>(base + L::Q2, m.q, ring.own, BR / BOX, h, q0, b, 0);
  load_rows<NH>(base + L::O2, m.dout, ring.own, BR / BOX, h, q0, b, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    if (!flash::any_key<WORDS2>(bits + kt * WORDS2)) continue;
    mbar_wait(ring.empty(), ring.phase ^ 1);
    const uint32_t full = ring.full();
    const int st = ring.stage;
    mbar_expect_tx(full, 2 * L::SMALL);
    load_rows<NH>(base + L::K2 + st * L::SMALL, m.k, full, 1, h, kt * BT, b,
                  shift);
    load_rows<NH>(base + L::V2 + st * L::SMALL, m.v, full, 1, h, kt * BT, b,
                  0);
    ring.advance();
  }
}

// Pass 2's consumer warpgroup wg: queries q0 + 64 wg .. + 63.
template <int D>
__device__ __forceinline__ void dq_consumer(const BwdArgs& a, int bh, int qt,
                                            int n_kt, int wg, uint32_t base,
                                            const uint32_t* bits,
                                            Ring ring) {
  using L = Layout<D>;
  constexpr int DP = 64 * L::NH;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = qt * BR;
  const int Sq = a.Sq;
  const int tw = threadIdx.x % 128;
  const int warp = tw / 32, lane = tw % 32;
  const int t = lane & 3;
  const int r_first = q0 + wg * 64;
  const int row0 = r_first + warp * 16 + (lane >> 2);  // rows row0, +8
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < Sq ? a.lse[(long long)bh * Sq + row] * flash::LOG2E : 0.f;
    dl[r] = row < Sq ? a.delta[(long long)bh * Sq + row] : 0.f;
  }
  const uint32_t qa = base + L::Q2 + wg * 64 * ROW;
  const uint32_t oa = base + L::O2 + wg * 64 * ROW;
  float dq[DP / 2];
  zero(dq);
  mbar_wait(ring.own, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const uint32_t* tb = bits + kt * WORDS2;
    if (!flash::any_key<WORDS2>(tb)) continue;
    mbar_wait(ring.full(), ring.phase);
    const int k0 = kt * BT;
    if (a.causal && k0 > r_first + 63) {
      // no row of the warpgroup attends the tile
      mbar_arrive(ring.empty());
      ring.advance();
      continue;
    }
    const int st = ring.stage;
    const uint32_t tk = base + L::K2 + st * L::SMALL;
    const uint32_t tv = base + L::V2 + st * L::SMALL;

    // S = Q K^T and dP = dO V^T: the warpgroup's 64 queries x BT keys
    float s[BT / 2], dp[BT / 2];
    zero(s);
    zero(dp);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    product_ss<BT, D / 16, BR, BT>(s, qa, tk);
    product_ss<BT, D / 16, BR, BT>(dp, oa, tv);
    wgmma_commit();
    wgmma_wait_n<0>();
    fence_regs(s);
    fence_regs(dp);

    // P = exp(S scale - lse), masked; dS = P (dP - delta) scale
    const bool pred = !flash::all_keys<WORDS2>(tb) ||
                      (a.causal && k0 + BT - 1 > r_first);
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) {
      const int col = 8 * (i / 4) + 2 * t + (i & 1);
      const int r = (i >> 1) & 1;
      const bool ok = !pred || (flash::key_bit(tb, col) &&
                                (!a.causal || k0 + col <= row0 + 8 * r));
      const float p = ok ? exp2f(s[i] * a.scale_log2 - lse2[r]) : 0.f;
      dp[i] = p * (dp[i] - dl[r]) * a.scale;
    }
    // dQ += dS K over the tile's keys
    uint32_t sa[BT / 16][4];
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      flash::c_to_a(sa[kk], dp + 8 * kk);
      fence_regs(sa[kk]);
    }
    fence_regs(dq);
    wgmma_fence();
    product_rs<DP>(dq, sa, tk);
    wgmma_commit();
    wgmma_wait_n<0>();
    fence_regs(dq);
    mbar_arrive(ring.empty());
    ring.advance();
  }
  store_rows<D, DP>(a.dq, dq, b, h, a.H, Sq, row0, t);
}

// Both passes in one kernel: blocks y < n_kt1 of the grid (B*H, n_kt1 +
// n_qt) run pass 1 on key tile y; the others pass 2, the heaviest query
// tiles first, so pass 2's blocks fill the tail of pass 1's.
template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap dout_map, const BwdArgs a,
    int n_kt1) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + L::BITS);
  Ring ring;
  ring.own = base + L::BARS;
  ring.full0 = ring.own + 8;
  ring.empty0 = ring.full0 + 8 * STAGES;

  const bool pass1 = (int)blockIdx.y < n_kt1;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const uint8_t* mask = a.kv_mask + (long long)b * a.mask_stride;
  // pass 1: its key tile's words, from k0; pass 2: every key tile's up to
  // its causal limit, from key 0
  const int tile = pass1 ? blockIdx.y : gridDim.y - 1 - blockIdx.y;
  int n_tiles = 1, n_words = WORDS1;
  if (pass1) {
    flash::mask_words<THREADS>(mask + tile * BR, a.Sk - tile * BR, bits,
                               WORDS1, threadIdx.x);
  } else {
    const int q_end = min(a.Sq, (tile + 1) * BR);
    const int k_end = a.causal ? min(a.Sk, q_end) : a.Sk;
    n_tiles = (k_end + BT - 1) / BT;
    n_words = n_tiles * WORDS2;
    flash::mask_words<THREADS>(mask, a.Sk, bits, n_words, threadIdx.x);
  }
  if (threadIdx.x == 0) {
    mbar_init(ring.own, 1);
    for (int s = 0; s < STAGES; ++s) {
      // pass 1: the TMA thread and the 32 lanes of the lse and delta warp
      mbar_init(ring.full0 + 8 * s, pass1 ? 33 : 1);
      mbar_init(ring.empty0 + 8 * s, CONSUMERS * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (a.fault == flash::FAULT_SKIP) {
    if (pass1)
      flash::plant_skip_fault<WORDS1>(bits, 1, threadIdx.x);
    else
      flash::plant_skip_fault<WORDS2>(bits, n_tiles, threadIdx.x);
    __syncthreads();
  }
  const bool live = !pass1 || flash::any_key<WORDS1>(bits);
  const Maps m{&q_map, &k_map, &v_map, &dout_map};

  // the warpgroup, uniform across the warp as the compiler sees it
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == CONSUMERS) {
    // the producer warpgroup: one thread keeps the ring full, and in
    // pass 1 its second warp copies the lse and delta
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    const int warp = threadIdx.x / 32 - 4 * CONSUMERS;
    if (live && threadIdx.x % 32 == 0 && warp == 0) {
      if (pass1)
        dkdv_producer<D>(a, m, bh, tile, base, ring);
      else
        dq_producer<D>(a, m, bh, tile, n_tiles, base, bits, ring);
    } else if (live && pass1 && warp == 1) {
      dkdv_rows<D>(a, bh, tile, smem, ring);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    if (pass1)
      dkdv_consumer<D>(a, bh, tile, wg, smem, base, bits, live, ring);
    else
      dq_consumer<D>(a, bh, tile, n_tiles, wg, base, bits, ring);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const BwdArgs& a, int B, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        flash::MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int n_words = std::max(WORDS1, ((a.Sk + BT - 1) / BT) * WORDS2);
  const size_t bytes = Layout<D>::bytes(n_words);
  if (bytes > (size_t)flash::MAX_SMEM) return (int)cudaErrorInvalidValue;
  CUtensorMap q_map, k_map, v_map, dout_map;
  if (!encode_bshd_bf16(&q_map, q, B, a.Sq, a.H, D, BOX) ||
      !encode_bshd_bf16(&k_map, k, B, a.Sk, a.H, D, BOX) ||
      !encode_bshd_bf16(&v_map, v, B, a.Sk, a.H, D, BOX) ||
      !encode_bshd_bf16(&dout_map, dout, B, a.Sq, a.H, D, BOX))
    return (int)cudaErrorInvalidValue;
  const int n_kt = (a.Sk + BR - 1) / BR;
  const int n_qt = (a.Sq + BR - 1) / BR;
  flash_bwd_kernel<D><<<dim3(B * a.H, n_kt + n_qt), THREADS, bytes,
                        stream>>>(q_map, k_map, v_map, dout_map, a, n_kt);
  return (int)cudaGetLastError();
}

// delta = rowsum(dO * O) in fp32, laid out (B*H, Sq) like the lse: a group
// of D/8 threads per (b, s, h) row, one 16-byte load of each, the group's
// sums added in a fixed order; one thread per 8 columns.
template <int D>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(
    const __nv_bfloat16* __restrict__ out,
    const __nv_bfloat16* __restrict__ dout, float* __restrict__ delta, int H,
    int Sq, long long n_rows) {
  constexpr int G = D / 8;  // threads per row
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = t / G;  // (b * Sq + s) * H + h
  const int part = (int)(t % G);
  float sum = 0.f;
  if (row < n_rows) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(out + row * D) + part);
    const uint4 y =
        __ldg(reinterpret_cast<const uint4*>(dout + row * D) + part);
    const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 a = __bfloat1622float2(x2[j]);
      const float2 c = __bfloat1622float2(y2[j]);
      sum = fmaf(a.x, c.x, sum);
      sum = fmaf(a.y, c.y, sum);
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (row < n_rows && part == 0) {
    const long long bs = row / H;
    const int h = (int)(row % H);
    delta[(bs / Sq * H + h) * Sq + bs % Sq] = sum;
  }
}

template <int D>
int launch_delta(const void* out, const void* dout, void* delta, int B, int H,
                 int Sq, cudaStream_t stream) {
  const long long n_rows = (long long)B * Sq * H;
  const long long threads = n_rows * (D / 8);
  flash_bwd_delta_kernel<D><<<(unsigned)((threads + 255) / 256), 256, 0,
                              stream>>>(
      static_cast<const __nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(dout), static_cast<float*>(delta), H,
      Sq, n_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t as int: 0 when the kernel launched.  ``fault``
// plants one of flash_common.cuh's faults for the card tests; 0 otherwise.
extern "C" int flash_bwd_bf16(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, const void* kv_mask,
                              long long mask_stride, void* dq, void* dk,
                              void* dv, int B, int H, int Sq, int Sk, int D,
                              int causal, float scale, int fault,
                              void* stream) {
  const BwdArgs a{static_cast<const uint8_t*>(kv_mask),
                  mask_stride,
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta),
                  static_cast<__nv_bfloat16*>(dq),
                  static_cast<__nv_bfloat16*>(dk),
                  static_cast<__nv_bfloat16*>(dv),
                  H, Sq, Sk, causal, fault, scale, scale * flash::LOG2E};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, dout, a, B, st);
    case 32:
      return launch<32>(q, k, v, dout, a, B, st);
    case 64:
      return launch<64>(q, k, v, dout, a, B, st);
    case 128:
      return launch<128>(q, k, v, dout, a, B, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// delta = rowsum(dO * O) for flash_bwd_bf16: out/dout (B, Sq, H, D)
// contiguous bf16, delta (B*H, Sq) fp32.  Returns a cudaError_t as int.
extern "C" int flash_bwd_delta_bf16(const void* out, const void* dout,
                                    void* delta, int B, int H, int Sq, int D,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_delta<16>(out, dout, delta, B, H, Sq, st);
    case 32:
      return launch_delta<32>(out, dout, delta, B, H, Sq, st);
    case 64:
      return launch_delta<64>(out, dout, delta, B, H, Sq, st);
    case 128:
      return launch_delta<128>(out, dout, delta, B, H, Sq, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
