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
// What bounds it on the H100: at the Valley-7B training shape (B=16,
// S=512, H=32, D=128, causal) one layer moves ~537 MB of q/k/v/o/dO/dq/dk/dv
// (160 us at 3.35 TB/s) and needs ~86 GFLOP of products (87 us at the bf16
// tensor-core peak), so bytes bound it on paper.  In practice latency does:
// with mma.sync each warp rereads the streamed tile from shared memory for
// its own 16 rows, and 255 registers and ~105 KB of shared memory a block
// leave 8 warps on an SM, so the tensor cores idle between dependent
// ldmatrix/mma steps.  wgmma (64-row warpgroup tiles fed from shared memory)
// is the next step.
//
// What the design does about it: the Pallas kernel carries dQ in fp32
// across a sequential grid of K tiles; Hopper's blocks run in parallel and
// in no order, so the work is split into two deterministic passes (no
// atomics: two runs give the same bits), each recomputing P from the lse,
// launched as one grid so that pass 2's blocks fill the tail of pass 1's:
//   pass 1, one block of 4 warps per (64-key tile, batch, head), each warp
//     16 keys: K and V stay in shared memory while Q, dO, lse and delta
//     tiles of 64 queries stream past through a 2-stage cp.async ring;
//     S^T = K Q^T, dP^T = V dO^T, dV += P^T dO and dK += dS^T Q, in steps
//     of 32 queries, dK and dV accumulating in registers.  Causal: Q tiles
//     entirely above the key tile are skipped; a key tile with no attended
//     key loads nothing and writes its zero dK and dV.
//   pass 2, one block per (64-query tile, batch, head), each warp 16
//     queries: Q and dO are read once into registers as mma A fragments
//     while K and V tiles stream past (a tile with no attended key is never
//     loaded, nor one past the causal diagonal); S = Q K^T, dP = dO V^T,
//     dQ += dS K, in steps of 32 keys.
// All seven products run on the tensor cores (mma.sync m16n8k16 bf16, fp32
// sums, operands through ldmatrix or ldmatrix.trans from padded bf16
// tiles), with P and dS rounded to bf16 and repacked in registers as A
// fragments.  A tile fully attended and off the diagonal takes no
// per-element predicate.  Ragged S is masked inside the kernel (zero-filled
// copies past the edge): no padding copy.  delta = rowsum(dO * O) has a
// kernel of its own here (flash_bwd_delta_bf16, one pass over dO and O in
// fp32): the eager PyTorch reduction writes and rereads fp32 copies of
// both, 9x the time at the training shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "flash_common.cuh"

namespace {

using flash::pitch;

constexpr int BR = 64;    // a block's rows: keys (pass 1), queries (pass 2)
constexpr int BT = 64;    // rows of a streamed tile
constexpr int NT = 128;   // 4 warps of 16 rows
constexpr int STEP = 32;  // streamed rows per step: queries (1), keys (2)
constexpr int NB = STEP / 8;  // n-blocks of S and dP per step

// K, V, then two stages of Q, dO and of the lse and delta of BT rows.
template <int D>
constexpr size_t dkdv_smem_bytes() {
  return 2 * pitch<D>() * (2 * BR + 4 * BT) + 2 * 2 * BT * sizeof(float);
}

// Q, dO, two stages of K and V, then the key bit words.
template <int D>
size_t dq_smem_bytes(int sk) {
  return 2 * pitch<D>() * (2 * BR + 4 * BT) + 8 * ((sk + BT - 1) / BT);
}

// q/dout: (B, Sq, H, D); k/v and dq/dk/dv: (B, Sk, H, D) and (B, Sq, H,
// D), contiguous bf16.  lse/delta: (B*H, Sq) fp32.  kv_mask: (B, Sk) bytes,
// row b at kv_mask + b * mask_stride, nonzero = attend.
struct BwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;
  const float* delta;
  const uint8_t* kv_mask;
  long long mask_stride;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int H, Sq, Sk, causal;
  float scale, scale_log2;
};

// Pass 1: dK and dV of the 64-key tile kt of (batch, head) bh.
template <int D>
__device__ __forceinline__ void dkdv_tile(const BwdArgs& a, int bh, int kt,
                                          unsigned char* smem) {
  constexpr int P = pitch<D>();
  constexpr int KS = D / 16;  // k-steps over the head dim
  constexpr int DB = D / 8;   // n-blocks of dK and dV
  const __nv_bfloat16* q = a.q;
  const __nv_bfloat16* k = a.k;
  const __nv_bfloat16* v = a.v;
  const __nv_bfloat16* dout = a.dout;
  const float* lse = a.lse;
  const float* delta = a.delta;
  __nv_bfloat16* dk = a.dk;
  __nv_bfloat16* dv = a.dv;
  const int H = a.H, Sq = a.Sq, Sk = a.Sk, causal = a.causal;
  const float scale = a.scale, scale_log2 = a.scale_log2;
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + BR * P;
  __nv_bfloat16* sQ = sV + BR * P;      // 2 stages
  __nv_bfloat16* sO = sQ + 2 * BT * P;  // 2 stages, dO
  float* sL = reinterpret_cast<float*>(sO + 2 * BT * P);  // 2 x (lse, delta)

  const int b = bh / H;
  const int h = bh % H;
  const int k0 = kt * BR;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long rs = (long long)H * D;  // elements between consecutive s
  const __nv_bfloat16* qb = q + (long long)b * Sq * rs + (long long)h * D;
  const __nv_bfloat16* ob = dout + (long long)b * Sq * rs + (long long)h * D;
  const __nv_bfloat16* kb = k + (long long)b * Sk * rs + (long long)h * D;
  const __nv_bfloat16* vb = v + (long long)b * Sk * rs + (long long)h * D;
  const float* lb = lse + (long long)bh * Sq;
  const float* db = delta + (long long)bh * Sq;
  const uint8_t* mb = a.kv_mask + (long long)b * a.mask_stride;

  // keys key0 and key0 + 8 of this thread's accumulator rows
  const int key0 = k0 + warp * 16 + (lane >> 2);
  const bool kok[2] = {key0 < Sk && mb[key0] != 0,
                       key0 + 8 < Sk && mb[key0 + 8] != 0};
  const bool tile_key = tid < BR && k0 + tid < Sk && mb[k0 + tid] != 0;
  // causal: query tiles before k0 see none of this block's keys
  const int qt_begin = causal ? k0 / BT : 0;
  const int n_qt = (Sq + BT - 1) / BT;
  auto load_q = [&](int qt, int st) {
    const int q0 = qt * BT;
    flash::load_tile<D, BT, NT>(qb, q0, Sq, rs, sQ + st * BT * P, tid);
    flash::load_tile<D, BT, NT>(ob, q0, Sq, rs, sO + st * BT * P, tid);
    if (tid < 2 * BT) {
      const int i = tid & (BT - 1);
      const bool ok = q0 + i < Sq;
      const float* src = (tid < BT ? lb : db) + (ok ? q0 + i : 0);
      flash::cp_async4(sL + st * 2 * BT + tid, src, ok);
    }
  };
  const int any_key = __syncthreads_or(tile_key);
  const int all_keys = __syncthreads_and(tid >= BR || tile_key);
  const int c0 = 2 * (lane & 3);

  float dkv[2][DB][4];  // dK, dV
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int j = 0; j < DB; ++j)
      dkv[x][j][0] = dkv[x][j][1] = dkv[x][j][2] = dkv[x][j][3] = 0.f;

  if (any_key) {
    flash::load_tile<D, BR, NT>(kb, k0, Sk, rs, sK, tid);
    flash::load_tile<D, BR, NT>(vb, k0, Sk, rs, sV, tid);
    if (qt_begin < n_qt) load_q(qt_begin, 0);
    flash::cp_async_commit();

    int stage = 0;
    for (int qt = qt_begin; qt < n_qt; ++qt) {
      if (qt + 1 < n_qt) load_q(qt + 1, stage ^ 1);
      flash::cp_async_commit();
      flash::cp_async_wait<1>();  // K, V and this Q tile have landed
      __syncthreads();
      const int q0 = qt * BT;
      const __nv_bfloat16* tQ = sQ + stage * BT * P;
      const __nv_bfloat16* tO = sO + stage * BT * P;
      const float* tL = sL + stage * 2 * BT;
      const float* tD = tL + BT;
      const bool pred = !all_keys || q0 + BT > Sq ||
                        (causal && q0 < k0 + BR - 1);

#pragma unroll
      for (int step = 0; step < BT / STEP; ++step) {
        const int qh = step * STEP;  // the step's first query in the tile
        // S^T = K Q^T and dP^T = V dO^T: 16 keys x STEP queries a warp
        float st[NB][4], dpt[NB][4];
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t ka[4], va[4];
          flash::load_a<P>(ka, sK + warp * 16 * P + ks * 16, lane);
          flash::load_a<P>(va, sV + warp * 16 * P + ks * 16, lane);
#pragma unroll
          for (int np = 0; np < NB / 2; ++np) {
            uint32_t bf[4];
            flash::load_b_nk<P>(bf, tQ + (qh + np * 16) * P + ks * 16, lane);
            flash::mma(st[2 * np], ka, bf[0], bf[1]);
            flash::mma(st[2 * np + 1], ka, bf[2], bf[3]);
            flash::load_b_nk<P>(bf, tO + (qh + np * 16) * P + ks * 16, lane);
            flash::mma(dpt[2 * np], va, bf[0], bf[1]);
            flash::mma(dpt[2 * np + 1], va, bf[2], bf[3]);
          }
        }
        // P^T = exp(S^T scale - lse), masked; dS^T = P^T (dP^T - delta) scale
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = qh + j * 8 + c0 + (e & 1);
            const int r = e >> 1;
            const bool ok =
                !pred || (kok[r] && q0 + qi < Sq &&
                          (!causal || key0 + 8 * r <= q0 + qi));
            const float p =
                ok ? exp2f(st[j][e] * scale_log2 - tL[qi] * flash::LOG2E)
                   : 0.f;
            st[j][e] = p;
            dpt[j][e] = p * (dpt[j][e] - tD[qi]) * scale;
          }
        // dV += P^T dO and dK += dS^T Q over the step's queries
#pragma unroll
        for (int kk = 0; kk < STEP / 16; ++kk) {
          uint32_t pa[4], sa[4];
          flash::c_to_a(pa, st[2 * kk], st[2 * kk + 1]);
          flash::c_to_a(sa, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
          for (int dp = 0; dp < DB / 2; ++dp) {
            uint32_t bf[4];
            flash::load_b_kn<P>(bf, tO + (qh + kk * 16) * P + dp * 16, lane);
            flash::mma(dkv[1][2 * dp], pa, bf[0], bf[1]);
            flash::mma(dkv[1][2 * dp + 1], pa, bf[2], bf[3]);
            flash::load_b_kn<P>(bf, tQ + (qh + kk * 16) * P + dp * 16, lane);
            flash::mma(dkv[0][2 * dp], sa, bf[0], bf[1]);
            flash::mma(dkv[0][2 * dp + 1], sa, bf[2], bf[3]);
          }
        }
      }
      __syncthreads();  // this stage is consumed before it is refilled
      stage ^= 1;
    }
  }
  flash::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= Sk) continue;
    const long long off = (long long)b * Sk * rs + (long long)key * rs +
                          (long long)h * D + c0;
#pragma unroll
    for (int j = 0; j < DB; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + j * 8) =
          __floats2bfloat162_rn(dkv[0][j][2 * r], dkv[0][j][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + j * 8) =
          __floats2bfloat162_rn(dkv[1][j][2 * r], dkv[1][j][2 * r + 1]);
    }
  }
}

// Pass 2: dQ of the 64-query tile qt of (batch, head) bh.
template <int D>
__device__ __forceinline__ void dq_tile(const BwdArgs& a, int bh, int qt,
                                        unsigned char* smem) {
  constexpr int P = pitch<D>();
  constexpr int KS = D / 16;
  constexpr int DB = D / 8;
  const __nv_bfloat16* q = a.q;
  const __nv_bfloat16* k = a.k;
  const __nv_bfloat16* v = a.v;
  const __nv_bfloat16* dout = a.dout;
  const float* lse = a.lse;
  const float* delta = a.delta;
  __nv_bfloat16* dq = a.dq;
  const int H = a.H, Sq = a.Sq, Sk = a.Sk, causal = a.causal;
  const float scale = a.scale, scale_log2 = a.scale_log2;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sO = sQ + BR * P;      // dO
  __nv_bfloat16* sK = sO + BR * P;      // 2 stages
  __nv_bfloat16* sV = sK + 2 * BT * P;  // 2 stages
  uint32_t* bits = reinterpret_cast<uint32_t*>(sV + 2 * BT * P);

  const int b = bh / H;
  const int h = bh % H;
  const int q0 = qt * BR;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long rs = (long long)H * D;
  const __nv_bfloat16* qb = q + (long long)b * Sq * rs + (long long)h * D;
  const __nv_bfloat16* ob = dout + (long long)b * Sq * rs + (long long)h * D;
  const __nv_bfloat16* kb = k + (long long)b * Sk * rs + (long long)h * D;
  const __nv_bfloat16* vb = v + (long long)b * Sk * rs + (long long)h * D;

  const int q_end = min(Sq, q0 + BR);
  // causal: keys at or past q_end are masked for every row of this tile
  const int k_end = causal ? min(Sk, q_end) : Sk;
  const int n_kt = (k_end + BT - 1) / BT;

  flash::load_tile<D, BR, NT>(qb, q0, Sq, rs, sQ, tid);
  flash::load_tile<D, BR, NT>(ob, q0, Sq, rs, sO, tid);
  flash::cp_async_commit();
  flash::mask_words<NT>(a.kv_mask + (long long)b * a.mask_stride, Sk, bits,
                        2 * n_kt, tid);
  __syncthreads();
  auto live = [&](int t) { return (bits[2 * t] | bits[2 * t + 1]) != 0u; };

  int kt = 0;
  while (kt < n_kt && !live(kt)) ++kt;
  int stage = 0;
  if (kt < n_kt) {
    flash::load_tile<D, BT, NT>(kb, kt * BT, Sk, rs, sK, tid);
    flash::load_tile<D, BT, NT>(vb, kt * BT, Sk, rs, sV, tid);
  }
  flash::cp_async_commit();
  flash::cp_async_wait<1>();  // Q and dO have landed
  __syncthreads();

  uint32_t qf[KS][4], of[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    flash::load_a<P>(qf[ks], sQ + warp * 16 * P + ks * 16, lane);
    flash::load_a<P>(of[ks], sO + warp * 16 * P + ks * 16, lane);
  }
  const int row0 = q0 + warp * 16 + (lane >> 2);  // rows row0, row0 + 8
  const int c0 = 2 * (lane & 3);
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < Sq ? lse[(long long)bh * Sq + row] * flash::LOG2E : 0.f;
    dl[r] = row < Sq ? delta[(long long)bh * Sq + row] : 0.f;
  }

  float acc[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  while (kt < n_kt) {
    int nxt = kt + 1;
    while (nxt < n_kt && !live(nxt)) ++nxt;
    if (nxt < n_kt) {
      flash::load_tile<D, BT, NT>(kb, nxt * BT, Sk, rs,
                                  sK + (stage ^ 1) * BT * P, tid);
      flash::load_tile<D, BT, NT>(vb, nxt * BT, Sk, rs,
                                  sV + (stage ^ 1) * BT * P, tid);
    }
    flash::cp_async_commit();
    flash::cp_async_wait<1>();  // tile kt has landed
    __syncthreads();
    const __nv_bfloat16* tK = sK + stage * BT * P;
    const __nv_bfloat16* tV = sV + stage * BT * P;
    const int k0 = kt * BT;
    const uint32_t* tb = bits + 2 * kt;
    const bool pred =
        (tb[0] & tb[1]) != 0xffffffffu || (causal && k0 + BT - 1 > q0);

#pragma unroll
    for (int step = 0; step < BT / STEP; ++step) {
      const int kh = step * STEP;  // the step's first key in the tile
      // S = Q K^T and dP = dO V^T: 16 queries x STEP keys a warp
      float s[NB][4], dp[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint32_t(&qa)[4] = qf[ks];
        const uint32_t(&oa)[4] = of[ks];
#pragma unroll
        for (int np = 0; np < NB / 2; ++np) {
          uint32_t bf[4];
          flash::load_b_nk<P>(bf, tK + (kh + np * 16) * P + ks * 16, lane);
          flash::mma(s[2 * np], qa, bf[0], bf[1]);
          flash::mma(s[2 * np + 1], qa, bf[2], bf[3]);
          flash::load_b_nk<P>(bf, tV + (kh + np * 16) * P + ks * 16, lane);
          flash::mma(dp[2 * np], oa, bf[0], bf[1]);
          flash::mma(dp[2 * np + 1], oa, bf[2], bf[3]);
        }
      }
      // P = exp(S scale - lse), masked; dS = P (dP - delta) scale
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kh + j * 8 + c0 + (e & 1);
          const int r = e >> 1;
          const bool ok = !pred || (flash::key_bit(tb, col) &&
                                    (!causal || k0 + col <= row0 + 8 * r));
          const float p = ok ? exp2f(s[j][e] * scale_log2 - lse2[r]) : 0.f;
          dp[j][e] = p * (dp[j][e] - dl[r]) * scale;
        }
      // dQ += dS K over the step's keys
#pragma unroll
      for (int kk = 0; kk < STEP / 16; ++kk) {
        uint32_t sa[4];
        flash::c_to_a(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int dq2 = 0; dq2 < DB / 2; ++dq2) {
          uint32_t bf[4];
          flash::load_b_kn<P>(bf, tK + (kh + kk * 16) * P + dq2 * 16, lane);
          flash::mma(acc[2 * dq2], sa, bf[0], bf[1]);
          flash::mma(acc[2 * dq2 + 1], sa, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
    kt = nxt;
    stage ^= 1;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    __nv_bfloat16* o = dq + (long long)b * Sq * rs + (long long)row * rs +
                       (long long)h * D + c0;
#pragma unroll
    for (int j = 0; j < DB; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + j * 8) =
          __floats2bfloat162_rn(acc[j][2 * r], acc[j][2 * r + 1]);
  }
}

// Both passes in one kernel: blocks y < n_kt of the grid (B*H, n_kt +
// n_qt) run pass 1 on key tile y; the others pass 2, the heaviest query
// tiles first, so pass 2's blocks fill the tail of pass 1's.
template <int D>
__global__ void __launch_bounds__(NT, 2)
    flash_bwd_kernel(const BwdArgs a, int n_kt) {
  extern __shared__ __align__(16) unsigned char smem[];
  if ((int)blockIdx.y < n_kt)
    dkdv_tile<D>(a, blockIdx.x, blockIdx.y, smem);
  else
    dq_tile<D>(a, blockIdx.x, gridDim.y - 1 - blockIdx.y, smem);
}

template <int D>
int launch(const BwdArgs& a, int B, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        flash::MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const size_t bytes = std::max(dkdv_smem_bytes<D>(), dq_smem_bytes<D>(a.Sk));
  if (bytes > (size_t)flash::MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int n_kt = (a.Sk + BR - 1) / BR;
  const int n_qt = (a.Sq + BR - 1) / BR;
  flash_bwd_kernel<D><<<dim3(B * a.H, n_kt + n_qt), NT, bytes, stream>>>(
      a, n_kt);
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

// Returns a cudaError_t as int: 0 when the kernel launched.
extern "C" int flash_bwd_bf16(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, const void* kv_mask,
                              long long mask_stride, void* dq, void* dk,
                              void* dv, int B, int H, int Sq, int Sk, int D,
                              int causal, float scale, void* stream) {
  const BwdArgs a{static_cast<const __nv_bfloat16*>(q),
                  static_cast<const __nv_bfloat16*>(k),
                  static_cast<const __nv_bfloat16*>(v),
                  static_cast<const __nv_bfloat16*>(dout),
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta),
                  static_cast<const uint8_t*>(kv_mask),
                  mask_stride,
                  static_cast<__nv_bfloat16*>(dq),
                  static_cast<__nv_bfloat16*>(dk),
                  static_cast<__nv_bfloat16*>(dv),
                  H, Sq, Sk, causal, scale, scale * flash::LOG2E};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(a, B, st);
    case 32:
      return launch<32>(a, B, st);
    case 64:
      return launch<64>(a, B, st);
    case 128:
      return launch<128>(a, B, st);
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
