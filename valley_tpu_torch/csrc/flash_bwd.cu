// Flash attention backward for Hopper, sm_90a, plain C interface.
//
// Replaces: valley_tpu/ops/flash_attention.py `_bwd_kernel` (the Pallas TPU
// kernel launched by `_flash_bwd_impl`), the backward of every decoder
// layer's attention in training.  Same formulas: P = exp(S*scale - lse)
// recomputed from the forward's logsumexp, with the mask applied as a
// predicate (P = 0 where a key is masked, causal or past the edge, so a
// fully masked row, whose lse is near -1e9, gives 0 and never inf * 0);
// dV = P^T dO; dP = dO V^T; dS = P * (dP - delta) * scale; dQ = dS K;
// dK = dS^T Q; delta = rowsum(dO * O) comes in from the wrapper.  Every sum
// is fp32; dq, dk and dv are written in bf16.
//
// What bounds it on the H100: arithmetic.  At the Valley-7B training shape
// (B=16, S=512, H=32, D=128, causal) one layer needs ~86 GFLOP of the five
// products against ~537 MB of q/k/v/o/dO/dq/dk/dv traffic: 87 us at the
// bf16 tensor-core peak, 160 us at the memory rate.  This first version
// multiplies on the CUDA cores in fp32 (no tensor cores), so the fp32 FMA
// rate and shared-memory bandwidth bound it, not device memory.
//
// What the design does about it: the Pallas kernel carries dQ in fp32
// across a sequential grid of K tiles; Hopper's blocks run in parallel and
// in no order, so the work is split into two deterministic passes (no
// atomics), each recomputing P from the lse:
//   pass 1, one block per (64-key tile, batch, head): K and V stay in shared
//     memory while Q and dO tiles stream past; dK and dV accumulate in
//     registers (4 key rows x D/16 columns per thread).  Causal: Q tiles
//     entirely above the key tile are skipped.
//   pass 2, one block per (64-query tile, batch, head): Q and dO stay while
//     K and V tiles stream past; dQ accumulates in registers.  Causal: key
//     tiles past the query tile's last row are skipped.
// The (S, S) matrices never leave the SM.  Tiles are fp32 in shared memory
// with rows padded by one float so column walks hit distinct banks (up to
// 166 KB per block, above the 48 KB default, hence cudaFuncSetAttribute).
// Ragged S is masked inside the kernel: no padding copy.  Tensor cores
// (mma.sync / wgmma), TMA and a fused single pass are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // key rows per tile
constexpr int NT = 256;  // threads per block: 16 row groups x 16 lanes
constexpr int PP = BK + 1;  // padded pitch of the P and dS tiles

template <int D>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * BQ * PP + 2 * BQ);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * 64 * (D + 1) + BQ * PP);
}

// Rows [r0, r0 + ROWS) of a (S, row_stride) bf16 matrix -> fp32 shared
// memory with row pitch `pitch`; rows at or past S read as zero.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ src,
                                          int r0, int S, long long row_stride,
                                          float* dst, int pitch, int tid) {
  constexpr int VEC = 8;  // 8 bf16 = 16 bytes per load
  constexpr int PER_ROW = D / VEC;
  for (int idx = tid; idx < ROWS * PER_ROW; idx += NT) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * VEC;
    float* o = dst + r * pitch + c;
    if (r0 + r < S) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + (long long)(r0 + r) * row_stride + c);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC / 2; ++j) {
        const float2 f = __bfloat1622float2(h2[j]);
        o[2 * j] = f.x;
        o[2 * j + 1] = f.y;
      }
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) o[j] = 0.f;
    }
  }
}

// S = A B^T and dP = C E^T for the 4x4 block of one thread: rows ty*4+i of
// the row tiles (A = Q, C = dO), columns tx+16j of the column tiles (B = K,
// E = V), all with pitch D+1.
template <int D>
__device__ __forceinline__ void two_products(const float* sA, const float* sC,
                                             const float* sB, const float* sE,
                                             int tx, int ty, float s[4][4],
                                             float dp[4][4]) {
  constexpr int QP = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[4], cv[4], bv[4], ev[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = sA[(ty * 4 + i) * QP + d];
      cv[i] = sC[(ty * 4 + i) * QP + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bv[j] = sB[(tx + 16 * j) * QP + d];
      ev[j] = sE[(tx + 16 * j) * QP + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i], bv[j], s[i][j]);
        dp[i][j] = fmaf(cv[i], ev[j], dp[i][j]);
      }
  }
}

// Pass 1: dK and dV of one 64-key tile.  Grid (ceil(Sk/BK), B*H).
// q/dout: (B, Sq, H, D); k/v/dk/dv: (B, Sk, H, D), contiguous bf16.
// lse/delta: (B*H, Sq) fp32.  kv_mask: (B, Sk) bytes, row b at
// kv_mask + b * mask_stride, nonzero = attend.
template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const uint8_t* __restrict__ kv_mask, long long mask_stride,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H,
    int Sq, int Sk, int causal, float scale) {
  constexpr int QP = D + 1;
  constexpr int DC = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* sK = smem;          // BK x QP
  float* sV = sK + BK * QP;  // BK x QP
  float* sQ = sV + BK * QP;  // BQ x QP
  float* sO = sQ + BQ * QP;  // BQ x QP, dO
  float* sP = sO + BQ * QP;  // BQ x PP
  float* sS = sP + BQ * PP;  // BQ x PP, dS
  float* sL = sS + BQ * PP;  // BQ, lse of the Q tile's rows
  float* sD = sL + BQ;       // BQ, delta of the Q tile's rows

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long rs = (long long)H * D;  // elements between consecutive s
  const __nv_bfloat16* qb = q + (long long)b * Sq * rs + (long long)h * D;
  const __nv_bfloat16* ob = dout + (long long)b * Sq * rs + (long long)h * D;
  const __nv_bfloat16* kb = k + (long long)b * Sk * rs + (long long)h * D;
  const __nv_bfloat16* vb = v + (long long)b * Sk * rs + (long long)h * D;
  const float* lb = lse + (long long)bh * Sq;
  const float* db = delta + (long long)bh * Sq;
  const uint8_t* mb = kv_mask + (long long)b * mask_stride;

  load_tile<D, BK>(kb, k0, Sk, rs, sK, QP, tid);
  load_tile<D, BK>(vb, k0, Sk, rs, sV, QP, tid);
  bool col_ok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = k0 + tx + 16 * j;
    col_ok[j] = col < Sk && mb[col] != 0;
  }

  float acc_dk[4][DC], acc_dv[4][DC];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_dk[j][c] = acc_dv[j][c] = 0.f;

  // causal: query rows before k0 see none of this tile's keys
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_begin; q0 < Sq; q0 += BQ) {
    __syncthreads();  // the previous Q tile's sQ/sO/sP/sS are consumed
    load_tile<D, BQ>(qb, q0, Sq, rs, sQ, QP, tid);
    load_tile<D, BQ>(ob, q0, Sq, rs, sO, QP, tid);
    if (tid < BQ) {
      const int r = q0 + tid;
      sL[tid] = r < Sq ? lb[r] : 0.f;
      sD[tid] = r < Sq ? db[r] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    two_products<D>(sQ, sO, sK, sV, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ri = ty * 4 + i;
      const int row = q0 + ri;
      const float l = sL[ri];
      const float dl = sD[ri];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = row < Sq && col_ok[j] && (!causal || col <= row);
        const float p = ok ? expf(s[i][j] * scale - l) : 0.f;
        sP[ri * PP + tx + 16 * j] = p;
        sS[ri * PP + tx + 16 * j] = p * (dp[i][j] - dl) * scale;
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q over the tile's 64 query rows
#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      float pv[4], sv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pv[j] = sP[r * PP + ty * 4 + j];
        sv[j] = sS[r * PP + ty * 4 + j];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float ov = sO[r * QP + tx + 16 * c];
        const float qv = sQ[r * QP + tx + 16 * c];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc_dv[j][c] = fmaf(pv[j], ov, acc_dv[j][c]);
          acc_dk[j][c] = fmaf(sv[j], qv, acc_dk[j][c]);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = k0 + ty * 4 + j;
    if (row >= Sk) continue;
    const long long off = (long long)b * Sk * rs + (long long)row * rs +
                          (long long)h * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[off + tx + 16 * c] = __float2bfloat16(acc_dk[j][c]);
      dv[off + tx + 16 * c] = __float2bfloat16(acc_dv[j][c]);
    }
  }
}

// Pass 2: dQ of one 64-query tile.  Grid (ceil(Sq/BQ), B*H); arguments as
// in pass 1.
template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const uint8_t* __restrict__ kv_mask, long long mask_stride,
    __nv_bfloat16* __restrict__ dq, int H, int Sq, int Sk, int causal,
    float scale) {
  constexpr int QP = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;          // BQ x QP
  float* sO = sQ + BQ * QP;  // BQ x QP, dO
  float* sK = sO + BQ * QP;  // BK x QP
  float* sV = sK + BK * QP;  // BK x QP
  float* sS = sV + BK * QP;  // BQ x PP, dS

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long rs = (long long)H * D;
  const __nv_bfloat16* qb = q + (long long)b * Sq * rs + (long long)h * D;
  const __nv_bfloat16* ob = dout + (long long)b * Sq * rs + (long long)h * D;
  const __nv_bfloat16* kb = k + (long long)b * Sk * rs + (long long)h * D;
  const __nv_bfloat16* vb = v + (long long)b * Sk * rs + (long long)h * D;
  const uint8_t* mb = kv_mask + (long long)b * mask_stride;

  load_tile<D, BQ>(qb, q0, Sq, rs, sQ, QP, tid);
  load_tile<D, BQ>(ob, q0, Sq, rs, sO, QP, tid);
  float l[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    l[i] = row < Sq ? lse[(long long)bh * Sq + row] : 0.f;
    dl[i] = row < Sq ? delta[(long long)bh * Sq + row] : 0.f;
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  const int q_end = min(Sq, q0 + BQ);
  // causal: keys at or past q_end are masked for every row of this tile
  const int k_end = causal ? min(Sk, q_end) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's sK/sV are consumed
    load_tile<D, BK>(kb, k0, Sk, rs, sK, QP, tid);
    load_tile<D, BK>(vb, k0, Sk, rs, sV, QP, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
    two_products<D>(sQ, sO, sK, sV, tx, ty, s, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      const bool col_ok = col < Sk && mb[col] != 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty * 4 + i;
        const bool ok = row < Sq && col_ok && (!causal || col <= row);
        const float p = ok ? expf(s[i][j] * scale - l[i]) : 0.f;
        sS[(ty * 4 + i) * PP + tx + 16 * j] = p * (dp[i][j] - dl[i]) * scale;
      }
    }
    __syncwarp();  // a row's dS is written and read by one half-warp

    // dQ += dS K over the tile's 64 keys
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = sS[(ty * 4 + i) * PP + c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const float kv = sK[c * QP + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(sv[i], kv, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const long long off = (long long)b * Sq * rs + (long long)row * rs +
                          (long long)h * D;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc)
      dq[off + tx + 16 * cc] = __float2bfloat16(acc[i][cc]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, const void* kv_mask,
           long long mask_stride, void* dq, void* dk, void* dv, int B, int H,
           int Sq, int Sk, int causal, float scale, cudaStream_t stream) {
  constexpr size_t bytes_kv = dkdv_smem_bytes<D>();
  constexpr size_t bytes_q = dq_smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes_kv);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes_q);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* op = static_cast<const __nv_bfloat16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dp = static_cast<const float*>(delta);
  const auto* mp = static_cast<const uint8_t*>(kv_mask);
  const dim3 grid_kv((Sk + BK - 1) / BK, B * H);
  flash_bwd_dkdv_kernel<D><<<grid_kv, NT, bytes_kv, stream>>>(
      qp, kp, vp, op, lp, dp, mp, mask_stride,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, Sq,
      Sk, causal, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_q((Sq + BQ - 1) / BQ, B * H);
  flash_bwd_dq_kernel<D><<<grid_q, NT, bytes_q, stream>>>(
      qp, kp, vp, op, lp, dp, mp, mask_stride, static_cast<__nv_bfloat16*>(dq),
      H, Sq, Sk, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t as int: 0 when both passes launched.
extern "C" int flash_bwd_bf16(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, const void* kv_mask,
                              long long mask_stride, void* dq, void* dk,
                              void* dv, int B, int H, int Sq, int Sk, int D,
                              int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, dout, lse, delta, kv_mask, mask_stride, dq,
                        dk, dv, B, H, Sq, Sk, causal, scale, st);
    case 32:
      return launch<32>(q, k, v, dout, lse, delta, kv_mask, mask_stride, dq,
                        dk, dv, B, H, Sq, Sk, causal, scale, st);
    case 64:
      return launch<64>(q, k, v, dout, lse, delta, kv_mask, mask_stride, dq,
                        dk, dv, B, H, Sq, Sk, causal, scale, st);
    case 128:
      return launch<128>(q, k, v, dout, lse, delta, kv_mask, mask_stride, dq,
                         dk, dv, B, H, Sq, Sk, causal, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
