// Flash forward attention (prefill) for Hopper, sm_90a, plain C interface.
//
// Replaces: valley_tpu/ops/flash_attention.py `_fwd_kernel` (the Pallas TPU
// kernel launched by `_flash_fwd_impl`), the prefill attention of the LLaMA
// decoder.  Same semantics: scale d^-1/2, a (B, Sk) key-validity mask, an
// optional causal mask, fp32 running max / denominator / accumulator, P kept
// in fp32 for PV, per-row logsumexp written in fp32 for a backward pass.
// A row whose keys are all masked outputs 0 (denominator clamped at 1e-30).
//
// What bounds it on the H100: arithmetic.  At the Valley-7B prefill shape
// (S=512, H=32, D=128, causal) one layer needs ~2.1 GFLOP against ~17 MB of
// q/k/v/o traffic.  This first version multiplies on the CUDA cores in fp32
// (no tensor cores), so the fp32 FMA rate and shared-memory bandwidth bound
// it, not device memory.
//
// What the design does about it: the (S, S) logits never leave the SM.  One
// block of 256 threads owns 64 query rows of one (batch, head); K and V
// stream through shared memory in 64-row tiles that all 64 query rows reuse;
// each thread keeps a 4x4 block of logits and a 4 x D/16 block of the output
// in registers; the softmax statistics of a row live in the 16 lanes of one
// half-warp, so row reductions are register shuffles.  Causal tiles above the
// diagonal are never loaded.  Ragged S is masked inside the kernel: no
// padding copy.  Shared-memory rows are padded by one float so that column
// walks hit distinct banks.  Tensor cores (mma.sync / wgmma) and TMA are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per tile
constexpr int NT = 256;       // threads per block: 16 row groups x 16 lanes
constexpr float NEG = -1e9f;  // running-max floor (flash_attention.py _NEG_INF)

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

// Rows [r0, r0 + rows) of a (S, row_stride) bf16 matrix -> fp32 shared
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

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// q/out: (B, Sq, H, D); k/v: (B, Sk, H, D), all contiguous bf16.
// kv_mask: (B, Sk) bytes, row b at kv_mask + b * mask_stride, nonzero = attend.
// lse: (B*H, Sq) fp32.  Grid (ceil(Sq/BQ), B*H).
template <int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ kv_mask,
    long long mask_stride, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int H, int Sq, int Sk, int causal, float scale) {
  constexpr int QP = D + 1;   // padded pitch of the Q and K tiles
  constexpr int PP = BK + 1;  // padded pitch of the P tile
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;          // BQ x QP
  float* sK = sQ + BQ * QP;  // BK x QP
  float* sV = sK + BK * QP;  // BK x D
  float* sP = sV + BK * D;   // BQ x PP

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column lane inside the half-warp
  const int ty = tid / 16;  // row group: rows ty*4 .. ty*4+3
  const long long rs = (long long)H * D;  // elements between consecutive s
  const __nv_bfloat16* qb = q + (long long)b * Sq * rs + (long long)h * D;
  const __nv_bfloat16* kb = k + (long long)b * Sk * rs + (long long)h * D;
  const __nv_bfloat16* vb = v + (long long)b * Sk * rs + (long long)h * D;
  const uint8_t* mb = kv_mask + (long long)b * mask_stride;

  load_tile<D, BQ>(qb, q0, Sq, rs, sQ, QP, tid);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int q_end = min(Sq, q0 + BQ);
  // causal: keys at or past q_end are masked for every row of this block
  const int k_end = causal ? min(Sk, q_end) : Sk;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's sK/sV are consumed
    load_tile<D, BK>(kb, k0, Sk, rs, sK, QP, tid);
    load_tile<D, BK>(vb, k0, Sk, rs, sV, D, tid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * QP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * QP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < Sk && mb[col] != 0 && (!causal || col <= row);
        // masked logits are -inf: they never raise the running max (floored
        // at NEG) and their probability is exactly 0
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(ty * 4 + i) * PP + tx + 16 * j] = p;
        ps += p;
      }
      l[i] = l[i] * alpha + half_warp_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // a row's P is written and read by one half-warp

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * PP + c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const float vv = sV[c * D + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(pv[i], vv, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);  // fully masked rows -> 0
    __nv_bfloat16* o = out + (long long)b * Sq * rs + (long long)row * rs +
                       (long long)h * D;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc)
      o[tx + 16 * cc] = __float2bfloat16(acc[i][cc] / denom);
    if (tx == 0) lse[(long long)bh * Sq + row] = m[i] + logf(denom);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* kv_mask,
           long long mask_stride, void* out, void* lse, int B, int H, int Sq,
           int Sk, int causal, float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<D><<<grid, NT, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(kv_mask),
      mask_stride, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), H,
      Sq, Sk, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t as int: 0 on a successful launch.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              const void* kv_mask, long long mask_stride,
                              void* out, void* lse, int B, int H, int Sq,
                              int Sk, int D, int causal, float scale,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, kv_mask, mask_stride, out, lse, B, H, Sq, Sk,
                        causal, scale, st);
    case 32:
      return launch<32>(q, k, v, kv_mask, mask_stride, out, lse, B, H, Sq, Sk,
                        causal, scale, st);
    case 64:
      return launch<64>(q, k, v, kv_mask, mask_stride, out, lse, B, H, Sq, Sk,
                        causal, scale, st);
    case 128:
      return launch<128>(q, k, v, kv_mask, mask_stride, out, lse, B, H, Sq, Sk,
                         causal, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
