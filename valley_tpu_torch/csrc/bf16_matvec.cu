// bf16 GEMV for decode, for Hopper, sm_90a, plain C interface.
//
// Replaces: tools/exp_pallas_gemv.py `matvec` (T1: x (rows, H) bf16 @ w
// (H, F) bf16 -> (rows, F) fp32, an MXU dot accumulated over H tiles) and
// tools/exp_pallas_gemv2.py `matvec_vpu` (T2: the same function at one row
// as an fp32 VPU multiply-accumulate); with ROUND, `matvec_vpu_bf16acc`
// (T3: each product rounded to bf16, the products summed in fp32).
//   w (F, K), the decoder's projections:  y[b, o] = sum_k x[b, k] * w[o, k]
//   w (K, F), T1's layout and lm_head's:  y[b, o] = sum_k x[b, k] * w[k, o]
// bf16 activations (B <= 8 rows), bf16 weights, fp32 products and sums,
// fp32 output.
//
// What bounds it on the H100: device-memory bytes.  Each weight is read
// once per call and used for B multiply-adds (2 FLOP per 2-byte weight at
// B = 1, 8 at B = 8), far under the card's ~295 FLOP/byte ridge, so the
// floor is 2 F K bytes / 3.35 TB/s (Valley-7B fused: 30 us for wqkv, 78 us
// for lm_head, 3.94 ms for one step's 13.2 GB of decoder and lm_head
// weights).  At 8 rows a step's fp32 FMAs come to ~106 GFLOP, ~1.6 ms on
// the CUDA cores' 67 TFLOP/s, so a weight converted once per row would make
// arithmetic the limit: each weight is loaded and converted once and used
// for every row.
//
// What the design does about it.  (F, K): one warp per output row streams
// the row in 16-byte vectors (8 bf16 per lane per load), four loads in
// flight per lane, with the streaming cache hint (the weights do not fit L2
// and are not reread within a call); x (at most 8 x 11008 bf16, ~176 KB) is
// reread by every warp through the read-only path; a warp shuffle reduces
// the row.  (K, F): each thread owns 8 neighbouring outputs (one 16-byte
// vector along F, so a warp reads 512 contiguous bytes of a row of w), a
// block's 16 warps split K between them, and the 16 partial sums of an
// output are added in shared memory in a fixed order; an F that is not a
// multiple of 8 takes one output per thread and 2-byte loads.
//
// The order in which an output's products are summed depends on K and F
// only, never on B: a row's result does not change when other rows join
// the call (decode stays row-independent in a batch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_ROWS = 8;   // activation rows B a launch takes
constexpr int NT = 256;       // (F, K): threads per block (8 warps, 8 rows)
constexpr int NW = NT / 32;
constexpr int UNROLL = 4;     // 16-byte weight loads in flight per lane
constexpr int KS = 16;        // (K, F): warps of a block, each a K slice

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Two bf16 in a 32-bit word (element 0 in the low half) -> two floats.
__device__ __forceinline__ void bf16x2_to_f32(uint32_t h, float* f) {
  f[0] = __uint_as_float(h << 16);
  f[1] = __uint_as_float(h & 0xFFFF0000u);
}

__device__ __forceinline__ void bf16x8_to_f32(const uint4& v, float* f) {
  bf16x2_to_f32(v.x, f);
  bf16x2_to_f32(v.y, f + 2);
  bf16x2_to_f32(v.z, f + 4);
  bf16x2_to_f32(v.w, f + 6);
}

// acc + x * w, or with ROUND acc + bf16(x * w) (the product of two bf16 is
// exact in fp32, so rounding it once gives the bf16 product)
template <bool ROUND>
__device__ __forceinline__ float madd(float x, float w, float acc) {
  if (ROUND)
    return acc + __bfloat162float(__float2bfloat16_rn(__fmul_rn(x, w)));
  return fmaf(x, w, acc);
}

// acc[b] += x[b, 8v .. 8v + 7] . w_vec for every row b.
template <int B, bool ROUND>
__device__ __forceinline__ void fma_vec(const uint4& wv,
                                        const uint4* __restrict__ xv, int v,
                                        int nvec, float* acc) {
  float wf[8];
  bf16x8_to_f32(wv, wf);
#pragma unroll
  for (int b = 0; b < B; ++b) {
    float xf[8];
    bf16x8_to_f32(__ldg(xv + (long long)b * nvec + v), xf);
    float a = acc[b];
#pragma unroll
    for (int e = 0; e < 8; ++e) a = madd<ROUND>(xf[e], wf[e], a);
    acc[b] = a;
  }
}

// x: (B, K) bf16; w: (F, K) bf16; y: (B, F) fp32.  Grid ceil(F / NW); warp
// `threadIdx.x / 32` of block i owns row i*NW + warp.
template <int B, bool ROUND>
__global__ void __launch_bounds__(NT) bf16_matvec_fk_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    float* __restrict__ y, int K, int F) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * NW + threadIdx.x / 32;
  if (row >= F) return;
  const int nvec = K / 8;
  const uint4* wr = reinterpret_cast<const uint4*>(w + (long long)row * K);
  const uint4* xv = reinterpret_cast<const uint4*>(x);

  float acc[B];
#pragma unroll
  for (int b = 0; b < B; ++b) acc[b] = 0.f;

  int v = lane;
  for (; v + 32 * (UNROLL - 1) < nvec; v += 32 * UNROLL) {
    uint4 wv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) wv[u] = __ldcs(wr + v + 32 * u);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      fma_vec<B, ROUND>(wv[u], xv, v + 32 * u, nvec, acc);
  }
  for (; v < nvec; v += 32) fma_vec<B, ROUND>(__ldcs(wr + v), xv, v, nvec, acc);

#pragma unroll
  for (int b = 0; b < B; ++b) acc[b] = warp_sum(acc[b]);
  if (lane == 0) {
#pragma unroll
    for (int b = 0; b < B; ++b) y[(long long)b * F + row] = acc[b];
  }
}

// The VEC weights of row k at columns col .. col + VEC - 1, as floats.
template <int VEC>
__device__ __forceinline__ void load_w(const __nv_bfloat16* __restrict__ w,
                                       long long at, float* wf) {
  if (VEC == 8) {
    bf16x8_to_f32(__ldcs(reinterpret_cast<const uint4*>(w + at)), wf);
  } else {
    wf[0] = __bfloat162float(w[at]);
  }
}

// x: (B, K) bf16; w: (K, F) bf16; y: (B, F) fp32.  Block (32, KS); grid
// ceil(F / (32 VEC)).  Thread (tx, ty) owns columns col .. col + VEC - 1
// and the rows k = ty, ty + KS, ...; the KS partial sums of a column are
// then added in the order ty = 0 .. KS - 1.
template <int B, int VEC, bool ROUND>
__global__ void __launch_bounds__(32 * KS) bf16_matvec_kf_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    float* __restrict__ y, int K, int F) {
  __shared__ float part[KS][32 * VEC];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = (blockIdx.x * 32 + tx) * VEC;

  float acc[B][VEC];
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[b][e] = 0.f;

  if (col < F) {   // VEC 8 takes F % 8 == 0: the whole vector is in range
    auto step = [&](const float* wf, int k) {
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const float xb = __bfloat162float(x[(long long)b * K + k]);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[b][e] = madd<ROUND>(xb, wf[e], acc[b][e]);
      }
    };
    int k = ty;
    for (; k + KS * (UNROLL - 1) < K; k += KS * UNROLL) {
      float wf[UNROLL][VEC];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        load_w<VEC>(w, (long long)(k + KS * u) * F + col, wf[u]);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) step(wf[u], k + KS * u);
    }
    for (; k < K; k += KS) {
      float wf[VEC];
      load_w<VEC>(w, (long long)k * F + col, wf);
      step(wf, k);
    }
  }

  const int t = ty * 32 + tx;
  const int base = blockIdx.x * 32 * VEC;
#pragma unroll
  for (int b = 0; b < B; ++b) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) part[ty][tx * VEC + e] = acc[b][e];
    __syncthreads();
    for (int c = t; c < 32 * VEC; c += 32 * KS) {
      if (base + c < F) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < KS; ++j) s += part[j][c];
        y[(long long)b * F + base + c] = s;
      }
    }
    __syncthreads();
  }
}

template <int B, bool ROUND>
int launch(const void* x, const void* w, void* y, int K, int F, int kf,
           cudaStream_t stream) {
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  auto* yf = static_cast<float*>(y);
  if (!kf) {
    bf16_matvec_fk_kernel<B, ROUND><<<(F + NW - 1) / NW, NT, 0, stream>>>(
        xb, wb, yf, K, F);
  } else if (F % 8 == 0) {
    bf16_matvec_kf_kernel<B, 8, ROUND>
        <<<(F + 255) / 256, dim3(32, KS), 0, stream>>>(xb, wb, yf, K, F);
  } else {
    bf16_matvec_kf_kernel<B, 1, ROUND>
        <<<(F + 31) / 32, dim3(32, KS), 0, stream>>>(xb, wb, yf, K, F);
  }
  return (int)cudaGetLastError();
}

template <bool ROUND>
int dispatch(const void* x, const void* w, void* y, int B, int K, int F,
             int kf, cudaStream_t st) {
  switch (B) {
    case 1: return launch<1, ROUND>(x, w, y, K, F, kf, st);
    case 2: return launch<2, ROUND>(x, w, y, K, F, kf, st);
    case 3: return launch<3, ROUND>(x, w, y, K, F, kf, st);
    case 4: return launch<4, ROUND>(x, w, y, K, F, kf, st);
    case 5: return launch<5, ROUND>(x, w, y, K, F, kf, st);
    case 6: return launch<6, ROUND>(x, w, y, K, F, kf, st);
    case 7: return launch<7, ROUND>(x, w, y, K, F, kf, st);
    default: return launch<8, ROUND>(x, w, y, K, F, kf, st);
  }
}

}  // namespace

// Most activation rows one launch takes.
extern "C" int bf16_matvec_max_rows(void) { return MAX_ROWS; }

// Returns a cudaError_t as int: 0 when the launch succeeded.  kf = 0: w is
// (F, K), K a multiple of 8; kf = 1: w is (K, F).  x and w 16-byte aligned;
// round = 1 rounds each product to bf16 before it is summed (T3).
extern "C" int bf16_matvec(const void* x, const void* w, void* y, int B,
                           int K, int F, int kf, int round, void* stream) {
  if (B < 1 || B > MAX_ROWS || K <= 0 || F <= 0 || (!kf && K % 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return round ? dispatch<true>(x, w, y, B, K, F, kf, st)
               : dispatch<false>(x, w, y, B, K, F, kf, st);
}
