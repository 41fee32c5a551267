// int8-weight GEMV for decode, for Hopper, sm_90a, plain C interface.
//
// Replaces: valley_tpu/ops/quant.py `_int8_matvec_kernel` (the Pallas TPU
// kernel launched by `int8_matvec`).  Same function:
//   y[b, o] = scale[o] * sum_k float(x[b, k]) * float(w[o, k])
// with bf16 activations x (B, K), int8 weights, a bf16 per-output-channel
// scale, fp32 accumulation and fp32 output.  The Pallas kernel takes w
// (in, out); the port stores every int8 matrix (out, in), so w here is
// (F, K) with each output's K inputs contiguous.
//
// What bounds it on the H100: device-memory bytes.  Each weight byte is read
// once per call and used for B multiply-adds (B <= 8 at decode), ~2 FLOP per
// byte at B = 1, far under the card's ~295 FLOP/byte ridge, so the floor is
// F * K bytes / 3.35 TB/s (Valley-7B fused: 15 us for wqkv, 39 us for
// lm_head, 1.97 ms for one token's weights).
//
// What the design does about it: one warp per output row streams the row in
// 16-byte vectors (16 int8 per lane per load), several loads in flight per
// lane, with the streaming cache hint (the weights do not fit L2 and are not
// reread within a call).  x (at most 8 x 11008 bf16, ~176 KB) is reread by
// every warp through the read-only L1/L2 path.  int8 -> fp32 takes one byte
// permute and one add per element (the value is placed in the mantissa of
// 2^23, exact), so the conversion stays off the slower I2F path.  A warp
// shuffle reduces the row and lane 0 applies the scale.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;       // threads per block (8 warps, 8 rows)
constexpr int NW = NT / 32;
constexpr int MAX_ROWS = 8;   // activation rows B a launch takes
constexpr int UNROLL = 4;     // 16-byte weight loads in flight per lane

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Four int8 in a 32-bit word -> four exact floats: each byte, biased to
// unsigned (xor 0x80), becomes the low mantissa byte of 2^23
// (0x4B0000uu = 8388608 + uu); subtracting 8388608 + 128 leaves the int8.
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
}

// Two bf16 in a 32-bit word (element 0 in the low half) -> two floats.
__device__ __forceinline__ void bf16x2_to_f32(uint32_t h, float* f) {
  f[0] = __uint_as_float(h << 16);
  f[1] = __uint_as_float(h & 0xFFFF0000u);
}

// acc[b] += x[b, 16v .. 16v + 15] . w_vec for every row b.
template <int B>
__device__ __forceinline__ void fma_vec(const uint4& wv, const uint4* __restrict__ xv,
                                        int v, int K, float* acc) {
  float wf[16];
  i8x4_to_f32(wv.x, wf);
  i8x4_to_f32(wv.y, wf + 4);
  i8x4_to_f32(wv.z, wf + 8);
  i8x4_to_f32(wv.w, wf + 12);
#pragma unroll
  for (int b = 0; b < B; ++b) {
    // 16 bf16 of row b = two 16-byte vectors; K % 16 == 0 keeps them aligned
    const long long o = ((long long)b * K + (long long)v * 16) / 8;
    const uint4 xa = __ldg(xv + o);
    const uint4 xb = __ldg(xv + o + 1);
    float xf[16];
    bf16x2_to_f32(xa.x, xf);
    bf16x2_to_f32(xa.y, xf + 2);
    bf16x2_to_f32(xa.z, xf + 4);
    bf16x2_to_f32(xa.w, xf + 6);
    bf16x2_to_f32(xb.x, xf + 8);
    bf16x2_to_f32(xb.y, xf + 10);
    bf16x2_to_f32(xb.z, xf + 12);
    bf16x2_to_f32(xb.w, xf + 14);
    float a = acc[b];
#pragma unroll
    for (int e = 0; e < 16; ++e) a = fmaf(xf[e], wf[e], a);
    acc[b] = a;
  }
}

// x: (B, K) bf16; w: (F, K) int8; scale: (F,) bf16; y: (B, F) fp32.
// Grid ceil(F / NW); warp `threadIdx.x / 32` of block i owns row i*NW + warp.
template <int B>
__global__ void __launch_bounds__(NT) int8_matvec_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    const __nv_bfloat16* __restrict__ scale, float* __restrict__ y, int K,
    int F) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * NW + threadIdx.x / 32;
  if (row >= F) return;
  const int nvec = K / 16;
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
    for (int u = 0; u < UNROLL; ++u) fma_vec<B>(wv[u], xv, v + 32 * u, K, acc);
  }
  for (; v < nvec; v += 32) fma_vec<B>(__ldcs(wr + v), xv, v, K, acc);

#pragma unroll
  for (int b = 0; b < B; ++b) acc[b] = warp_sum(acc[b]);
  if (lane == 0) {
    const float s = __bfloat162float(scale[row]);
#pragma unroll
    for (int b = 0; b < B; ++b) y[(long long)b * F + row] = acc[b] * s;
  }
}

template <int B>
int launch(const void* x, const void* w, const void* scale, void* y, int K,
           int F, cudaStream_t stream) {
  int8_matvec_kernel<B><<<(F + NW - 1) / NW, NT, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const __nv_bfloat16*>(scale), static_cast<float*>(y), K, F);
  return (int)cudaGetLastError();
}

}  // namespace

// Most activation rows one launch takes.
extern "C" int int8_matvec_max_rows(void) { return MAX_ROWS; }

// Returns a cudaError_t as int: 0 when the launch succeeded.  K must be a
// multiple of 16, x and w 16-byte aligned; the scale is read one bf16 at a
// time.
extern "C" int int8_matvec_bf16(const void* x, const void* w,
                                const void* scale, void* y, int B, int K,
                                int F, void* stream) {
  if (B < 1 || B > MAX_ROWS || K <= 0 || K % 16 || F <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (B) {
    case 1: return launch<1>(x, w, scale, y, K, F, st);
    case 2: return launch<2>(x, w, scale, y, K, F, st);
    case 3: return launch<3>(x, w, scale, y, K, F, st);
    case 4: return launch<4>(x, w, scale, y, K, F, st);
    case 5: return launch<5>(x, w, scale, y, K, F, st);
    case 6: return launch<6>(x, w, scale, y, K, F, st);
    case 7: return launch<7>(x, w, scale, y, K, F, st);
    default: return launch<8>(x, w, scale, y, K, F, st);
  }
}
