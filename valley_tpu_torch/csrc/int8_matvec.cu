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
// once per call and used for B multiply-adds (B <= 16: a decode step of up
// to 8 rows or of batch_infer's 16-row pool, or a speculative verify round
// of D + 1 = 9 tokens), ~2 FLOP per byte at B = 1, far under the card's
// ~295 FLOP/byte ridge, so the floor is F * K bytes / 3.35 TB/s (Valley-7B
// fused: 15 us for wqkv, 39 us for lm_head, 1.97 ms for one token's
// weights).  From 9 rows on the fp32 FMAs on the CUDA cores (B per weight
// byte) take longer than the bytes at the card's 67 TFLOP/s.
//
// What the design does about it: one warp per output row streams the row in
// 16-byte vectors (16 int8 per lane per load), several loads in flight per
// lane, with the streaming cache hint (the weights do not fit L2 and are not
// reread within a call).  x (at most 8 x 11008 bf16, ~176 KB) is reread by
// every warp through the read-only L1/L2 path.  int8 -> fp32 takes one byte
// permute and one add per element (the value is placed in the mantissa of
// 2^23, exact), so the conversion stays off the slower I2F path.  A warp
// shuffle reduces the row and lane 0 applies the scale.
//
// 9 to 16 rows (`int8_matvec_rows_kernel`): rereading every row of x from
// L1/L2 for every weight vector (32 bytes of x per 16 bytes of weights and
// row) held a 16-row template at a fifth of its bound, so a block of 8
// warps stages x through shared memory a chunk of 512 inputs at a time,
// laid out so that a warp's reads of one half-vector are 512 contiguous
// bytes, and each warp takes two output rows, so that each x read serves
// both.  A lane still takes the vectors lane, lane + 32, ... of its rows in
// order, with the same FMAs, so a row's result is bit-identical at every B
// (alone, among 8 rows or among 16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;       // threads per block (8 warps, 8 rows)
constexpr int NW = NT / 32;
constexpr int MAX_ROWS = 16;  // activation rows B a launch takes
constexpr int EXACT = 8;      // up to this B, one template per B
constexpr int RW = 2;         // 9-16 rows: output rows a warp
constexpr int CV = 32;        // 9-16 rows: vectors of a row a chunk
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

// x: (nb, K) bf16 with 9 <= nb <= 16; w: (F, K) int8; scale: (F,) bf16;
// y: (nb, F) fp32.  Grid ceil(F / (NW RW)); warp `threadIdx.x / 32` of
// block i owns rows (i NW + warp) RW ..  + RW - 1 (a row past F rereads
// row F - 1 and stores nothing).  Chunk c holds inputs 512 c .. 512 c +
// 511 of every x row in shared memory, xs[b][h][lane] = x[b, 16 v + 8 h ..
// + 7] for the vector v = 32 c + lane that lane takes in that chunk.
__global__ void __launch_bounds__(NT) int8_matvec_rows_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    const __nv_bfloat16* __restrict__ scale, float* __restrict__ y, int K,
    int F, int nb) {
  __shared__ uint4 xs[MAX_ROWS][2][CV];       // 16 KB
  const int lane = threadIdx.x % 32;
  const int row0 = (blockIdx.x * NW + threadIdx.x / 32) * RW;
  const bool active = row0 < F;
  const int nvec = K / 16, nchunk = (nvec + CV - 1) / CV;
  const uint4* wr[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r)
    wr[r] = reinterpret_cast<const uint4*>(
        w + (long long)min(row0 + r, F - 1) * K);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  float acc[RW][MAX_ROWS];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int b = 0; b < MAX_ROWS; ++b) acc[r][b] = 0.f;

  // the next chunk's weights are loaded before this chunk's products
  uint4 cur[RW], nxt[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r)
    cur[r] = active && lane < nvec ? __ldcs(wr[r] + lane) : zero;
  for (int c = 0; c < nchunk; ++c) {
    const int v = c * CV + lane;
#pragma unroll
    for (int r = 0; r < RW; ++r)
      nxt[r] = active && v + CV < nvec ? __ldcs(wr[r] + v + CV) : zero;
    __syncthreads();   // every warp is done with the last chunk
    for (int i = threadIdx.x; i < MAX_ROWS * 2 * CV; i += NT) {
      const int b = i / (2 * CV), q = i % (2 * CV);
      const int k = c * CV * 16 + 8 * q;
      if (b < nb && k < K)
        xs[b][q % 2][q / 2] = __ldg(reinterpret_cast<const uint4*>(
            x + (long long)b * K + k));
    }
    __syncthreads();
    if (active && v < nvec) {
      float wf[RW][16];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        i8x4_to_f32(cur[r].x, wf[r]);
        i8x4_to_f32(cur[r].y, wf[r] + 4);
        i8x4_to_f32(cur[r].z, wf[r] + 8);
        i8x4_to_f32(cur[r].w, wf[r] + 12);
      }
#pragma unroll
      for (int b = 0; b < MAX_ROWS; ++b) {
        if (b >= nb) break;
        const uint4 xa = xs[b][0][lane], xb = xs[b][1][lane];
        float xf[16];
        bf16x2_to_f32(xa.x, xf);
        bf16x2_to_f32(xa.y, xf + 2);
        bf16x2_to_f32(xa.z, xf + 4);
        bf16x2_to_f32(xa.w, xf + 6);
        bf16x2_to_f32(xb.x, xf + 8);
        bf16x2_to_f32(xb.y, xf + 10);
        bf16x2_to_f32(xb.z, xf + 12);
        bf16x2_to_f32(xb.w, xf + 14);
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          float a = acc[r][b];
#pragma unroll
          for (int e = 0; e < 16; ++e) a = fmaf(xf[e], wf[r][e], a);
          acc[r][b] = a;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RW; ++r) cur[r] = nxt[r];
  }

#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int b = 0; b < MAX_ROWS; ++b) acc[r][b] = warp_sum(acc[r][b]);
  if (lane == 0 && active) {
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      if (row0 + r >= F) break;
      const float s = __bfloat162float(scale[row0 + r]);
#pragma unroll
      for (int b = 0; b < MAX_ROWS; ++b)
        if (b < nb) y[(long long)b * F + row0 + r] = acc[r][b] * s;
    }
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
  if (B > EXACT) {
    int8_matvec_rows_kernel<<<(F + NW * RW - 1) / (NW * RW), NT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
        static_cast<const __nv_bfloat16*>(scale), static_cast<float*>(y), K,
        F, B);
    return (int)cudaGetLastError();
  }
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
