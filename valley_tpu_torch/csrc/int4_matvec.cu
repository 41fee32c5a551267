// Grouped int4-weight GEMV for decode, for Hopper, sm_90a, plain C interface.
//
// Replaces: tools/exp_int4_group.py `pallas_grouped` (the Pallas TPU kernel
// `kern`, int4 weight tiles dequantized in VMEM), the hand-written form of
// the grouped decode product of valley_tpu/models/llama.py `_proj`
// (:270-317).  Same function:
//   y[b, o] = sum_g scale[o, g] * sum_{i in group g} float(x[b, i]) * w[o, i]
// with bf16 activations x (B, K), int4 weights in [-8, 7], bf16 scales per
// output channel and group of K / G inputs (G = 1: per channel), fp32
// accumulation and fp32 output.  The weights are nibble-packed along K, two
// to a byte, the low nibble first: w is (F, K/2) uint8, each output's
// inputs contiguous; the scale is (F, G).
//
// What bounds it on the H100: device-memory bytes.  Each weight byte holds
// two weights and is read once per call for 2B multiply-adds each (B <= 8),
// ~4 FLOP per byte at B = 1, far under the card's ~295 FLOP/byte ridge, so
// the floor is (F * K / 2 + 2 * F * G) bytes / 3.35 TB/s (Valley-13B fused
// at group 128: 12.1 us for wqkv, 21.8 us for w_gateup, 24.5 us for the
// per-channel lm_head, 1.98 ms for one token's weights).
//
// What the design does about it: as the int8 GEMV (int8_matvec.cu), a
// warp streams its rows in 16-byte vectors (32 weights per lane per load),
// several loads in flight per lane, with the streaming cache hint.
// Neighbouring lanes read neighbouring vectors, so a warp's load is 512
// contiguous bytes.  x is reread by every warp through the read-only path:
// at one row per warp that is 4 bytes of x through L1 for each packed
// weight byte, and it held the kernel at half its bound, so a warp takes R
// rows (4 at B <= 2, 2 at B <= 4) and each x load and conversion serves
// all R.  A nibble becomes an exact float with integer ops: xor 8
// biases it to [0, 15], a mask and a byte permute place it in the low
// mantissa byte of 2^23, and one subtraction leaves the signed value.  Each
// 32-weight vector lies in one group when the group size is a multiple of
// 32, so its partial sum takes the group's scale in one multiply-add (a
// multiple of 8 only: per 8-weight word), the group found by a multiply-high
// instead of a division; a per-channel scale (G = 1) is applied once to the
// row's sum.  A warp shuffle reduces the row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// threads per block: 2 warps, so that F = 5120 at 4 rows per warp makes 640
// blocks for the 132 SMs (8 warps made 160, two on 28 SMs, one elsewhere)
constexpr int NT = 64;
constexpr int NW = NT / 32;
constexpr int MAX_ROWS = 8;   // activation rows B a launch takes
constexpr int UNROLL = 4;     // 16-byte loads in flight per lane at R = 1
constexpr int MAX_K = 1 << 19;  // `group_of` is exact below it

// Where the scales apply: one per row (G = 1), one per 32-weight vector
// (group size a multiple of 32) or one per 8-weight word (a multiple of 8)
enum Scales { PER_ROW, PER_VECTOR, PER_WORD };

// floor(n / d) for the d units (vectors or words) of a group, with m =
// ceil(2^32 / d): exact for n, d < 2^16, which K < MAX_K keeps.
__device__ __forceinline__ uint32_t group_of(uint32_t n, uint32_t d,
                                            uint32_t m) {
  return d == 1 ? n : __umulhi(n, m);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Eight int4 in a 32-bit word (weight 2j in the low nibble of byte j, 2j+1
// in its high nibble) -> eight exact floats in weight order.  Each nibble,
// biased to unsigned (xor 8), becomes the low mantissa byte of 2^23
// (0x4B0000uu = 8388608 + uu); subtracting 8388608 + 8 leaves the int4.
__device__ __forceinline__ void i4x8_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x88888888u;
  const uint32_t lo = u & 0x0F0F0F0Fu;
  const uint32_t hi = (u >> 4) & 0x0F0F0F0Fu;
  f[0] = __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7650)) - 8388616.f;
  f[1] = __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7650)) - 8388616.f;
  f[2] = __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7651)) - 8388616.f;
  f[3] = __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7651)) - 8388616.f;
  f[4] = __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7652)) - 8388616.f;
  f[5] = __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7652)) - 8388616.f;
  f[6] = __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7653)) - 8388616.f;
  f[7] = __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7653)) - 8388616.f;
}

// Two bf16 in a 32-bit word (element 0 in the low half) -> two floats.
__device__ __forceinline__ void bf16x2_to_f32(uint32_t h, float* f) {
  f[0] = __uint_as_float(h << 16);
  f[1] = __uint_as_float(h & 0xFFFF0000u);
}

// The 32-bit word j of a 16-byte vector.
__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// acc[r][b] += sum over the 32 weights of vector v (inputs 32v .. 32v + 31)
// of row r of x[b, i] * w[i], for the R rows of a warp: unscaled (PER_ROW),
// the vector's partial times the scale of the one group it lies in
// (PER_VECTOR), or each 8-weight word's partial times its group's
// (PER_WORD).  Each x load and conversion serves the R rows.  A group holds
// d vectors or words; m = ceil(2^32 / d).
template <int B, int R, int SCALES>
__device__ __forceinline__ void fma_vec(const uint4* wv,
                                        const uint4* __restrict__ xv,
                                        const __nv_bfloat16* const* sr,
                                        int v, int K, uint32_t d, uint32_t m,
                                        float (*acc)[B]) {
  float part[R][B];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int b = 0; b < B; ++b) part[r][b] = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float wf[R][8];
#pragma unroll
    for (int r = 0; r < R; ++r) i4x8_to_f32(word(wv[r], j), wf[r]);
#pragma unroll
    for (int b = 0; b < B; ++b) {
      // 8 bf16 of row b = one 16-byte vector; K % 32 == 0 keeps it aligned
      const uint4 xa =
          __ldg(xv + ((long long)b * K + (long long)v * 32 + j * 8) / 8);
      float xf[8];
      bf16x2_to_f32(xa.x, xf);
      bf16x2_to_f32(xa.y, xf + 2);
      bf16x2_to_f32(xa.z, xf + 4);
      bf16x2_to_f32(xa.w, xf + 6);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float p = part[r][b];
#pragma unroll
        for (int e = 0; e < 8; ++e) p = fmaf(xf[e], wf[r][e], p);
        part[r][b] = p;
      }
    }
    if (SCALES == PER_WORD) {
      const uint32_t g = group_of(4 * v + j, d, m);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float s = __bfloat162float(sr[r][g]);
#pragma unroll
        for (int b = 0; b < B; ++b) {
          acc[r][b] = fmaf(part[r][b], s, acc[r][b]);
          part[r][b] = 0.f;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float s = SCALES == PER_VECTOR
        ? __bfloat162float(sr[r][group_of(v, d, m)]) : 1.f;
#pragma unroll
    for (int b = 0; b < B; ++b)
      if (SCALES != PER_WORD) acc[r][b] = fmaf(part[r][b], s, acc[r][b]);
  }
}

// x: (B, K) bf16; w: (F, K/2) uint8; scale: (F, G) bf16; y: (B, F) fp32.
// Grid ceil(F / (NW * R)); warp `threadIdx.x / 32` of block i owns the R
// rows from (i * NW + warp) * R (the last warp's rows past F reread row
// F - 1 and store nothing).
template <int B, int R, int SCALES>
__global__ void __launch_bounds__(NT) int4_matvec_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
    const __nv_bfloat16* __restrict__ scale, float* __restrict__ y, int K,
    int F, int G) {
  // vector positions each lane keeps in flight: U * R loads of 16 bytes
  constexpr int U = R == 1 ? UNROLL : 8 / R;
  const int lane = threadIdx.x % 32;
  const int row0 = (blockIdx.x * NW + threadIdx.x / 32) * R;
  if (row0 >= F) return;
  const int nvec = K / 32;
  // vectors or words per group, and its reciprocal for `group_of`
  const uint32_t d = (K / G) / (SCALES == PER_WORD ? 8 : 32);
  const uint32_t m = (uint32_t)((0x100000000ull + d - 1) / d);
  const uint4* wr[R];
  const __nv_bfloat16* sr[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = min(row0 + r, F - 1);
    wr[r] = reinterpret_cast<const uint4*>(w + (long long)row * (K / 2));
    sr[r] = scale + (long long)row * G;
  }
  const uint4* xv = reinterpret_cast<const uint4*>(x);

  float acc[R][B];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int b = 0; b < B; ++b) acc[r][b] = 0.f;

  int v = lane;
  for (; v + 32 * (U - 1) < nvec; v += 32 * U) {
    uint4 wv[U][R];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < R; ++r) wv[u][r] = __ldcs(wr[r] + v + 32 * u);
#pragma unroll
    for (int u = 0; u < U; ++u)
      fma_vec<B, R, SCALES>(wv[u], xv, sr, v + 32 * u, K, d, m, acc);
  }
  for (; v < nvec; v += 32) {
    uint4 wv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) wv[r] = __ldcs(wr[r] + v);
    fma_vec<B, R, SCALES>(wv, xv, sr, v, K, d, m, acc);
  }

#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int b = 0; b < B; ++b) acc[r][b] = warp_sum(acc[r][b]);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (row0 + r >= F) break;
      const float s = SCALES == PER_ROW ? __bfloat162float(sr[r][0]) : 1.f;
#pragma unroll
      for (int b = 0; b < B; ++b)
        y[(long long)b * F + row0 + r] = acc[r][b] * s;
    }
  }
}

template <int B, int R>
int launch(const void* x, const void* w, const void* scale, void* y, int K,
           int F, int G, cudaStream_t stream) {
  const dim3 grid((F + NW * R - 1) / (NW * R));
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const uint8_t*>(w);
  const auto* sp = static_cast<const __nv_bfloat16*>(scale);
  float* yp = static_cast<float*>(y);
  if (G == 1)
    int4_matvec_kernel<B, R, PER_ROW><<<grid, NT, 0, stream>>>(xp, wp, sp,
                                                               yp, K, F, G);
  else if ((K / G) % 32 == 0)
    int4_matvec_kernel<B, R, PER_VECTOR><<<grid, NT, 0, stream>>>(
        xp, wp, sp, yp, K, F, G);
  else
    int4_matvec_kernel<B, R, PER_WORD><<<grid, NT, 0, stream>>>(
        xp, wp, sp, yp, K, F, G);
  return (int)cudaGetLastError();
}

}  // namespace

// Most activation rows one launch takes.
extern "C" int int4_matvec_max_rows(void) { return MAX_ROWS; }

// Returns a cudaError_t as int: 0 when the launch succeeded.  K must be a
// multiple of 32 and of G, below MAX_K, the group size K / G a multiple of
// 8; x and w 16-byte aligned; the scale is read one bf16 at a time.
extern "C" int int4_matvec_bf16(const void* x, const void* w,
                                const void* scale, void* y, int B, int K,
                                int F, int G, void* stream) {
  if (B < 1 || B > MAX_ROWS || K <= 0 || K % 32 || K >= MAX_K || F <= 0 ||
      G <= 0 || K % G || (K / G) % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (B) {
    // rows per warp: as many as the registers hold at B rows of x
    case 1: return launch<1, 4>(x, w, scale, y, K, F, G, st);
    case 2: return launch<2, 4>(x, w, scale, y, K, F, G, st);
    case 3: return launch<3, 2>(x, w, scale, y, K, F, G, st);
    case 4: return launch<4, 2>(x, w, scale, y, K, F, G, st);
    case 5: return launch<5, 1>(x, w, scale, y, K, F, G, st);
    case 6: return launch<6, 1>(x, w, scale, y, K, F, G, st);
    case 7: return launch<7, 1>(x, w, scale, y, K, F, G, st);
    default: return launch<8, 1>(x, w, scale, y, K, F, G, st);
  }
}
