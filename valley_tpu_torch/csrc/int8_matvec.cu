// int8-weight GEMV for decode, for Hopper, sm_90a, plain C interface.
//
// Replaces: valley_tpu/ops/quant.py `_int8_matvec_kernel` (the Pallas TPU
// kernel launched by `int8_matvec`, which widens each int8 weight tile to
// bf16 for one MXU dot with fp32 sums).  Same function:
//   y[b, o] = scale[o] * sum_k float(x[b, k]) * float(w[o, k])
// with bf16 activations x (B, K), int8 weights, a bf16 per-output-channel
// scale, fp32 accumulation and fp32 output.  The Pallas kernel takes w
// (in, out); the port stores every int8 matrix (out, in), so w here is
// (F, K) with each output's K inputs contiguous.
//
// What bounds it on the H100: device-memory bytes.  Each weight byte is read
// once per call and used for B multiply-adds (B <= 16: a decode step of up
// to 8 rows or of batch_infer's 16-row pool, or a speculative verify round
// of D + 1 = 9 tokens), 2 FLOP per byte at B = 1 and 32 at B = 16, far under
// the card's ~295 FLOP/byte ridge, so the floor is F * K bytes / 3.35 TB/s
// (Valley-7B fused: 15 us for wqkv, 39 us for lm_head, 1.97 ms for one
// token's weights).  What keeps a kernel off that floor is the work each
// byte brings: turning it into a number, B multiply-adds, and reading B
// rows of x for them.
//
// What the design does about it.  The multiply-adds run on the tensor
// cores, in the layout of the bf16 GEMV (bf16_matvec.cu), one path for
// every B: a warp takes 16 output rows as mma.sync.m16n8k16's M (bf16
// operands, fp32 sums) and the activation rows as N, one n8 tile up to 8
// rows and a second for 9 to 16 that reuses each lane's A fragments, so the
// weights are read and converted once whatever B.  This is the Pallas
// kernel's arithmetic: an int8 value is exact in bf16 and a product of two
// bf16 is exact in fp32, so only the order of the fp32 sums differs.
//   Lane (g = lane / 4, t = lane % 4) streams 16-byte vectors of weight
// rows g and g + 8 (streaming loads: the weights are not reread) and turns
// them in registers straight into its A fragments, with no float
// conversion: a byte permute puts two bytes in the low bytes of a bf16
// pair, one lop3 keeps their low 7 bits m in the mantissa of 128.0 (0x4300:
// 128 + m), another their sign bits s in the exponent of -128.0 (0xC300:
// -128, or -256 where s is set), and one bf16x2 fma by 1.0 adds them:
// m - 128 s, the byte's value, exact.  A unit is 64 inputs: lane t holds
// inputs 16 t .. 16 t + 15 of it (the quad of a row reads 64 contiguous
// bytes), and each of the unit's 4 k16 steps takes 4 neighbouring inputs
// from each lane of the quad (values 4 s .. 4 s + 3 of the lane's vector as
// its A columns 2t, 2t+1, 2t+8, 2t+9), so x, read as its own bf16 pairs at
// the same inputs, is the B fragment.  The MW warps of a block take a row's
// units in turn, AHEAD at a time, and each issues its next step's loads
// before the products of the one it holds (left to itself the compiler
// issues each load just before its use); at the end they add their C
// fragments in shared memory in warp order, and the channel scale
// multiplies the row's sum once, as in the Pallas kernel.  Staging the
// weights in shared memory (cp.async, several steps ahead) was tried and
// was not faster.  An F that is not a multiple of 16 reads row F - 1 for
// the rows past it and stores nothing for them; the vectors of a K that is
// not a multiple of 64 past its end are loaded clamped and zeroed.
//
// Sum order: per output, the units of each warp in order (within a unit
// its k16 steps in order), then the warps in order.  It depends on K and F
// only, never on B, and a tensor-core product's column is a function of
// that column of x alone, so a row's result is bit-identical whatever
// other rows share the call (a speculative verify round gives each row the
// bits of plain decode).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int MAX_ROWS = 16;  // activation rows B a launch takes
constexpr int N8 = 8;         // the mma's N: activation rows of one tile
constexpr int MW = 8;         // warps of a block, taking units in turn
constexpr int AHEAD = 1;      // units a step of a warp loads at once
static_assert(MAX_ROWS == 2 * N8, "at most two n8 tiles of rows");

constexpr uint32_t BF16X2_ONE = 0x3F803F80u;     // 1.0, 1.0
constexpr uint32_t BF16X2_128 = 0x43004300u;     // 128.0, 128.0
constexpr uint32_t BF16X2_NEG128 = 0xC300C300u;  // -128.0, -128.0

// a * b + c on bf16 pairs.
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// (a & b) | c in one instruction (the compiler splits the same expression
// written in C into two when both b and c are constants).
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t b,
                                           uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The four int8 of a word (weight j in byte j) as two bf16 pairs h[j] =
// (w[2j], w[2j + 1]), the first in the low half: (128 + m) + (-128 - 128 s)
// for a byte's low 7 bits m and its sign bit s.
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t (&h)[2]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    // byte 2j to byte 0, byte 2j + 1 to byte 2
    const uint32_t p = __byte_perm(w, 0u, 2 * j | (2 * j + 1) << 8);
    h[j] = fma_bf16x2(and_or(p, 0x007F007Fu, BF16X2_128), BF16X2_ONE,
                      and_or(p, 0x00800080u, BF16X2_NEG128));
  }
}

// The 32-bit word j of a 16-byte vector.
__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// What a lane holds of AHEAD units: its vectors of weight rows g and
// g + 8.
struct Held {
  uint4 a0[AHEAD], a1[AHEAD];
};

// Lane t's loads of units u0 .. u0 + AHEAD - 1 that lie before uend: vector
// 4 u + t of each row, clamped to the row (`products` zeroes what lies past
// K).
__device__ __forceinline__ void load_units(Held& h, const uint4* w0,
                                           const uint4* w1, int u0, int uend,
                                           int t, int nvec) {
#pragma unroll
  for (int i = 0; i < AHEAD; ++i) {
    const int u = u0 + i;
    h.a0[i] = h.a1[i] = make_uint4(0u, 0u, 0u, 0u);
    if (u < uend) {
      const int v = min(4 * u + t, nvec - 1);
      h.a0[i] = __ldcs(w0 + v);
      h.a1[i] = __ldcs(w1 + v);
    }
  }
}

// The products of unit u, added to c: lane (g, t)'s vectors a0 (row g) and
// a1 (row g + 8) hold inputs 64 u + 16 t .. + 15, x rows 8 n + g the same
// inputs.  Word j of a vector holds inputs 4 j .. 4 j + 3, k16 step j.
template <int NT8>
__device__ __forceinline__ void products(float (&c)[NT8][4], uint4 a0,
                                         uint4 a1,
                                         const uint4* const (&xr)[NT8],
                                         int u, int t, int nvec) {
  const int v = 4 * u + t;
  if (v >= nvec) {   // past K: zero weights add nothing
    a0 = make_uint4(0u, 0u, 0u, 0u);
    a1 = a0;
  }
  const int xv = 2 * min(v, nvec - 1);
  uint4 xb[NT8][2];
#pragma unroll
  for (int n = 0; n < NT8; ++n)
#pragma unroll
    for (int q = 0; q < 2; ++q) xb[n][q] = __ldg(xr[n] + xv + q);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t h0[2], h1[2];
    i8x4_to_bf16(word(a0, j), h0);
    i8x4_to_bf16(word(a1, j), h1);
    // A columns 2t, 2t+1: values 4j, 4j + 1; columns 2t+8, 2t+9: + 2, + 3
    const uint32_t a[4] = {h0[0], h1[0], h0[1], h1[1]};
#pragma unroll
    for (int n = 0; n < NT8; ++n)
      flash::mma(c[n], a, word(xb[n][j / 2], 2 * (j % 2)),
                 word(xb[n][j / 2], 2 * (j % 2) + 1));
  }
}

// x: (B, K) bf16; w: (F, K) int8; scale: (F,) bf16; y: (B, F) fp32; B at
// most 8 NT8.  Grid ceil(F / 16), MW warps a block: block i owns outputs
// 16 i .. 16 i + 15, warp w the steps of AHEAD units (j MW + w) AHEAD ..
// + AHEAD - 1 (j = 0, 1, ...) of the ceil(K / 64) of a row.
template <int NT8>
__global__ void __launch_bounds__(MW * 32) int8_matvec_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    const __nv_bfloat16* __restrict__ scale, float* __restrict__ y, int B,
    int K, int F) {
  __shared__ float part[MW][4 * NT8][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int o0 = blockIdx.x * 16;
  const uint4* w0 = reinterpret_cast<const uint4*>(
      w + (long long)min(o0 + g, F - 1) * K);
  const uint4* w1 = reinterpret_cast<const uint4*>(
      w + (long long)min(o0 + g + 8, F - 1) * K);
  const uint4* xr[NT8];
#pragma unroll
  for (int n = 0; n < NT8; ++n)
    xr[n] = reinterpret_cast<const uint4*>(
        x + (long long)min(N8 * n + g, B - 1) * K);
  const int nvec = K / 16;               // 16-byte vectors a row
  const int nunit = (nvec + 3) / 4;

  float c[NT8][4];
#pragma unroll
  for (int n = 0; n < NT8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[n][i] = 0.f;
  // warp w's j-th step: units (j MW + w) AHEAD .. + AHEAD - 1; the next
  // step's loads are issued together before this step's products (a row's
  // AHEAD units are 64 AHEAD contiguous bytes, asked for at once)
  const int step = MW * AHEAD, uend = nunit;
  int u0 = warp * AHEAD;
  Held cur;
  load_units(cur, w0, w1, u0, uend, t, nvec);
  for (; u0 < uend; u0 += step) {
    Held nxt;
    load_units(nxt, w0, w1, u0 + step, uend, t, nvec);
#pragma unroll
    for (int i = 0; i < AHEAD; ++i)
      if (u0 + i < uend)
        products<NT8>(c, cur.a0[i], cur.a1[i], xr, u0 + i, t, nvec);
    cur = nxt;
  }

  // tile n's c0, c1: row g, x rows 8n + 2t, 8n + 2t + 1; c2, c3: row g + 8
#pragma unroll
  for (int n = 0; n < NT8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) part[warp][4 * n + i][lane] = c[n][i];
  __syncthreads();
  for (int e = threadIdx.x; e < 128 * NT8; e += MW * 32) {
    const int n = e / 16, m = e % 16;
    const int nn = n % N8;
    const int src = (m % 8) * 4 + nn / 2;
    const int i = 4 * (n / N8) + (m / 8) * 2 + nn % 2;
    float s = 0.f;
#pragma unroll
    for (int ww = 0; ww < MW; ++ww) s += part[ww][i][src];
    if (n < B && o0 + m < F)
      y[(long long)n * F + o0 + m] = s * __bfloat162float(scale[o0 + m]);
  }
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
  const int grid = (F + 15) / 16;
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sp = static_cast<const __nv_bfloat16*>(scale);
  float* yp = static_cast<float*>(y);
  if (B <= N8)
    int8_matvec_mma_kernel<1><<<grid, MW * 32, 0, st>>>(xp, wp, sp, yp, B, K,
                                                        F);
  else
    int8_matvec_mma_kernel<2><<<grid, MW * 32, 0, st>>>(xp, wp, sp, yp, B, K,
                                                        F);
  return (int)cudaGetLastError();
}
