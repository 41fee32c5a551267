// Grouped int4-weight GEMV for decode, for Hopper, sm_90a, plain C interface.
//
// Replaces: tools/exp_int4_group.py `pallas_grouped` (the Pallas TPU kernel
// `kern`, int4 weight tiles widened to bf16 in VMEM for one MXU dot per
// group), the hand-written form of the grouped decode product of
// valley_tpu/models/llama.py `_proj` (:270-317).  Same function:
//   y[b, o] = sum_g scale[o, g] * sum_{i in group g} float(x[b, i]) * w[o, i]
// with bf16 activations x (B, K), int4 weights in [-8, 7], bf16 scales per
// output channel and group of K / G inputs (G = 1: per channel), fp32
// accumulation and fp32 output.  The weights are nibble-packed along K, two
// to a byte, the low nibble first: w is (F, K/2) uint8, each output's
// inputs contiguous; the scale is (F, G).
//
// What bounds it on the H100: device-memory bytes.  Each packed byte holds
// two weights and is read once per call for B multiply-adds each (B <= 16:
// a decode step of up to 8 rows or of batch_infer's 16-row pool, or a
// speculative verify round of D + 1 = 9 tokens): 4 FLOP per byte at B = 1
// and 64 at B = 16, far under the card's ~295 FLOP/byte ridge, so the floor
// is (F * K / 2 + 2 * F * G) bytes / 3.35 TB/s (Valley-13B fused at group
// 128: 12.1 us for wqkv, 21.8 us for w_gateup, 24.5 us for the per-channel
// lm_head, 1.98 ms for one token's weights).  What keeps a kernel off that
// floor is the work each byte brings: turning two nibbles into numbers, 2B
// multiply-adds, and reading B rows of x for them.
//
// What the design does about it.  The multiply-adds run on the tensor
// cores, in the layout of the bf16 GEMV (bf16_matvec.cu), one path for
// every B: a warp takes 16 output rows (an m-tile) as mma.sync.m16n8k16's
// M (bf16 operands, fp32 sums) and the activation rows as N, one n8 tile up
// to 8 rows and a second for 9 to 16 that reuses each lane's A fragments,
// so the weights are read and converted once whatever B.  This is the
// Pallas kernel's arithmetic: an int4 value is exact in bf16 and a product
// of two bf16 is exact in fp32, so only the order of the fp32 sums differs.
//   Lane (g = lane / 4, t = lane % 4) streams 16-byte vectors of weight
// rows g and g + 8 (streaming loads: the weights are not reread) and turns
// them in registers straight into its A fragments: a byte permute puts a
// nibble pair (the low nibble first, as pack_int4 lays it) in the two
// halves of a word, one lop3 masks them, biases them by xor 8 to [0, 15]
// and puts them in the low mantissa bits of two bf16 128.0 (0x4300), and
// one bf16x2 fma subtracts 136: three instructions a pair, no float
// conversion.  A unit is 128 inputs: lane t holds inputs 32 t .. 32 t + 31
// of it (the quad of a row reads 64 contiguous bytes), and each of the
// unit's 8 k16 steps takes 4 neighbouring inputs from each lane of the
// quad (values 4 s .. 4 s + 3 of the lane's vector as its A columns 2t,
// 2t+1, 2t+8, 2t+9), so a k16 step never leaves its unit and x, read as
// its own bf16 pairs at the same inputs, is the B fragment.  The MW warps
// of a block take a row's units in turn, AHEAD at a time, and each issues
// its next step's loads before the products of the one it holds (left to
// itself the compiler issues each load just before its use); at the end
// they add their C fragments in shared memory in warp order.  At 9 to 16
// rows x, reread by every warp for its 16 rows, cost more than the weights
// (four bytes of x through L1 and L2 for each packed byte), so a warp takes
// two m-tiles there and each x load serves 32 rows.  Staging the weights
// in shared memory (cp.async, several steps ahead) was tried and was not
// faster.  An F that is not a multiple of 16 reads row F - 1 for the rows
// past it and stores nothing for them; the vectors of a K that is not a
// multiple of 128 past its end are loaded clamped and zeroed.
//   Scales, as pallas_grouped and _proj apply them: with a group size that
// is a multiple of 128 (int4gp's 128) a unit lies in one group, so each
// unit's products go into a C fragment of their own, which joins the row's
// sum times the group's scale (fp32 per-group partials, never a weight
// scaled in bf16); per channel (G = 1) the row's sum is scaled once; any
// other multiple of 8 (tests, tiny models) splits each k16 step into the
// four 4-input chunks of the quad, each in a product of its own (the other
// lanes' A zeroed) times its chunk's group scale.
//
// Sum order: per output, the units of each warp in order (within a unit
// its k16 steps in order), then the warps in order.  It depends on K, F
// and G only, never on B or on the m-tiles a warp takes, and a tensor-core
// product's column is a function of that column of x alone, so a row's
// result is bit-identical whatever other rows share the call (a
// speculative verify round gives each row the bits of plain decode).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int MAX_ROWS = 16;  // activation rows B a launch takes
constexpr int N8 = 8;         // the mma's N: activation rows of one tile
constexpr int MW = 8;         // warps of a block, taking units in turn
constexpr int AHEAD = 1;      // units a step of a warp loads at once
constexpr int UNIT = 128;     // inputs of a unit: a quad's four vectors
constexpr int MAX_K = 1 << 19;  // K's limit in the C interface
static_assert(MAX_ROWS == 2 * N8, "at most two n8 tiles of rows");

// Where the scales apply: once to a row's sum (G = 1), to each unit's
// partial (group size a multiple of UNIT), or to each 4-input chunk's
// partial (any other multiple of 8)
enum Scales { PER_ROW, PER_UNIT, PER_CHUNK };

constexpr uint32_t BF16X2_ONE = 0x3F803F80u;     // 1.0, 1.0
constexpr uint32_t BF16X2_NEG136 = 0xC308C308u;  // -136.0, -136.0

// a * b + c on bf16 pairs.
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// b ? a ^ c : c, bit by bit, in one instruction (the compiler splits the
// same expression written in C into two when both b and c are constants)
__device__ __forceinline__ uint32_t select_xor(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The eight int4 of a packed word (weight 2j in the low nibble of byte j,
// 2j + 1 in its high nibble) as four bf16 pairs h[j] = (w[2j], w[2j + 1]),
// the first in the low half.  A nibble biased by xor 8 is the value plus 8,
// u; in the low mantissa bits of 128.0 (0x4300) it makes 128 + u, and
// 128 + u - 136 is the value, exact.  One lop3 masks a pair of nibbles,
// biases them and puts them into 128.0.
__device__ __forceinline__ void i4x8_to_bf16(uint32_t w, uint32_t (&h)[4]) {
  const uint32_t hi = w >> 4;  // byte j's high nibble in its low nibble
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // byte j of w to byte 0, byte j of hi to byte 2
    const uint32_t p = __byte_perm(w, hi, j | (4 + j) << 8);
    h[j] = fma_bf16x2(select_xor(p, 0x000F000Fu, 0x43084308u), BF16X2_ONE,
                      BF16X2_NEG136);
  }
}

// The 32-bit word j of a 16-byte vector.
__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// What a lane holds of AHEAD units: its vectors of weight rows g + 8 r
// (r = 0 .. 2 MT - 1: rows g and g + 8 of each of its MT m-tiles) and, per
// unit, their group scales.
template <int MT>
struct Held {
  uint4 a[2 * MT][AHEAD];
  // bf16 bits, made floats only where they are used, so that a warp does
  // not wait for them when it loads them
  unsigned short s[2 * MT][AHEAD];
};

// Lane t's loads of units u0 .. u0 + AHEAD - 1 that lie before uend: vector
// 4 u + t of each row (clamped to the row; `products` zeroes what lies past
// K) and, per unit, the scale of the group it lies in: floor(u / upg) for
// upg units a group, as a multiply-high by mh = ceil(2^32 / upg), exact for
// u and upg below 2^16 (K below MAX_K keeps them there).
template <int MT, int MODE>
__device__ __forceinline__ void load_units(
    Held<MT>& h, const uint4* const (&wr)[2 * MT],
    const unsigned short* const (&sr)[2 * MT], int u0, int uend, int t,
    int nvec, uint32_t upg, uint32_t mh) {
#pragma unroll
  for (int i = 0; i < AHEAD; ++i) {
    const int u = u0 + i;
#pragma unroll
    for (int r = 0; r < 2 * MT; ++r) {
      h.a[r][i] = make_uint4(0u, 0u, 0u, 0u);
      h.s[r][i] = 0;
    }
    if (u < uend) {
      const int v = min(4 * u + t, nvec - 1);
#pragma unroll
      for (int r = 0; r < 2 * MT; ++r) h.a[r][i] = __ldcs(wr[r] + v);
      if constexpr (MODE == PER_UNIT) {
        const uint32_t grp = upg == 1 ? u : __umulhi(u, mh);
#pragma unroll
        for (int r = 0; r < 2 * MT; ++r) h.s[r][i] = __ldg(sr[r] + grp);
      }
    }
  }
}

__device__ __forceinline__ float bf16_bits_to_float(unsigned short b) {
  return __uint_as_float((uint32_t)b << 16);
}

// The products of unit u, added to c: lane (g, t)'s vectors a[r] (rows
// g + 8 r) hold inputs 128 u + 32 t .. + 31, x rows 8 n + g the same
// inputs.  Word j of a vector holds inputs 8 j .. 8 j + 7, k16 steps 2j and
// 2j + 1; each x load serves the MT m-tiles.  The unit's products are
// summed apart (p), then added to c as they are (PER_ROW) or times their
// group's scale (PER_UNIT).
template <int NT8, int MT, int MODE>
__device__ __forceinline__ void products(
    float (&c)[MT][NT8][4], uint4 (&a)[2 * MT],
    const unsigned short (&sb)[2 * MT], const uint4* const (&xr)[NT8],
    const unsigned short* const (&sr)[2 * MT], int u, int t, int nvec,
    int gs, int G) {
  const int v = 4 * u + t;
  if (v >= nvec) {   // past K: zero weights add nothing
#pragma unroll
    for (int r = 0; r < 2 * MT; ++r) a[r] = make_uint4(0u, 0u, 0u, 0u);
  }
  const int xv = 4 * min(v, nvec - 1);
  float p[MT][NT8][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) p[m][n][i] = 0.f;

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // x rows 8 n + g at the word's 8 inputs
    uint4 xb[NT8];
#pragma unroll
    for (int n = 0; n < NT8; ++n) xb[n] = __ldg(xr[n] + xv + j);
    uint32_t h[2 * MT][4];
#pragma unroll
    for (int r = 0; r < 2 * MT; ++r) i4x8_to_bf16(word(a[r], j), h[r]);
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        // A columns 2t, 2t+1: values 8j + 4e, + 1; columns 2t+8, 2t+9: + 2,
        // + 3; rows g and g + 8 of m-tile m
        const uint32_t af[4] = {h[2 * m][2 * e], h[2 * m + 1][2 * e],
                                h[2 * m][2 * e + 1], h[2 * m + 1][2 * e + 1]};
        if constexpr (MODE != PER_CHUNK) {
#pragma unroll
          for (int n = 0; n < NT8; ++n)
            flash::mma(p[m][n], af, word(xb[n], 2 * e),
                       word(xb[n], 2 * e + 1));
        } else {
          // quad lane tp's chunk: inputs 128 u + 32 tp + 8 j + 4 e .. + 3
#pragma unroll
          for (int tp = 0; tp < 4; ++tp) {
            const uint32_t keep = t == tp ? ~0u : 0u;
            const uint32_t am[4] = {af[0] & keep, af[1] & keep,
                                    af[2] & keep, af[3] & keep};
            const int grp = min((UNIT * u + 32 * tp + 8 * j + 4 * e) / gs,
                                G - 1);
            const float q0 = bf16_bits_to_float(sr[2 * m][grp]);
            const float q1 = bf16_bits_to_float(sr[2 * m + 1][grp]);
#pragma unroll
            for (int n = 0; n < NT8; ++n) {
              float q[4] = {0.f, 0.f, 0.f, 0.f};
              flash::mma(q, am, word(xb[n], 2 * e),
                         word(xb[n], 2 * e + 1));
              c[m][n][0] = fmaf(q[0], q0, c[m][n][0]);
              c[m][n][1] = fmaf(q[1], q0, c[m][n][1]);
              c[m][n][2] = fmaf(q[2], q1, c[m][n][2]);
              c[m][n][3] = fmaf(q[3], q1, c[m][n][3]);
            }
          }
        }
      }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if constexpr (MODE == PER_ROW) {
#pragma unroll
      for (int n = 0; n < NT8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) c[m][n][i] += p[m][n][i];
    } else if constexpr (MODE == PER_UNIT) {
      // c0, c1: output row g of the m-tile; c2, c3: row g + 8
      const float s0 = bf16_bits_to_float(sb[2 * m]);
      const float s1 = bf16_bits_to_float(sb[2 * m + 1]);
#pragma unroll
      for (int n = 0; n < NT8; ++n) {
        c[m][n][0] = fmaf(p[m][n][0], s0, c[m][n][0]);
        c[m][n][1] = fmaf(p[m][n][1], s0, c[m][n][1]);
        c[m][n][2] = fmaf(p[m][n][2], s1, c[m][n][2]);
        c[m][n][3] = fmaf(p[m][n][3], s1, c[m][n][3]);
      }
    }
  }
}

// x: (B, K) bf16; w: (F, K/2) uint8; scale: (F, G) bf16; y: (B, F) fp32;
// B at most 8 NT8.  Grid ceil(F / (16 MT)), MW warps a block: block i owns
// outputs 16 MT i .. 16 MT (i + 1) - 1 (MT m-tiles of 16), warp w the
// steps of AHEAD units w AHEAD, (MW + w) AHEAD, ... of the ceil(K / 128)
// of a row.
template <int NT8, int MT, int MODE>
__global__ void __launch_bounds__(MW * 32) int4_matvec_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
    const __nv_bfloat16* __restrict__ scale, float* __restrict__ y, int B,
    int K, int F, int G) {
  __shared__ float part[MW][MT][4 * NT8][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int o0 = blockIdx.x * 16 * MT;
  const uint4* wr[2 * MT];
  const unsigned short* sr[2 * MT];
#pragma unroll
  for (int r = 0; r < 2 * MT; ++r) {
    const long long row = min(o0 + g + 8 * r, F - 1);
    wr[r] = reinterpret_cast<const uint4*>(w + row * (K / 2));
    sr[r] = reinterpret_cast<const unsigned short*>(scale + row * G);
  }
  const uint4* xr[NT8];
#pragma unroll
  for (int n = 0; n < NT8; ++n)
    xr[n] = reinterpret_cast<const uint4*>(
        x + (long long)min(N8 * n + g, B - 1) * K);
  const int nvec = K / 32;               // 16-byte vectors a row
  const int nunit = (nvec + 3) / 4;
  const int gs = K / G;                   // group size
  const uint32_t upg = gs / UNIT;         // PER_UNIT: units a group
  const uint32_t mh = upg > 1 ? (uint32_t)((0x100000000ull + upg - 1) / upg)
                              : 0u;

  float c[MT][NT8][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[m][n][i] = 0.f;
  // warp w's j-th step: units (j MW + w) AHEAD .. + AHEAD - 1; the next
  // step's loads are issued before this step's products
  const int step = MW * AHEAD, uend = nunit;
  int u0 = warp * AHEAD;
  Held<MT> cur;
  load_units<MT, MODE>(cur, wr, sr, u0, uend, t, nvec, upg, mh);
  for (; u0 < uend; u0 += step) {
    Held<MT> nxt;
    load_units<MT, MODE>(nxt, wr, sr, u0 + step, uend, t, nvec, upg, mh);
#pragma unroll
    for (int i = 0; i < AHEAD; ++i)
      if (u0 + i < uend) {
        uint4 a[2 * MT];
        unsigned short sb[2 * MT];
#pragma unroll
        for (int r = 0; r < 2 * MT; ++r) {
          a[r] = cur.a[r][i];
          sb[r] = cur.s[r][i];
        }
        products<NT8, MT, MODE>(c, a, sb, xr, sr, u0 + i, t, nvec, gs, G);
      }
    cur = nxt;
  }

  // m-tile m, tile n: c0, c1 row g, x rows 8n + 2t, 8n + 2t + 1; c2, c3 row
  // g + 8
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[warp][m][4 * n + i][lane] = c[m][n][i];
  __syncthreads();
  for (int e = threadIdx.x; e < 128 * NT8 * MT; e += MW * 32) {
    const int mt = e / (128 * NT8), n = e / 16 % (8 * NT8), r = e % 16;
    const int nn = n % N8;
    const int src = (r % 8) * 4 + nn / 2;
    const int i = 4 * (n / N8) + (r / 8) * 2 + nn % 2;
    const int o = o0 + 16 * mt + r;
    float s = 0.f;
#pragma unroll
    for (int ww = 0; ww < MW; ++ww) s += part[ww][mt][i][src];
    if (n < B && o < F) {
      if constexpr (MODE == PER_ROW) s *= __bfloat162float(scale[o]);
      y[(long long)n * F + o] = s;
    }
  }
}

// The kernel of the scales' kind, MT m-tiles a warp.
template <int NT8, int MT>
int launch(const void* x, const void* w, const void* scale, void* y, int B,
           int K, int F, int G, cudaStream_t stream) {
  const int grid = (F + 16 * MT - 1) / (16 * MT);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const uint8_t*>(w);
  const auto* sp = static_cast<const __nv_bfloat16*>(scale);
  float* yp = static_cast<float*>(y);
  if (G == 1)
    int4_matvec_mma_kernel<NT8, MT, PER_ROW><<<grid, MW * 32, 0, stream>>>(
        xp, wp, sp, yp, B, K, F, G);
  else if ((K / G) % UNIT == 0)
    int4_matvec_mma_kernel<NT8, MT, PER_UNIT><<<grid, MW * 32, 0, stream>>>(
        xp, wp, sp, yp, B, K, F, G);
  else
    int4_matvec_mma_kernel<NT8, MT, PER_CHUNK><<<grid, MW * 32, 0, stream>>>(
        xp, wp, sp, yp, B, K, F, G);
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
  // 9 to 16 rows: two m-tiles a warp, so that each x load serves 32 weight
  // rows (a row's sums are the same whatever m-tile it lies in)
  return B <= N8 ? launch<1, 1>(x, w, scale, y, B, K, F, G, st)
                 : launch<2, 2>(x, w, scale, y, B, K, F, G, st);
}
