// bf16 GEMV for decode, for Hopper, sm_90a, plain C interface.
//
// Replaces: tools/exp_pallas_gemv.py `matvec` (T1: x (rows, H) bf16 @ w
// (H, F) bf16 -> (rows, F) fp32, an MXU dot accumulated over H tiles) and
// tools/exp_pallas_gemv2.py `matvec_vpu` (T2: the same function at one row
// as an fp32 VPU multiply-accumulate); with ROUND, `matvec_vpu_bf16acc`
// (T3: each product rounded to bf16, the products summed in fp32).
//   w (F, K), the decoder's projections:  y[b, o] = sum_k x[b, k] * w[o, k]
//   w (K, F), T1's layout and lm_head's:  y[b, o] = sum_k x[b, k] * w[k, o]
// bf16 activations (B <= 16 rows: a decode step of up to 8 rows, or a
// speculative verify round of D + 1 = 9 tokens), bf16 weights, fp32
// products and sums, fp32 output.
//
// What bounds it on the H100: device-memory bytes.  Each weight is read
// once per call and used for B multiply-adds (2 FLOP per 2-byte weight at
// B = 1, 8 at B = 8), far under the card's ~295 FLOP/byte ridge, so the
// floor is 2 F K bytes / 3.35 TB/s (Valley-7B fused: 30 us for wqkv, 78 us
// for lm_head, 3.94 ms for one step's 13.2 GB of decoder and lm_head
// weights).  But on the CUDA cores every 16-byte weight vector costs B x 8
// fp32 FMAs, 8 bf16 -> fp32 converts and B 16-byte reads of x from L1: at
// B = 8 that issue rate, not memory, set the pace (58 % of the bound).
//
// What the design does about it.  The multiply-adds run on the tensor
// cores, one path for every B.  (F, K), the decoder's projections: a warp
// takes 16 output rows and mma.sync.m16n8k16 (bf16 operands, fp32 sums)
// with N = 8 activation rows, rows past B zero; 9 to 16 rows take a second
// n8 tile (NT8 = 2) whose products reuse each lane's A (weight) fragments,
// so the weights are still read once.  A sum over k
// may take k in any order as long as x takes the same order, so lane
// (g = lane / 4, t = lane % 4) loads VPL = 2 neighbouring 16-byte vectors
// of weight rows g and g + 8 straight from device memory (streaming loads;
// the quad of lanes of a row covers a whole 128-byte line) and uses each
// vector's 8 values as its A fragments of two k16 steps (values 0-3 the
// first, 4-7 the second), and the 16 bytes of x row g at the same offset
// as its B fragments: no shared-memory staging, no ldmatrix, and x's L1
// traffic is half the weight bytes.  Each warp issues its next MU groups'
// loads before the products of the ones it holds (double buffering by
// hand: left alone, the compiler issued each group's loads just before
// its products, and a warp waited on memory once per group).  The 8 warps
// of a block split K between them (F = 4096 still gives 16 warps an SM)
// and add their C fragments in shared memory in warp order.  An F that is
// not a multiple of 16 and a K that is not a multiple of VPL x 32 take
// clamped loads whose values are zeroed (zeros add nothing).  (K, F),
// lm_head: the same products and schedule, 4 warps a block; a lane's
// 16-byte vectors now run along F, so each 32-bit word of them, taken over
// the warp, is an 8 x 8 (k x output) tile that movmatrix transposes into
// an A fragment (outputs as rows), k in natural order.  An F that is not a
// multiple of 8 (or an odd K) and the T3 variant stay on the CUDA cores
// (9 to 16 rows there: two launches, rows 0-7 and the rest):
// each thread owns 8 neighbouring outputs (one 16-byte vector along F, so
// a warp reads 512 contiguous bytes of a row of w), a block's 16 warps
// split K, and the 16 partial sums of an output are added in shared memory
// in a fixed order; an F that is not a multiple of 8 takes one output per
// thread and 2-byte loads; T3's (F, K) kernel is a warp per output row.
//
// The order in which an output's products are summed depends on K and F
// only, never on B, and a tensor-core product's column is a function of
// that column of x alone: a row's result does not change when other rows
// join the call (decode stays row-independent in a batch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int MAX_ROWS = 16;  // activation rows B a launch takes
constexpr int N8 = 8;         // the mma's N: activation rows of one tile
constexpr int NT = 256;       // T3's (F, K): threads a block (8 warps)
constexpr int NW = NT / 32;
constexpr int UNROLL = 4;     // 16-byte weight loads in flight per lane
constexpr int KS = 16;        // (K, F): warps of a block, each a K slice
constexpr int MW = 8;         // (F, K) mma: warps of a block, each a K slice
constexpr int MU = 2;         // mma kernels: steps in flight a warp
constexpr int VPL = 2;        // mma kernels: neighbouring vectors a lane loads
constexpr int MWK = 4;        // (K, F) mma: warps of a block, each a K slice
static_assert(MAX_ROWS == 2 * N8, "at most two n8 tiles of rows");

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

// 16 bytes of a weight row, streamed (evict first).
__device__ __forceinline__ uint4 ld_w(const uint4* p) { return __ldcs(p); }

// A lane's share of one step of the (F, K) mma kernel: for each of MU
// groups of 4 VPL vectors (a row's 32 VPL values), VPL neighbouring 16-byte
// vectors of weight rows g and g + 8 and of x row g (and g + 8 with a
// second tile of rows, NT8 = 2).
constexpr int GV = 4 * VPL;            // vectors a group spans (a row)
template <int NT8>
struct Frag {
  uint4 a0[MU][VPL], a1[MU][VPL], bx[NT8][MU][VPL];
};

template <int NT8>
__device__ __forceinline__ void load_frag(Frag<NT8>& f, const uint4* w0,
                                          const uint4* w1,
                                          const uint4* (&xr)[NT8],
                                          int j0, int t, int nvec) {
#pragma unroll
  for (int u = 0; u < MU; ++u)
#pragma unroll
    for (int h = 0; h < VPL; ++h) {
      const int v = min((j0 + u) * GV + VPL * t + h, nvec - 1);
      f.a0[u][h] = ld_w(w0 + v);
      f.a1[u][h] = ld_w(w1 + v);
#pragma unroll
      for (int n = 0; n < NT8; ++n) f.bx[n][u][h] = __ldg(xr[n] + v);
    }
}

// The products of a loaded step: what lies past K, F or B is zeroed first.
// Each tile of rows takes the same A fragments and the same k order.
template <int NT8>
__device__ __forceinline__ void mma_frag(float (&c)[NT8][4], Frag<NT8>& f,
                                         int j0, int t, int nvec, bool ok0,
                                         bool ok1, bool (&okx)[NT8]) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int u = 0; u < MU; ++u)
#pragma unroll
    for (int h = 0; h < VPL; ++h) {
      const bool in = (j0 + u) * GV + VPL * t + h < nvec;
      if (!(in && ok0)) f.a0[u][h] = zero;
      if (!(in && ok1)) f.a1[u][h] = zero;
#pragma unroll
      for (int n = 0; n < NT8; ++n)
        if (!(in && okx[n])) f.bx[n][u][h] = zero;
      const uint32_t lo[4] = {f.a0[u][h].x, f.a1[u][h].x, f.a0[u][h].y,
                              f.a1[u][h].y};
#pragma unroll
      for (int n = 0; n < NT8; ++n)
        flash::mma(c[n], lo, f.bx[n][u][h].x, f.bx[n][u][h].y);
      const uint32_t hi[4] = {f.a0[u][h].z, f.a1[u][h].z, f.a0[u][h].w,
                              f.a1[u][h].w};
#pragma unroll
      for (int n = 0; n < NT8; ++n)
        flash::mma(c[n], hi, f.bx[n][u][h].z, f.bx[n][u][h].w);
    }
}

// x: (B, K) bf16; w: (F, K) bf16; y: (B, F) fp32; K a multiple of 8; B at
// most 8 NT8.  Grid ceil(F / 16), MW warps a block: block i owns outputs
// 16 i .. 16 i + 15, warp w the groups w MU .. w MU + MU - 1, then those
// MW MU further on.
template <int NT8>
__global__ void __launch_bounds__(MW * 32) bf16_matvec_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    float* __restrict__ y, int B, int K, int F) {
  __shared__ float part[MW][4 * NT8][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int o0 = blockIdx.x * 16;
  const bool ok0 = o0 + g < F, ok1 = o0 + g + 8 < F;
  bool okx[NT8];
  const uint4* xr[NT8];
#pragma unroll
  for (int n = 0; n < NT8; ++n) {
    okx[n] = N8 * n + g < B;
    xr[n] = reinterpret_cast<const uint4*>(
        x + (long long)min(N8 * n + g, B - 1) * K);
  }
  const uint4* w0 = reinterpret_cast<const uint4*>(
      w + (long long)min(o0 + g, F - 1) * K);
  const uint4* w1 = reinterpret_cast<const uint4*>(
      w + (long long)min(o0 + g + 8, F - 1) * K);
  const int nvec = K / 8;               // 16-byte vectors a row
  const int ngroup = (nvec + GV - 1) / GV;

  // the next step's loads are issued before this step's products: left to
  // itself the compiler issues each step's loads just before their
  // products, and a warp then waits on memory once per step
  float c[NT8][4];
#pragma unroll
  for (int n = 0; n < NT8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[n][i] = 0.f;
  Frag<NT8> cur;
  int j0 = warp * MU;
  if (j0 < ngroup) load_frag(cur, w0, w1, xr, j0, t, nvec);
  for (; j0 < ngroup; j0 += MW * MU) {
    Frag<NT8> nxt;
    const int jn = j0 + MW * MU;
    if (jn < ngroup) load_frag(nxt, w0, w1, xr, jn, t, nvec);
    mma_frag(c, cur, j0, t, nvec, ok0, ok1, okx);
    cur = nxt;
  }

  // tile n's c0, c1: row g, x rows 8n + 2t, 8n + 2t + 1; c2, c3: row g + 8
#pragma unroll
  for (int n = 0; n < NT8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) part[warp][4 * n + i][lane] = c[n][i];
  __syncthreads();
  if (threadIdx.x < 128 * NT8) {
    const int n = threadIdx.x / 16, m = threadIdx.x % 16;
    const int nn = n % N8;
    const int src = (m % 8) * 4 + nn / 2;
    const int i = 4 * (n / N8) + (m / 8) * 2 + nn % 2;
    float s = 0.f;
#pragma unroll
    for (int ww = 0; ww < MW; ++ww) s += part[ww][i][src];
    if (n < B && o0 + m < F) y[(long long)n * F + o0 + m] = s;
  }
}

// An 8 x 8 tile of 16-bit values, one 32-bit word a lane (row lane / 4,
// columns 2 (lane % 4) and 2 (lane % 4) + 1), transposed across the warp.
__device__ __forceinline__ uint32_t transpose8x8(uint32_t v) {
  uint32_t r;
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;" : "=r"(r) : "r"(v));
  return r;
}

// (K, F) on the tensor cores, lm_head's layout.  A step is 16 rows of w
// (k0 .. k0 + 15) and the block's 32 VPL outputs: lane (g, t) loads VPL
// neighbouring 16-byte vectors of rows k0 + g and k0 + 8 + g at outputs
// o0 + 8 (VPL t + h) .. + 7.  Word j of vector h, taken over the warp, is
// an 8 x 8 (k x output) tile whose column pair t holds outputs
// o0 + 8 (VPL t + h) + 2 j + {0, 1}; movmatrix turns it into the A
// fragment of those 8 outputs (rows) over 8 k (columns), in natural k
// order, so x's B fragments are its plain 4-byte words.  Tiles 2p and
// 2p + 1 (tile index 4 h + j) are product p's rows 0-7 and 8-15.
constexpr int KT = 4 * VPL;            // output tiles of 8 a step
template <int NT8>
struct FragKF {
  uint4 w0[MU][VPL], w1[MU][VPL];      // rows k0 + g, k0 + 8 + g
  // x row 8n + g at k0 + 2t, k0 + 8 + 2t
  uint32_t b0[NT8][MU], b1[NT8][MU];
};

template <int NT8>
__device__ __forceinline__ void load_kf(
    FragKF<NT8>& f, const __nv_bfloat16* __restrict__ w,
    const uint32_t* (&xw)[NT8], int j0, int g, int t, int o0, int K,
    int F) {
#pragma unroll
  for (int u = 0; u < MU; ++u) {
    const int k0 = (j0 + u) * 16;
    const long long r0 = min(k0 + g, K - 1), r1 = min(k0 + 8 + g, K - 1);
#pragma unroll
    for (int h = 0; h < VPL; ++h) {
      const int oc = min(o0 + 8 * (VPL * t + h), F - 8);
      f.w0[u][h] = ld_w(reinterpret_cast<const uint4*>(w + r0 * F + oc));
      f.w1[u][h] = ld_w(reinterpret_cast<const uint4*>(w + r1 * F + oc));
    }
#pragma unroll
    for (int n = 0; n < NT8; ++n) {
      f.b0[n][u] = __ldg(xw[n] + min(k0 + 2 * t, K - 2) / 2);
      f.b1[n][u] = __ldg(xw[n] + min(k0 + 8 + 2 * t, K - 2) / 2);
    }
  }
}

template <int NT8>
__device__ __forceinline__ void mma_kf(float (&c)[NT8][2 * VPL][4],
                                       FragKF<NT8>& f, int j0, int g, int t,
                                       int o0, int K, int F,
                                       bool (&okx)[NT8]) {
#pragma unroll
  for (int u = 0; u < MU; ++u) {
    const int k0 = (j0 + u) * 16;
    const bool in0 = k0 + g < K, in1 = k0 + 8 + g < K;
    uint32_t a0[KT], a1[KT];   // tile 4 h + j over k-block 0, then 1
#pragma unroll
    for (int h = 0; h < VPL; ++h) {
      const bool col = o0 + 8 * (VPL * t + h) < F;
      const uint32_t v0[4] = {f.w0[u][h].x, f.w0[u][h].y, f.w0[u][h].z,
                              f.w0[u][h].w};
      const uint32_t v1[4] = {f.w1[u][h].x, f.w1[u][h].y, f.w1[u][h].z,
                              f.w1[u][h].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a0[4 * h + j] = transpose8x8(col && in0 ? v0[j] : 0u);
        a1[4 * h + j] = transpose8x8(col && in1 ? v1[j] : 0u);
      }
    }
#pragma unroll
    for (int n = 0; n < NT8; ++n) {
      const uint32_t b0 = okx[n] && k0 + 2 * t < K ? f.b0[n][u] : 0u;
      const uint32_t b1 = okx[n] && k0 + 8 + 2 * t < K ? f.b1[n][u] : 0u;
#pragma unroll
      for (int p = 0; p < 2 * VPL; ++p) {
        const uint32_t a[4] = {a0[2 * p], a0[2 * p + 1], a1[2 * p],
                               a1[2 * p + 1]};
        flash::mma(c[n][p], a, b0, b1);
      }
    }
  }
}

// x: (B, K) bf16, K even, B at most 8 NT8; w: (K, F) bf16, F a multiple of
// 8; y: (B, F) fp32.  Grid ceil(F / (32 VPL)), MWK warps a block: block i
// owns outputs 32 VPL i .. + 32 VPL - 1, warp w the 16-row steps
// w MU .. w MU + MU - 1, then those MWK MU further on; the warps' sums are
// added in warp order.
template <int NT8>
__global__ void __launch_bounds__(MWK * 32) bf16_matvec_kf_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    float* __restrict__ y, int B, int K, int F) {
  __shared__ float part[MWK][NT8][2 * VPL][4][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int o0 = blockIdx.x * 32 * VPL;
  bool okx[NT8];
  const uint32_t* xw[NT8];
#pragma unroll
  for (int n = 0; n < NT8; ++n) {
    okx[n] = N8 * n + g < B;
    xw[n] = reinterpret_cast<const uint32_t*>(
        x + (long long)min(N8 * n + g, B - 1) * K);
  }
  const int nstep = (K + 15) / 16;

  float c[NT8][2 * VPL][4];
#pragma unroll
  for (int n = 0; n < NT8; ++n)
#pragma unroll
    for (int p = 0; p < 2 * VPL; ++p)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[n][p][i] = 0.f;
  FragKF<NT8> cur;
  int j0 = warp * MU;
  if (j0 < nstep) load_kf(cur, w, xw, j0, g, t, o0, K, F);
  for (; j0 < nstep; j0 += MWK * MU) {
    FragKF<NT8> nxt;
    const int jn = j0 + MWK * MU;
    if (jn < nstep) load_kf(nxt, w, xw, jn, g, t, o0, K, F);
    mma_kf(c, cur, j0, g, t, o0, K, F, okx);
    cur = nxt;
  }

#pragma unroll
  for (int n = 0; n < NT8; ++n)
#pragma unroll
    for (int p = 0; p < 2 * VPL; ++p)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[warp][n][p][i][lane] = c[n][p][i];
  __syncthreads();
  // product p's row m is column m % 8 of tile T = 2 p + m / 8 (h = T / 4,
  // j = T % 4): output o0 + 8 (VPL (m % 8) / 2 + h) + 2 j + m % 2; x row
  // n is column n % 8 of row tile n / 8
  for (int e = threadIdx.x; e < N8 * NT8 * 32 * VPL; e += MWK * 32) {
    const int n = e / (32 * VPL), q = e % (32 * VPL);
    const int p = q / 16, m = q % 16, nn = n % N8;
    const int tile = 2 * p + m / 8, h = tile / 4, j = tile % 4;
    const int o = o0 + 8 * (VPL * ((m % 8) / 2) + h) + 2 * j + m % 2;
    const int src = (m % 8) * 4 + nn / 2, i = (m / 8) * 2 + nn % 2;
    float s = 0.f;
#pragma unroll
    for (int ww = 0; ww < MWK; ++ww) s += part[ww][n / N8][p][i][src];
    if (n < B && o < F) y[(long long)n * F + o] = s;
  }
}

// The T3 variant on (F, K): x: (B, K) bf16; w: (F, K) bf16; y: (B, F)
// fp32.  Grid ceil(F / NW); warp `threadIdx.x / 32` of block i owns row
// i*NW + warp.
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
  if (!kf) {   // T3 only: the plain (F, K) product takes the mma kernel
    if constexpr (ROUND)
      bf16_matvec_fk_kernel<B, true><<<(F + NW - 1) / NW, NT, 0, stream>>>(
          xb, wb, yf, K, F);
    else
      return (int)cudaErrorInvalidValue;
  } else if (F % 8 == 0) {
    bf16_matvec_kf_kernel<B, 8, ROUND>
        <<<(F + 255) / 256, dim3(32, KS), 0, stream>>>(xb, wb, yf, K, F);
  } else {
    bf16_matvec_kf_kernel<B, 1, ROUND>
        <<<(F + 31) / 32, dim3(32, KS), 0, stream>>>(xb, wb, yf, K, F);
  }
  return (int)cudaGetLastError();
}

// The CUDA-core kernels, rows 0 .. 7 (9 to 16 rows: two launches, the
// second over rows 8 ..).
template <bool ROUND>
int dispatch(const void* x, const void* w, void* y, int B, int K, int F,
             int kf, cudaStream_t st) {
  if (B > N8) {
    const int err = dispatch<ROUND>(x, w, y, N8, K, F, kf, st);
    if (err) return err;
    return dispatch<ROUND>(static_cast<const __nv_bfloat16*>(x) +
                               (long long)N8 * K,
                           w, static_cast<float*>(y) + (long long)N8 * F,
                           B - N8, K, F, kf, st);
  }
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
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  float* yf = static_cast<float*>(y);
  if (!kf && !round) {
    const int grid = (F + 15) / 16;
    if (B <= N8)
      bf16_matvec_mma_kernel<1><<<grid, MW * 32, 0, st>>>(xb, wb, yf, B, K, F);
    else
      bf16_matvec_mma_kernel<2><<<grid, MW * 32, 0, st>>>(xb, wb, yf, B, K, F);
    return (int)cudaGetLastError();
  }
  if (kf && !round && F % 8 == 0 && K % 2 == 0) {
    const int grid = (F + 32 * VPL - 1) / (32 * VPL);
    if (B <= N8)
      bf16_matvec_kf_mma_kernel<1><<<grid, MWK * 32, 0, st>>>(xb, wb, yf, B,
                                                             K, F);
    else
      bf16_matvec_kf_mma_kernel<2><<<grid, MWK * 32, 0, st>>>(xb, wb, yf, B,
                                                             K, F);
    return (int)cudaGetLastError();
  }
  return round ? dispatch<true>(x, w, y, B, K, F, kf, st)
               : dispatch<false>(x, w, y, B, K, F, kf, st);
}
