// Grouped W4A8 matrix product for prefill chunks (K8), for Hopper, sm_90a,
// plain C interface.
//
// Replaces no Pallas kernel: it is the product of
// valley_tpu/models/llama.py:210 `_w4a8_group_dot`, which the JAX package
// leaves to XLA (an einsum over (token, group, input) with int32
// accumulation).  No single library call computes it: an int8 matrix
// product has no per-group rescale, and looping one over the groups costs
// K / 128 launches a projection.  Same function:
//   y[t, f] = a[t] * sum_g float(sum_{i in g} xq[t, i] * w[f, i]) * s[f, g]
// with per-token int8 activations xq (T, K) and their fp32 scales a (T,)
// (quantized beside it in plain torch, as in JAX), int4 weights in [-8, 7]
// nibble-packed along K (w is (F, K/2) uint8, the low nibble first, each
// output's inputs contiguous), bf16 group scales s (F, K/128), the sum of a
// group exact in int32 (|sum| <= 128 * 127 * 8 < 2^24, so exact in fp32
// too), fp32 arithmetic after it, and y (T, F) in fp32 or bf16.
//
// What bounds it on the H100: the operations.  At the prefill's shapes
// (T 128-512 rows against Valley-13B's fused projections, 5120-27648 by
// 5120-13824) it does 2 T F K int8 operations for (T K + F K / 2 + 2 F K /
// 128 + T F out) bytes: T / 2 operations a weight byte, 64-256, at the
// card's int8 ridge of 1979 / 3.35 ~ 590 only beyond T ~ 1200, so the floor
// is 2 T F K / 1979 TOPS (41 us for wqkv at T 512).
//
// What the design does about it (a first, simple cut).  The products run on
// the tensor cores as mma.sync.m16n8k32 with int8 operands and int32 sums.
// A block of 4 warps takes 64 rows of x by 128 outputs; a warp 32 rows by
// 64 outputs (2 m16 tiles by 8 n8 tiles, 64 int32 and 64 fp32 registers of
// sums).  The block walks K one group of 128 inputs at a time: the group's
// x tile (64 x 128 bytes) is copied and its packed weight tile (128 x 64
// bytes) unpacked into int8 in shared memory (rows padded to 144 bytes, so
// the fragment loads of a warp hit 32 different banks), with the group's
// 128 scales; the next group's tiles are loaded into registers while the
// warps run this group's four k32 steps.  After a group each int32 sum is
// converted and multiplied by its output's scale, and added to the fp32
// sum (separately rounded: no fused multiply-add), so the result is
// bit-equal to the plain version's group-by-group sum; the int32 sums start
// again at 0.  The token's scale multiplies at the end.  Not done yet, and
// what a redesign would bring: wgmma with TMA-fed tiles (mma.sync reaches a
// fraction of the int8 peak), the weight unpacked in registers as K5 does
// it (each row block unpacks the same weight again), the activation's
// quantization fused in, and a persistent grid.
//
// Ragged edges: rows past T and outputs past F read zeros and store
// nothing.  K must be a multiple of 128 (one group of 128 inputs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // rows of x a block
constexpr int BN = 128;       // outputs a block
constexpr int GROUP = 128;    // inputs a group
constexpr int PITCH = GROUP + 16;  // bytes a row of a shared tile
constexpr int THREADS = 128;  // 4 warps: 2 along the rows, 2 along F
constexpr int WM = 32;        // rows a warp
constexpr int WN = 64;        // outputs a warp
constexpr int MT = WM / 16;   // m16 tiles a warp
constexpr int NT = WN / 8;    // n8 tiles a warp
// 16-byte vectors a thread copies of each tile a group
constexpr int XV = BM * GROUP / 16 / THREADS;        // 4
constexpr int WV = BN * (GROUP / 2) / 16 / THREADS;  // 4

// four nibbles (the low 16 bits, the lowest first) -> four int8 values
__device__ __forceinline__ uint32_t nibbles_to_s8x4(uint32_t h) {
  uint32_t v = (h & 0xFu) | ((h & 0xF0u) << 4) | ((h & 0xF00u) << 8) |
               ((h & 0xF000u) << 12);
  // per byte, (n ^ 8) - 8 sign-extends the nibble
  return __vsub4(v ^ 0x08080808u, 0x08080808u);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS)
w4a8_group_gemm_kernel(const int8_t* __restrict__ xq,
                       const float* __restrict__ a,
                       const uint8_t* __restrict__ w,
                       const __nv_bfloat16* __restrict__ scale,
                       void* __restrict__ y, int T, int K, int F,
                       int out_bf16) {
  __shared__ __align__(16) int8_t xs[BM * PITCH];
  __shared__ __align__(16) int8_t ws[BN * PITCH];
  __shared__ float ss[BN];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 1) * WM, wn = (warp & 1) * WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int G = K / GROUP;
  const int wrow = K / 2;  // bytes a packed weight row

  uint4 xr[XV], wr[WV];
  float sr;
  // the global tiles of group g into registers (zeros past T and F)
  auto load = [&](int g) {
#pragma unroll
    for (int j = 0; j < XV; ++j) {
      const int i = tid + j * THREADS, row = i / (GROUP / 16),
                c = i % (GROUP / 16);
      xr[j] = m0 + row < T
                  ? *reinterpret_cast<const uint4*>(
                        xq + (size_t)(m0 + row) * K + g * GROUP + c * 16)
                  : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < WV; ++j) {
      const int i = tid + j * THREADS, row = i / (GROUP / 32),
                c = i % (GROUP / 32);
      wr[j] = n0 + row < F
                  ? *reinterpret_cast<const uint4*>(
                        w + (size_t)(n0 + row) * wrow + g * (GROUP / 2) +
                        c * 16)
                  : make_uint4(0, 0, 0, 0);
    }
    sr = n0 + tid < F ? __bfloat162float(scale[(size_t)(n0 + tid) * G + g])
                      : 0.f;
  };
  // the registers into shared memory, the weights unpacked to int8
  auto store = [&]() {
#pragma unroll
    for (int j = 0; j < XV; ++j) {
      const int i = tid + j * THREADS, row = i / (GROUP / 16),
                c = i % (GROUP / 16);
      *reinterpret_cast<uint4*>(xs + row * PITCH + c * 16) = xr[j];
    }
#pragma unroll
    for (int j = 0; j < WV; ++j) {
      const int i = tid + j * THREADS, row = i / (GROUP / 32),
                c = i % (GROUP / 32);
      const uint32_t p[4] = {wr[j].x, wr[j].y, wr[j].z, wr[j].w};
      uint4 lo, hi;
      lo.x = nibbles_to_s8x4(p[0] & 0xFFFFu);
      lo.y = nibbles_to_s8x4(p[0] >> 16);
      lo.z = nibbles_to_s8x4(p[1] & 0xFFFFu);
      lo.w = nibbles_to_s8x4(p[1] >> 16);
      hi.x = nibbles_to_s8x4(p[2] & 0xFFFFu);
      hi.y = nibbles_to_s8x4(p[2] >> 16);
      hi.z = nibbles_to_s8x4(p[3] & 0xFFFFu);
      hi.w = nibbles_to_s8x4(p[3] >> 16);
      int8_t* dst = ws + row * PITCH + c * 32;
      *reinterpret_cast<uint4*>(dst) = lo;
      *reinterpret_cast<uint4*>(dst + 16) = hi;
    }
    ss[tid] = sr;
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;

  load(0);
  for (int g = 0; g < G; ++g) {
    __syncthreads();  // the last group's fragments are read
    store();
    __syncthreads();
    if (g + 1 < G) load(g + 1);  // in flight while this group runs

    int isum[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) isum[mt][nt][r] = 0;
#pragma unroll
    for (int k0 = 0; k0 < GROUP; k0 += 32) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int8_t* base = xs + (wm + mt * 16 + gid) * PITCH + k0 + tig * 4;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(base);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(base + 8 * PITCH);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(base + 8 * PITCH + 16);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int8_t* base = ws + (wn + nt * 8 + gid) * PITCH + k0 + tig * 4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(base);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(base + 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_s8(isum[mt][nt], af[mt], b0, b1);
      }
    }
    // the group's exact sums into the fp32 sums, times their scales
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float s0 = ss[wn + nt * 8 + tig * 2];
      const float s1 = ss[wn + nt * 8 + tig * 2 + 1];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[mt][nt][r] = __fadd_rn(
              acc[mt][nt][r],
              __fmul_rn(__int2float_rn(isum[mt][nt][r]), r & 1 ? s1 : s0));
    }
  }

  // the token's scale; c0/c1 at row gid, c2/c3 at row gid + 8, columns
  // 2 tig and 2 tig + 1
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + mt * 16 + gid + half * 8;
      if (row >= T) continue;
      const float at = a[row];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = n0 + wn + nt * 8 + tig * 2;
        const float v0 = __fmul_rn(acc[mt][nt][half * 2], at);
        const float v1 = __fmul_rn(acc[mt][nt][half * 2 + 1], at);
        const size_t o = (size_t)row * F + col;
        if (out_bf16) {
          __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
          if (col < F) yb[o] = __float2bfloat16_rn(v0);
          if (col + 1 < F) yb[o + 1] = __float2bfloat16_rn(v1);
        } else {
          float* yf = static_cast<float*>(y);
          if (col < F) yf[o] = v0;
          if (col + 1 < F) yf[o + 1] = v1;
        }
      }
    }
}

}  // namespace

extern "C" int w4a8_group_size(void) { return GROUP; }

// Returns a cudaError_t as int: 0 when the launch succeeded.  K must be a
// positive multiple of 128, T and F positive; xq and w 16-byte aligned.
extern "C" int w4a8_group_gemm(const void* xq, const void* a, const void* w,
                               const void* scale, void* y, int T, int K,
                               int F, int out_bf16, void* stream) {
  if (T <= 0 || F <= 0 || K <= 0 || K % GROUP)
    return (int)cudaErrorInvalidValue;
  dim3 grid((F + BN - 1) / BN, (T + BM - 1) / BM);
  w4a8_group_gemm_kernel<<<grid, THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(a),
      static_cast<const uint8_t*>(w),
      static_cast<const __nv_bfloat16*>(scale), y, T, K, F, out_bf16);
  return (int)cudaGetLastError();
}
