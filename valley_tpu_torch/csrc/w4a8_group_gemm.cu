// Grouped W4A8 matrix product for prefill chunks (K8), and the per-token
// int8 quantization of its activations (K8q), for Hopper, sm_90a, plain C
// interface.
//
// Replaces no Pallas kernel: K8 is the product of
// valley_tpu/models/llama.py:210 `_w4a8_group_dot`, which the JAX package
// leaves to XLA (an einsum over (token, group, input) with int32
// accumulation), and K8q its activation quantization (llama.py:232-235).
// No single library call computes K8: an int8 matrix product has no
// per-group rescale, and looping one over the groups costs K / group
// launches a projection.  Same function:
//   y[t, f] = a[t] * sum_g float(sum_{i in g} xq[t, i] * w[f, i]) * s[f, g]
// with per-token int8 activations xq (T, K) and their fp32 scales a (T,)
// (K8q), int4 weights in [-8, 7] nibble-packed along K (w is (F, K/2)
// uint8, the low nibble first, each output's inputs contiguous: the layout
// of quant.pack_int4, which K5 and the checkpoints share), bf16 group
// scales s (F, K/gs) for any group size gs that is a multiple of 32 and
// divides K, the sum of a group exact in int32, fp32 arithmetic after it
// (each product and sum rounded on its own, the groups in order), and y
// (T, F) in fp32 or bf16.  The result is bit-equal to the plain version,
// ops/w4a8.py `w4a8_group_plain`.
//
// What bounds K8 on the H100: the operations.  At the prefill's shapes
// (T 128-512 rows against Valley-13B's fused projections, 5120-27648 by
// 5120-13824) it does 2 T F K int8 operations for (T K + F K / 2 + 2 F K /
// gs + T F out) bytes: T / 2 operations a weight byte, 64-256, under the
// card's int8 ridge of 1979 / 3.35 ~ 590, so the floor is the larger of
// 2 T F K / 1979 TOPS (41 us for wqkv at T 512) and the bytes at 3.35 TB/s
// (wqkv at T 128: 13 us).  Beyond the tensor cores, each group costs every
// output an int32 -> fp32 conversion, a multiply and an add, and every
// weight a nibble unpack: CUDA-core work of the same order as the products.
//
// Design.  The product runs swapped, y^T = W x^T, on wgmma:
//   - A is the weight, from registers.  A block takes 128 outputs, one
//     consumer warpgroup 64 of them.  Their packed nibbles come in by TMA
//     (64-byte swizzle: the four quads of a warp read a fragment's words
//     from 32 banks) and each thread unpacks its fragment in registers (a
//     byte permute takes its two nibble pairs, masks and two more permutes
//     interleave them, a multiply-or sign-extends), so the weight is
//     unpacked once per tile of BN tokens, never staged as int8.
//   - B is xq, K-major as wgmma wants 8-bit B, brought in by TMA with the
//     128-byte swizzle: a stage's 128 inputs of a token are one swizzle row.
//   - One k32 step is one wgmma.m64nNk32.s32.s8.s8 into int32 sums; the
//     first step of a group zeroes them (scale-d 0).  After the group's
//     last step each sum is converted to fp32 (cvt.rn, exact below 2^24,
//     rounded to nearest even above, as the plain version's conversion),
//     multiplied by its output's group scale and added to the fp32 sum
//     (__fmul_rn, __fadd_rn: no fused multiply-add).  Each output's
//     groups are summed in order by one thread: no split-K.  A thread's
//     group scales are loaded one group ahead from global memory (two rows
//     a thread).
//   - Groups of 128 (one stage; int4gpa8's) run a software pipeline over
//     half tiles (`Consumer::tile128`): the tile's two halves of BN / 2
//     tokens each have their own int32 sums and wgmma group, so one half
//     is rescaled while the other's products run, and group g + 1's
//     weights are unpacked while group g's run.  Other group sizes and a K
//     that is not a multiple of 128 take a plain loop (`tile_any`): a
//     group may end inside a stage or span stages, a stage's missing steps
//     are skipped.
//   - A ring of STAGES stages (a token tile and a weight tile each) in
//     shared memory, filled through TMA and mbarriers by one thread of a
//     producer warpgroup (setmaxnreg 40; the two consumer warpgroups 232);
//     every consumer thread arrives at a stage's empty barrier when its
//     wgmmas on it are done.
//     The pipeline is worth its second loop: a Valley-13B layer at 512
//     tokens takes 0.62 ms with it and 0.84 ms through `tile_any`, at 128
//     tokens 0.20 and 0.28 (w4a8_check --against, PERF.md).
//   - What holds it back (PERF.md): the rescale.  Three CUDA-core
//     instructions for each sum and group, as many as the products' share
//     of the tensor cores, and they overlap little with the wgmmas: a
//     build without the rescale takes about half the time.
//   - Epilogue: the token's scale in fp32, then y in fp32 or bf16.  The
//     sums lie transposed to y, so a warpgroup stages them in shared
//     memory and writes each token's outputs as coalesced rows, with plain
//     guarded stores (F = 130 is a shape the tests hold; a TMA store needs
//     16-byte strides).
//   - Grid: persistent, one block an SM over the (output tile, token tile)
//     pairs, the token tiles of one weight tile next to each other (the
//     weight read once from device memory, again from L2).  BN is 128
//     tokens, or 64 where that fills the card better: at T 128 the
//     5120-wide wo and w_down give 40 tiles of 128 by 128 for 132 SMs, and
//     80 of 128 by 64 (the rule in `choose_bn`).
//
// K8q, the quantization, reads x (bf16 or fp32, T x K) once more than it
// must (a row's absmax, then its values from L1/L2) and writes xq and a:
// a block a token, the absmax exact, a = fmaxf(amax, 1e-6f) * fl(1/127)
// (what XLA compiles JAX's `/ 127.0` into under jit: a constant divisor
// becomes its reciprocal's product) and q = round-half-even(x / a), the
// division correctly rounded (no __fdividef, no fast math), so bit-equal
// to `_quantize_tokens`.  It is bound by its bytes, 3 T K for bf16 (2.3 us
// at T 512, K 5120).
//
// Ragged edges: tokens past T and outputs past F are read as zeros by TMA
// and stored nowhere; a K that is not a multiple of 128 ends in a stage
// whose missing steps are skipped.  TMA wants 16-byte row strides: K a
// multiple of 32, which a group size that is a multiple of 32 gives.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int KC = 128;        // inputs a stage: one 128-byte row of xq
constexpr int KSTEP = 32;      // inputs a wgmma
constexpr int STEPS = KC / KSTEP;
constexpr int BM = 128;        // outputs a tile: two warpgroups of 64
constexpr int CONSUMERS = 2;   // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;  // and a producer
constexpr int STAGES = 4;
constexpr int WBYTES = BM * KC / 2;  // a stage's packed weight tile
constexpr int PITCH = 64 + 4;  // floats a token row of the epilogue tile
constexpr int QUANTUM = 32;    // group sizes are multiples of this
constexpr float RECIP_127 = 1.0f / 127.0f;  // K8q's scale: amax times this

// Shared memory of a block, offsets from a 1024-byte aligned base (the
// swizzle patterns repeat every 1024 bytes).
template <int BN>
struct Layout {
  static constexpr int XBYTES = BN * KC;  // a stage's token tile
  static constexpr int X = 0;
  static constexpr int W = X + STAGES * XBYTES;
  static constexpr int OUT = W + STAGES * WBYTES;
  static constexpr int BARS = OUT + CONSUMERS * BN * PITCH * 4;
  static constexpr int BYTES = BARS + 2 * STAGES * 8;
  static constexpr int ALLOC = BYTES + 1024;  // room to align the base
};

// The shared-memory descriptor of a K-major 8-bit B tile in the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return sw128_desc(addr, 16, 1024);  // leading offset unused
}

__device__ __forceinline__ void wgmma_n32(int (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n64(int (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

// wgmma.m64nNk32 for N = 32, 64 or 128 tokens
template <int N>
__device__ __forceinline__ void wgmma_n(int (&d)[N / 2],
                                        const uint32_t (&a)[4],
                                        uint64_t desc, int scale_d) {
  if constexpr (N == 128)
    wgmma_n128(d, a, desc, scale_d);
  else if constexpr (N == 64)
    wgmma_n64(d, a, desc, scale_d);
  else
    wgmma_n32(d, a, desc, scale_d);
}

// Four nibbles as bytes 0-3 of ``v`` (values 0-15) -> four int8: a set
// bit 3 makes the byte n - 16, n | 0xF0, and (v & 0x08...) * 30 puts 0xF0
// in exactly those bytes.
__device__ __forceinline__ uint32_t sign_extend4(uint32_t v) {
  return v | ((v & 0x08080808u) * 30u);
}

// One thread's A fragment of a k32 step for one row, from the word ``p``
// whose bytes 0-1 hold inputs 4 tig .. 4 tig + 3 and bytes 2-3 inputs
// 16 + 4 tig .. 16 + 4 tig + 3 (low nibble first): the two s8x4 registers
// of wgmma's 8-bit A layout (columns 4 tig.. and 16 + 4 tig..).
__device__ __forceinline__ void unpack_a(uint32_t p, uint32_t& lo,
                                         uint32_t& hi) {
  const uint32_t ev = p & 0x0F0F0F0Fu;          // inputs 0, 2, 16, 18
  const uint32_t od = (p >> 4) & 0x0F0F0F0Fu;   // inputs 1, 3, 17, 19
  lo = sign_extend4(__byte_perm(ev, od, 0x5140));
  hi = sign_extend4(__byte_perm(ev, od, 0x7362));
}

__device__ __forceinline__ float load_scale(const __nv_bfloat16* scale,
                                            int row, int g, int G, int F) {
  return row < F ? __bfloat162float(scale[static_cast<size_t>(row) * G + g])
                 : 0.f;
}

// A consumer warpgroup's view of the ring and of its 64 outputs.
template <int BN>
struct Consumer {
  static constexpr int NACC = BN / 2;  // int32 and fp32 sums a thread
  uint8_t* smem;
  uint32_t base, full0, empty0;
  const __nv_bfloat16* scale;
  int G, F;
  int tr, wsw;     // the thread's first tile row, its weight swizzle
  int word;        // where its words sit in a 16-byte chunk
  uint32_t pick;   // which halves of them it takes
  int stage = 0;
  uint32_t phase = 0;
  int r0 = 0, r1 = 0;
  float s0 = 0.f, s1 = 0.f, n0 = 0.f, n1 = 0.f;  // this and the next group's
  int isum[NACC];
  float acc[NACC];

  __device__ void start_tile(int f0) {
    r0 = f0 + tr;
    r1 = r0 + 8;
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NACC; ++i) isum[i] = 0;
    n0 = load_scale(scale, r0, 0, G, F);
    n1 = load_scale(scale, r1, 0, G, F);
  }

  // group g's scales; group g + 1's start loading
  __device__ void next_scales(int g) {
    s0 = n0;
    s1 = n1;
    if (g + 1 < G) {
      n0 = load_scale(scale, r0, g + 1, G, F);
      n1 = load_scale(scale, r1, g + 1, G, F);
    }
  }

  __device__ uint32_t full() const { return full0 + 8 * stage; }
  __device__ uint32_t empty() const { return empty0 + 8 * stage; }
  __device__ uint32_t x_tile() const {
    return base + Layout<BN>::X + stage * Layout<BN>::XBYTES;
  }
  __device__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  // the A fragments of k32 step s of the current stage's weight tile
  __device__ void unpack(uint32_t (&af)[4], int s) const {
    const uint8_t* wt = smem + Layout<BN>::W + stage * WBYTES;
    const uint8_t* p0 = wt + tr * 64 + ((s ^ wsw) << 4) + word;
    const uint8_t* p1 = p0 + 8 * 64;
    const uint32_t w0 =
        __byte_perm(*reinterpret_cast<const uint32_t*>(p0),
                    *reinterpret_cast<const uint32_t*>(p0 + 8), pick);
    const uint32_t w1 =
        __byte_perm(*reinterpret_cast<const uint32_t*>(p1),
                    *reinterpret_cast<const uint32_t*>(p1 + 8), pick);
    unpack_a(w0, af[0], af[2]);
    unpack_a(w1, af[1], af[3]);
  }

  // the group's exact sums into the fp32 sums, times their scales; c[i]
  // sits at output row gid (+ 8 for i % 4 >= 2).  The conversion rounds
  // to nearest even as the plain version's does (exact below 2^24: any
  // group under 16513 inputs).
  __device__ void rescale() {
#pragma unroll
    for (int i = 0; i < NACC; ++i)
      acc[i] = __fadd_rn(acc[i], __fmul_rn(__int2float_rn(isum[i]),
                                           (i & 2) ? s1 : s0));
  }

  // The main loop of a tile whose groups are 128 inputs (one stage) and
  // whose K is a multiple of 128: a software pipeline over half tiles.
  // Each group's products go to two sets of int32 sums, the tile's first
  // BN / 2 tokens (lo) and its last (hi), each its own wgmma group; while
  // the tensor cores run one half, the warpgroup rescales the other:
  //   lo(g+1) issued -> wait for hi(g) -> rescale hi(g) -> hi(g+1) issued
  //   -> wait for lo(g+1) -> rescale lo(g+1) -> lo(g+2) issued ...
  // and unpacks group g+1's weights while group g's products run.
  static constexpr int HALF = BN / 2;      // tokens a half tile
  static constexpr int HACC = HALF / 2;    // sums a thread a half

  // The k32 steps of the current stage's group into half ``h``'s sums.
  template <int H>
  __device__ void issue_half(int (&sums)[HACC],
                             const uint32_t (&af)[STEPS][4]) {
    const uint32_t xt = x_tile() + H * HALF * KC;
    fence_regs(sums);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < STEPS; ++s)
      wgmma_n<HALF>(sums, af[s], b_desc(xt + s * KSTEP), s != 0);
    wgmma_commit();
  }

  template <int H>
  __device__ void rescale_half(const int (&sums)[HACC]) {
#pragma unroll
    for (int i = 0; i < HACC; ++i)
      acc[H * HACC + i] = __fadd_rn(
          acc[H * HACC + i],
          __fmul_rn(__int2float_rn(sums[i]), (i & 2) ? s1 : s0));
  }

  // Group g, whose fragments ``cur`` holds and whose lo half was issued;
  // with NEXT, group g + 1's fragments are unpacked into ``nxt`` and its
  // lo half issued.
  template <bool NEXT>
  __device__ void group128(uint32_t (&cur)[STEPS][4],
                           uint32_t (&nxt)[STEPS][4], int (&lo)[HACC],
                           int (&hi)[HACC], int g) {
    const uint32_t done = empty();
    issue_half<1>(hi, cur);
    next_scales(g);
    if (NEXT) {
      advance();
      mbar_wait(full(), phase);
#pragma unroll
      for (int s = 0; s < STEPS; ++s) unpack(nxt[s], s);
    }
    wgmma_wait_n<1>();        // lo(g) done, hi(g) running
    fence_regs(lo);
    rescale_half<0>(lo);
    if (NEXT) {
      issue_half<0>(lo, nxt);
      wgmma_wait_n<1>();      // hi(g) done, lo(g + 1) running
    } else {
      wgmma_wait_n<0>();
    }
    fence_regs(hi);
    mbar_arrive(done);
    rescale_half<1>(hi);
  }

  __device__ void tile128(int n_kc) {
    uint32_t af0[STEPS][4], af1[STEPS][4];
    int lo[HACC], hi[HACC];
    mbar_wait(full(), phase);
#pragma unroll
    for (int s = 0; s < STEPS; ++s) unpack(af0[s], s);
    issue_half<0>(lo, af0);
    int g = 0;
    for (; g + 2 < n_kc; g += 2) {
      group128<true>(af0, af1, lo, hi, g);
      group128<true>(af1, af0, lo, hi, g + 1);
    }
    if (g + 1 < n_kc) {
      group128<true>(af0, af1, lo, hi, g);
      group128<false>(af1, af0, lo, hi, g + 1);
    } else {
      group128<false>(af0, af1, lo, hi, g);
    }
    advance();
  }

  // Any group size that is a multiple of 32 (spg k32 steps) and any K
  // that is a multiple of 32: a stage's missing steps are skipped, a group
  // may end inside a stage or span stages.
  __device__ void tile_any(int K, int spg) {
    const int ksteps = K / KSTEP, n_kc = (K + KC - 1) / KC;
    int g = 0, in_group = 0;
    for (int kc = 0; kc < n_kc; ++kc) {
      const int nst = min(STEPS, ksteps - kc * STEPS);
      mbar_wait(full(), phase);
      uint32_t af[STEPS][4];
#pragma unroll
      for (int s = 0; s < STEPS; ++s)
        if (s < nst) unpack(af[s], s);
      const uint32_t xt = x_tile();
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        if (s < nst) {
          if (in_group == 0) next_scales(g);
          // a fence after the registers' last writes: the unpack (a
          // stage's first step) and the rescale (a group's first)
          if (s == 0 || in_group == 0) {
            fence_regs(isum);
            wgmma_fence();
          }
          wgmma_n<BN>(isum, af[s], b_desc(xt + s * KSTEP), in_group != 0);
          wgmma_commit();
          if (++in_group == spg) {
            wgmma_wait_n<0>();
            fence_regs(isum);
            rescale();
            in_group = 0;
            ++g;
          }
        }
      }
      wgmma_wait_n<0>();
      fence_regs(isum);
      mbar_arrive(empty());
      advance();
    }
  }
};

// ANY: the general main loop (`Consumer::tile_any`), else the one for
// groups of 128 and K a multiple of 128 (`tile128`).
template <int BN, bool ANY>
__global__ void __launch_bounds__(THREADS, 1)
w4a8_group_gemm_kernel(const __grid_constant__ CUtensorMap x_map,
                       const __grid_constant__ CUtensorMap w_map,
                       const float* __restrict__ a,
                       const __nv_bfloat16* __restrict__ scale,
                       void* __restrict__ y, int T, int K, int F, int gs,
                       int out_bf16) {
  using L = Layout<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t full0 = base + L::BARS, empty0 = full0 + STAGES * 8;

  const int n_t = (T + BN - 1) / BN;
  const int n_tiles = ((F + BM - 1) / BM) * n_t;
  const int n_kc = (K + KC - 1) / KC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS * 128);  // every consumer thread
    }
    mbar_init_fence();
  }
  __syncthreads();

  // the warpgroup, uniform across the warp as the compiler sees it
  const int wg = __shfl_sync(0xFFFFFFFFu, threadIdx.x / 128, 0);
  if (wg == CONSUMERS) {
    // the producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == CONSUMERS * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int f0 = (tile / n_t) * BM, t0 = (tile % n_t) * BN;
        for (int kc = 0; kc < n_kc; ++kc) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage;
          mbar_expect_tx(full, L::XBYTES + WBYTES);
          tma_load(base + L::X + stage * L::XBYTES, &x_map, full, kc * KC,
                   t0);
          tma_load(base + L::W + stage * WBYTES, &w_map, full,
                   kc * (KC / 2), f0);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    // the consumers: warpgroup wg takes outputs wg * 64 .. + 63 of a tile
    const int tw = threadIdx.x % 128;
    const int warp = tw / 32, lane = tw % 32;
    const int gid = lane / 4, tig = lane % 4;
    Consumer<BN> c;
    c.smem = smem;
    c.base = base;
    c.full0 = full0;
    c.empty0 = empty0;
    c.scale = scale;
    c.G = K / gs;
    c.F = F;
    c.tr = wg * 64 + warp * 16 + gid;
    // the swizzled chunk of step s in a weight row is s ^ ((row / 2) % 4)
    // (rows tr and tr + 8 share it); the thread's words sit 4 (tig / 2)
    // bytes into it, and it takes their halves tig % 2
    c.wsw = (c.tr >> 1) & 3;
    c.word = 4 * (tig >> 1);
    c.pick = tig & 1 ? 0x7632u : 0x5410u;
    float* out_tile =
        reinterpret_cast<float*>(smem + L::OUT) + wg * BN * PITCH;

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int f0 = (tile / n_t) * BM, t0 = (tile % n_t) * BN;
      c.start_tile(f0);
      if constexpr (ANY)
        c.tile_any(K, gs / KSTEP);
      else
        c.tile128(n_kc);

      // epilogue: the sums to the warpgroup's tile [token][output] ...
      asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
#pragma unroll
      for (int i = 0; i < Consumer<BN>::NACC; ++i) {
        const int t = 8 * (i >> 2) + 2 * tig + (i & 1);
        const int f = warp * 16 + gid + 8 * ((i >> 1) & 1);
        out_tile[t * PITCH + f] = c.acc[i];
      }
      asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
      // ... and each token's 64 outputs as one row, times its scale
      const int fw = f0 + wg * 64;
      for (int t = warp; t < BN; t += 4) {
        const int tg = t0 + t;
        if (tg >= T) break;
        const float at = a[tg];
        const float* row = out_tile + t * PITCH;
        if (out_bf16) {
          __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y) +
                              static_cast<size_t>(tg) * F;
          const int f = fw + 2 * lane;
          const float v0 = __fmul_rn(row[2 * lane], at);
          const float v1 = __fmul_rn(row[2 * lane + 1], at);
          if (!(F & 1) && f < F) {
            *reinterpret_cast<__nv_bfloat162*>(yb + f) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            if (f < F) yb[f] = __float2bfloat16_rn(v0);
            if (f + 1 < F) yb[f + 1] = __float2bfloat16_rn(v1);
          }
        } else {
          float* yf = static_cast<float*>(y) + static_cast<size_t>(tg) * F;
          if (fw + lane < F) yf[fw + lane] = __fmul_rn(row[lane], at);
          if (fw + lane + 32 < F)
            yf[fw + lane + 32] = __fmul_rn(row[lane + 32], at);
        }
      }
    }
  }
}

// K8q: a block a token.  Vectors of 8 values (16 bytes of bf16, two of
// fp32); K a multiple of 8.
constexpr int QTHREADS = 256;

template <typename X>
__device__ __forceinline__ void load8(const X* p, float (&v)[8]);

template <>
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
  }
}

template <>
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 u0 = *reinterpret_cast<const float4*>(p);
  const float4 u1 = *reinterpret_cast<const float4*>(p + 4);
  v[0] = u0.x; v[1] = u0.y; v[2] = u0.z; v[3] = u0.w;
  v[4] = u1.x; v[5] = u1.y; v[6] = u1.z; v[7] = u1.w;
}

template <typename X>
__global__ void __launch_bounds__(QTHREADS)
quantize_tokens_kernel(const X* __restrict__ x,
                       const float* __restrict__ amax_in,
                       int8_t* __restrict__ xq, float* __restrict__ a,
                       int K) {
  __shared__ float part[QTHREADS / 32];
  const X* row = x + static_cast<size_t>(blockIdx.x) * K;
  int8_t* qrow = xq + static_cast<size_t>(blockIdx.x) * K;
  const int nv = K / 8;
  float m = 0.f;
  if (amax_in != nullptr) {
    // the token's absmax over a wider row (a tensor-parallel rank's share)
    m = amax_in[blockIdx.x];
  } else {
    for (int i = threadIdx.x; i < nv; i += QTHREADS) {
      float v[8];
      load8(row + 8 * i, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(v[j]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, o));
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = m;
    __syncthreads();
    m = part[0];
#pragma unroll
    for (int w = 1; w < QTHREADS / 32; ++w) m = fmaxf(m, part[w]);
  }
  const float as = __fmul_rn(fmaxf(m, 1e-6f), RECIP_127);
  for (int i = threadIdx.x; i < nv; i += QTHREADS) {
    float v[8];
    load8(row + 8 * i, v);
    uint32_t q[2] = {0, 0};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // round half to even, as torch.round and jnp.round
      const int r = __float2int_rn(__fdiv_rn(v[j], as));
      q[j / 4] |= (static_cast<uint32_t>(r) & 0xFFu) << (8 * (j % 4));
    }
    *reinterpret_cast<uint2*>(qrow + 8 * i) = make_uint2(q[0], q[1]);
  }
  if (threadIdx.x == 0) a[blockIdx.x] = as;
}

// A 2-D uint8 tensor map over a row-major (rows, cols) array, boxes of
// (box_rows, box_cols), zeros outside the array.
bool encode_2d(CUtensorMap* map, const void* ptr, uint64_t rows,
               uint64_t cols, uint32_t box_rows, uint32_t box_cols,
               CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

// BN: 128 tokens a tile, or 64 where the 128-token tiles leave the card's
// SMs idle.  A 64-token tile costs about 0.66 of a 128-token one (its
// weight unpack does not shrink; measured at Valley-13B's wqkv, T 512),
// so take 64 when its rounds of tiles over the SMs cost clearly less.
int choose_bn(int T, int F) {
  const long n_f = (F + BM - 1) / BM, sms = sm_count();
  const long r128 = (n_f * ((T + 127) / 128) + sms - 1) / sms;
  const long r64 = (n_f * ((T + 63) / 64) + sms - 1) / sms;
  return 70 * r64 < 100 * r128 ? 64 : 128;
}

template <int BN, bool ANY>
int launch_gemm(const CUtensorMap& x_map, const CUtensorMap& w_map,
                const void* a, const void* scale, void* y, int T, int K,
                int F, int gs, int out_bf16, cudaStream_t stream) {
  using L = Layout<BN>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        w4a8_group_gemm_kernel<BN, ANY>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::ALLOC);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const int tiles = ((F + BM - 1) / BM) * ((T + BN - 1) / BN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  w4a8_group_gemm_kernel<BN, ANY><<<grid, THREADS, L::ALLOC, stream>>>(
      x_map, w_map, static_cast<const float*>(a),
      static_cast<const __nv_bfloat16*>(scale), y, T, K, F, gs, out_bf16);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_bn(const void* xq, const void* a, const void* w,
              const void* scale, void* y, int T, int K, int F, int gs,
              int out_bf16, cudaStream_t stream) {
  CUtensorMap x_map, w_map;
  if (!encode_2d(&x_map, xq, T, K, BN, KC, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(&w_map, w, F, K / 2, BM, KC / 2, CU_TENSOR_MAP_SWIZZLE_64B))
    return static_cast<int>(cudaErrorInvalidValue);
  if (gs == KC && K % KC == 0)
    return launch_gemm<BN, false>(x_map, w_map, a, scale, y, T, K, F, gs,
                                  out_bf16, stream);
  return launch_gemm<BN, true>(x_map, w_map, a, scale, y, T, K, F, gs,
                               out_bf16, stream);
}

}  // namespace

extern "C" int w4a8_group_quantum(void) { return QUANTUM; }

// Returns a cudaError_t as int: 0 when the launch succeeded.  gs a
// positive multiple of 32 dividing K, T and F positive; xq and w 16-byte
// aligned.
extern "C" int w4a8_group_gemm(const void* xq, const void* a, const void* w,
                               const void* scale, void* y, int T, int K,
                               int F, int gs, int out_bf16, void* stream) {
  if (T <= 0 || F <= 0 || K <= 0 || gs <= 0 || gs % QUANTUM || K % gs)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bn = choose_bn(T, F);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bn == 64 ? launch_bn<64>(xq, a, w, scale, y, T, K, F, gs,
                                  out_bf16, s)
                  : launch_bn<128>(xq, a, w, scale, y, T, K, F, gs,
                                   out_bf16, s);
}

// K8q: x (T, K) bf16 (x_bf16) or fp32 -> xq (T, K) int8 and a (T,) fp32.
// K a multiple of 8; x 16-byte and xq 8-byte aligned.  amax: each token's
// absmax (T,) fp32 to quantize by, or null to take it from x.
extern "C" int w4a8_quantize_tokens(const void* x, const void* amax,
                                    void* xq, void* a, int T, int K,
                                    int x_bf16, void* stream) {
  if (T <= 0 || K <= 0 || K % 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    quantize_tokens_kernel<__nv_bfloat16><<<T, QTHREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const float*>(amax), static_cast<int8_t*>(xq),
        static_cast<float*>(a), K);
  else
    quantize_tokens_kernel<float><<<T, QTHREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(amax),
        static_cast<int8_t*>(xq), static_cast<float*>(a), K);
  return static_cast<int>(cudaGetLastError());
}
