// Device helpers shared by the port's CUDA kernels.
//
// For K3-K6 (decode_attn.cu, int8_matvec.cu, int4_matvec.cu,
// bf16_matvec.cu): asynchronous 16-byte copies into shared memory and the
// bf16 tensor-core product mma.sync.m16n8k16 (sm_80+ instructions; the
// kernels build for sm_90a).  For K1 and K2 (flash_fwd.cu, flash_bwd.cu,
// whose products are wgmma: hopper.cuh): the softmax's constants, the
// packing of fp32 sums into bf16 A fragments, the key-mask bit words, quad
// reductions and the planted faults of their card tests.
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32,
// for lane = 4 * g + t (g = lane / 4 in 0..7, t = lane % 4):
//   A (16 x 16, row-major), four 32-bit registers of two bf16 each:
//     a0 = (row g, cols 2t, 2t+1), a1 = (row g+8, cols 2t, 2t+1),
//     a2 = (row g, cols 2t+8, 2t+9), a3 = (row g+8, cols 2t+8, 2t+9);
//   B (16 x 8, k x n), two registers: b0 = (k 2t, 2t+1; n g),
//     b1 = (k 2t+8, 2t+9; n g);
//   C (16 x 8, fp32): c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = (row g+8,
//     cols 2t, 2t+1).
// A wgmma m64nN accumulator holds, for each warp of the warpgroup, the C
// fragments of its 16 rows over N / 8 n-blocks, and a wgmma's register A
// operand is the A fragment above for the warp's 16 rows.  So the sums of
// two neighbouring n-blocks, rounded to bf16 and packed, are the A operand
// of the next product over those 16 columns: P and dS never leave the
// registers.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace flash {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG = -1e9f;  // running-max floor (flash_attention.py _NEG_INF)

// Planted faults of K1 and K2, for the card tests that must catch them
// (the C entry points' ``fault``; 0 in every real call): FAULT_BOX loads
// every K tile one 64-column box over (a swizzled row read from the wrong
// box); FAULT_SKIP reads a key tile the mask says to skip and attends all
// its keys.
constexpr int FAULT_NONE = 0;
constexpr int FAULT_BOX = 1;
constexpr int FAULT_SKIP = 2;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without the registers; 0 source bytes when
// !valid, so the destination is filled with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c += a b on the tensor cores (bf16 operands, fp32 sums).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to bf16, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of a product over 16 columns whose values are the C
// fragments of two neighbouring n-blocks, c[0..3] (columns 0-7) and
// c[4..7] (columns 8-15), rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float* c) {
  a[0] = pack_bf16(c[0], c[1]);
  a[1] = pack_bf16(c[2], c[3]);
  a[2] = pack_bf16(c[4], c[5]);
  a[3] = pack_bf16(c[6], c[7]);
}

// As c_to_a, with the values carried as two bf16 terms: hi = bf16(c) and
// lo = bf16(c - hi) (c - hi is exact in fp32), so that products with hi and
// then lo add up 16 bits of each value.
__device__ __forceinline__ void c_to_a2(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                        const float* c) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(c[2 * i], c[2 * i + 1]);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    const float2 f = __bfloat1622float2(h);
    lo[i] = pack_bf16(c[2 * i] - f.x, c[2 * i + 1] - f.y);
  }
}

// words[w], bit j: key 32 w + j is attended (mask byte nonzero and key < n),
// for w < n_words, written by the NT threads of a block.
template <int NT>
__device__ __forceinline__ void mask_words(const uint8_t* mask, int n,
                                           uint32_t* words, int n_words,
                                           int tid) {
  const int lane = tid & 31;
  for (int w = tid >> 5; w < n_words; w += NT / 32) {
    const int col = 32 * w + lane;
    const uint32_t bits = __ballot_sync(0xffffffffu, col < n && mask[col]);
    if (lane == 0) words[w] = bits;
  }
}

__device__ __forceinline__ bool key_bit(const uint32_t* words, int col) {
  return (words[col >> 5] >> (col & 31)) & 1u;
}

// Whether a tile's W mask words hold any attended key, and all attended.
template <int W>
__device__ __forceinline__ bool any_key(const uint32_t* words) {
  uint32_t x = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) x |= words[i];
  return x != 0u;
}

template <int W>
__device__ __forceinline__ bool all_keys(const uint32_t* words) {
  uint32_t x = 0xffffffffu;
#pragma unroll
  for (int i = 0; i < W; ++i) x &= words[i];
  return x == 0xffffffffu;
}

// FAULT_SKIP: every tile of W words among the first n_tiles with no
// attended key is marked fully attended; by threads tid < n_tiles.
template <int W>
__device__ __forceinline__ void plant_skip_fault(uint32_t* words,
                                                 int n_tiles, int tid) {
  if (tid < n_tiles && !any_key<W>(words + W * tid)) {
#pragma unroll
    for (int i = 0; i < W; ++i) words[W * tid + i] = 0xffffffffu;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The most dynamic shared memory a block may take on the H100
// (cudaDevAttrMaxSharedMemoryPerBlockOptin).
constexpr int MAX_SMEM = 232448;

}  // namespace flash
