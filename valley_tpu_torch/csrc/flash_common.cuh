// Device helpers shared by the flash forward (flash_fwd.cu) and backward
// (flash_bwd.cu) kernels: asynchronous copies into shared memory, ldmatrix,
// the bf16 tensor-core product mma.sync.m16n8k16, fragment packing, and the
// key-mask bit words.  sm_80+ instructions; the kernels build for sm_90a.
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
// So the C fragments of two neighbouring n-blocks of a product, rounded to
// bf16 and packed, are the A fragment of the next product over the same 16
// columns: P and dS never leave the registers.
//
// Tiles live in shared memory as rows of D bf16 padded by 8 (16 bytes):
// the 8 rows one ldmatrix phase reads then start in 8 distinct 16-byte bank
// groups for every D in {16, 32, 64, 128}, so ldmatrix is conflict-free.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace flash {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG = -1e9f;  // running-max floor (flash_attention.py _NEG_INF)

// Row pitch, in bf16 elements, of a tile of head dim D in shared memory.
template <int D>
__host__ __device__ constexpr int pitch() {
  return D + 8;
}

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

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
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

// Rows [r0, r0 + ROWS) of a (S, row_stride) bf16 matrix into a shared tile
// of pitch<D>(), by NT threads; rows at or past S read as zero.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* src, int r0,
                                          int S, long long row_stride,
                                          __nv_bfloat16* dst, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  constexpr int P = pitch<D>();
#pragma unroll
  for (int i = tid; i < ROWS * CH; i += NT) {
    const int r = i / CH;
    const int c = i % CH;
    const bool ok = r0 + r < S;
    const __nv_bfloat16* s =
        src + (long long)(ok ? r0 + r : 0) * row_stride + c * 8;
    cp_async16(dst + r * P + c * 8, s, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
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
// fragments c0 (columns 0-7) and c1 (columns 8-15), rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// As c_to_a, with the values carried as two bf16 terms: hi = bf16(c) and
// lo = bf16(c - hi) (c - hi is exact in fp32), so that products with hi and
// then lo add up 16 bits of each value.
__device__ __forceinline__ void c_to_a2(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                        const float (&c0)[4],
                                        const float (&c1)[4]) {
  const float c[8] = {c0[0], c0[1], c0[2], c0[3], c1[0], c1[1], c1[2], c1[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(c[2 * i], c[2 * i + 1]);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    const float2 f = __bfloat1622float2(h);
    lo[i] = pack_bf16(c[2 * i] - f.x, c[2 * i + 1] - f.y);
  }
}

// The A fragment of 16 rows x 16 columns of a shared tile of pitch P,
// starting at `tile` (row 0, column 0 of the fragment).
template <int P>
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int lane) {
  ldsm_x4(a, tile + (lane & 15) * P + (lane >> 4) * 8);
}

// B fragments of two n-blocks of 8 from a tile stored n-major ([n][k],
// e.g. K rows for Q K^T): b[0], b[1] of n-block 0 and b[2], b[3] of
// n-block 1, over k 0-15 from `tile`.
template <int P>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4],
                                          const __nv_bfloat16* tile,
                                          int lane) {
  ldsm_x4(b, tile + ((lane & 7) + ((lane >> 4) << 3)) * P +
                 ((lane >> 3) & 1) * 8);
}

// B fragments of two n-blocks of 8 from a tile stored k-major ([k][n],
// e.g. V rows for P V): b[0], b[1] of n-block 0 and b[2], b[3] of n-block 1,
// over k 0-15 from `tile`.
template <int P>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4],
                                          const __nv_bfloat16* tile,
                                          int lane) {
  ldsm_x4_trans(b, tile + ((lane & 7) + ((lane >> 3) & 1) * 8) * P +
                       (lane >> 4) * 8);
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
