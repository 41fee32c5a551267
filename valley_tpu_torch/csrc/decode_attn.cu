// Single-token decode attention over the stacked KV cache, for Hopper,
// sm_90a, plain C interface.
//
// Replaces: valley_tpu/ops/decode_pallas.py `_kernel` (the Pallas TPU kernel
// launched by `decode_attention_stacked`), both its bf16-cache branch and its
// int8-cache branch (`quant=True`).  Same semantics as its oracle
// ops/attention.py `decode_attention` over layer `li` of the cache: fp32
// logits scaled by d^-1/2 (an int8 cache: times the slot's bf16 K scale),
// slots where the boolean (B, Smax) validity mask is false set to -1e9, fp32
// softmax, probabilities (an int8 cache: times the slot's bf16 V scale)
// rounded to bf16 before the PV product (decode_pallas.py:107-111), fp32
// accumulation, the normalising sum unscaled.  The mask is read slot by
// slot, never reduced to a length: a prompt padded to its bucket leaves
// invalid slots between the prompt and the decoded tokens.
//
// What bounds it on the H100: device-memory bytes and latency.  The work
// the data needs is the valid slots' K and V rows (Valley-7B, 513 valid of
// 639 slots: 2 x 513 x 32 x 128 x 2 B = 8.4 MB in bf16, half that plus the
// scales in int8) at ~1 FLOP per byte, far under the card's ~295 FLOP/byte
// ridge: a few microseconds at 3.35 TB/s.  At one query head per kv head
// (Valley's LLaMA-7B and -13B) QK^T and PV are matrix-vector products, so
// the tensor cores would buy nothing: everything runs on the CUDA cores.
//
// What the design does about it.  Two launches: one block of 128 threads
// per (row, kv head, chunk of 64 slots; 128 measured slower at four of the
// five path shapes), reading each K and V row once for all the n_rep query heads of
// its kv head (GQA without repeating K/V), then a merge block per (row, kv
// head):
// - The block reads its chunk's mask bytes first and lists the valid
//   slots.  A chunk with none writes an empty marker (m = -inf, l = 0) and
//   reads no K, V or scale; a partly valid chunk loads only its valid rows.
//   That is exact: whenever a row holds a valid slot, the softmax gives a
//   masked slot exp(-1e9 - m) = 0 in fp32, a zero term.
// - The valid K rows, then the V rows, go to shared memory by 16-byte
//   cp.async copies, all issued before any arithmetic, so V's bytes arrive
//   while QK runs (D = 128, REP = 1: 37 KB of dynamic shared memory a
//   block in bf16, 25 KB in int8); an int8 chunk's K and V scales are read once per
//   slot.
// - QK: a row is LPR lanes x 16 bytes (bf16 D = 128: 16 lanes, 2 rows a
//   warp step; int8: 8 lanes, 4 rows), reduced by a shuffle over its lanes.
//   PV: each thread owns 16 bytes of columns (8 bf16 or 16 int8) and a
//   group of slots; the groups' partial sums are added in shared memory in
//   group order.
// - The kernel is templated on REP, the query heads a kv head serves (1, 2,
//   4, 8; n_rep 3, 5-7 take the next one with the extra heads masked), so
//   REP = 1 holds one head's q slice and accumulators in registers.
// - Each block writes its chunk's max, sum and unnormalised PV in fp32 to
//   the caller's scratch; the second kernel merges each (row, kv head)'s
//   chunks in chunk order, so two calls give the same bits.  A row with no
//   valid slot at all is uniform in the plain version (every logit -1e9):
//   the merge then computes that result, V's mean, from V itself.
// - The merge can instead run in the last of a pair's blocks to count
//   itself in an arrival counter (ONE_LAUNCH): one launch, but more
//   registers at REP = 1 (bf16 56-64 against 32) and a fence and an atomic
//   in every block.  On an H100 it was a few percent faster at two of the
//   five path shapes and 7 % slower on the pool's mostly empty chunks.
// An int8 cache is read as int8 (16 bytes a lane) with its (L, B, Smax,
// Hkv) scales in their storage layout; the V scale multiplies the chunk's
// unnormalised probabilities, as the Pallas kernel does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int NT = 128;       // threads per block (4 warps)
constexpr int NW = NT / 32;
constexpr int CHUNK = 64;     // cache slots per block
constexpr int MAX_REP = 8;    // query heads per kv head
// true: the last block of each (row, kv head) merges its chunks, found by
// a counter in `arrivals`, instead of a second kernel (a variant that
// tools/decode_variants.py times against the two launches)
constexpr bool ONE_LAUNCH = false;
constexpr int MAX_PAIRS = ONE_LAUNCH ? 1 << 16 : 1;  // (row, kv head) pairs
__device__ int arrivals[MAX_PAIRS];   // zero at load, left at zero
static_assert(CHUNK <= NT && CHUNK % 32 == 0, "a thread per mask byte");

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Two bf16 in a 32-bit word (element 0 in the low half) -> two floats.
__device__ __forceinline__ void bf16x2_to_f32(uint32_t h, float* f) {
  f[0] = __uint_as_float(h << 16);
  f[1] = __uint_as_float(h & 0xFFFF0000u);
}

// Four int8 in a 32-bit word -> four exact floats: each byte, biased to
// unsigned (xor 0x80), becomes the low mantissa byte of 2^23; subtracting
// 2^23 + 128 leaves the int8.
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
}

// 16 bytes of cache values -> 8 (bf16) or 16 (int8) floats.
__device__ __forceinline__ void vec_to_f32(const uint4& v, float* f,
                                           const __nv_bfloat16*) {
  bf16x2_to_f32(v.x, f);
  bf16x2_to_f32(v.y, f + 2);
  bf16x2_to_f32(v.z, f + 4);
  bf16x2_to_f32(v.w, f + 6);
}

__device__ __forceinline__ void vec_to_f32(const uint4& v, float* f,
                                           const int8_t*) {
  i8x4_to_f32(v.x, f);
  i8x4_to_f32(v.y, f + 4);
  i8x4_to_f32(v.z, f + 8);
  i8x4_to_f32(v.w, f + 12);
}

__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The geometry of a K or V row of D values of type T in 16-byte pieces.
template <typename T, int D>
struct Row {
  static constexpr int BYTES = D * (int)sizeof(T);
  static constexpr int LPR = BYTES / 16;         // lanes (pieces) a row
  static constexpr int EPL = 16 / (int)sizeof(T);  // values a piece
  static constexpr int RW = 32 / LPR;            // rows a warp step (QK)
  static constexpr int G = NT / LPR;             // slot groups (PV)
  static constexpr int CPL = D >= 32 ? D / 32 : 1;  // merge: columns a lane
  static_assert(BYTES % 16 == 0 && LPR <= 32, "16-byte pieces");
};

// Dynamic shared memory of one block: the chunk's K and V rows, the logits
// (then probabilities) of each query head, the PV group partials (also the
// merge's per-warp sums), the scales and the valid slots' list.
template <typename T, int D, int REP>
constexpr int smem_bytes() {
  return 2 * CHUNK * Row<T, D>::BYTES +
         4 * (REP * CHUNK + Row<T, D>::G * D + 2 * CHUNK + CHUNK);
}

// The merge of (row, kv head) bk's chunks by the whole block, chunk by
// chunk in chunk order: warp w takes chunks w, w + NW, ...; lane l columns
// l CPL .. l CPL + CPL - 1; the warps' sums are then added in warp order.
// out = sum_s w_s acc_s / sum_s w_s l_s, w_s = exp(m_s - max_s m_s), empty
// chunks left out.  sNum: NW * D floats of shared memory, sDen: NW.
template <typename T, bool QUANT, int D>
__device__ __forceinline__ void merge_chunks(
    const T* __restrict__ v_all, const __nv_bfloat16* __restrict__ v_scale,
    const float* __restrict__ part_acc, const float* __restrict__ part_m,
    const float* __restrict__ part_l, __nv_bfloat16* __restrict__ out,
    float* sNum, float* sDen, int bk, int li, int B, int Smax, int Hkv,
    int n_rep, int n_split) {
  using R = Row<T, D>;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b = bk / Hkv, kvh = bk % Hkv;
  const long long ss = (long long)Hkv * D;
  const long long row0 = ((long long)li * B + b) * Smax;
  const long long hb0 = ((long long)b * Hkv + kvh) * n_rep;
  constexpr int CPL = R::CPL;
  const bool col = lane * CPL < D;
  const float* pm0 = part_m + hb0 * n_split;
  float mx0 = -INFINITY;
  for (int s = lane; s < n_split; s += 32) mx0 = fmaxf(mx0, __ldcg(pm0 + s));
  mx0 = warp_max(mx0);
  if (mx0 == -INFINITY) {
    // No valid slot in the row: every logit is -1e9, so the plain softmax
    // is uniform, p = 1 / Smax (times the V scale), rounded to bf16; the
    // same for every query head.
    const float u = 1.f / (float)Smax;
    const T* vrow = v_all + row0 * ss + (long long)kvh * D;
    float num[CPL];
#pragma unroll
    for (int e = 0; e < CPL; ++e) num[e] = 0.f;
    for (int s = warp; s < Smax; s += NW) {
      float p = u;
      if constexpr (QUANT)
        p *= __bfloat162float(v_scale[(row0 + s) * Hkv + kvh]);
      p = round_bf16(p);
      if (col) {
#pragma unroll
        for (int e = 0; e < CPL; ++e)
          num[e] = fmaf(p, to_f32(vrow[s * ss + lane * CPL + e]), num[e]);
      }
    }
    if (col) {
#pragma unroll
      for (int e = 0; e < CPL; ++e) sNum[warp * D + lane * CPL + e] = num[e];
    }
    __syncthreads();
    for (int d = tid; d < D; d += NT) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) t += sNum[w * D + d];
      for (int r = 0; r < n_rep; ++r)
        out[(hb0 + r) * D + d] = __float2bfloat16(t);
    }
    return;
  }
  for (int r = 0; r < n_rep; ++r) {
    const long long hb = hb0 + r;
    const float* pm = part_m + hb * n_split;
    const float* pl = part_l + hb * n_split;
    const float* pa = part_acc + hb * n_split * D;
    float mx = mx0;
    if (r > 0) {
      mx = -INFINITY;
      for (int s = lane; s < n_split; s += 32) mx = fmaxf(mx, __ldcg(pm + s));
      mx = warp_max(mx);
    }
    float num[CPL], den = 0.f;
#pragma unroll
    for (int e = 0; e < CPL; ++e) num[e] = 0.f;
#pragma unroll 4
    for (int s = warp; s < n_split; s += NW) {
      const float ms = __ldcg(pm + s);
      const bool live = ms != -INFINITY;   // an empty chunk adds nothing
      const float wgt = live ? expf(ms - mx) : 0.f;
      const float ls = live ? __ldcg(pl + s) : 0.f;
      den = fmaf(wgt, ls, den);
      if (live && col) {
#pragma unroll
        for (int e = 0; e < CPL; ++e)
          num[e] = fmaf(wgt, __ldcg(pa + (long long)s * D + lane * CPL + e),
                        num[e]);
      }
    }
    if (col) {
#pragma unroll
      for (int e = 0; e < CPL; ++e) sNum[warp * D + lane * CPL + e] = num[e];
    }
    if (lane == 0) sDen[warp] = den;
    __syncthreads();
    for (int d = tid; d < D; d += NT) {
      float tn = 0.f, td = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        tn += sNum[w * D + d];
        td += sDen[w];
      }
      out[hb * D + d] = __float2bfloat16(tn / td);
    }
    __syncthreads();
  }
}

// q: (B, H, D) bf16; k_all/v_all: (L, B, Smax, Hkv, D) contiguous, bf16 or
// int8 (T); with QUANT, k_scale/v_scale: (L, B, Smax, Hkv) contiguous bf16.
// mask: (B, Smax) bytes, row b at mask + b * mask_stride.
// part_acc: (B, H, n_split, D); part_m/part_l: (B, H, n_split), fp32.
// out: (B, H, D), written by the merge.  Grid (B * Hkv, n_split), n_split =
// ceil(Smax / CHUNK).
template <typename T, bool QUANT, int D, int REP>
__global__ void __launch_bounds__(NT) decode_attn_kernel(
    const __nv_bfloat16* __restrict__ q, const T* __restrict__ k_all,
    const T* __restrict__ v_all, const __nv_bfloat16* __restrict__ k_scale,
    const __nv_bfloat16* __restrict__ v_scale, const uint8_t* __restrict__ mask,
    long long mask_stride, float* __restrict__ part_acc,
    float* __restrict__ part_m, float* __restrict__ part_l,
    __nv_bfloat16* __restrict__ out, int li, int B, int Smax, int Hkv,
    int n_rep, float scale) {
  using R = Row<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + CHUNK * D;
  float* sS = reinterpret_cast<float*>(sV + CHUNK * D);  // [REP][CHUNK]
  float* sAcc = sS + REP * CHUNK;                        // [G][D]
  float* sKs = sAcc + R::G * D;                          // [CHUNK]
  float* sVs = sKs + CHUNK;                              // [CHUNK]
  int* sIdx = reinterpret_cast<int*>(sVs + CHUNK);       // [CHUNK]
  __shared__ int sCnt[NW];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bk = blockIdx.x;
  const int b = bk / Hkv, kvh = bk % Hkv;
  const int split = blockIdx.y, n_split = gridDim.y;
  const int s0 = split * CHUNK;
  const int n = min(Smax - s0, CHUNK);
  const int H = Hkv * n_rep;
  const long long ss = (long long)Hkv * D;   // elements between slots
  const long long row0 = ((long long)li * B + b) * Smax;  // slot 0 of row b
  const T* kb = k_all + (row0 + s0) * ss + (long long)kvh * D;
  const T* vb = v_all + (row0 + s0) * ss + (long long)kvh * D;
  const long long sc = (row0 + s0) * Hkv + kvh;  // slot j's scale at sc + j Hkv
  const long long hb0 = (long long)b * H + kvh * n_rep;  // first query head

  // 1. the chunk's mask, and the list of its valid slots in slot order
  const bool ok = tid < n && mask[(long long)b * mask_stride + s0 + tid] != 0;
  const unsigned bal = __ballot_sync(0xffffffffu, ok);
  if (lane == 0) sCnt[warp] = __popc(bal);
  __syncthreads();
  int nv = 0, before = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    before += w < warp ? sCnt[w] : 0;
    nv += sCnt[w];
  }
  if (ok) sIdx[before + __popc(bal & ((1u << lane) - 1u))] = tid;
  __syncthreads();

  if (nv == 0) {   // the empty marker: no K, V or scale read
    for (int r = tid; r < n_rep; r += NT) {
      part_m[(hb0 + r) * n_split + split] = -INFINITY;
      part_l[(hb0 + r) * n_split + split] = 0.f;
    }
  } else {
    // 2. the valid rows into shared memory: K, then V, all in flight
    for (int p = tid; p < nv * R::LPR; p += NT) {
      const int i = p / R::LPR, c = p % R::LPR;
      flash::cp_async16(reinterpret_cast<char*>(sK) + i * R::BYTES + c * 16,
                        reinterpret_cast<const char*>(kb + sIdx[i] * ss) +
                            c * 16, true);
    }
    flash::cp_async_commit();
    for (int p = tid; p < nv * R::LPR; p += NT) {
      const int i = p / R::LPR, c = p % R::LPR;
      flash::cp_async16(reinterpret_cast<char*>(sV) + i * R::BYTES + c * 16,
                        reinterpret_cast<const char*>(vb + sIdx[i] * ss) +
                            c * 16, true);
    }
    flash::cp_async_commit();
    if constexpr (QUANT) {
      if (tid < nv) {
        const long long at = sc + (long long)sIdx[tid] * Hkv;
        sKs[tid] = __bfloat162float(k_scale[at]);
        sVs[tid] = __bfloat162float(v_scale[at]);
      }
    }

    // this lane's piece of each query head (zeros past n_rep)
    const int c = lane % R::LPR;
    float qr[REP][R::EPL];
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const uint4* qp = reinterpret_cast<const uint4*>(
          q + (hb0 + min(r, n_rep - 1)) * D + c * R::EPL);
#pragma unroll
      for (int h = 0; h < R::EPL / 8; ++h) {
        uint4 raw = __ldg(qp + h);
        if (r >= n_rep) raw = make_uint4(0u, 0u, 0u, 0u);
        vec_to_f32(raw, qr[r] + 8 * h, (const __nv_bfloat16*)nullptr);
      }
    }
    flash::cp_async_wait<1>();
    __syncthreads();

    // 3. logits: RW rows a warp step, LPR lanes a row
    for (int i0 = warp * R::RW; i0 < nv; i0 += NW * R::RW) {
      const int i = i0 + lane / R::LPR;
      float kf[R::EPL];
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (i < nv)
        raw = *reinterpret_cast<const uint4*>(
            reinterpret_cast<const char*>(sK) + i * R::BYTES + c * 16);
      vec_to_f32(raw, kf, (const T*)nullptr);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < R::EPL; ++e) dot = fmaf(qr[r][e], kf[e], dot);
#pragma unroll
        for (int off = R::LPR / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (c == 0 && i < nv && r < n_rep) {
          if constexpr (QUANT) dot = dot * scale * sKs[i];
          else dot = dot * scale;
          sS[r * CHUNK + i] = dot;
        }
      }
    }
    flash::cp_async_wait<0>();
    __syncthreads();

    // 4. each query head's chunk max and sum; probabilities (times the V
    // scale) rounded to bf16
    for (int r = warp; r < n_rep; r += NW) {
      float* srow = sS + r * CHUNK;
      float mx = -INFINITY;
      for (int i = lane; i < nv; i += 32) mx = fmaxf(mx, srow[i]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int i = lane; i < nv; i += 32) {
        float p = expf(srow[i] - mx);
        sum += p;
        if constexpr (QUANT) p *= sVs[i];
        srow[i] = round_bf16(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        part_m[(hb0 + r) * n_split + split] = mx;
        part_l[(hb0 + r) * n_split + split] = sum;
      }
    }
    __syncthreads();

    // 5. unnormalised PV: thread (g, pc) sums slots g, g + G, ... of its
    // piece pc; then the groups are added in group order, a head at a time
    const int pc = tid % R::LPR, g = tid / R::LPR;
    float acc[REP][R::EPL];
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int e = 0; e < R::EPL; ++e) acc[r][e] = 0.f;
    for (int i = g; i < nv; i += R::G) {
      float vf[R::EPL];
      vec_to_f32(*reinterpret_cast<const uint4*>(
                     reinterpret_cast<const char*>(sV) + i * R::BYTES +
                     pc * 16),
                 vf, (const T*)nullptr);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        if (r >= n_rep) break;
        const float p = sS[r * CHUNK + i];
#pragma unroll
        for (int e = 0; e < R::EPL; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
      }
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (r >= n_rep) break;
#pragma unroll
      for (int e = 0; e < R::EPL; e += 4)
        *reinterpret_cast<float4*>(sAcc + g * D + pc * R::EPL + e) =
            make_float4(acc[r][e], acc[r][e + 1], acc[r][e + 2],
                        acc[r][e + 3]);
      __syncthreads();
      for (int d = tid; d < D; d += NT) {
        float t = 0.f;
        for (int gg = 0; gg < R::G; ++gg) t += sAcc[gg * D + d];
        part_acc[((hb0 + r) * n_split + split) * D + d] = t;
      }
      __syncthreads();
    }
  }

  // 6. ONE_LAUNCH: the last block of this (row, kv head) merges its chunks
  if constexpr (ONE_LAUNCH) {
    __shared__ int sLast;
    __threadfence();
    __syncthreads();
    if (tid == 0) sLast = atomicAdd(arrivals + bk, 1) == n_split - 1;
    __syncthreads();
    if (!sLast) return;
    __threadfence();
    if (tid == 0) arrivals[bk] = 0;
    merge_chunks<T, QUANT, D>(v_all, v_scale, part_acc, part_m, part_l, out,
                              sAcc, sS, bk, li, B, Smax, Hkv, n_rep, n_split);
  }
}

// The merge as a second kernel: a block of NT threads per (row, kv head),
// grid B * Hkv.
template <typename T, bool QUANT, int D>
__global__ void __launch_bounds__(NT) decode_merge_kernel(
    const T* __restrict__ v_all, const __nv_bfloat16* __restrict__ v_scale,
    const float* __restrict__ part_acc, const float* __restrict__ part_m,
    const float* __restrict__ part_l, __nv_bfloat16* __restrict__ out, int li,
    int B, int Smax, int Hkv, int n_rep, int n_split) {
  __shared__ float sNum[NW * D];
  __shared__ float sDen[NW];
  merge_chunks<T, QUANT, D>(v_all, v_scale, part_acc, part_m, part_l, out,
                            sNum, sDen, blockIdx.x, li, B, Smax, Hkv, n_rep,
                            n_split);
}

template <typename T, bool QUANT, int D, int REP>
int launch(const void* q, const void* k_all, const void* v_all,
           const void* k_scale, const void* v_scale, const void* mask,
           long long mask_stride, void* part_acc, void* part_m, void* part_l,
           void* out, int li, int B, int Smax, int Hkv, int n_rep,
           int n_split, float scale, cudaStream_t stream) {
  auto kernel = decode_attn_kernel<T, QUANT, D, REP>;
  constexpr int smem = smem_bytes<T, D, REP>();
  if constexpr (smem > 48 * 1024) {   // set on each launch: it is per device
    const cudaError_t set = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (set != cudaSuccess) return (int)set;
  }
  kernel<<<dim3(B * Hkv, n_split), NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k_all),
      static_cast<const T*>(v_all), static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale),
      static_cast<const uint8_t*>(mask), mask_stride,
      static_cast<float*>(part_acc), static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<__nv_bfloat16*>(out),
      li, B, Smax, Hkv, n_rep, scale);
  if constexpr (!ONE_LAUNCH)
    decode_merge_kernel<T, QUANT, D><<<B * Hkv, NT, 0, stream>>>(
        static_cast<const T*>(v_all),
        static_cast<const __nv_bfloat16*>(v_scale),
        static_cast<const float*>(part_acc), static_cast<const float*>(part_m),
        static_cast<const float*>(part_l), static_cast<__nv_bfloat16*>(out),
        li, B, Smax, Hkv, n_rep, n_split);
  return (int)cudaGetLastError();
}

// The head_dim and query-heads-per-kv-head switches shared by both entry
// points.
template <typename T, bool QUANT>
int dispatch(const void* q, const void* k_all, const void* v_all,
             const void* k_scale, const void* v_scale, const void* mask,
             long long mask_stride, void* part_acc, void* part_m,
             void* part_l, void* out, int li, int B, int Smax, int Hkv,
             int n_rep, int D, int n_split, float scale, void* stream) {
  if (n_rep < 1 || n_rep > MAX_REP || n_split != (Smax + CHUNK - 1) / CHUNK ||
      (ONE_LAUNCH && B * Hkv > MAX_PAIRS))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DECODE_LAUNCH(DD, RR)                                                 \
  launch<T, QUANT, DD, RR>(q, k_all, v_all, k_scale, v_scale, mask,          \
                           mask_stride, part_acc, part_m, part_l, out, li,   \
                           B, Smax, Hkv, n_rep, n_split, scale, st)
#define DECODE_REP(DD)                          \
  (n_rep == 1   ? DECODE_LAUNCH(DD, 1)          \
   : n_rep == 2 ? DECODE_LAUNCH(DD, 2)          \
   : n_rep <= 4 ? DECODE_LAUNCH(DD, 4)          \
                : DECODE_LAUNCH(DD, 8))
  switch (D) {
    case 16: return DECODE_REP(16);
    case 32: return DECODE_REP(32);
    case 64: return DECODE_REP(64);
    case 128: return DECODE_REP(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DECODE_REP
#undef DECODE_LAUNCH
}

}  // namespace

// Slots per chunk: the caller sizes the scratch as ceil(Smax / chunk) chunks.
extern "C" int decode_attn_chunk(void) { return CHUNK; }

// Most query heads one kv head may serve.
extern "C" int decode_attn_max_rep(void) { return MAX_REP; }

// Returns a cudaError_t as int: 0 when the launches succeeded.
extern "C" int decode_attn_bf16(const void* q, const void* k_all,
                                const void* v_all, const void* mask,
                                long long mask_stride, void* part_acc,
                                void* part_m, void* part_l, void* out, int li,
                                int B, int Smax, int Hkv, int n_rep, int D,
                                int n_split, float scale, void* stream) {
  return dispatch<__nv_bfloat16, false>(
      q, k_all, v_all, nullptr, nullptr, mask, mask_stride, part_acc, part_m,
      part_l, out, li, B, Smax, Hkv, n_rep, D, n_split, scale, stream);
}

// The int8 cache with its bf16 (L, B, Smax, Hkv) K and V scales; the query
// and the output stay bf16.  Returns a cudaError_t as int.
extern "C" int decode_attn_int8(const void* q, const void* k_all,
                                const void* v_all, const void* k_scale,
                                const void* v_scale, const void* mask,
                                long long mask_stride, void* part_acc,
                                void* part_m, void* part_l, void* out, int li,
                                int B, int Smax, int Hkv, int n_rep, int D,
                                int n_split, float scale, void* stream) {
  return dispatch<int8_t, true>(
      q, k_all, v_all, k_scale, v_scale, mask, mask_stride, part_acc, part_m,
      part_l, out, li, B, Smax, Hkv, n_rep, D, n_split, scale, stream);
}
