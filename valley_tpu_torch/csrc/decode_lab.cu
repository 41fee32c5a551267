// Decode-attention variants kept to measure where decode attention's time
// goes, for Hopper, sm_90a, plain C interface.  Each replaces one of the
// TPU measurement kernels in tools/:
//
//   T4  tools/exp_attn_pallas2.py `decode_attn_pallas`: one-token attention
//       over a head-major (B, H, S, D) bf16 cache with an additive fp32
//       (B, S) bias, `hc` heads per block (grid (B, H / hc)), fp32 out.
//   T5  tools/exp_attn_layout.py `attn_pallas`: the same, one (row, head)
//       per block (grid (B * H)).  The tool broadcasts row 0's bias to every
//       row (a B = 1 shortcut); this kernel reads each row's own.
//   T6  tools/exp_attn_pallas3.py `decode_attn_stacked`: T4 over the
//       stacked (L, B, H, S, D) cache, layer `li` addressed by offset.
//   T7  tools/exp_kernel_ablate.py `make_kernel(stage)`: the fused decode
//       kernel cut stage by stage, here built on the first K3's structure
//       (the first csrc/decode_attn.cu, since redesigned: a block per
//       (row, head, 64-slot chunk) reading every slot, the chunk's max, sum
//       and unnormalised PV in fp32, then a combine kernel) over the
//       port's slot-major (L, B, S, H, D) cache with an
//       additive bias in place of K3's boolean mask.  Stage 0 reads K and V
//       and writes k[0:H, head 0] + v[0:H, head 0] (the tool's
//       k_flat[0:H, 0:D] + v_flat[0:H, 0:D]); 1 adds the QK logits and
//       writes their max; 2 adds the bias and the softmax statistics and
//       writes m + l per head; 3 adds PV (the full kernel: K3's bf16
//       function); 4 computes stage 3's function with the probabilities
//       staged transposed through shared memory, the counterpart of the
//       tool's explicit transpose of P.  Every stage reads every K and V
//       byte: where a stage does not use them, streaming loads
//       (ld.global.cs) feed a value written only behind a run-time
//       predicate, so neither compiler can drop them.  Stage by stage, the
//       differences attribute K3's time to reading, QK, softmax and PV.
//
// The arithmetic is the tools': fp32 logits scaled by D^-1/2 plus the
// bias, fp32 softmax, probabilities rounded to bf16 (the value dtype)
// before PV, fp32 accumulation, the sum that normalises them unrounded.
// A row whose every slot carries the -1e9 bias gets the mean of V, as the
// tools' softmax gives it.
//
// What bounds them on the H100: device-memory bytes (each slot's K and V
// row read once, ~2 FLOP per byte).  The head-major kernels keep one
// head's S logits in shared memory and stream its K and V rows with the
// whole block; how many blocks they launch is the variable the tools
// measured (T4 and T6: B * ceil(H / hc) blocks, two to five at B1 H32-40;
// T5: B * H), so they are written simply, not fast.
//
// Every entry point returns a cudaError_t as int: 0 when its launches
// succeeded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HM_NT = 256;          // threads per head-major block
constexpr int HM_NW = HM_NT / 32;
constexpr int MAX_S = 12000;        // slots of one head's logits in shared memory
constexpr int NT = 128;             // T7: the first K3's block
constexpr int NW = NT / 32;
constexpr int CHUNK = 64;           // T7: the first K3's slots per block
constexpr int TSTRIDE = 8;          // T7 stage 4: floats between slots of P^T

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

// EPL consecutive bf16 values at p (EPL * 2 bytes, aligned to that) -> fp32.
template <int EPL>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* p, float* out) {
  if constexpr (EPL == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h2[0]);
    const float2 c = __bfloat1622float2(h2[1]);
    out[0] = a.x; out[1] = a.y; out[2] = c.x; out[3] = c.y;
  } else {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = a.x; out[1] = a.y;
  }
}

// Block-wide max and sum over HM_NT threads through `red` (HM_NW floats).
__device__ float block_max(float x, float* red) {
  x = warp_max(x);
  __syncthreads();               // red may still be read by a previous call
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float r = -INFINITY;
#pragma unroll
  for (int w = 0; w < HM_NW; ++w) r = fmaxf(r, red[w]);
  return r;
}

__device__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float r = 0.f;
#pragma unroll
  for (int w = 0; w < HM_NW; ++w) r += red[w];
  return r;
}

// One (row, head) of head-major attention, by the whole block: q (D), k/v
// (S, D) rows of this head, bias (S); writes out (D) fp32.  sS holds S
// floats, red HM_NW, sAcc HM_NT.
template <int D>
__device__ void attend_head(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const float* __restrict__ bias, int S, float scale,
                            float* sS, float* red, float* sAcc,
                            float* __restrict__ out) {
  constexpr int EPL = D / 32;      // q and K elements per lane
  constexpr int G = HM_NT / D;     // slot groups in the PV pass
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  float qr[EPL];
  load_bf16<EPL>(q + lane * EPL, qr);
  // logits: one warp per slot
  for (int j = warp; j < S; j += HM_NW) {
    float kv[EPL];
    load_bf16<EPL>(k + (long long)j * D + lane * EPL, kv);
    float dot = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) dot = fmaf(qr[e], kv[e], dot);
    dot = warp_sum(dot);
    if (lane == 0) sS[j] = dot * scale + bias[j];
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int j = threadIdx.x; j < S; j += HM_NT) mx = fmaxf(mx, sS[j]);
  mx = block_max(mx, red);
  float z = 0.f;
  for (int j = threadIdx.x; j < S; j += HM_NT) {
    const float p = expf(sS[j] - mx);
    z += p;
    sS[j] = __bfloat162float(__float2bfloat16(p));
  }
  z = block_sum(z, red);           // its barriers publish sS too
  // PV: thread (g, d) sums slots g, g + G, ... of column d
  const int d = threadIdx.x % D;
  const int g = threadIdx.x / D;
  float acc = 0.f;
  for (int j = g; j < S; j += G)
    acc = fmaf(sS[j], __bfloat162float(v[(long long)j * D + d]), acc);
  sAcc[g * D + d] = acc;
  __syncthreads();
  if (g == 0) {
    float t = 0.f;
#pragma unroll
    for (int gg = 0; gg < G; ++gg) t += sAcc[gg * D + d];
    out[d] = t / z;
  }
  __syncthreads();                 // sS and sAcc are reused by the next head
}

// Heads [blockIdx.y * hc, + hc) of row blockIdx.x, the last block ragged:
// k/v point at the (B, H, S, D) layer.
template <int D>
__device__ void head_chunk(const __nv_bfloat16* q, const __nv_bfloat16* k,
                           const __nv_bfloat16* v, const float* bias,
                           float* out, int H, int S, int hc, float scale) {
  extern __shared__ float sS[];
  __shared__ float red[HM_NW];
  __shared__ float sAcc[HM_NT];
  const int b = blockIdx.x;
  const int h1 = min(H, (blockIdx.y + 1) * hc);
  for (int h = blockIdx.y * hc; h < h1; ++h) {
    const long long bh = (long long)b * H + h;
    attend_head<D>(q + bh * D, k + bh * S * D, v + bh * S * D,
                   bias + (long long)b * S, S, scale, sS, red, sAcc,
                   out + bh * D);
  }
}

template <int D>
__global__ void __launch_bounds__(HM_NT) t4_head_chunked_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    float* __restrict__ out, int H, int S, int hc, float scale) {
  head_chunk<D>(q, k, v, bias, out, H, S, hc, scale);
}

template <int D>
__global__ void __launch_bounds__(HM_NT) t5_per_head_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    float* __restrict__ out, int H, int S, float scale) {
  extern __shared__ float sS[];
  __shared__ float red[HM_NW];
  __shared__ float sAcc[HM_NT];
  const long long bh = blockIdx.x;
  attend_head<D>(q + bh * D, k + bh * S * D, v + bh * S * D,
                 bias + (bh / H) * S, S, scale, sS, red, sAcc, out + bh * D);
}

// T4 on layer li of the stacked (L, B, H, S, D) cache.
template <int D>
__global__ void __launch_bounds__(HM_NT) t6_stacked_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_all,
    const __nv_bfloat16* __restrict__ v_all, const float* __restrict__ bias,
    float* __restrict__ out, int li, int B, int H, int S, int hc,
    float scale) {
  const long long layer = (long long)li * B * H * S * D;
  head_chunk<D>(q, k_all + layer, v_all + layer, bias, out, H, S, hc, scale);
}

// 16 bytes at p through a streaming load, folded to one word.
__device__ __forceinline__ uint32_t touch16(const void* p) {
  uint32_t a, b, c, d;
  asm volatile("ld.global.cs.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(a), "=r"(b), "=r"(c), "=r"(d)
               : "l"(p));
  return a ^ b ^ c ^ d;
}

// Every byte of n rows of D bf16 values, rows ss elements apart.
template <int D>
__device__ __forceinline__ uint32_t touch_rows(const __nv_bfloat16* base,
                                               long long ss, int n) {
  constexpr int VPR = D / 8;       // 16-byte vectors per row
  uint32_t x = 0;
  for (int i = threadIdx.x; i < n * VPR; i += NT)
    x ^= touch16(base + (long long)(i / VPR) * ss + (i % VPR) * 8);
  return x;
}

// T7's split kernel, stage STAGE.  q: (B, H, D) bf16; k_all/v_all:
// (L, B, S, H, D) bf16; bias: (B, S) fp32; part_acc (B, H, n_split, D),
// part_m/part_l (B, H, n_split) fp32; out (B, H, D) bf16, written here by
// stage 0 only.  `sink` takes the touched bytes' fold where it equals
// `sentinel`.  Grid (B * H, n_split).
template <int STAGE, int D>
__global__ void __launch_bounds__(NT) t7_stage_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_all,
    const __nv_bfloat16* __restrict__ v_all, const float* __restrict__ bias,
    float* __restrict__ part_acc, float* __restrict__ part_m,
    float* __restrict__ part_l, __nv_bfloat16* __restrict__ out,
    uint32_t* __restrict__ sink, uint32_t sentinel, int li, int B, int S,
    int H, float scale) {
  constexpr int EPL = D / 32;
  constexpr int G = NT / D;
  __shared__ float sS[CHUNK];
  __shared__ float sT[STAGE == 4 ? CHUNK * TSTRIDE : 1];
  __shared__ float sAcc[G][D];

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int split = blockIdx.y;
  const int s0 = split * CHUNK;
  const int n = min(S - s0, CHUNK);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const long long ss = (long long)H * D;   // elements between slots
  const long long base =
      ((long long)li * B + b) * S * ss + (long long)s0 * ss + (long long)h * D;
  const __nv_bfloat16* kb = k_all + base;
  const __nv_bfloat16* vb = v_all + base;
  const long long o = ((long long)b * H + h) * gridDim.y + split;

  uint32_t x = 0;
  if constexpr (STAGE == 0) x ^= touch_rows<D>(kb, ss, n);
  if constexpr (STAGE <= 2) x ^= touch_rows<D>(vb, ss, n);
  if (STAGE <= 2 && x == sentinel) sink[blockIdx.x] = x;
  if constexpr (STAGE == 0) {
    // out[b, h] = k + v at slot h of head 0: one row for each head's
    // first block, so no block carries more than one row of it
    if (split == 0) {
      const long long at = base - (long long)h * D + (long long)h * ss;
      for (int i = threadIdx.x; i < D; i += NT)
        out[((long long)b * H + h) * D + i] = __float2bfloat16(
            __bfloat162float(k_all[at + i]) + __bfloat162float(v_all[at + i]));
    }
    return;
  }

  // logits: one warp per slot (the diagonal block of the tool's qd)
  float qr[EPL];
  load_bf16<EPL>(q + ((long long)b * H + h) * D + lane * EPL, qr);
  for (int j = warp; j < n; j += NW) {
    float kv[EPL];
    load_bf16<EPL>(kb + (long long)j * ss + lane * EPL, kv);
    float dot = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) dot = fmaf(qr[e], kv[e], dot);
    dot = warp_sum(dot);
    if (lane == 0) {
      float s = dot * scale;
      if constexpr (STAGE >= 2) s += bias[(long long)b * S + s0 + j];
      sS[j] = s;
    }
  }
  __syncthreads();

  if (warp == 0) {
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sS[j]);
    mx = warp_max(mx);
    if constexpr (STAGE >= 2) {
      // the chunk's sum and, from stage 3, its probabilities in bf16
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(sS[j] - mx);
        sum += p;
        if constexpr (STAGE >= 3) sS[j] = __bfloat162float(__float2bfloat16(p));
      }
      sum = warp_sum(sum);
      if (lane == 0) part_l[o] = sum;
    }
    if (lane == 0) part_m[o] = mx;
  }
  if constexpr (STAGE <= 2) return;
  __syncthreads();

  const float* P = sS;
  int ps = 1;
  if constexpr (STAGE == 4) {
    // P staged transposed: slot j's probability at sT[j * TSTRIDE]
    for (int j = threadIdx.x; j < n; j += NT) sT[j * TSTRIDE] = sS[j];
    __syncthreads();
    P = sT;
    ps = TSTRIDE;
  }
  // unnormalised PV: thread (g, d) sums slots g, g + G, ... of column d
  const int d = threadIdx.x % D;
  const int g = threadIdx.x / D;
  float acc = 0.f;
  for (int j = g; j < n; j += G)
    acc = fmaf(P[j * ps], __bfloat162float(vb[(long long)j * ss + d]), acc);
  if constexpr (G > 1) {
    sAcc[g][d] = acc;
    __syncthreads();
    if (g == 0) {
      float t = 0.f;
#pragma unroll
      for (int gg = 0; gg < G; ++gg) t += sAcc[gg][d];
      acc = t;
    }
  }
  if (g == 0) part_acc[o * D + d] = acc;
}

// T7's combine, grid (B * H), D threads: stage 1 the max over every head
// and chunk of the row; stage 2 m + l; stages 3 and 4 K3's merge.
template <int STAGE, int D>
__global__ void __launch_bounds__(D) t7_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_m,
    const float* __restrict__ part_l, __nv_bfloat16* __restrict__ out, int H,
    int n_split) {
  const long long bh = blockIdx.x;
  const int d = threadIdx.x;
  if constexpr (STAGE == 1) {
    // the row's H * n_split chunk maxima, strided over the block's threads
    __shared__ float red[D / 32];
    const float* pm = part_m + (bh / H) * H * n_split;
    float mx = -INFINITY;
    for (int i = d; i < H * n_split; i += D) mx = fmaxf(mx, pm[i]);
    mx = warp_max(mx);
    if (d % 32 == 0) red[d / 32] = mx;
    __syncthreads();
    mx = red[0];
#pragma unroll
    for (int w = 1; w < D / 32; ++w) mx = fmaxf(mx, red[w]);
    out[bh * D + d] = __float2bfloat16(mx);
    return;
  }
  const float* pm = part_m + bh * n_split;
  const float* pl = part_l + bh * n_split;
  float mx = -INFINITY;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, pm[s]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float w = expf(pm[s] - mx);
    if constexpr (STAGE >= 3)
      num = fmaf(w, part_acc[(bh * n_split + s) * D + d], num);
    den = fmaf(w, pl[s], den);
  }
  out[bh * D + d] = __float2bfloat16(STAGE == 2 ? mx + den : num / den);
}

// The head-major launches, by head_dim.
int head_major(int kind, const void* q, const void* k, const void* v,
               const void* bias, void* out, int li, int B, int H, int S,
               int D, int hc, float scale, cudaStream_t st) {
  if (S < 1 || S > MAX_S || hc < 1 || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)S * sizeof(float);
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* kk = static_cast<const __nv_bfloat16*>(k);
  const auto* vv = static_cast<const __nv_bfloat16*>(v);
  const auto* bb = static_cast<const float*>(bias);
  auto* oo = static_cast<float*>(out);
  const dim3 chunked(B, (H + hc - 1) / hc);
#define HM_LAUNCH(DD)                                                         \
  if (kind == 4)                                                              \
    t4_head_chunked_kernel<DD><<<chunked, HM_NT, smem, st>>>(qq, kk, vv, bb,  \
                                                              oo, H, S, hc,   \
                                                              scale);         \
  else if (kind == 5)                                                         \
    t5_per_head_kernel<DD><<<B * H, HM_NT, smem, st>>>(qq, kk, vv, bb, oo, H, \
                                                       S, scale);             \
  else                                                                        \
    t6_stacked_kernel<DD><<<chunked, HM_NT, smem, st>>>(qq, kk, vv, bb, oo,   \
                                                        li, B, H, S, hc,      \
                                                        scale);
  if (D == 64) {
    HM_LAUNCH(64)
  } else {
    HM_LAUNCH(128)
  }
#undef HM_LAUNCH
  return (int)cudaGetLastError();
}

template <int STAGE, int D>
int t7_launch(const void* q, const void* k_all, const void* v_all,
              const void* bias, void* part_acc, void* part_m, void* part_l,
              void* out, void* sink, int li, int B, int S, int H,
              int n_split, float scale, cudaStream_t st) {
  t7_stage_kernel<STAGE, D><<<dim3(B * H, n_split), NT, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_all),
      static_cast<const __nv_bfloat16*>(v_all),
      static_cast<const float*>(bias), static_cast<float*>(part_acc),
      static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<__nv_bfloat16*>(out), static_cast<uint32_t*>(sink),
      0x9e3779b9u, li, B, S, H, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if constexpr (STAGE > 0)
    t7_combine_kernel<STAGE, D><<<B * H, D, 0, st>>>(
        static_cast<const float*>(part_acc),
        static_cast<const float*>(part_m), static_cast<const float*>(part_l),
        static_cast<__nv_bfloat16*>(out), H, n_split);
  return (int)cudaGetLastError();
}

template <int D>
int t7_stage(int stage, const void* q, const void* k_all, const void* v_all,
             const void* bias, void* part_acc, void* part_m, void* part_l,
             void* out, void* sink, int li, int B, int S, int H, int n_split,
             float scale, cudaStream_t st) {
#define T7_LAUNCH(SS)                                                      \
  t7_launch<SS, D>(q, k_all, v_all, bias, part_acc, part_m, part_l, out,   \
                   sink, li, B, S, H, n_split, scale, st)
  switch (stage) {
    case 0: return T7_LAUNCH(0);
    case 1: return T7_LAUNCH(1);
    case 2: return T7_LAUNCH(2);
    case 3: return T7_LAUNCH(3);
    case 4: return T7_LAUNCH(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef T7_LAUNCH
}

}  // namespace

// T7's slots per block: the caller sizes the scratch as ceil(S / chunk).
extern "C" int decode_lab_chunk(void) { return CHUNK; }

// Most slots the head-major kernels (T4-T6) take.
extern "C" int decode_lab_max_slots(void) { return MAX_S; }

// T4: q (B, H, D), k/v (B, H, S, D) bf16, bias (B, S) fp32, out (B, H, D)
// fp32; hc heads per block.
extern "C" int decode_lab_t4(const void* q, const void* k, const void* v,
                             const void* bias, void* out, int B, int H, int S,
                             int D, int hc, float scale, void* stream) {
  return head_major(4, q, k, v, bias, out, 0, B, H, S, D, hc, scale,
                    static_cast<cudaStream_t>(stream));
}

// T5: as T4, one (row, head) per block.
extern "C" int decode_lab_t5(const void* q, const void* k, const void* v,
                             const void* bias, void* out, int B, int H, int S,
                             int D, float scale, void* stream) {
  return head_major(5, q, k, v, bias, out, 0, B, H, S, D, 1, scale,
                    static_cast<cudaStream_t>(stream));
}

// T6: as T4 on layer li of k_all/v_all (L, B, H, S, D).
extern "C" int decode_lab_t6(const void* q, const void* k_all,
                             const void* v_all, const void* bias, void* out,
                             int li, int B, int H, int S, int D, int hc,
                             float scale, void* stream) {
  return head_major(6, q, k_all, v_all, bias, out, li, B, H, S, D, hc, scale,
                    static_cast<cudaStream_t>(stream));
}

// T7 at `stage` (0-4) on layer li of k_all/v_all (L, B, S, H, D); scratch
// part_acc (B, H, n_split, D), part_m/part_l (B, H, n_split) fp32, sink
// (B * H) words; out (B, H, D) bf16.
extern "C" int decode_lab_t7(const void* q, const void* k_all,
                             const void* v_all, const void* bias,
                             void* part_acc, void* part_m, void* part_l,
                             void* out, void* sink, int li, int B, int S,
                             int H, int D, int n_split, int stage,
                             float scale, void* stream) {
  if (n_split != (S + CHUNK - 1) / CHUNK || S < H)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return t7_stage<64>(stage, q, k_all, v_all, bias, part_acc, part_m,
                        part_l, out, sink, li, B, S, H, n_split, scale, st);
  if (D == 128)
    return t7_stage<128>(stage, q, k_all, v_all, bias, part_acc, part_m,
                         part_l, out, sink, li, B, S, H, n_split, scale, st);
  return (int)cudaErrorInvalidValue;
}
