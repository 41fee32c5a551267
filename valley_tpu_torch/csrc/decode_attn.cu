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
// accumulation.  The mask is read slot by slot, never reduced to a length:
// a prompt padded to its bucket leaves invalid slots between the prompt and
// the decoded tokens.
//
// What bounds it on the H100: device-memory bytes.  One call reads layer
// li's K and V once (Valley-7B, Smax ~600: 2 x 600 x 32 x 128 x 2 B = 9.8 MB
// in bf16, half that plus 77 KB of scales in int8) for ~2 FLOP per byte,
// far under the card's ~295 FLOP/byte ridge, so the floor is bytes /
// 3.35 TB/s, a few microseconds.
//
// What the design does about it: the layer is addressed by offset into the
// stacked (L, B, Smax, Hkv, D) cache, so no per-layer slice is copied.  To
// put enough loads in flight, S is split into 64-slot chunks: one block per
// (batch, kv head, chunk), so a 7B step runs ~300 blocks instead of 32.  A
// block reads each K and V row of its chunk once and serves all n_rep query
// heads of its kv head (GQA without repeating K/V).  K rows are read by one
// warp each with a warp-reduced dot; V rows by all threads, each thread one
// column.  Each block writes its chunk's max, sum and unnormalised PV in
// fp32; a second small kernel merges the chunks with the usual rescale.  An
// int8 cache is read as int8 (4 bytes per lane at D = 128) and its
// (L, B, Smax, Hkv) scales in their storage layout; the V scale multiplies
// the chunk's unnormalised probabilities, as the Pallas kernel does, and
// the sum that normalises them stays unscaled.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;       // threads per block (4 warps)
constexpr int NW = NT / 32;
constexpr int CHUNK = 64;     // cache slots per block
constexpr int MAX_REP = 8;    // query heads per kv head
constexpr float NEG = -1e9f;  // masked logit (ops/attention.py decode_attention)

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
  } else if constexpr (EPL == 2) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = a.x; out[1] = a.y;
  } else {
    out[0] = __bfloat162float(*p);
  }
}

// EPL consecutive int8 values at p (EPL bytes, aligned to that) -> fp32.
template <int EPL>
__device__ __forceinline__ void load_kv(const int8_t* p, float* out) {
  if constexpr (EPL == 4) {
    const char4 c = *reinterpret_cast<const char4*>(p);
    out[0] = c.x; out[1] = c.y; out[2] = c.z; out[3] = c.w;
  } else if constexpr (EPL == 2) {
    const char2 c = *reinterpret_cast<const char2*>(p);
    out[0] = c.x; out[1] = c.y;
  } else {
    out[0] = *p;
  }
}

template <int EPL>
__device__ __forceinline__ void load_kv(const __nv_bfloat16* p, float* out) {
  load_bf16<EPL>(p, out);
}

__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// q: (B, H, D) bf16; k_all/v_all: (L, B, Smax, Hkv, D) contiguous, bf16 or
// int8 (T); with QUANT, k_scale/v_scale: (L, B, Smax, Hkv) contiguous bf16.
// mask: (B, Smax) bytes, row b at mask + b * mask_stride.
// part_acc: (B, H, n_split, D); part_m/part_l: (B, H, n_split), fp32.
// Grid (B * Hkv, n_split).
template <typename T, bool QUANT, int D>
__global__ void __launch_bounds__(NT) decode_split_kernel(
    const __nv_bfloat16* __restrict__ q, const T* __restrict__ k_all,
    const T* __restrict__ v_all, const __nv_bfloat16* __restrict__ k_scale,
    const __nv_bfloat16* __restrict__ v_scale, const uint8_t* __restrict__ mask,
    long long mask_stride, float* __restrict__ part_acc,
    float* __restrict__ part_m, float* __restrict__ part_l, int li, int B,
    int Smax, int Hkv, int n_rep, float scale) {
  constexpr int EPL = D >= 32 ? D / 32 : 1;  // K elements per lane
  constexpr int LANES = D / EPL;              // lanes holding a K element
  constexpr int G = NT / D;    // slot groups in the PV pass
  __shared__ float sS[MAX_REP][CHUNK];
  __shared__ float sAcc[G > 1 ? G : 1][MAX_REP][D];

  const int b = blockIdx.x / Hkv;
  const int kvh = blockIdx.x % Hkv;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int s0 = split * CHUNK;
  const int n = min(Smax - s0, CHUNK);
  const int H = Hkv * n_rep;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const long long ss = (long long)Hkv * D;  // elements between slots
  const long long base =
      ((long long)li * B + b) * Smax * ss + (long long)s0 * ss + (long long)kvh * D;
  const T* kb = k_all + base;
  const T* vb = v_all + base;
  const uint8_t* mb = mask + (long long)b * mask_stride + s0;
  // this chunk's scales of kv head kvh: slot j at sc[j * Hkv]
  const long long sc =
      ((long long)li * B + b) * Smax * Hkv + (long long)s0 * Hkv + kvh;

  // lanes past LANES (D = 16) hold zeros and add nothing to the dots
  float qr[MAX_REP][EPL];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[r][e] = 0.f;
    if (r < n_rep && lane < LANES)
      load_bf16<EPL>(q + ((long long)b * H + kvh * n_rep + r) * D + lane * EPL,
                     qr[r]);
  }

  // logits: one warp per slot
  for (int j = warp; j < n; j += NW) {
    float kv[EPL] = {};
    if (lane < LANES) load_kv<EPL>(kb + (long long)j * ss + lane * EPL, kv);
    const bool ok = mb[j] != 0;
    float ks = 1.f;
    if constexpr (QUANT) ks = __bfloat162float(k_scale[sc + (long long)j * Hkv]);
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r >= n_rep) break;
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) dot = fmaf(qr[r][e], kv[e], dot);
      dot = warp_sum(dot);
      if constexpr (QUANT) dot = dot * scale * ks;
      else dot = dot * scale;
      if (lane == 0) sS[r][j] = ok ? dot : NEG;
    }
  }
  __syncthreads();

  // chunk max and sum per query head; probabilities (times the V scale)
  // rounded to bf16
  for (int r = warp; r < n_rep; r += NW) {
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sS[r][j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      float p = expf(sS[r][j] - mx);
      sum += p;
      if constexpr (QUANT)
        p *= __bfloat162float(v_scale[sc + (long long)j * Hkv]);
      sS[r][j] = __bfloat162float(__float2bfloat16(p));
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const long long o = ((long long)b * H + kvh * n_rep + r) * n_split + split;
      part_m[o] = mx;
      part_l[o] = sum;
    }
  }
  __syncthreads();

  // unnormalised PV: thread (g, d) sums slots g, g + G, ... of column d
  const int d = threadIdx.x % D;
  const int g = threadIdx.x / D;
  float acc[MAX_REP];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) acc[r] = 0.f;
  for (int j = g; j < n; j += G) {
    const float vv = to_f32(vb[(long long)j * ss + d]);
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r)
      if (r < n_rep) acc[r] = fmaf(sS[r][j], vv, acc[r]);
  }
  if constexpr (G > 1) {
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r)
      if (r < n_rep) sAcc[g][r][d] = acc[r];
    __syncthreads();
    if (g == 0) {
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r) {
        if (r >= n_rep) break;
        float t = 0.f;
        for (int gg = 0; gg < G; ++gg) t += sAcc[gg][r][d];
        acc[r] = t;
      }
    }
  }
  if (g == 0) {
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r >= n_rep) break;
      const long long o = ((long long)b * H + kvh * n_rep + r) * n_split + split;
      part_acc[o * D + d] = acc[r];
    }
  }
}

// Merge the chunks of one (batch, query head): out = sum_s w_s acc_s /
// sum_s w_s l_s with w_s = exp(m_s - max_s m_s).  Grid (B * H), D threads.
template <int D>
__global__ void __launch_bounds__(D) decode_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_m,
    const float* __restrict__ part_l, __nv_bfloat16* __restrict__ out,
    int n_split) {
  const long long bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* pm = part_m + bh * n_split;
  const float* pl = part_l + bh * n_split;
  float mx = -INFINITY;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, pm[s]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float w = expf(pm[s] - mx);
    num = fmaf(w, part_acc[(bh * n_split + s) * D + d], num);
    den = fmaf(w, pl[s], den);
  }
  out[bh * D + d] = __float2bfloat16(num / den);
}

template <typename T, bool QUANT, int D>
int launch(const void* q, const void* k_all, const void* v_all,
           const void* k_scale, const void* v_scale, const void* mask,
           long long mask_stride, void* part_acc, void* part_m, void* part_l,
           void* out, int li, int B, int Smax, int Hkv, int n_rep,
           int n_split, float scale, cudaStream_t stream) {
  decode_split_kernel<T, QUANT, D><<<dim3(B * Hkv, n_split), NT, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k_all),
      static_cast<const T*>(v_all), static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale),
      static_cast<const uint8_t*>(mask), mask_stride,
      static_cast<float*>(part_acc), static_cast<float*>(part_m),
      static_cast<float*>(part_l), li, B, Smax, Hkv, n_rep, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_combine_kernel<D><<<B * Hkv * n_rep, D, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_m),
      static_cast<const float*>(part_l), static_cast<__nv_bfloat16*>(out),
      n_split);
  return (int)cudaGetLastError();
}

// The head_dim switch shared by both entry points.
template <typename T, bool QUANT>
int dispatch(const void* q, const void* k_all, const void* v_all,
             const void* k_scale, const void* v_scale, const void* mask,
             long long mask_stride, void* part_acc, void* part_m,
             void* part_l, void* out, int li, int B, int Smax, int Hkv,
             int n_rep, int D, int n_split, float scale, void* stream) {
  if (n_rep < 1 || n_rep > MAX_REP || n_split != (Smax + CHUNK - 1) / CHUNK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DECODE_LAUNCH(DD)                                                   \
  launch<T, QUANT, DD>(q, k_all, v_all, k_scale, v_scale, mask, mask_stride, \
                       part_acc, part_m, part_l, out, li, B, Smax, Hkv,     \
                       n_rep, n_split, scale, st)
  switch (D) {
    case 16: return DECODE_LAUNCH(16);
    case 32: return DECODE_LAUNCH(32);
    case 64: return DECODE_LAUNCH(64);
    case 128: return DECODE_LAUNCH(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DECODE_LAUNCH
}

}  // namespace

// Slots per chunk: the caller sizes the scratch as ceil(Smax / chunk) chunks.
extern "C" int decode_attn_chunk(void) { return CHUNK; }

// Most query heads one kv head may serve.
extern "C" int decode_attn_max_rep(void) { return MAX_REP; }

// Returns a cudaError_t as int: 0 when both launches succeeded.
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
