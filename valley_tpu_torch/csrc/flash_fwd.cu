// Flash forward attention (prefill) for Hopper, sm_90a, plain C interface.
//
// Replaces: valley_tpu/ops/flash_attention.py `_fwd_kernel` (the Pallas TPU
// kernel launched by `_flash_fwd_impl`), the prefill attention of the LLaMA
// decoder.  Same semantics: scale d^-1/2, a (B, Sk) key-validity mask, an
// optional causal mask, fp32 running max / denominator / accumulator, per-row
// logsumexp written in fp32 for a backward pass.  A row whose keys are all
// masked outputs 0 (denominator clamped at 1e-30).  The one new rounding
// point: P enters the P V product as two bf16 terms, hi = bf16(P) and
// lo = bf16(P - hi), 16 bits of it (the sums stay fp32).  One term, 8 bits,
// changes 5-7 % of the bf16 outputs against an fp32 reference and moves a
// W8A8 model's logits by int8 steps; two terms change ~0.03 %.
//
// What bounds it on the H100: at S <= 2048 the bytes (q/k/v/o once:
// ~4 MB a layer at the Valley-7B prefill, 5 us at 3.35 TB/s) bound it on
// paper; in practice latency does: a block walks its key tiles one after
// another, each warp rereads the streamed tile from shared memory for its
// own 16 rows, and the registers and 87 KB of shared memory a block leave
// 8 warps on an SM.  The products are ~2 GFLOP a layer (P V's twice over,
// for P's two terms).
//
// What the design does about it: one block of 4 warps owns 64 query rows
// of one (batch, head), each warp 16 rows.  Q is read once into registers as
// mma A fragments (ldmatrix).  K and V stream through a 2-stage ring of bf16
// tiles of 64 keys filled by cp.async (the next tile loads while this one
// is multiplied).  S = Q K^T and O += P V run on the tensor cores
// (mma.sync m16n8k16 bf16, fp32 sums): K through ldmatrix as the B operand,
// V through ldmatrix.trans; S's accumulator fragments are scaled,
// exponentiated with exp2f (scale * log2 e folded in), split into two bf16
// terms and repacked in registers as the A fragments of P V, so P never
// touches shared memory.  Row max and sum are quad shuffles.  The key mask
// becomes one bit per key in shared memory (warp ballots) at the start: a
// key tile with no attended key is never loaded, a tile fully attended and
// off the diagonal takes no per-element predicate, and causal tiles above
// the diagonal are never loaded.  The grid is (B*H, query tiles) with the heaviest query
// tiles (the last, under causal) launched first.  Ragged S is masked inside
// the kernel (zero-filled copies past the edge): no padding copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::pitch;

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // key rows per tile
constexpr int NT = 128;  // 4 warps of 16 query rows

// Q, two stages of K and V, then the key bit words.
template <int D>
size_t smem_bytes(int sk) {
  return 2 * pitch<D>() * (BQ + 4 * BK) + 8 * ((sk + BK - 1) / BK);
}

// q/out: (B, Sq, H, D); k/v: (B, Sk, H, D), all contiguous bf16.
// kv_mask: (B, Sk) bytes, row b at kv_mask + b * mask_stride, nonzero =
// attend.  lse: (B*H, Sq) fp32.  Grid (B*H, ceil(Sq/BQ)).
template <int D>
__global__ void __launch_bounds__(NT, 2) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ kv_mask,
    long long mask_stride, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int H, int Sq, int Sk, int causal,
    float scale_log2) {
  constexpr int P = pitch<D>();
  constexpr int KS = D / 16;  // k-steps of Q K^T
  constexpr int DB = D / 8;   // n-blocks of the output
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + BQ * P;      // 2 stages
  __nv_bfloat16* sV = sK + 2 * BK * P;  // 2 stages
  uint32_t* bits = reinterpret_cast<uint32_t*>(sV + 2 * BK * P);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest first
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long rs = (long long)H * D;  // elements between consecutive s
  const __nv_bfloat16* qb = q + (long long)b * Sq * rs + (long long)h * D;
  const __nv_bfloat16* kb = k + (long long)b * Sk * rs + (long long)h * D;
  const __nv_bfloat16* vb = v + (long long)b * Sk * rs + (long long)h * D;

  const int q_end = min(Sq, q0 + BQ);
  // causal: keys at or past q_end are masked for every row of this block
  const int k_end = causal ? min(Sk, q_end) : Sk;
  const int n_kt = (k_end + BK - 1) / BK;

  flash::load_tile<D, BQ, NT>(qb, q0, Sq, rs, sQ, tid);
  flash::cp_async_commit();
  flash::mask_words<NT>(kv_mask + (long long)b * mask_stride, Sk, bits,
                        2 * n_kt, tid);
  __syncthreads();
  auto live = [&](int t) { return (bits[2 * t] | bits[2 * t + 1]) != 0u; };

  int kt = 0;
  while (kt < n_kt && !live(kt)) ++kt;
  int stage = 0;
  if (kt < n_kt) {
    flash::load_tile<D, BK, NT>(kb, kt * BK, Sk, rs, sK, tid);
    flash::load_tile<D, BK, NT>(vb, kt * BK, Sk, rs, sV, tid);
  }
  flash::cp_async_commit();
  flash::cp_async_wait<1>();  // the Q tile has landed
  __syncthreads();

  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    flash::load_a<P>(qf[ks], sQ + warp * 16 * P + ks * 16, lane);

  float o[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  const float neg2 = flash::NEG * flash::LOG2E;
  float m2[2] = {neg2, neg2};  // running max in the log2 domain
  float l[2] = {0.f, 0.f};     // this thread's share of the denominator
  const int row0 = q0 + warp * 16 + (lane >> 2);  // rows row0, row0 + 8
  const int c0 = 2 * (lane & 3);                   // columns c0, c0 + 1

  while (kt < n_kt) {
    int nxt = kt + 1;
    while (nxt < n_kt && !live(nxt)) ++nxt;
    if (nxt < n_kt) {
      flash::load_tile<D, BK, NT>(kb, nxt * BK, Sk, rs,
                                  sK + (stage ^ 1) * BK * P, tid);
      flash::load_tile<D, BK, NT>(vb, nxt * BK, Sk, rs,
                                  sV + (stage ^ 1) * BK * P, tid);
    }
    flash::cp_async_commit();
    flash::cp_async_wait<1>();  // tile kt has landed
    __syncthreads();
    const __nv_bfloat16* tK = sK + stage * BK * P;
    const __nv_bfloat16* tV = sV + stage * BK * P;

    // S = Q K^T: 16 rows x 64 keys per warp
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        flash::load_b_nk<P>(bf, tK + np * 16 * P + ks * 16, lane);
        flash::mma(s[2 * np], qf[ks], bf[0], bf[1]);
        flash::mma(s[2 * np + 1], qf[ks], bf[2], bf[3]);
      }

    const int k0 = kt * BK;
    const uint32_t* tb = bits + 2 * kt;
    const bool diag = causal && k0 + BK - 1 > q0;
    if ((tb[0] & tb[1]) == 0xffffffffu && !diag) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
    } else {
      // masked logits are -inf: they never raise the running max (floored
      // at NEG) and their probability is exactly 0
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + c0 + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          const bool ok = flash::key_bit(tb, col) &&
                          (!causal || k0 + col <= row);
          s[j][e] = ok ? s[j][e] * scale_log2 : -INFINITY;
        }
    }

    // online softmax; rows row0 (e = 0, 1) and row0 + 8 (e = 2, 3)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      const float m_new = fmaxf(m2[r], flash::quad_max(mx));
      const float alpha = exp2f(m2[r] - m_new);
      m2[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[j][e] = exp2f(s[j][e] - m_new);
          sum += s[j][e];
        }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int j = 0; j < DB; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
    }

#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // P as two bf16 terms, hi = bf16(P) and lo = bf16(P - hi): 16 of its
      // bits reach P V, where one term carries 8.  lo's products are added
      // first (tools/flash_numerics.py holds this order against the others)
      uint32_t pa[4], pl[4];
      flash::c_to_a2(pa, pl, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < DB / 2; ++dp) {
        uint32_t bf[4];
        flash::load_b_kn<P>(bf, tV + kk * 16 * P + dp * 16, lane);
        flash::mma(o[2 * dp], pl, bf[0], bf[1]);
        flash::mma(o[2 * dp + 1], pl, bf[2], bf[3]);
        flash::mma(o[2 * dp], pa, bf[0], bf[1]);
        flash::mma(o[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
    kt = nxt;
    stage ^= 1;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float denom = fmaxf(flash::quad_sum(l[r]), 1e-30f);
    if (row >= Sq) continue;
    const float inv = 1.f / denom;
    __nv_bfloat16* orow = out + (long long)b * Sq * rs + (long long)row * rs +
                          (long long)h * D + c0;
#pragma unroll
    for (int j = 0; j < DB; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    if ((lane & 3) == 0)
      // a row that attended nothing keeps the natural-log floor exactly
      lse[(long long)bh * Sq + row] =
          (m2[r] == neg2 ? flash::NEG : m2[r] * flash::LN2) + logf(denom);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* kv_mask,
           long long mask_stride, void* out, void* lse, int B, int H, int Sq,
           int Sk, int causal, float scale, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        flash::MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const size_t bytes = smem_bytes<D>(Sk);
  if (bytes > (size_t)flash::MAX_SMEM) return (int)cudaErrorInvalidValue;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_fwd_kernel<D><<<grid, NT, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(kv_mask),
      mask_stride, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), H,
      Sq, Sk, causal, scale * flash::LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t as int: 0 on a successful launch.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              const void* kv_mask, long long mask_stride,
                              void* out, void* lse, int B, int H, int Sq,
                              int Sk, int D, int causal, float scale,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, kv_mask, mask_stride, out, lse, B, H, Sq, Sk,
                        causal, scale, st);
    case 32:
      return launch<32>(q, k, v, kv_mask, mask_stride, out, lse, B, H, Sq, Sk,
                        causal, scale, st);
    case 64:
      return launch<64>(q, k, v, kv_mask, mask_stride, out, lse, B, H, Sq, Sk,
                        causal, scale, st);
    case 128:
      return launch<128>(q, k, v, kv_mask, mask_stride, out, lse, B, H, Sq, Sk,
                         causal, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
