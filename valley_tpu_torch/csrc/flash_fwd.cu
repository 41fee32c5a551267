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
// What bounds it on the H100: the operations.  At the training shapes
// (B16 S512 and B1 S2048, H32, D128, causal) the attended pairs need 2 D
// operations each for Q K^T and for P V (34 GFLOP a layer at B1 S2048,
// 35 us at the bf16 peak), against 2-4 MB of q/k/v/o (1 us at 3.35 TB/s);
// P's two terms make P V two products, so the tensor cores do 1.5x the
// work the bound counts.  What holds a kernel under that rate is feeding
// the tensor cores: operands through the registers (mma.sync, this kernel's
// earlier design)
// and the block's softmax between its products.
//
// Design (wgmma and TMA, after FlashAttention-3):
//   - A block owns BQ = 128 query rows of one (batch, head): a producer
//     warpgroup and two consumer warpgroups of 64 rows each.  One producer
//     thread loads Q once and streams K and V tiles of BK = 64 keys
//     through a ring of STAGES stages by TMA (cp.async.bulk.tensor, a 4-D
//     map over (B, S, H, D): a row of one head is H D bf16 from the next;
//     boxes of 64 columns in the 128-byte swizzle, so a D = 128 row is two
//     boxes; rows past S come in as zeros, so ragged S needs no padding
//     copy), completing on the stage's full mbarrier; every consumer thread
//     arrives on its empty mbarrier when its products on it are done.
//     setmaxnreg gives the producer 24 registers and each consumer 240.
//   - S = Q K^T is wgmma m64n64k16 with both operands from shared memory
//     (K-major: D is the reduction), D / 16 steps into fp32 sums.  Key
//     tiles of 64 rescale O every 64 keys as the earlier mma.sync design
//     did: its sums in the same order, and the same first-step training
//     loss, where tiles of 128 move it past chip_smoke.py's bar (rounding,
//     not error: tools/flash_numerics.py, PERF.md).
//   - The sums are scaled (scale * log2 e folded in), masked, and folded
//     into the running max and denominator (quad shuffles; exp2f) while
//     the previous tile's P V runs on the tensor cores (issued after this
//     tile's S, FlashAttention-3's intra-warpgroup overlap); O is rescaled
//     in registers when that product is done.  P's two bf16 terms are packed from S's
//     accumulator registers straight into wgmma's register A layout (the
//     fragment of mma.sync's A, flash_common.cuh), so P never touches
//     shared memory.
//   - O += P V is wgmma m64nDk16 with A = P from registers and B = V from
//     shared memory, read MN-major through the transpose flag (no
//     transposed copy of V): per 16 keys the lo term's product, then hi's,
//     into the same fp32 sums (the order tools/flash_numerics.py holds).
//   - The key mask becomes one bit per key in shared memory (warp ballots)
//     before the warpgroups part, so the producer and the consumers walk
//     the same tiles: a key tile with no attended key is never loaded,
//     causal tiles past the block's last row are never loaded, and a tile
//     fully attended and off a warpgroup's diagonal takes no per-element
//     predicate; a warpgroup skips (and releases) a causal tile wholly past
//     its last row.  Masked logits are -inf: they never raise the running
//     max (floored at NEG) and their probability is exactly 0.
//   - D 16 and 32 are read as one 64-column box whose columns past D are
//     zeros (the products take D / 16 steps; P V runs at N = 64).
//   - Grid (B*H, query tiles), the heaviest query tiles (the last, under
//     causal) launched first; the output and lse are written from the
//     registers.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 128;       // query rows a block: two warpgroups of 64
constexpr int BK = 64;        // keys a tile
constexpr int WORDS = BK / 32;  // mask words a key tile
constexpr int CONSUMERS = 2;  // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;  // and a producer
constexpr int STAGES = 4;
constexpr int ROW = 128;      // bytes of a swizzled row: 64 bf16

// Shared memory of a block, offsets from a 1024-byte aligned base.  A tile
// of R rows is NH column boxes of [R][64] bf16, box c at c * R * ROW.
template <int D>
struct Layout {
  static constexpr int NH = D <= 64 ? 1 : D / 64;  // 64-column boxes
  static constexpr int TILE = NH * BK * ROW;       // a K or a V tile
  static constexpr int Q = 0;
  static constexpr int K = Q + NH * BQ * ROW;
  static constexpr int V = K + STAGES * TILE;
  static constexpr int BARS = V + STAGES * TILE;  // q, full[], empty[]
  static constexpr int BITS = BARS + 8 * (1 + 2 * STAGES);
  static size_t bytes(int n_words) { return BITS + 4 * n_words + 1024; }
};

// P as two bf16 terms, hi = bf16(P) and lo = bf16(P - hi): 16 of its bits
// reach P V, where one term carries 8.  lo's products are added first, per
// 16 keys (tools/flash_numerics.py holds this order against the others).
struct PTerms {
  uint32_t hi[BK / 16][4], lo[BK / 16][4];
};

// P's terms from S's sums (the probabilities, fp32), in wgmma's register A
// layout.
__device__ __forceinline__ void split_p(PTerms& p, const float* s) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    flash::c_to_a2(p.hi[kk], p.lo[kk], s + 8 * kk);
    fence_regs(p.hi[kk]);
    fence_regs(p.lo[kk]);
  }
}

// O += P V, issued (not committed): V's tile of BK keys at vb, MN-major.
template <int DP>
__device__ __forceinline__ void p_times_v(float (&o)[DP / 2],
                                          const PTerms& p, uint32_t vb) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv = sw128_desc(vb + kk * 2048, BK * ROW, 1024);
    wgmma_bf16_rs<DP, 1>(o, p.lo[kk], dv, 1);
    wgmma_bf16_rs<DP, 1>(o, p.hi[kk], dv, 1);
  }
}

// A consumer warpgroup's 64 query rows: O's sums, the running max and
// denominator, P's terms, and its place in the ring of K and V tiles.
template <int D>
struct Rows {
  static constexpr int DP = 64 * Layout<D>::NH;  // the head dim in smem
  float o[DP / 2];
  float m2[2];  // running max in the log2 domain
  float l[2];   // this thread's share of the denominator
  PTerms p;
  uint32_t base, full0, empty0, qa;
  int stage = 0;
  uint32_t phase = 0;
  int row0, r_first, t, causal;
  float scale_log2;

  __device__ uint32_t full() const { return full0 + 8 * stage; }
  __device__ uint32_t empty() const { return empty0 + 8 * stage; }
  __device__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  // S = Q K^T of the current stage's keys, issued and committed: the
  // warpgroup's 64 rows x BK keys
  __device__ void issue_s(float (&s)[BK / 2]) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    fence_regs(s);
    fence_regs(o);
    wgmma_fence();
    const uint32_t kb = base + Layout<D>::K + stage * Layout<D>::TILE;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int c = ks / 4, off = (ks % 4) * 32;
      wgmma_bf16_ss<BK, 0>(s, sw128_desc(qa + c * BQ * ROW + off, 16, 1024),
                           sw128_desc(kb + c * BK * ROW + off, 16, 1024), 1);
    }
    wgmma_commit();
  }

  // The tile's S (keys k0.., mask words tb) scaled and masked, folded into
  // the running max and denominator: s becomes P, alpha O's rescale.
  // Rows row0 (i % 4 in 0, 1) and row0 + 8 (2, 3).
  __device__ void softmax(float (&s)[BK / 2], const uint32_t* tb, int k0,
                          float (&alpha)[2]) {
    const bool diag = causal && k0 + BK - 1 > r_first;
    if (flash::all_keys<WORDS>(tb) && !diag) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] *= scale_log2;
    } else {
      // masked logits are -inf: they never raise the running max (floored
      // at NEG) and their probability is exactly 0
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int col = 8 * (i / 4) + 2 * t + (i & 1);
        const int row = row0 + 8 * ((i >> 1) & 1);
        const bool ok =
            flash::key_bit(tb, col) && (!causal || k0 + col <= row);
        s[i] = ok ? s[i] * scale_log2 : -INFINITY;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      const float m_new = fmaxf(m2[r], flash::quad_max(mx));
      alpha[r] = exp2f(m2[r] - m_new);
      m2[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[4 * j + e] = exp2f(s[4 * j + e] - m_new);
          sum += s[4 * j + e];
        }
      l[r] = l[r] * alpha[r] + sum;
    }
  }

  __device__ void rescale(const float (&alpha)[2]) {
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];
  }
};

// q/out: (B, Sq, H, D); k/v: (B, Sk, H, D), contiguous bf16 (by tensor
// maps).  kv_mask: (B, Sk) bytes, row b at kv_mask + b * mask_stride,
// nonzero = attend.  lse: (B*H, Sq) fp32.  Grid (B*H, ceil(Sq/BQ)).
template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const uint8_t* __restrict__ kv_mask, long long mask_stride,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int H, int Sq,
    int Sk, int causal, float scale_log2, int fault) {
  using L = Layout<D>;
  constexpr int NH = L::NH;
  constexpr int DP = 64 * NH;  // the head dim in shared memory
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem_raw + (base - raw) +
                                               L::BITS);
  const uint32_t qbar = base + L::BARS;
  const uint32_t full0 = qbar + 8, empty0 = full0 + 8 * STAGES;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest first
  const int q_end = min(Sq, q0 + BQ);
  // causal: keys at or past q_end are masked for every row of this block
  const int k_end = causal ? min(Sk, q_end) : Sk;
  const int n_kt = (k_end + BK - 1) / BK;

  flash::mask_words<THREADS>(kv_mask + (long long)b * mask_stride, Sk, bits,
                             n_kt * WORDS, threadIdx.x);
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS * 128);  // every consumer thread
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (fault == flash::FAULT_SKIP) {
    flash::plant_skip_fault<WORDS>(bits, n_kt, threadIdx.x);
    __syncthreads();
  }

  // the warpgroup, uniform across the warp as the compiler sees it
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == CONSUMERS) {
    // the producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == CONSUMERS * 128) {
      const int shift = fault == flash::FAULT_BOX ? 64 : 0;
      mbar_expect_tx(qbar, NH * BQ * ROW);
      for (int c = 0; c < NH; ++c)
        tma_load_4d(base + L::Q + c * BQ * ROW, &q_map, qbar, 64 * c, h, q0,
                    b);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < n_kt; ++kt) {
        if (!flash::any_key<WORDS>(bits + kt * WORDS)) continue;
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        const uint32_t full = full0 + 8 * stage;
        mbar_expect_tx(full, 2 * L::TILE);
        for (int c = 0; c < NH; ++c) {
          tma_load_4d(base + L::K + stage * L::TILE + c * BK * ROW, &k_map,
                      full, 64 * c + shift, h, kt * BK, b);
          tma_load_4d(base + L::V + stage * L::TILE + c * BK * ROW, &v_map,
                      full, 64 * c, h, kt * BK, b);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int tw = threadIdx.x % 128;
    const int warp = tw / 32, lane = tw % 32;
    const int t = lane & 3;
    Rows<D> w;
    w.base = base;
    w.full0 = full0;
    w.empty0 = empty0;
    w.qa = base + L::Q + wg * 64 * ROW;
    w.r_first = q0 + wg * 64;                          // the warpgroup's
    w.row0 = w.r_first + warp * 16 + (lane >> 2);      // rows row0, +8
    w.t = t;
    w.causal = causal;
    w.scale_log2 = scale_log2;
    const float neg2 = flash::NEG * flash::LOG2E;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) w.o[i] = 0.f;
    w.m2[0] = w.m2[1] = neg2;
    w.l[0] = w.l[1] = 0.f;

    // The tiles the warpgroup computes: live, and under causal not wholly
    // past its last row.  Tile j's S = Q K^T is issued before tile j - 1's
    // O += P V, and its softmax runs while that product does; the order of
    // O's arithmetic is unchanged (rescale by tile j - 1's alpha, add its
    // P V, rescale by tile j's).  A stage is released when its P V is done.
    const int kt_end = causal ? min(n_kt, (w.r_first + 63) / BK + 1) : n_kt;
    auto next = [&](int kt) {
      while (kt < kt_end && !flash::any_key<WORDS>(bits + kt * WORDS)) ++kt;
      return kt;
    };
    mbar_wait(qbar, 0);
    int kt = next(0);
    if (kt < kt_end) {
      float s[BK / 2], alpha[2];
      mbar_wait(w.full(), w.phase);
      w.issue_s(s);
      wgmma_wait_n<0>();
      fence_regs(s);
      w.softmax(s, bits + kt * WORDS, kt * BK, alpha);  // O is 0
      split_p(w.p, s);
      int p_stage = w.stage;
      w.advance();
      for (kt = next(kt + 1); kt < kt_end; kt = next(kt + 1)) {
        mbar_wait(w.full(), w.phase);
        w.issue_s(s);
        p_times_v<DP>(w.o, w.p, base + L::V + p_stage * L::TILE);
        wgmma_commit();
        wgmma_wait_n<1>();  // S is done; P V runs on
        fence_regs(s);
        w.softmax(s, bits + kt * WORDS, kt * BK, alpha);
        wgmma_wait_n<0>();
        fence_regs(w.o);
        mbar_arrive(empty0 + 8 * p_stage);
        w.rescale(alpha);
        split_p(w.p, s);
        p_stage = w.stage;
        w.advance();
      }
      fence_regs(w.o);
      wgmma_fence();
      p_times_v<DP>(w.o, w.p, base + L::V + p_stage * L::TILE);
      wgmma_commit();
      wgmma_wait_n<0>();
      fence_regs(w.o);
      mbar_arrive(empty0 + 8 * p_stage);
    }
    // the causal tiles past the warpgroup's rows, released unread
    for (kt = kt_end; kt < n_kt; ++kt) {
      if (!flash::any_key<WORDS>(bits + kt * WORDS)) continue;
      mbar_wait(w.full(), w.phase);
      mbar_arrive(w.empty());
      w.advance();
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = w.row0 + 8 * r;
      const float denom = fmaxf(flash::quad_sum(w.l[r]), 1e-30f);
      if (row >= Sq) continue;
      const float inv = 1.f / denom;
      __nv_bfloat16* orow = out + ((long long)b * Sq + row) * H * D +
                            (long long)h * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(w.o[4 * j + 2 * r] * inv,
                                  w.o[4 * j + 2 * r + 1] * inv);
      if (t == 0)
        // a row that attended nothing keeps the natural-log floor exactly
        lse[(long long)bh * Sq + row] =
            (w.m2[r] == neg2 ? flash::NEG : w.m2[r] * flash::LN2) +
            logf(denom);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* kv_mask,
           long long mask_stride, void* out, void* lse, int B, int H, int Sq,
           int Sk, int causal, float scale, int fault, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        flash::MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const size_t bytes = Layout<D>::bytes(((Sk + BK - 1) / BK) * WORDS);
  if (bytes > (size_t)flash::MAX_SMEM) return (int)cudaErrorInvalidValue;
  CUtensorMap q_map, k_map, v_map;
  if (!encode_bshd_bf16(&q_map, q, B, Sq, H, D, BQ) ||
      !encode_bshd_bf16(&k_map, k, B, Sk, H, D, BK) ||
      !encode_bshd_bf16(&v_map, v, B, Sk, H, D, BK))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_fwd_kernel<D><<<grid, THREADS, bytes, stream>>>(
      q_map, k_map, v_map, static_cast<const uint8_t*>(kv_mask), mask_stride,
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), H, Sq, Sk,
      causal, scale * flash::LOG2E, fault);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t as int: 0 on a successful launch.  ``fault`` plants
// one of flash_common.cuh's faults for the card tests; 0 otherwise.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              const void* kv_mask, long long mask_stride,
                              void* out, void* lse, int B, int H, int Sq,
                              int Sk, int D, int causal, float scale,
                              int fault, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, kv_mask, mask_stride, out, lse, B, H, Sq, Sk,
                        causal, scale, fault, st);
    case 32:
      return launch<32>(q, k, v, kv_mask, mask_stride, out, lse, B, H, Sq, Sk,
                        causal, scale, fault, st);
    case 64:
      return launch<64>(q, k, v, kv_mask, mask_stride, out, lse, B, H, Sq, Sk,
                        causal, scale, fault, st);
    case 128:
      return launch<128>(q, k, v, kv_mask, mask_stride, out, lse, B, H, Sq,
                         Sk, causal, scale, fault, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
