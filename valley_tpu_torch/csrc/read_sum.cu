// Read-bandwidth probe: the fp32 sum of a bf16 array times a scalar, for
// Hopper, sm_90a, plain C interface.
//
// Replaces: tools/exp_read_bw.py `pallas_sum_2d` (T8): the fp32 sum of a
// 2-D bf16 (N, D) array in row blocks, each block's sum times a scalar read
// from SMEM, accumulated into a (1, 1) output:
//   y = seed * sum_i float(x[i])
// over the array's N * D elements in memory order.
//
// What bounds it on the H100: device-memory bytes.  One add per 2-byte
// element is far under the ridge, so the floor is 2 N D bytes / 3.35 TB/s;
// its one job is to read as fast as the card can, so that its time on an
// array far past the 50 MB L2 measures the card's real read ceiling.
//
// What the design does about it: a grid of BLOCKS blocks walks the array
// in 16-byte vectors (8 bf16 per load), grid-strided so neighbouring
// threads read neighbouring vectors, four loads in flight per thread, with
// the streaming cache hint.  Each block reduces its threads' fp32 partials
// (warp shuffles, then shared memory) into one partial; a second launch of
// one block adds the BLOCKS partials in a fixed order and applies the
// scalar.  No float atomics: the result is the same on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 512;        // threads per block
constexpr int BLOCKS = 528;    // partials: 4 resident blocks on each of 132 SMs
constexpr int UNROLL = 4;      // 16-byte loads in flight per thread

__device__ __forceinline__ float sum8(const uint4& v) {
  const uint32_t h[4] = {v.x, v.y, v.z, v.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    s += __uint_as_float(h[i] << 16) + __uint_as_float(h[i] & 0xFFFF0000u);
  return s;
}

// The sum over the block's threads of `v`, in thread 0 (fixed order).
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warps[NT / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (threadIdx.x % 32 == 0) warps[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NT / 32; ++i) s += warps[i];
  }
  return s;
}

// part[block] = the sum of this block's share of the nvec vectors of x,
// plus, in block 0, the ntail (< 8) elements of `tail`.
__global__ void __launch_bounds__(NT) read_sum_partial_kernel(
    const uint4* __restrict__ x, long long nvec,
    const __nv_bfloat16* __restrict__ tail, int ntail,
    float* __restrict__ part) {
  const long long stride = (long long)gridDim.x * NT;
  long long i = (long long)blockIdx.x * NT + threadIdx.x;
  float acc = 0.f;
  for (; i + stride * (UNROLL - 1) < nvec; i += stride * UNROLL) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = __ldcs(x + i + stride * u);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc += sum8(v[u]);
  }
  for (; i < nvec; i += stride) acc += sum8(__ldcs(x + i));
  if (blockIdx.x == 0 && threadIdx.x < ntail)
    acc += __bfloat162float(tail[threadIdx.x]);
  const float s = block_sum(acc);
  if (threadIdx.x == 0) part[blockIdx.x] = s;
}

// y[0] = seed[0] * the sum of the n partials.
__global__ void __launch_bounds__(NT) read_sum_final_kernel(
    const float* __restrict__ part, int n, const float* __restrict__ seed,
    float* __restrict__ y) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += NT) acc += part[i];
  const float s = block_sum(acc);
  if (threadIdx.x == 0) y[0] = s * seed[0];
}

}  // namespace

// Partials the caller's scratch must hold (fp32).
extern "C" int read_sum_blocks(void) { return BLOCKS; }

// Returns a cudaError_t as int: 0 when both launches succeeded.  x holds n
// bf16 and is 16-byte aligned; seed and y are one fp32 each on the device;
// scratch holds read_sum_blocks() fp32.
extern "C" int read_sum_bf16(const void* x, long long n, const void* seed,
                             void* y, void* scratch, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nvec = n / 8;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  read_sum_partial_kernel<<<BLOCKS, NT, 0, st>>>(
      reinterpret_cast<const uint4*>(x), nvec, xb + nvec * 8,
      (int)(n - nvec * 8), static_cast<float*>(scratch));
  int err = (int)cudaGetLastError();
  if (err) return err;
  read_sum_final_kernel<<<1, NT, 0, st>>>(
      static_cast<const float*>(scratch), BLOCKS,
      static_cast<const float*>(seed), static_cast<float*>(y));
  return (int)cudaGetLastError();
}
