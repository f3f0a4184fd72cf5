// Segment sums for the bundle-adjustment normal equations.
//
// mavmap_seg_accum_full replaces mavmap_tpu/ops/pallas/ba_accum.py
// seg_accum_full (_full_kernel): out[s, :] = sum over o with ids[o] == s of
// contrib[o, :], ids in any order. On the TPU it is a one-hot MXU product
// with the (S, K) accumulator resident in VMEM across a sequential grid.
// Here each block owns a chunk of observations and a tile of segments, and
// reduces the chunk into a shared-memory accumulator with shared-memory
// atomics; the block's nonzero partial sums then go to `out` (zeroed by the
// caller) with global atomicAdd. The segment axis is tiled so that
// (segments x K x 4 B) fits the block's shared memory (the selfcal Hessian's
// B^2 = 1089 segments x 81 floats is 353 KB and does not fit whole), at one
// extra pass over the chunk per segment tile. Bound on an H100: reading
// O x K floats once per segment tile, plus the atomics. Atomics make the
// order of the sums change from run to run: results agree to f32 rounding,
// not bit for bit.
//
// mavmap_seg_accum_sorted replaces seg_accum_sorted (_sorted_kernel): the
// same sum for observations sorted by a gapless dense point id. The TPU
// kernel needs a banded one-hot per 1024-row tile, a carry row between
// tiles and a gather epilogue; with the CSR offsets that the host builds
// with the problem (offsets[s] .. offsets[s+1] are segment s's rows) it is a
// plain segmented reduction: one thread per (segment, column), so a warp
// covers a group of consecutive segments and reads their contiguous rows.
// No carry, no atomics, deterministic. Bound: one read of O x K floats
// (tracks are short, so the per-thread loops are a few rows long).

#include <cuda_runtime.h>

namespace {

constexpr int FULL_THREADS = 256;
constexpr int FULL_SMEM_FLOATS = 24576;  // 96 KB accumulator per block
constexpr int SORTED_THREADS = 256;

__global__ void __launch_bounds__(FULL_THREADS)
seg_full_kernel(const float* __restrict__ contrib, const int* __restrict__ ids, int O,
                int K, int S, int seg_tile, int rows_per_block, float* __restrict__ out) {
  extern __shared__ float acc[];
  const int s0 = blockIdx.y * seg_tile;
  const int nseg = min(seg_tile, S - s0);
  for (int e = threadIdx.x; e < nseg * K; e += FULL_THREADS) acc[e] = 0.f;
  __syncthreads();

  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min((long long)O, r0 + rows_per_block);
  for (long long e = r0 * K + threadIdx.x; e < r1 * K; e += FULL_THREADS) {
    const long long row = e / K;
    const int col = (int)(e - row * K);
    const int rel = ids[row] - s0;
    if (rel >= 0 && rel < nseg) {
      const float v = contrib[e];
      if (v != 0.f) atomicAdd(&acc[rel * K + col], v);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nseg * K; e += FULL_THREADS) {
    const float v = acc[e];
    if (v != 0.f) atomicAdd(&out[(long long)s0 * K + e], v);
  }
}

__global__ void __launch_bounds__(SORTED_THREADS)
seg_sorted_kernel(const float* __restrict__ contrib, const int* __restrict__ offsets,
                  int S, int K, float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * SORTED_THREADS + threadIdx.x;
  if (t >= (long long)S * K) return;
  const int s = (int)(t / K);
  const int col = (int)(t - (long long)s * K);
  const int a = offsets[s], b = offsets[s + 1];
  float acc = 0.f;
  for (int r = a; r < b; ++r) acc += contrib[(long long)r * K + col];
  out[t] = acc;
}

}  // namespace

extern "C" {

// out (S, K) must be zero on entry. Segment ids outside [0, S) are dropped.
int mavmap_seg_accum_full(const float* contrib, const int* ids, int O, int K, int S,
                          float* out, cudaStream_t stream) {
  if (O == 0 || S == 0 || K == 0) return (int)cudaGetLastError();
  const int seg_tile = min(S, max(1, FULL_SMEM_FLOATS / K));
  const int n_seg_tiles = (S + seg_tile - 1) / seg_tile;
  // About two waves of blocks over 132 SMs, at least 64 rows per block.
  const int target_x = max(1, 264 / n_seg_tiles);
  const int rows_per_block = max(64, (O + target_x - 1) / target_x);
  const dim3 grid((O + rows_per_block - 1) / rows_per_block, n_seg_tiles);
  const size_t smem = sizeof(float) * (size_t)seg_tile * K;
  cudaFuncSetAttribute(seg_full_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)(sizeof(float) * FULL_SMEM_FLOATS));
  seg_full_kernel<<<grid, FULL_THREADS, smem, stream>>>(contrib, ids, O, K, S, seg_tile,
                                                        rows_per_block, out);
  return (int)cudaGetLastError();
}

// offsets (S + 1,) nondecreasing; out (S, K) is fully written.
int mavmap_seg_accum_sorted(const float* contrib, const int* offsets, int S, int K,
                            float* out, cudaStream_t stream) {
  const long long n = (long long)S * K;
  if (n == 0) return (int)cudaGetLastError();
  const int blocks = (int)((n + SORTED_THREADS - 1) / SORTED_THREADS);
  seg_sorted_kernel<<<blocks, SORTED_THREADS, 0, stream>>>(contrib, offsets, S, K, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
