// Segment sums for the bundle-adjustment normal equations.
//
// mavmap_seg_accum_full replaces mavmap_tpu/ops/pallas/ba_accum.py
// seg_accum_full (_full_kernel): out[s, :] = sum over o with ids[o] == s of
// contrib[o, :], ids in any order. On the TPU it is a one-hot MXU product
// with the (S, K) accumulator resident in VMEM across a sequential grid,
// which adds in the same order on every run. Here the host builds a plan
// once per problem (ops/cuda/ba_accum.py make_plan): `order`, the rows
// stably sorted by id, and each segment cut into pieces of at most
// PIECE_ROWS rows, so a segment that holds half the rows (the camera block
// of a self-calibrating problem) spreads over many blocks instead of one.
//   pass 1 (seg_pieces_kernel): one block per piece. It stages the piece's
//     row indices in shared memory, and each thread (q, c) of a G x KC
//     layout adds rows q, q+G, q+2G, ... of column c in that order (eight
//     loads in flight), then a tree of fixed shape adds the G lanes: one
//     partial row per piece.
//   pass 2 (seg_merge_kernel): one block per segment adds the segment's
//     pieces in the same way (G lanes over the pieces in ascending order,
//     the same fixed tree) and writes every output row, empty segments
//     included (as zeros).
// No memset, no atomics, no contention on a crowded segment, and the same
// bits on every run: the order of every addition is fixed by the plan and
// the launch shape, which the host derives from the plan alone.
//   one pass (mavmap_seg_accum_one_pass): a plan whose longest segment
//     is short for its segment count (make_plan's one_pass_limit, from
//     the plan alone) is summed by seg_rows_kernel<true, ...>, K3's kernel
//     with the rows gathered through `order`: one thread per (segment,
//     column), one launch, no atomics. The per-(point, block) plans of
//     the dense steps have ~10^5 segments of a few rows each, mostly
//     empty; the two passes spent a block on each of them in pass 2 and a
//     256-thread block on each piece of one or two rows in pass 1. The
//     rows are added in plan order from 0.0, the order of the planned
//     plain version (index_add_) on the CPU, so this path gives its bits.
//     Its time grows with the longest segment, whose thread adds the rows
//     one after another (~80 ns a row past the first 2 ROW_BATCH), while
//     the two passes' grows with the segment count: make_plan weighs the
//     two (ops/cuda/ba_accum.py ONE_PASS_ROWS, with the measurements).
//     A thread of an empty segment still waits for its offsets before it
//     writes its zero, so on a plan whose segments are mostly empty the
//     kernel wrote at ~1.2 TB/s and lost to index_add_ (a memset, then
//     the rows added). There (make_plan's `sparse`) the output is zeroed
//     by cudaMemsetAsync first and the kernel (SCATTER) runs over the
//     non-empty segments alone, writing each one's row; the bits are the
//     same (benchmarks/torch_k2_paths.py's sparse plans time both).
// Bound on an H100: one read of O x K floats and of the row indices, one
// write of S x K. The rows are gathered through `order`: a row of K floats
// is K*4 bytes at an arbitrary offset, so at K = 3..9 each row touches one
// or two 32-byte sectors for 12..36 useful bytes, which the L2 softens when
// the contributions were just written (they fit its 50 MB below ~12M
// floats); at K = 81 a row is ten sectors and the gather costs little.
// Shared memory is static and under 48 KB, so no launch needs
// cudaFuncSetAttribute: a CUDA runtime call, host time on every launch
// that makes it.
//
// mavmap_seg_accum_sorted replaces seg_accum_sorted (_sorted_kernel): the
// same sum for observations sorted by a gapless dense point id. The TPU
// kernel multiplies each 1024-row tile by a banded one-hot, carries the
// last segment's partial row into the next tile and gathers each segment's
// total from its last tile in an epilogue. Here the host builds the CSR
// offsets with the problem (offsets[s] .. offsets[s+1] are segment s's
// rows), and seg_rows_kernel gives one thread to each (segment, column):
// it reads the segment's two offsets, starts the loads of its first
// ROW_BATCH rows at once (rows past the segment's end load its last row
// again, a valid address whose value is never added, so no branch splits
// the warp), then adds them in row order from 0.0; a longer segment takes
// a second batch the same way, and rows past 2 ROW_BATCH are added one by
// one. The additions are a sequential loop over the rows, the order of
// index_add_ on the CPU: the kernel gives the bits of the plain version run
// on the CPU, on every run, and needs no memset and no atomics.
// Bound on an H100: one read of O x K floats and of the offsets, one write
// of S x K floats. At the mapper's sizes (at most a few MB) two dependent
// rounds of loads (offsets, then rows) and the launch set the time. A
// loop of one dependent load per row makes a warp wait for its longest
// track; here the loads of up to 2 ROW_BATCH rows are in flight together.
// Staging groups of whole segments in shared memory and adding from there
// was slower at the survey's shape (benchmarks/torch_k3_designs.py).
// The one-pass path of K2 is the same kernel (GATHER = true): one more
// dependent round of loads (offsets, order, rows); K3's instance
// (GATHER = false) computes the same addresses it always did.

#include <cuda_runtime.h>

namespace {

constexpr int PIECE_THREADS = 256;      // pass 1 block
constexpr int PIECE_ROWS = 256;         // ops/cuda/ba_accum.py PIECE_ROWS
constexpr int MERGE_MAX_THREADS = 1024;  // pass 2 block, at most
constexpr int SORTED_THREADS = 256;
constexpr int ROW_BATCH = 8;            // rows of a segment whose loads go out together

// Column sums of n rows of src (K columns): the i-th row is rows[i]
// (GATHER) or base + i. Thread t is lane q = t / KC of column c = t % KC
// (G lanes, KC columns at a time); lane q adds rows q, q+G, q+2G, ... in
// that order, then a tree of fixed shape over the lanes (its first step
// folds lanes >= P/2 for P the power of two >= G) leaves the sum in lane 0,
// which writes dst[column]. Every thread of the block must call it.
template <bool GATHER>
__device__ __forceinline__ void column_sums(const float* __restrict__ src,
                                            const int* __restrict__ rows, int base, int n,
                                            int K, int KC, int G, float* red,
                                            float* __restrict__ dst) {
  const int q = threadIdx.x / KC;
  const int c = threadIdx.x - q * KC;
  int P = 1;
  while (P < G) P <<= 1;
  for (int c0 = 0; c0 < K; c0 += KC) {
    const int col = c0 + c;
    const bool active = q < G && col < K;
    if (active) {
      float acc = 0.f;
      int i = q;
      for (; i + 7 * G < n; i += 8 * G) {
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int r = GATHER ? rows[i + u * G] : base + i + u * G;
          v[u] = src[(size_t)r * K + col];
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) acc += v[u];
      }
      for (; i < n; i += G) {
        const int r = GATHER ? rows[i] : base + i;
        acc += src[(size_t)r * K + col];
      }
      red[q * KC + c] = acc;
    }
    __syncthreads();
    for (int s = P >> 1; s >= 1; s >>= 1) {
      if (active && q < s && q + s < G) red[q * KC + c] += red[(q + s) * KC + c];
      __syncthreads();
    }
    if (active && q == 0) dst[col] = red[c];
    __syncthreads();  // red is reused by the next column chunk
  }
}

__global__ void __launch_bounds__(PIECE_THREADS)
seg_pieces_kernel(const float* __restrict__ contrib, const int* __restrict__ order,
                  const int* __restrict__ piece_starts, int K, int KC, int G,
                  float* __restrict__ partial) {
  __shared__ int rows[PIECE_ROWS];
  __shared__ float red[PIECE_THREADS];
  const int p = blockIdx.x;
  const int a = piece_starts[p];
  const int n = piece_starts[p + 1] - a;
  for (int i = threadIdx.x; i < n; i += PIECE_THREADS) rows[i] = order[a + i];
  __syncthreads();
  column_sums<true>(contrib, rows, 0, n, K, KC, G, red, partial + (size_t)p * K);
}

__global__ void __launch_bounds__(MERGE_MAX_THREADS)
seg_merge_kernel(const float* __restrict__ partial, const int* __restrict__ seg_pieces,
                 int K, int KC, int G, float* __restrict__ out) {
  __shared__ float red[MERGE_MAX_THREADS];
  const int s = blockIdx.x;
  const int a = seg_pieces[s];
  column_sums<false>(partial, nullptr, a, seg_pieces[s + 1] - a, K, KC, G, red,
                     out + (size_t)s * K);
}

// Thread t sums column t % K of segment t / K (t < S K, checked by the
// caller to fit an int). The i-th row of segment s is row a + i, a =
// offsets[s] (K3), or row order[a + i] (GATHER: K2's one-pass path). The
// sum goes to output row s, or to row out_rows[s] (SCATTER: the one-pass
// path over the non-empty segments of a plan whose segments are mostly
// empty).
template <bool GATHER, bool SCATTER>
__global__ void __launch_bounds__(SORTED_THREADS)
seg_rows_kernel(const float* __restrict__ contrib, const int* __restrict__ order,
                const int* __restrict__ offsets, const int* __restrict__ out_rows, int S,
                int K, float* __restrict__ out) {
  const int t = blockIdx.x * SORTED_THREADS + threadIdx.x;
  if (t >= S * K) return;
  const int s = t / K;
  const int col = t - s * K;
  const long long dst = SCATTER ? (long long)__ldg(out_rows + s) * K + col : t;
  const int a = __ldg(offsets + s);
  const int n = __ldg(offsets + s + 1) - a;
  float acc = 0.f;
  if (GATHER && n == 1) {
    // One row (most segments of the per-(point, block) plans): one load of
    // its index and one of its value, not a batch of clamped loads.
    acc += __ldg(contrib + (long long)__ldg(order + a) * K + col);
  } else if (n > 0) {
    const float* p = contrib + (GATHER ? 0 : (long long)a * K) + col;
    const int* rows = order + a;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (q > 0 && n <= ROW_BATCH) break;
      float v[ROW_BATCH];
#pragma unroll
      for (int u = 0; u < ROW_BATCH; ++u) {
        const int i = min(q * ROW_BATCH + u, n - 1);
        v[u] = __ldg(p + (long long)(GATHER ? __ldg(rows + i) : i) * K);
      }
#pragma unroll
      for (int u = 0; u < ROW_BATCH; ++u) acc = q * ROW_BATCH + u < n ? acc + v[u] : acc;
    }
    for (int i = 2 * ROW_BATCH; i < n; ++i)
      acc += __ldg(p + (long long)(GATHER ? __ldg(rows + i) : i) * K);
  }
  out[dst] = acc;
}

}  // namespace

extern "C" {

// The plan's order (rows with ids in [0, S), sorted by id), piece_starts
// (n_pieces + 1) and seg_pieces (S + 1), as make_plan builds them, with
// max_pieces the most pieces of one segment. partial (n_pieces, K) is
// scratch; out (S, K) is fully written.
int mavmap_seg_accum_full(const float* contrib, const int* order, const int* piece_starts,
                          int n_pieces, const int* seg_pieces, int S, int K, int max_pieces,
                          float* partial, float* out, cudaStream_t stream) {
  if (S == 0 || K == 0) return (int)cudaGetLastError();
  if (n_pieces > 0) {
    const int kc = min(K, PIECE_THREADS);
    seg_pieces_kernel<<<n_pieces, PIECE_THREADS, 0, stream>>>(
        contrib, order, piece_starts, K, kc, PIECE_THREADS / kc, partial);
  }
  // Pass 2: as many lanes per column as the longest segment has pieces
  // (up to the block), so the camera block's hundreds of pieces are not
  // added by one thread each.
  const int kc = min(K, MERGE_MAX_THREADS);
  const int g = max(1, min(max_pieces, MERGE_MAX_THREADS / kc));
  const int threads = (kc * g + 31) / 32 * 32;
  seg_merge_kernel<<<S, threads, 0, stream>>>(partial, seg_pieces, K, kc, g, out);
  return (int)cudaGetLastError();
}

// offsets (S + 1,) nondecreasing, S K < 2^31; out (S, K) is fully written.
int mavmap_seg_accum_sorted(const float* contrib, const int* offsets, int S, int K,
                            float* out, cudaStream_t stream) {
  const long long n = (long long)S * K;
  if (n == 0) return (int)cudaGetLastError();
  const int blocks = (int)((n + SORTED_THREADS - 1) / SORTED_THREADS);
  seg_rows_kernel<false, false><<<blocks, SORTED_THREADS, 0, stream>>>(contrib, nullptr, offsets,
                                                                       nullptr, S, K, out);
  return (int)cudaGetLastError();
}

// K2's one-pass path, out (S, K) fully written, segment s being the rows
// order[seg_offsets[s]:seg_offsets[s + 1]] added in that order from 0.0.
// Not sparse: offsets is the plan's seg_offsets (n = S segments), one
// thread per (segment, column). sparse: the plan is mostly empty; out is
// zeroed and its n non-empty segments are summed, out_rows (n,) naming
// each one's segment and offsets (n + 1) their CSR offsets into order
// (make_plan's filled, filled_offsets). S K < 2^31.
int mavmap_seg_accum_one_pass(const float* contrib, const int* order, const int* offsets,
                              const int* out_rows, int sparse, int n, int S, int K,
                              float* out, cudaStream_t stream) {
  const long long items = (long long)n * K;
  if ((long long)S * K == 0) return (int)cudaGetLastError();
  const int blocks = (int)((items + SORTED_THREADS - 1) / SORTED_THREADS);
  if (sparse) {
    cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)S * K, stream);
    if (err != cudaSuccess) return (int)err;
    if (items > 0)
      seg_rows_kernel<true, true><<<blocks, SORTED_THREADS, 0, stream>>>(
          contrib, order, offsets, out_rows, n, K, out);
  } else {
    seg_rows_kernel<true, false><<<blocks, SORTED_THREADS, 0, stream>>>(
        contrib, order, offsets, nullptr, n, K, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
