// Fused brute-force descriptor matcher: both-direction 2-NN statistics.
//
// Replaces the Pallas kernel mavmap_tpu/ops/pallas/match.py
// (_match_pallas_raw / _match_kernel). Per (row i of d1, column j of d2):
//   dist = max(|d1_i|^2 + pen2_j - 2 d1_i.d2_j, 0) + rowpen_i
//   dist = BIG where the keypoint separation exceeds max_distance (prefilter)
// with pen2 = |d2_j|^2 (+ BIG for masked columns) and rowpen = BIG for masked
// rows, and reduces it to the per-row best/second/argmin and the per-column
// best/second/argmin. The (N1, N2) distance matrix never reaches device
// memory.
//
// What bounds it on an H100: 2*N1*N2*D flops (0.27 GFLOP at 1024x1024x128)
// in IEEE f32 FMAs on the CUDA cores (no TF32: ties decide matches) — a few
// tens of microseconds at the f32 rate; the d2 re-reads come from L2.
//
// Design. The TPU kernel walks row tiles in order and carries the running
// column top-2 in VMEM across the sequential grid. CUDA blocks run in no
// order, so the column reduction is split in two passes:
//   pass 1 (mavmap_match_tiles): one block per TM-row tile of d1; the tile
//     sits in shared memory and the block loops over d2 in TN-column chunks
//     staged in shared memory (all of d2 is 512 KB, more than a block's
//     227 KB). Each thread owns one column of the chunk and TM/4 rows. Rows
//     keep a running top-2+argmin in registers, reduced across the block at
//     the end; each chunk's column top-2 over the tile's rows is written as
//     a per-tile partial (n_tiles, 2, N2) + (n_tiles, N2).
//   pass 2 (mavmap_match_merge_cols): one thread per column merges the
//     partials over row tiles in ascending tile order with strict '<', so
//     ties keep the lower row index, as jnp.argmin and the TPU kernel do.
// Every merge of two partial top-2 sets breaks ties on the index, so the
// result does not depend on the order in which threads meet.

#include <cuda_runtime.h>

namespace {

constexpr int TM = 16;        // d1 rows per block
constexpr int TN = 64;        // d2 columns per chunk (one per thread column)
constexpr int THREADS = 256;  // TN x 4 thread rows; each thread row owns TM/4 rows
constexpr int RPT = TM / 4;   // rows per thread
constexpr float BIG = 1e30f;  // mask penalty, as in the TPU kernel
constexpr int NO_ARG = 0x7fffffff;

struct Top2 {
  float best, second;
  int arg;
};

__device__ __forceinline__ void push(Top2& t, float d, int idx) {
  // Sequential update in ascending idx: strict '<' keeps the first minimum.
  if (d < t.best) {
    t.second = t.best;
    t.best = d;
    t.arg = idx;
  } else if (d < t.second) {
    t.second = d;
  }
}

__device__ __forceinline__ Top2 merge(Top2 a, Top2 b) {
  // Top-2 of the union of two disjoint index sets; equal minima go to the
  // lower index.
  if (b.best < a.best || (b.best == a.best && b.arg < a.arg)) {
    return Top2{b.best, fminf(b.second, a.best), b.arg};
  }
  return Top2{a.best, fminf(a.second, b.best), a.arg};
}

__device__ __forceinline__ Top2 warp_merge(Top2 t) {
  for (int off = 16; off > 0; off >>= 1) {
    Top2 o;
    o.best = __shfl_xor_sync(0xffffffffu, t.best, off);
    o.second = __shfl_xor_sync(0xffffffffu, t.second, off);
    o.arg = __shfl_xor_sync(0xffffffffu, t.arg, off);
    t = merge(t, o);
  }
  return t;
}

__global__ void __launch_bounds__(THREADS)
match_tiles_kernel(const float* __restrict__ d1, const float* __restrict__ d2,
                   const float* __restrict__ rowpen,
                   const float* __restrict__ pen2,
                   const float* __restrict__ kp1, const float* __restrict__ kp2,
                   float maxd2, int use_kp, int N2, int D,
                   int* __restrict__ row_arg, float* __restrict__ row_d,
                   float* __restrict__ part_d, int* __restrict__ part_arg) {
  extern __shared__ float smem[];
  float* s1 = smem;                  // TM x D      (d1 tile)
  float* s2 = smem + TM * D;         // TN x (D+1)  (d2 chunk, padded rows)
  __shared__ float s_n1[TM], s_rp[TM], s_k1x[TM], s_k1y[TM];
  __shared__ Top2 s_col[4][TN];
  __shared__ Top2 s_row[TM][2];

  const int tx = threadIdx.x % TN;
  const int ty = threadIdx.x / TN;
  const int tile = blockIdx.x;
  const int r0 = tile * TM;

  for (int e = threadIdx.x; e < TM * D; e += THREADS) s1[e] = d1[(size_t)r0 * D + e];
  __syncthreads();
  if (threadIdx.x < TM) {
    const int r = threadIdx.x;
    float acc = 0.f;
    for (int k = 0; k < D; ++k) acc = fmaf(s1[r * D + k], s1[r * D + k], acc);
    s_n1[r] = acc;
    s_rp[r] = rowpen[r0 + r];
    if (use_kp) {
      s_k1x[r] = kp1[2 * (r0 + r)];
      s_k1y[r] = kp1[2 * (r0 + r) + 1];
    }
  }

  Top2 rows[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) rows[i] = Top2{INFINITY, INFINITY, NO_ARG};

  for (int c0 = 0; c0 < N2; c0 += TN) {
    __syncthreads();  // previous chunk fully consumed (and s_n1 ready)
    for (int e = threadIdx.x; e < TN * D; e += THREADS) {
      const int col = e / D, k = e - col * D;
      s2[col * (D + 1) + k] = d2[(size_t)(c0 + col) * D + k];
    }
    __syncthreads();

    float acc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
    const float* b = s2 + tx * (D + 1);
    for (int k = 0; k < D; ++k) {
      const float bk = b[k];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = fmaf(s1[(ty + 4 * i) * D + k], bk, acc[i]);
    }

    const int c = c0 + tx;
    const float p2 = pen2[c];
    float k2x = 0.f, k2y = 0.f, k2sq = 0.f;
    if (use_kp) {
      k2x = kp2[2 * c];
      k2y = kp2[2 * c + 1];
      k2sq = __fadd_rn(__fmul_rn(k2x, k2x), __fmul_rn(k2y, k2y));
    }
    Top2 col{INFINITY, INFINITY, NO_ARG};
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + 4 * i;
      float d = fmaxf(__fsub_rn(__fadd_rn(s_n1[r], p2), __fmul_rn(2.f, acc[i])), 0.f);
      d = __fadd_rn(d, s_rp[r]);
      if (use_kp) {
        const float k1sq = __fadd_rn(__fmul_rn(s_k1x[r], s_k1x[r]), __fmul_rn(s_k1y[r], s_k1y[r]));
        const float kc = __fadd_rn(__fmul_rn(s_k1x[r], k2x), __fmul_rn(s_k1y[r], k2y));
        const float sep = __fsub_rn(__fadd_rn(k1sq, k2sq), __fmul_rn(2.f, kc));
        if (!(sep <= maxd2)) d = BIG;
      }
      push(rows[i], d, c);
      push(col, d, r0 + r);  // rows visited in ascending order
    }
    s_col[ty][tx] = col;
    __syncthreads();
    if (ty == 0) {
      Top2 m = merge(merge(s_col[0][tx], s_col[1][tx]), merge(s_col[2][tx], s_col[3][tx]));
      part_d[((size_t)tile * 2) * N2 + c] = m.best;
      part_d[((size_t)tile * 2 + 1) * N2 + c] = m.second;
      part_arg[(size_t)tile * N2 + c] = m.arg;
    }
  }

  // Row direction: each row's TN columns live in two warps (tx < 32, >= 32).
  const int half = tx / 32;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    Top2 m = warp_merge(rows[i]);
    if ((tx & 31) == 0) s_row[ty + 4 * i][half] = m;
  }
  __syncthreads();
  if (threadIdx.x < TM) {
    const int r = threadIdx.x;
    Top2 m = merge(s_row[r][0], s_row[r][1]);
    row_arg[r0 + r] = m.arg;
    row_d[2 * (r0 + r)] = m.best;
    row_d[2 * (r0 + r) + 1] = m.second;
  }
}

__global__ void merge_cols_kernel(const float* __restrict__ part_d,
                                  const int* __restrict__ part_arg, int n_tiles,
                                  int N2, int* __restrict__ col_arg,
                                  float* __restrict__ col_d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= N2) return;
  float rb = part_d[c], rs = part_d[N2 + c];
  int ra = part_arg[c];
  for (int t = 1; t < n_tiles; ++t) {
    const float tb = part_d[(size_t)(2 * t) * N2 + c];
    const float ts = part_d[(size_t)(2 * t + 1) * N2 + c];
    const int ta = part_arg[(size_t)t * N2 + c];
    // Same update as the TPU kernel's _merge (match.py:100-103).
    const float nrs = fminf(fmaxf(rb, tb), fminf(rs, ts));
    if (tb < rb) ra = ta;
    rb = fminf(rb, tb);
    rs = nrs;
  }
  col_arg[c] = ra;
  col_d[c] = rb;
  col_d[N2 + c] = rs;
}

}  // namespace

extern "C" {

size_t mavmap_match_smem_bytes(int D) {
  return sizeof(float) * ((size_t)TM * D + (size_t)TN * (D + 1));
}

// Pass 1. N1 % TM == 0 and N2 % TN == 0 (the wrapper pads). Outputs:
// row_arg (N1,), row_d (N1, 2) = [best, second], part_d (N1/TM, 2, N2),
// part_arg (N1/TM, N2).
int mavmap_match_tiles(const float* d1, const float* d2, const float* rowpen,
                       const float* pen2, const float* kp1, const float* kp2,
                       float maxd2, int use_kp, int N1, int N2, int D,
                       int* row_arg, float* row_d, float* part_d, int* part_arg,
                       cudaStream_t stream) {
  const size_t smem = mavmap_match_smem_bytes(D);
  cudaFuncSetAttribute(match_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  match_tiles_kernel<<<N1 / TM, THREADS, smem, stream>>>(
      d1, d2, rowpen, pen2, kp1, kp2, maxd2, use_kp, N2, D, row_arg, row_d, part_d,
      part_arg);
  return (int)cudaGetLastError();
}

// Pass 2: col_arg (N2,), col_d (2, N2) = [best; second].
int mavmap_match_merge_cols(const float* part_d, const int* part_arg, int n_tiles,
                            int N2, int* col_arg, float* col_d, cudaStream_t stream) {
  merge_cols_kernel<<<(N2 + 255) / 256, 256, 0, stream>>>(part_d, part_arg, n_tiles, N2,
                                                          col_arg, col_d);
  return (int)cudaGetLastError();
}

}  // extern "C"
