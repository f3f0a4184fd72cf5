// Fused brute-force descriptor matcher: both-direction 2-NN statistics.
//
// Replaces the Pallas kernel mavmap_tpu/ops/pallas/match.py
// (_match_pallas_raw / _match_kernel). Per (row i of d1, column j of d2):
//   dist = max(|d1_i|^2 + pen2_j - 2 d1_i.d2_j, 0) + rowpen_i
//   dist = BIG where the keypoint separation exceeds max_distance (prefilter)
// with pen2 = |d2_j|^2 (+ BIG for masked columns) and rowpen = BIG for masked
// rows, and reduces it to the per-row best/second/argmin and the per-column
// best/second/argmin, ties to the lower index. The (N1, N2) distance matrix
// never reaches device memory.
//
// What bounds it on an H100: 2*N1*N2*D flops (0.27 GFLOP at 1024x1024x128
// with the prefilter's keypoint products) in IEEE f32 FMAs on the CUDA cores
// — no TF32, because the ratio test and the cross-check decide on near-equal
// distances — which is 4.07 us at 67 TFLOP/s; its 1.1 MB of operands take
// 0.34 us of HBM time and do not bind.
//
// Design. The TPU kernel walks row tiles in order and carries the running
// column top-2 in VMEM across the sequential grid. CUDA blocks run in no
// order, so both directions reduce to partials that a second launch merges:
//   pass 1 (match_tile_kernel): a 2-D grid of 64 x 64 output tiles (256
//     blocks at 1024^2, about two per SM). The tile's d1 and d2 rows are
//     staged in shared memory 32 dims at a time, double-buffered with
//     16-byte cp.async copies, so the next chunk loads while this one is
//     used. Each of the 256 threads keeps a 4 x 4 register tile of dot
//     products (rows ty + 16 i, columns tx + 16 j) and reads its operands
//     as float4 along the descriptor: per 4 dims, 8 shared-memory loads feed
//     64 FMAs. The rows' squared norms accumulate from the same stages (64
//     threads, float4 loads, dims in ascending order). The padded row stride
//     of 36 floats keeps 8 consecutive rows' float4 on distinct banks.
//     Epilogue in registers: the distance, penalty and prefilter arithmetic
//     of the plain version in round-to-nearest ops, a top-2 per row over the
//     tile's columns (shuffles across the 16 threads that share the rows)
//     and per column over the tile's rows (a shuffle, then the 8 warps
//     through shared memory), written as per-tile partials: rows
//     (N2/64, N1, 2 + arg), columns (N1/64, N2, 2 + arg).
//   pass 2 (match_merge_kernel): one thread per row and per column merges
//     its partials in ascending tile order.
// Batch axis (the TPU kernel under jax.vmap, as register_view_batch,
// register_view_pairs, two_view_init_batch and the loop-closure pre-gates
// run it): blockIdx.z is the slot in both launches. Each side has its own
// batch flag; a side that every slot shares (the current image of
// register_view_batch, the first image of two_view_init_batch, the query
// of a match-count pre-gate) is read from the same rows by every slot.
// Scratch and outputs carry a leading slot axis. A slot runs exactly the
// arithmetic of a single-pair launch, which is the launch with one slot. Both
// kernels are templates on kBatched: the launch with one slot takes the
// instance without the per-slot pointer offsets (on an H100 they made the
// single-pair launch 1.6 us slower, 16.2-16.7 -> 17.8-18.3 us, when computed
// at run time: benchmarks/torch_k1_ab.py), so its code is that of the
// kernel before the slot axis.
// Every merge of two partial top-2 sets keeps the exact top-2 of the union
// and breaks equal minima on the index, so the result does not depend on
// the order in which threads meet, and ties go to the lower index as
// jnp.argmin and the TPU kernel give them.
// Shared memory is static and under 48 KB, so no launch needs
// cudaFuncSetAttribute: a CUDA runtime call, host time on every launch
// that makes it.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;       // d1 rows per tile
constexpr int BN = 64;       // d2 rows (distance columns) per tile
constexpr int BK = 32;       // descriptor dims per shared-memory stage
constexpr int LDS = BK + 4;  // padded row stride in shared memory (floats)
// 4 x 4 outputs per thread, 256 threads: an 8 x 8 tile per thread (64
// threads, half the shared-memory loads per FMA) took 1.5x as long on an
// H100, its 4 warps per SM too few to hide the loads' latency.
constexpr int TR = 4;              // rows per thread: ty + TY i
constexpr int TC = 4;              // columns per thread: tx + TX j
constexpr int TX = BN / TC;        // threads along a row (a power of two <= 32)
constexpr int TY = BM / TR;        // threads along a column
constexpr int THREADS = TX * TY;
static_assert(TX <= 32 && (TX & (TX - 1)) == 0 && THREADS % 32 == 0 && THREADS >= BM,
              "thread tile");
constexpr int MERGE_THREADS = 256;
constexpr float BIG = 1e30f;  // mask penalty, as in the TPU kernel
constexpr int NO_ARG = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

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

__device__ __forceinline__ Top2 shfl_merge(Top2 t, int lane_mask) {
  Top2 o;
  o.best = __shfl_xor_sync(FULL, t.best, lane_mask);
  o.second = __shfl_xor_sync(FULL, t.second, lane_mask);
  o.arg = __shfl_xor_sync(FULL, t.arg, lane_mask);
  return merge(t, o);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <bool kBatched>
__global__ void __launch_bounds__(THREADS)
match_tile_kernel(const float* __restrict__ d1, const float* __restrict__ d2,
                  const float* __restrict__ rowpen, const float* __restrict__ pen2,
                  const float* __restrict__ kp1, const float* __restrict__ kp2,
                  float maxd2, int use_kp, int batch1, int batch2, int N1, int N2, int D,
                  float* __restrict__ row_part_d, int* __restrict__ row_part_arg,
                  float* __restrict__ col_part_d, int* __restrict__ col_part_arg) {
  __shared__ __align__(16) float sA[2][BM * LDS];
  __shared__ __align__(16) float sB[2][BN * LDS];
  __shared__ float s_n1[BM];
  __shared__ Top2 s_col[THREADS / 32][BN];

  if constexpr (kBatched) {
    // This slot's operands (a shared side stays at slot 0) and partials.
    const size_t b = blockIdx.z;
    const size_t b1 = batch1 ? b : 0, b2 = batch2 ? b : 0;
    d1 += b1 * N1 * D;
    rowpen += b1 * N1;
    d2 += b2 * N2 * D;
    pen2 += b2 * N2;
    if (use_kp) {
      kp1 += b1 * 2 * N1;
      kp2 += b2 * 2 * N2;
    }
    row_part_d += b * (N2 / BN) * N1 * 2;
    row_part_arg += b * (N2 / BN) * N1;
    col_part_d += b * (N1 / BM) * N2 * 2;
    col_part_arg += b * (N1 / BM) * N2;
  }

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int r0 = blockIdx.y * BM;
  const int c0 = blockIdx.x * BN;
  const float* gA = d1 + (size_t)r0 * D;
  const float* gB = d2 + (size_t)c0 * D;

  // One stage: 64 rows x 8 float4 of each operand.
  auto load_stage = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < BM * BK / 4 / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int row = e >> 3;
      const int c4 = (e & 7) * 4;
      cp_async16(&sA[buf][row * LDS + c4], gA + (size_t)row * D + k0 + c4);
      cp_async16(&sB[buf][row * LDS + c4], gB + (size_t)row * D + k0 + c4);
    }
    cp_async_commit();
  };

  float acc[TR][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;
  float n1 = 0.f;

  const int nk = D / BK;
  load_stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_stage((kt + 1) & 1, (kt + 1) * BK);  // its buffer was freed by the last sync
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* A = sA[kt & 1];
    const float* B = sB[kt & 1];
    if (tid < BM) {
#pragma unroll
      for (int k = 0; k < BK; k += 4) {
        const float4 v = *reinterpret_cast<const float4*>(&A[tid * LDS + k]);
        n1 = fmaf(v.x, v.x, n1);
        n1 = fmaf(v.y, v.y, n1);
        n1 = fmaf(v.z, v.z, n1);
        n1 = fmaf(v.w, v.w, n1);
      }
    }
#pragma unroll
    for (int k = 0; k < BK; k += 4) {
      float4 a[TR], b[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        a[i] = *reinterpret_cast<const float4*>(&A[(ty + TY * i) * LDS + k]);
#pragma unroll
      for (int j = 0; j < TC; ++j)
        b[j] = *reinterpret_cast<const float4*>(&B[(tx + TX * j) * LDS + k]);
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
        }
    }
    __syncthreads();  // this stage's buffer is refilled two chunks on
  }
  if (tid < BM) s_n1[tid] = n1;
  __syncthreads();

  // Epilogue: distances of the thread's 4 x 4 outputs, row and column top-2.
  float p2[TC], k2x[TC], k2y[TC], k2sq[TC];
#pragma unroll
  for (int j = 0; j < TC; ++j) {
    const int c = c0 + tx + TX * j;
    p2[j] = pen2[c];
    k2x[j] = k2y[j] = k2sq[j] = 0.f;
    if (use_kp) {
      k2x[j] = kp2[2 * c];
      k2y[j] = kp2[2 * c + 1];
      k2sq[j] = __fadd_rn(__fmul_rn(k2x[j], k2x[j]), __fmul_rn(k2y[j], k2y[j]));
    }
  }
  Top2 colt[TC];
#pragma unroll
  for (int j = 0; j < TC; ++j) colt[j] = Top2{INFINITY, INFINITY, NO_ARG};
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = r0 + ty + TY * i;
    const float n1r = s_n1[ty + TY * i];
    const float rp = rowpen[r];
    float k1x = 0.f, k1y = 0.f, k1sq = 0.f;
    if (use_kp) {
      k1x = kp1[2 * r];
      k1y = kp1[2 * r + 1];
      k1sq = __fadd_rn(__fmul_rn(k1x, k1x), __fmul_rn(k1y, k1y));
    }
    Top2 rt{INFINITY, INFINITY, NO_ARG};
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      float d = fmaxf(__fsub_rn(__fadd_rn(n1r, p2[j]), __fmul_rn(2.f, acc[i][j])), 0.f);
      d = __fadd_rn(d, rp);
      if (use_kp) {
        const float kc = __fadd_rn(__fmul_rn(k1x, k2x[j]), __fmul_rn(k1y, k2y[j]));
        const float sep = __fsub_rn(__fadd_rn(k1sq, k2sq[j]), __fmul_rn(2.f, kc));
        if (!(sep <= maxd2)) d = BIG;
      }
      push(rt, d, c0 + tx + TX * j);  // columns in ascending order
      push(colt[j], d, r);            // rows in ascending order
    }
    // The row's 64 columns live in the TX threads of this ty: adjacent
    // lanes of one warp.
#pragma unroll
    for (int m = TX / 2; m >= 1; m >>= 1) rt = shfl_merge(rt, m);
    if (tx == 0) {
      const size_t o = (size_t)blockIdx.x * N1 + r;
      row_part_d[2 * o] = rt.best;
      row_part_d[2 * o + 1] = rt.second;
      row_part_arg[o] = rt.arg;
    }
  }
  // A column's 64 rows live in the TY values of ty: 32 / TX per warp
  // (lanes tx, tx + TX, ...), then the warps through shared memory.
  const int warp = tid >> 5;
#pragma unroll
  for (int j = 0; j < TC; ++j) {
    Top2 m = colt[j];
#pragma unroll
    for (int l = TX; l < 32; l <<= 1) m = shfl_merge(m, l);
    if ((tid & 31) < TX) s_col[warp][tx + TX * j] = m;
  }
  __syncthreads();
  if (tid < BN) {
    Top2 m = s_col[0][tid];
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w) m = merge(m, s_col[w][tid]);
    const size_t o = (size_t)blockIdx.y * N2 + c0 + tid;
    col_part_d[2 * o] = m.best;
    col_part_d[2 * o + 1] = m.second;
    col_part_arg[o] = m.arg;
  }
}

__device__ __forceinline__ Top2 merge_tiles(const float* __restrict__ part_d,
                                            const int* __restrict__ part_arg, int n_tiles,
                                            int N, int t) {
  Top2 m{part_d[2 * t], part_d[2 * t + 1], part_arg[t]};
  for (int k = 1; k < n_tiles; ++k) {
    const size_t o = (size_t)k * N + t;
    m = merge(m, Top2{part_d[2 * o], part_d[2 * o + 1], part_arg[o]});
  }
  return m;
}

template <bool kBatched>
__global__ void __launch_bounds__(MERGE_THREADS)
match_merge_kernel(const float* __restrict__ row_part_d, const int* __restrict__ row_part_arg,
                   const float* __restrict__ col_part_d, const int* __restrict__ col_part_arg,
                   int N1, int N2, int* __restrict__ row_arg, float* __restrict__ row_d,
                   int* __restrict__ col_arg, float* __restrict__ col_d) {
  if constexpr (kBatched) {
    const size_t b = blockIdx.y;  // the slot
    row_part_d += b * (N2 / BN) * N1 * 2;
    row_part_arg += b * (N2 / BN) * N1;
    col_part_d += b * (N1 / BM) * N2 * 2;
    col_part_arg += b * (N1 / BM) * N2;
    row_arg += b * N1;
    row_d += b * N1 * 2;
    col_arg += b * N2;
    col_d += b * 2 * N2;
  }
  const int t = blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (t < N1) {
    const Top2 m = merge_tiles(row_part_d, row_part_arg, N2 / BN, N1, t);
    row_arg[t] = m.arg;
    row_d[2 * t] = m.best;
    row_d[2 * t + 1] = m.second;
  } else if (t < N1 + N2) {
    const int c = t - N1;
    const Top2 m = merge_tiles(col_part_d, col_part_arg, N1 / BM, N2, c);
    col_arg[c] = m.arg;
    col_d[c] = m.best;
    col_d[N2 + c] = m.second;
  }
}

}  // namespace

extern "C" {

// Both launches, for B slots (B = 1: a single pair). N1 % 64 == 0,
// N2 % 64 == 0, D % 32 == 0, and d1/d2 16-byte aligned (the wrapper checks
// and pads). batch1 / batch2: 1 if that side holds one set of rows per slot
// (d1 (B, N1, D), rowpen (B, N1), kp1 (B, N1, 2)), 0 if every slot reads the
// same (N1, D) rows; likewise d2, pen2, kp2. Scratch: row_part_d
// (B, N2/64, N1, 2), row_part_arg (B, N2/64, N1), col_part_d (B, N1/64, N2,
// 2), col_part_arg (B, N1/64, N2). Outputs: row_arg (B, N1), row_d
// (B, N1, 2) = [best, second], col_arg (B, N2), col_d (B, 2, N2) =
// [best; second].
int mavmap_match(const float* d1, const float* d2, const float* rowpen, const float* pen2,
                 const float* kp1, const float* kp2, float maxd2, int use_kp, int B,
                 int batch1, int batch2, int N1, int N2, int D, float* row_part_d,
                 int* row_part_arg, float* col_part_d, int* col_part_arg, int* row_arg,
                 float* row_d, int* col_arg, float* col_d, cudaStream_t stream) {
  if (B <= 0 || B > 65535 || N1 <= 0 || N2 <= 0 || D <= 0 || N1 % BM || N2 % BN || D % BK)
    return (int)cudaErrorInvalidValue;
  const dim3 tiles(N2 / BN, N1 / BM, B), merge((N1 + N2 + MERGE_THREADS - 1) / MERGE_THREADS, B);
  if (B == 1) {
    match_tile_kernel<false><<<tiles, THREADS, 0, stream>>>(
        d1, d2, rowpen, pen2, kp1, kp2, maxd2, use_kp, batch1, batch2, N1, N2, D, row_part_d,
        row_part_arg, col_part_d, col_part_arg);
  } else {
    match_tile_kernel<true><<<tiles, THREADS, 0, stream>>>(
        d1, d2, rowpen, pen2, kp1, kp2, maxd2, use_kp, batch1, batch2, N1, N2, D, row_part_d,
        row_part_arg, col_part_d, col_part_arg);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (B == 1) {
    match_merge_kernel<false><<<merge, MERGE_THREADS, 0, stream>>>(
        row_part_d, row_part_arg, col_part_d, col_part_arg, N1, N2, row_arg, row_d, col_arg,
        col_d);
  } else {
    match_merge_kernel<true><<<merge, MERGE_THREADS, 0, stream>>>(
        row_part_d, row_part_arg, col_part_d, col_part_arg, N1, N2, row_arg, row_d, col_arg,
        col_d);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
