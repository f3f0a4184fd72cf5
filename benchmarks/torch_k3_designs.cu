// Designs of the sorted segment sum (K3) timed against the one that
// mavmap_tpu_torch/csrc/ba_accum.cu ships, by benchmarks/torch_k3_designs.py.
// None of these is part of the package.
//
//   loop      one thread per (segment, column), one dependent load per row:
//             the K3 kernel before the in-flight design.
//   grouped   one block per group of whole consecutive segments (at most
//             R rows and R segments, a longer segment alone): the block
//             stages the group's rows in shared memory (16-byte loads) and
//             one thread per (segment, column) adds them in row order.
//             LOADS_FIRST starts the offsets' loads with the rows' (one
//             round) instead of storing each offset before the rows' loads.
//   empty     an empty kernel: the launch floor, on one block or on the grid
//             of the per-(segment, column) kernels.
//   stream    reads the rows once with coalesced 16-byte loads and writes one
//             float per thread: the time to move the input, no dependency.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAXK = 16;

__global__ void loop_kernel(const float* __restrict__ contrib, const int* __restrict__ offsets,
                            int S, int K, float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * 256 + threadIdx.x;
  if (t >= (long long)S * K) return;
  const int s = (int)(t / K);
  const int col = (int)(t - (long long)s * K);
  const int a = offsets[s], b = offsets[s + 1];
  float acc = 0.f;
  for (int r = a; r < b; ++r) acc += contrib[(long long)r * K + col];
  out[t] = acc;
}

template <int R, int T, bool LOADS_FIRST>
__global__ void __launch_bounds__(T)
grouped_kernel(const float* __restrict__ contrib, const int* __restrict__ offsets,
               const int* __restrict__ group_segs, const int* __restrict__ group_rows, int K,
               float* __restrict__ out) {
  constexpr int NV = (R * MAXK / 4 + T - 1) / T;
  constexpr int NO = (R + 1 + T - 1) / T;
  __shared__ __align__(16) float stage[R * MAXK + 4];
  __shared__ int soff[R + 1];
  const int t = threadIdx.x;
  const int g = blockIdx.x;
  const int seg0 = group_segs[g];
  const int nseg = group_segs[g + 1] - seg0;
  const int row0 = group_rows[g];
  const int row1 = group_rows[g + 1];
  float* dst = out + (long long)seg0 * K;
  if (row1 - row0 > R) {  // one segment longer than a group: chunks, in order
    float acc = 0.f;
    for (int r0 = row0; r0 < row1; r0 += R) {
      const int n = min(R, row1 - r0);
      for (int i = t; i < n * K; i += T) stage[i] = contrib[(long long)r0 * K + i];
      __syncthreads();
      if (t < K)
        for (int r = 0; r < n; ++r) acc += stage[r * K + t];
      __syncthreads();
    }
    if (t < K) dst[t] = acc;
    return;
  }
  if (!LOADS_FIRST)
    for (int i = t; i <= nseg; i += T) soff[i] = offsets[seg0 + i] - row0;
  int o[NO];
  if (LOADS_FIRST) {
#pragma unroll
    for (int u = 0; u < NO; ++u) {
      const int i = t + u * T;
      if (i <= nseg) o[u] = __ldg(offsets + seg0 + i);
    }
  }
  // The span of floats [a, b): float a + i lands at stage[pad + i], which
  // puts its first 16-byte-aligned float on a 16-byte boundary of stage.
  const long long a = (long long)row0 * K, b = (long long)row1 * K;
  const int mis = (int)((reinterpret_cast<uintptr_t>(contrib + a) >> 2) & 3);
  const int h = (int)min((long long)((4 - mis) & 3), b - a);
  const int pad = (4 - h) & 3;
  const long long a4 = a + h;
  const int n4 = (int)((b - a4) >> 2);
  const long long b4 = a4 + 4 * n4;
  const float4* src4 = reinterpret_cast<const float4*>(contrib + a4);
  float4 v[NV];
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    const int i = t + u * T;
    if (i < n4) v[u] = __ldg(src4 + i);
  }
  float head = 0.f, tail = 0.f;
  if (t < h) head = __ldg(contrib + a + t);
  if (t < b - b4) tail = __ldg(contrib + b4 + t);
  if (LOADS_FIRST) {
#pragma unroll
    for (int u = 0; u < NO; ++u) {
      const int i = t + u * T;
      if (i <= nseg) soff[i] = o[u] - row0;
    }
  }
  float4* stage4 = reinterpret_cast<float4*>(stage + pad + h);
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    const int i = t + u * T;
    if (i < n4) stage4[i] = v[u];
  }
  if (t < h) stage[pad + t] = head;
  if (t < b - b4) stage[pad + (b4 - a) + t] = tail;
  __syncthreads();
  for (int j = t; j < nseg * K; j += T) {
    const int s = j / K;
    const int c = j - s * K;
    const int end = soff[s + 1];
    float acc = 0.f;
    for (int r = soff[s]; r < end; ++r) acc += stage[pad + r * K + c];
    dst[j] = acc;
  }
}

__global__ void empty_kernel() {}

__global__ void stream_kernel(const float4* __restrict__ src, long long n4,
                              float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * 256 + threadIdx.x;
  float acc = 0.f;
  for (long long i = t; i < n4; i += (long long)gridDim.x * 256) {
    const float4 v = __ldg(src + i);
    acc += v.x + v.y + v.z + v.w;
  }
  out[t] = acc;
}

template <int R, bool LOADS_FIRST>
void launch_grouped(int T, int n_groups, const float* c, const int* off, const int* gs,
                    const int* gr, int K, float* out, cudaStream_t st) {
  switch (T) {
    case 64: grouped_kernel<R, 64, LOADS_FIRST><<<n_groups, 64, 0, st>>>(c, off, gs, gr, K, out); break;
    case 128: grouped_kernel<R, 128, LOADS_FIRST><<<n_groups, 128, 0, st>>>(c, off, gs, gr, K, out); break;
    case 256: grouped_kernel<R, 256, LOADS_FIRST><<<n_groups, 256, 0, st>>>(c, off, gs, gr, K, out); break;
    case 512: grouped_kernel<R, 512, LOADS_FIRST><<<n_groups, 512, 0, st>>>(c, off, gs, gr, K, out); break;
    default: grouped_kernel<R, 1024, LOADS_FIRST><<<n_groups, 1024, 0, st>>>(c, off, gs, gr, K, out); break;
  }
}

}  // namespace

extern "C" {

// design: 0 loop; 1 grouped R 256, 256 threads, offsets stored first; 2
// grouped R 128, loads first, threads the next power of two (64..1024) at or
// above the mean (segment, column) count of a group; 3 empty, one block of
// 32; 4 empty, the loop kernel's grid; 5 stream. out has S K floats (and at
// least one per thread of the stream grid).
int k3_design(int design, const float* contrib, const int* offsets, const int* group_segs,
              const int* group_rows, int n_groups, int n_rows, int S, int K, float* out,
              cudaStream_t st) {
  const int blocks = (int)(((long long)S * K + 255) / 256);
  switch (design) {
    case 0: loop_kernel<<<blocks, 256, 0, st>>>(contrib, offsets, S, K, out); break;
    case 1:
      launch_grouped<256, false>(256, n_groups, contrib, offsets, group_segs, group_rows, K, out, st);
      break;
    case 2: {
      const long long items = ((long long)S * K + n_groups - 1) / n_groups;
      int T = 64;
      while (T < items && T < 1024) T <<= 1;
      launch_grouped<128, true>(T, n_groups, contrib, offsets, group_segs, group_rows, K, out, st);
      break;
    }
    case 3: empty_kernel<<<1, 32, 0, st>>>(); break;
    case 4: empty_kernel<<<blocks, 256, 0, st>>>(); break;
    case 5:
      stream_kernel<<<blocks, 256, 0, st>>>(reinterpret_cast<const float4*>(contrib),
                                            (long long)n_rows * K / 4, out);
      break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
