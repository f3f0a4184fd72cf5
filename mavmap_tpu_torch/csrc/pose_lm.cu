// The robust pose LM of the registration step, every iteration in one
// launch (kernel K4).
//
// mavmap_pose_lm replaces no TPU kernel: the JAX package leaves this loop
// (mavmap_tpu/ba/core.py _pose_refine_loop, a lax.while_loop under vmap)
// to XLA, which compiles it into one program on the TPU. The port's plain
// version (ba/core.py _pose_refine_plain) runs it from Python, a few
// hundred small launches per iteration: on the card that is host work,
// not device work. Here one block refines one slot's pose:
//   - the slot's rows (points (N, 3), pixels (N, 2), inlier mask (N,)) are
//     staged in shared memory once (read from device memory where they do
//     not fit under 48 KB), and thread t owns rows t, t + 256, t + 512, ...;
//   - each iteration every thread forms the rotation and its derivatives
//     by forward mode (a dual number of 6 tangents, one per pose axis),
//     projects its rows through the slot's camera model with the same
//     dual numbers, weights them by the Cauchy loss and adds its rows'
//     21 upper-triangle entries of H and 6 of g in row order; a tree of
//     fixed shape (warp shuffles, then the 8 warps' partials in order in
//     shared memory) adds the threads: no atomics, so a slot's bits repeat
//     from run to run and do not depend on B or on the other slots;
//   - one thread solves (H + lambda I) delta = g by LU with partial
//     pivoting, the block evaluates the trial pose's robust cost with the
//     same fixed tree, and one thread accepts or rejects the step and
//     updates lambda; a slot that stops leaves the loop (a block-uniform
//     branch) while the others go on.
// The rules are _pose_refine_plain's: the same formulas (Rodrigues with
// its Taylor branch, K K added in matmul_ordered's order, the PINHOLE,
// OPENCV and CATA projections with _safe's eps), the same iteration cap,
// damping, stop test and loss, f32 throughout, and NaN where H + lambda I
// has a non-finite entry or a zero pivot, which rejects the step. The
// file builds with -fmad=false (ops/cuda/build.py), so every product and
// sum rounds on its own as PyTorch's elementwise kernels do; sinf, cosf,
// sqrtf, log1pf and the divisions stay IEEE. What differs from the plain
// version: the order of the sums over rows (pairwise halving there), H's
// lower triangle copied from the upper, and this LU in place of
// torch.linalg.solve_ex's.
// Bound on an H100: neither bytes nor operations. A slot's rows are
// 21 KB at N = 1024 and an iteration is ~0.35 MFLOP; what sets the time
// is a serial chain per iteration: a row's dual projection (4 rows a
// thread), two block-wide reductions with their barriers and one 6x6
// solve on one thread, ~13 us in all. The slots run side by side on
// separate SMs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 27;  // H's 21 upper-triangle entries, then g's 6
// Staged rows stay under the 48 KB of shared memory that a launch gets
// without cudaFuncSetAttribute (a runtime call on the host per launch).
constexpr int kMaxStagedBytes = 46 * 1024;
constexpr float kEps = 1e-12f;  // models/camera.py world2image's eps

constexpr int OPENCV = 2;
constexpr int CATA = 3;

// A value and its derivatives along the 6 pose axes (rvec, then tvec).
struct Dual {
  float v;
  float d[6];
};

__device__ __forceinline__ Dual make(float v) {
  Dual r;
  r.v = v;
#pragma unroll
  for (int i = 0; i < 6; ++i) r.d[i] = 0.0f;
  return r;
}

__device__ __forceinline__ Dual operator+(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < 6; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}

__device__ __forceinline__ Dual operator+(const Dual& a, float b) {
  Dual r = a;
  r.v = a.v + b;
  return r;
}

__device__ __forceinline__ Dual operator+(float a, const Dual& b) { return b + a; }

__device__ __forceinline__ Dual operator-(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < 6; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}

__device__ __forceinline__ Dual operator-(const Dual& a, float b) {
  Dual r = a;
  r.v = a.v - b;
  return r;
}

__device__ __forceinline__ Dual operator-(float a, const Dual& b) {
  Dual r;
  r.v = a - b.v;
#pragma unroll
  for (int i = 0; i < 6; ++i) r.d[i] = -b.d[i];
  return r;
}

__device__ __forceinline__ Dual operator-(const Dual& a) {
  Dual r;
  r.v = -a.v;
#pragma unroll
  for (int i = 0; i < 6; ++i) r.d[i] = -a.d[i];
  return r;
}

__device__ __forceinline__ Dual operator*(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < 6; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}

__device__ __forceinline__ Dual operator*(float a, const Dual& b) {
  Dual r;
  r.v = a * b.v;
#pragma unroll
  for (int i = 0; i < 6; ++i) r.d[i] = a * b.d[i];
  return r;
}

__device__ __forceinline__ Dual operator*(const Dual& a, float b) { return b * a; }

__device__ __forceinline__ Dual operator/(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v / b.v;
#pragma unroll
  for (int i = 0; i < 6; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) / b.v;
  return r;
}

__device__ __forceinline__ Dual operator/(const Dual& a, float b) {
  Dual r;
  r.v = a.v / b;
#pragma unroll
  for (int i = 0; i < 6; ++i) r.d[i] = a.d[i] / b;
  return r;
}

__device__ __forceinline__ float val(float a) { return a; }
__device__ __forceinline__ float val(const Dual& a) { return a.v; }

__device__ __forceinline__ float dsqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ Dual dsqrt(const Dual& a) {
  Dual r;
  r.v = sqrtf(a.v);
#pragma unroll
  for (int i = 0; i < 6; ++i) r.d[i] = a.d[i] / (2.0f * r.v);
  return r;
}

__device__ __forceinline__ float dsin(float a) { return sinf(a); }
__device__ __forceinline__ Dual dsin(const Dual& a) {
  Dual r;
  r.v = sinf(a.v);
  const float c = cosf(a.v);
#pragma unroll
  for (int i = 0; i < 6; ++i) r.d[i] = a.d[i] * c;
  return r;
}

__device__ __forceinline__ float dcos(float a) { return cosf(a); }
__device__ __forceinline__ Dual dcos(const Dual& a) {
  Dual r;
  r.v = cosf(a.v);
  const float s = -sinf(a.v);
#pragma unroll
  for (int i = 0; i < 6; ++i) r.d[i] = a.d[i] * s;
  return r;
}

// The Euclidean norm of (x, y, z), torch.linalg.norm's derivative (zero at
// the origin).
__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf(x * x + y * y + z * z);
}
__device__ __forceinline__ Dual norm3(const Dual& x, const Dual& y, const Dual& z) {
  Dual r;
  r.v = sqrtf(x.v * x.v + y.v * y.v + z.v * z.v);
#pragma unroll
  for (int i = 0; i < 6; ++i)
    r.d[i] = r.v == 0.0f ? 0.0f : (x.v * x.d[i] + y.v * y.d[i] + z.v * z.d[i]) / r.v;
  return r;
}

template <typename T>
__device__ __forceinline__ T constant(float v);
template <>
__device__ __forceinline__ float constant<float>(float v) { return v; }
template <>
__device__ __forceinline__ Dual constant<Dual>(float v) { return make(v); }

// models/camera.py _safe: eps where |d| < eps (a constant: no derivative).
template <typename T>
__device__ __forceinline__ T safe(const T& d) {
  return fabsf(val(d)) < kEps ? constant<T>(kEps) : d;
}

// ops/rotation.py rotmat_from_rvec with matmul_ordered's K K: R row-major.
template <typename T>
__device__ __forceinline__ void rotation(const T w[3], T R[9]) {
  const T theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  T a, b;
  if (val(theta2) < 1e-12f) {
    a = 1.0f - theta2 / 6.0f;
    b = 0.5f - theta2 / 24.0f;
  } else {
    const T theta = dsqrt(theta2);
    a = dsin(theta) / theta;
    b = (1.0f - dcos(theta)) / theta2;
  }
  const T zero = constant<T>(0.0f);
  const T K[9] = {zero, -w[2], w[1], w[2], zero, -w[0], -w[1], w[0], zero};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const T kk = K[3 * i] * K[j] + K[3 * i + 1] * K[3 + j] + K[3 * i + 2] * K[6 + j];
      R[3 * i + j] = ((i == j ? 1.0f : 0.0f) + a * K[3 * i + j]) + b * kk;
    }
  }
}

// models/camera.py _distortion, added to (u, v).
template <typename T>
__device__ __forceinline__ void distort(T& u, T& v, const float* K) {
  const float k1 = K[4], k2 = K[5], p1 = K[6], p2 = K[7];
  const T u2 = u * u;
  const T v2 = v * v;
  const T uvp = u * v;
  const T r2 = u2 + v2;
  const T radial = k1 * r2 + k2 * r2 * r2;
  const T du = u * radial + 2.0f * p1 * uvp + p2 * (r2 + 2.0f * u2);
  const T dv = v * radial + 2.0f * p2 * uvp + p1 * (r2 + 2.0f * v2);
  u = u + du;
  v = v + dv;
}

// The pixel residual of one row: transform_points, then the camera
// model's world2image (PINHOLE for any code but OPENCV and CATA: the
// wrapper admits no other), less the observed pixel.
template <typename T>
__device__ __forceinline__ void residual(const T R[9], const T t[3], const float* X,
                                         const float* obs, const float* K, int code,
                                         T r[2]) {
  T xc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    xc[i] = X[0] * R[3 * i] + X[1] * R[3 * i + 1] + X[2] * R[3 * i + 2] + t[i];
  T z = xc[2];
  if (code == CATA) z = z + K[8] * norm3(xc[0], xc[1], xc[2]);
  const T zs = safe(z);
  T u = xc[0] / zs;
  T v = xc[1] / zs;
  if (code == OPENCV || code == CATA) distort(u, v, K);
  r[0] = u * K[0] + K[2] - obs[0];
  r[1] = v * K[1] + K[3] - obs[1];
}

// The sum of v over the block, by a tree of fixed shape (warp shuffles,
// then the warps' partials in order), returned to every thread, which
// must all call it. part: kWarps floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* part) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = part[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) s += part[w];
  return s;
}

// Solves A delta = g by LU with partial pivoting; NaN where A or g holds a
// non-finite entry or a pivot is zero (solve_or_nan's semantics).
__device__ void solve6(float A[6][6], float b[6], float x[6]) {
  bool ok = true;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    ok = ok && isfinite(b[i]);
#pragma unroll
    for (int j = 0; j < 6; ++j) ok = ok && isfinite(A[i][j]);
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float m = fabsf(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (fabsf(A[i][k]) > m) {
        m = fabsf(A[i][k]);
        p = i;
      }
    }
    ok = ok && m > 0.0f;
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (i == p) {
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const float s = A[k][j];
          A[k][j] = A[i][j];
          A[i][j] = s;
        }
        const float s = b[k];
        b[k] = b[i];
        b[i] = s;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float l = A[i][k] / A[k][k];
#pragma unroll
      for (int j = k + 1; j < 6; ++j) A[i][j] = A[i][j] - l * A[k][j];
      b[i] = b[i] - l * b[k];
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = b[i];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) s = s - A[i][j] * x[j];
    x[i] = s / A[i][i];
  }
  if (!ok) {
#pragma unroll
    for (int i = 0; i < 6; ++i) x[i] = NAN;
  }
}

// This thread's part of the masked robust cost sum(c2 log1p(s / c2)) at
// a pose, its rows added in order.
__device__ __forceinline__ float rows_cost(const float pose[6], const float* X, const float* obs,
                                           const unsigned char* mask, int N, const float* K,
                                           int code, float c2) {
  float R[9];
  rotation<float>(pose, R);
  float acc = 0.0f;
  for (int n = threadIdx.x; n < N; n += kThreads) {
    float r[2];
    residual<float>(R, pose + 3, X + 3 * n, obs + 2 * n, K, code, r);
    const float s = r[0] * r[0] + r[1] * r[1];
    acc = acc + (mask[n] ? c2 * log1pf(s / c2) : 0.0f);
  }
  return acc;
}

// This thread's part of H's 21 upper-triangle entries and g's 6 at a
// pose, its rows added in order: each row's Jacobian by forward mode,
// weighted by the Cauchy loss (zero off the mask, multiplied into J and r
// as the plain version does, so a masked row with a non-finite J or r
// still makes the sums non-finite).
__device__ __forceinline__ void rows_normal_equations(const float pose[6], const float* X,
                                                      const float* obs,
                                                      const unsigned char* mask, int N,
                                                      const float* K, int code, float c2,
                                                      float acc[kSums]) {
  Dual w[3], t[3], R[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    w[i] = make(pose[i]);
    w[i].d[i] = 1.0f;
    t[i] = make(pose[3 + i]);
    t[i].d[3 + i] = 1.0f;
  }
  rotation<Dual>(w, R);
#pragma unroll
  for (int e = 0; e < kSums; ++e) acc[e] = 0.0f;
  for (int n = threadIdx.x; n < N; n += kThreads) {
    Dual r[2];
    residual<Dual>(R, t, X + 3 * n, obs + 2 * n, K, code, r);
    const float s = r[0].v * r[0].v + r[1].v * r[1].v;
    const float wt = mask[n] ? 1.0f / (1.0f + s / c2) : 0.0f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float wJ[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) wJ[i] = wt * r[k].d[i];
      int e = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int j = i; j < 6; ++j) acc[e++] += wJ[i] * r[k].d[j];
      }
#pragma unroll
      for (int i = 0; i < 6; ++i) acc[21 + i] += wJ[i] * r[k].v;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    pose_lm_kernel(const float* __restrict__ pose0, const float* __restrict__ points,
                   const float* __restrict__ uv, const unsigned char* __restrict__ mask,
                   const float* __restrict__ kparams, const int* __restrict__ code_ids,
                   int code, int N, float c2, int max_iters, int staged,
                   float* __restrict__ pose_out, float* __restrict__ cost_out,
                   int* __restrict__ iters_out) {
  extern __shared__ float rows[];  // staged X (3N), pixels (2N), then mask (N bytes)
  __shared__ float part[kWarps][kSums];
  __shared__ float cost_part[kWarps];
  __shared__ float tot[kSums];
  __shared__ float pose[6];
  __shared__ float trial[6];
  __shared__ float cost;
  __shared__ int active;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* X = points + (size_t)b * N * 3;
  const float* obs = uv + (size_t)b * N * 2;
  const unsigned char* m = mask + (size_t)b * N;
  if (staged) {
    float* sX = rows;
    float* sobs = rows + 3 * N;
    unsigned char* sm = reinterpret_cast<unsigned char*>(rows + 5 * N);
    for (int i = tid; i < 3 * N; i += kThreads) sX[i] = X[i];
    for (int i = tid; i < 2 * N; i += kThreads) sobs[i] = obs[i];
    for (int i = tid; i < N; i += kThreads) sm[i] = m[i];
    X = sX;
    obs = sobs;
    m = sm;
  }
  float K[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) K[i] = kparams[(size_t)b * 9 + i];
  const int slot_code = code_ids != nullptr ? code_ids[b] : code;
  if (tid < 6) pose[tid] = pose0[(size_t)b * 6 + tid];
  __syncthreads();

  float p[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) p[i] = pose[i];
  const float cost0 =
      0.5f * block_sum(rows_cost(p, X, obs, m, N, K, slot_code, c2), cost_part);
  float lam = 1e-3f;  // thread 0's copy is the one that counts
  int iters = 0;
  if (tid == 0) {
    cost = cost0;
    active = 1;
  }
  __syncthreads();

  for (int it = 0; it < max_iters; ++it) {
    // Normal equations at the current pose.
#pragma unroll
    for (int i = 0; i < 6; ++i) p[i] = pose[i];
    float acc[kSums];
    rows_normal_equations(p, X, obs, m, N, K, slot_code, c2, acc);
#pragma unroll
    for (int e = 0; e < kSums; ++e) {
      float v = acc[e];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if ((tid & 31) == 0) part[tid >> 5][e] = v;
    }
    __syncthreads();
    if (tid < kSums) {
      float s = part[0][tid];
#pragma unroll
      for (int wp = 1; wp < kWarps; ++wp) s += part[wp][tid];
      tot[tid] = s;
    }
    __syncwarp();
    if (tid == 0) {
      float A[6][6], g[6], delta[6];
      int e = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int j = i; j < 6; ++j) {
          A[i][j] = tot[e];
          A[j][i] = tot[e];
          ++e;
        }
        g[i] = tot[21 + i];
      }
#pragma unroll
      for (int i = 0; i < 6; ++i) A[i][i] = A[i][i] + lam;
      solve6(A, g, delta);
#pragma unroll
      for (int i = 0; i < 6; ++i) trial[i] = pose[i] - delta[i];
    }
    __syncthreads();

    // The trial pose's cost; one thread takes or rejects the step.
    float q[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) q[i] = trial[i];
    const float new_cost =
        0.5f * block_sum(rows_cost(q, X, obs, m, N, K, slot_code, c2), cost_part);
    if (tid == 0) {
      const bool accept = new_cost < cost;
      lam = fminf(fmaxf(accept ? lam * 0.3f : lam * 10.0f, 1e-10f), 1e8f);
      const float rel = (cost - new_cost) / fmaxf(cost, 1e-20f);
      if (accept) {
#pragma unroll
        for (int i = 0; i < 6; ++i) pose[i] = q[i];
        cost = new_cost;
        if (rel < 1e-6f) active = 0;
      }
      iters = it + 1;
    }
    __syncthreads();
    if (!active) break;
  }
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 6; ++i) pose_out[(size_t)b * 6 + i] = pose[i];
    cost_out[b] = cost;
    iters_out[b] = iters;
  }
}

}  // namespace

extern "C" {

// pose0 (B, 6), points (B, N, 3), uv (B, N, 2), mask (B, N) bytes 0/1,
// kparams (B, 9), all contiguous on one device; code_ids (B,) int32, or
// null where every slot has camera model `code`. c2: the Cauchy scale
// squared. Writes pose_out (B, 6), cost_out (B,) and iters_out (B,).
int mavmap_pose_lm(const float* pose0, const float* points, const float* uv,
                   const unsigned char* mask, const float* kparams, const int* code_ids,
                   int code, int B, int N, float c2, int max_iters, float* pose_out,
                   float* cost_out, int* iters_out, cudaStream_t stream) {
  if (B == 0) return (int)cudaGetLastError();
  const size_t bytes = (size_t)N * (5 * sizeof(float) + 1);
  const int staged = bytes <= (size_t)kMaxStagedBytes;
  pose_lm_kernel<<<B, kThreads, staged ? bytes : 0, stream>>>(
      pose0, points, uv, mask, kparams, code_ids, code, N, c2, max_iters, staged, pose_out,
      cost_out, iters_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
