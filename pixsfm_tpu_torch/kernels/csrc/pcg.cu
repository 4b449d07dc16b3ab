// Batched Jacobi-preconditioned conjugate gradients on dense SPD systems.
//
// Replaces the Pallas TPU kernel pixsfm_tpu/ops/cg_pallas.py (_make_call,
// driven by pcg_solve_pallas) and serves the default LM path, whose XLA
// form is the scan in pixsfm_tpu/ops/lm.py:150-229.
//
// For each problem p solve (H[p] + diag(damp[p])) dx = -g[p] from a zero
// start with a fixed number of CG steps. The damping diagonal is folded into
// the matvec (lm.py:201-204), so the damped [P, N, N] copy is never built;
// damp == nullptr means H already holds the damped, masked system. The
// Jacobi preconditioner is 1 / max(diag(H) + damp, 1e-12) (lm.py:190) and
// both CG divisions are guarded by max(., 1e-30).
//
// Bound on the card: with P = 128 systems of N = 112 the data is ~6.4 MB
// (read once) and 15 steps are ~2 x 15 x P x N^2 = 48 MFLOP, so both bounds
// are near a microsecond and the kernel is latency-bound: 15 dependent
// steps, each a matvec and two block reductions. Design: one thread block
// per problem; H is loaded into shared memory once (row stride padded to an
// odd number of words, so the row-per-thread matvec reads are free of bank
// conflicts) and every step runs out of shared memory and registers.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (pixsfm_tpu_torch/kernels/__init__.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSharedBytes = 232448;  // 227 KB per block on sm_90

__host__ __device__ inline int padded_ld(int n) { return n | 1; }

__host__ inline size_t shared_bytes(int n) {
  // H (n rows, stride ld) + x, r, z, p, Ap, dinv, damp + reduction scratch
  return sizeof(float) * (static_cast<size_t>(n) * padded_ld(n) + 7 * n + kWarps);
}

// Sum over the block; every thread gets the result.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // scratch may still be read by the previous reduction
  if ((threadIdx.x & 31) == 0) scratch[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) s += scratch[i];
  return s;
}

__global__ void __launch_bounds__(kThreads)
pcg_kernel(const float* __restrict__ H, const float* __restrict__ damp,
           const float* __restrict__ g, float* __restrict__ dx, int n,
           int iters) {
  extern __shared__ float smem[];
  const int ld = padded_ld(n);
  float* sH = smem;
  float* x = sH + static_cast<size_t>(n) * ld;
  float* r = x + n;
  float* z = r + n;
  float* p = z + n;
  float* Ap = p + n;
  float* dinv = Ap + n;
  float* sd = dinv + n;
  float* scratch = sd + n;

  const int64_t prob = blockIdx.x;
  const float* Hp = H + prob * n * n;
  for (int e = threadIdx.x; e < n * n; e += kThreads) {
    const int i = e / n;
    sH[i * ld + (e - i * n)] = Hp[e];
  }
  __syncthreads();

  float part = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float di = damp ? damp[prob * n + i] : 0.f;
    sd[i] = di;
    dinv[i] = 1.0f / fmaxf(sH[i * ld + i] + di, 1e-12f);
    const float ri = -g[prob * n + i];
    const float zi = dinv[i] * ri;
    x[i] = 0.f;
    r[i] = ri;
    z[i] = zi;
    p[i] = zi;
    part += ri * zi;
  }
  float rz = block_sum(part, scratch);  // also publishes p to the block

  for (int it = 0; it < iters; ++it) {
    part = 0.f;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float* row = sH + i * ld;
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc = fmaf(row[j], p[j], acc);
      acc = fmaf(sd[i], p[i], acc);
      Ap[i] = acc;
      part += p[i] * acc;
    }
    const float alpha = rz / fmaxf(block_sum(part, scratch), 1e-30f);
    part = 0.f;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      x[i] += alpha * p[i];
      const float ri = r[i] - alpha * Ap[i];
      r[i] = ri;
      const float zi = dinv[i] * ri;
      z[i] = zi;
      part += ri * zi;
    }
    const float rz_new = block_sum(part, scratch);
    const float beta = rz_new / fmaxf(rz, 1e-30f);
    // each thread updates only the entries it owns; the barrier publishes
    // p before the next matvec reads all of it
    for (int i = threadIdx.x; i < n; i += kThreads) p[i] = z[i] + beta * p[i];
    __syncthreads();
    rz = rz_new;
  }

  for (int i = threadIdx.x; i < n; i += kThreads) dx[prob * n + i] = x[i];
}

}  // namespace

extern "C" {

// Largest N whose system fits the shared memory of one block.
int pixsfm_pcg_max_n() {
  int n = 1;
  while (shared_bytes(n + 1) <= kMaxSharedBytes) ++n;
  return n;
}

// H [P, N, N], damp [P, N] or null, g [P, N], dx [P, N]; all float32,
// contiguous. Returns the cudaError_t of the launch (0 = success).
int pixsfm_pcg(const float* H, const float* damp, const float* g, float* dx,
               int P, int n, int iters, void* stream) {
  if (P == 0) return 0;
  const size_t bytes = shared_bytes(n);
  if (bytes > static_cast<size_t>(kMaxSharedBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      pcg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  pcg_kernel<<<P, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      H, damp, g, dx, n, iters);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
