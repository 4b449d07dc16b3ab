// Batched Jacobi-preconditioned conjugate gradients on dense SPD systems (K2).
//
// Replaces the Pallas TPU kernel pixsfm_tpu/ops/cg_pallas.py (_make_call :40,
// its pallas_call :88, driven by pcg_solve_pallas) and serves the default LM
// path, whose XLA form is the scan in pixsfm_tpu/ops/lm.py:150-229.
//
// For each problem p solve (H[p] + diag(damp[p])) dx = -g[p] from a zero
// start with a fixed number of CG steps. The damping diagonal is folded into
// the matvec (lm.py:201-204), so the damped [P, N, N] copy is never built;
// damp == nullptr means H already holds the damped, masked system. The
// Jacobi preconditioner is 1 / max(diag(H) + damp, 1e-12) (lm.py:190) and
// both CG divisions are guarded by max(., 1e-30).
//
// Bound on the card: at the KA shape (P = 128 systems of N = 112, 15 steps)
// H is 6.4 MB, read once: 1.9 us at 3.35 TB/s, i.e. 50 KB per SM at 1/132
// of HBM; the arithmetic (48 MFLOP) is under 1 us. But the 15 steps depend
// on each other, each a matvec and two block-wide reductions, so latency
// sets the time. Measured on an H100 SXM at 700 W with variants of this
// source that were not kept: the smallest launch (one system of 4, no
// step) costs ~2.4 us in a stream of launches; the first kernel (27.5 us,
// kept as the general variant) spent ~7.4 us on its load (14.9 us when H
// comes from HBM: 98 scalar loads per thread, each with an integer
// division, few bytes in flight per SM) and 1.45 us on each step (a
// 112-deep FMA chain per row out of shared memory, five barriers). A first
// register design, 4 threads per row each holding every fourth float4 of
// it, took 17.4 us: 0.94 us per step, because its 14
// warps re-read all of p from shared memory every step (8 rows per warp
// asking for the same bytes, ~780 shared-memory wavefronts per step).
// Giving each lane one float4 column chunk of several rows instead (so a
// step reads 2 float4 of shared memory per lane) took a step to 0.73 us
// with 8 rows per warp and 0.67 us with 16 (32 spill); summing p.Hp from
// the lanes' partial products before the rows' sums was slower. With the
// matvec taken out a step still costs ~0.45 us: the two reductions'
// latency (shuffles, a barrier, a division each), which fewer warps barely
// shorten and which sets a floor of ~7 us for 15 steps.
//
// Two variants; pixsfm_pcg picks by N (and H's alignment):
// - pcg_kernel_register (N a multiple of 4, N <= 128, H 16-byte aligned):
//   one block per system, 16 rows per warp. Lane l of warp w holds the
//   float4 of columns 4l..4l+3 of rows 16w..16w+15 in registers (16
//   float4), loaded with every request issued before any is used, each load
//   instruction one row's contiguous bytes, no integer division. A step
//   reads only this lane's float4 of z and of the previous p from shared
//   memory, forms p_k = z_k + beta p_{k-1} from them (the same arithmetic as
//   forming p first), takes 16 dot products and sums them to rows with a
//   reduce-scatter of 16 xor-shuffles; row 16w + l / 2 then sits in lanes
//   2(l / 2) and 2(l / 2) + 1, which hold x, r, z, p and the row's diagonal
//   terms alike. Reductions: shuffles within the warp, one shared slot per
//   warp, one barrier: two barriers per step (z is published at the rz
//   barrier, p double-buffered). At the KA shape it takes ~12 us per launch
//   (~14 us on H sets that change), ~0.58 us per step.
// - pcg_kernel_general (any N up to pixsfm_pcg_max_n): the first design. One
//   block of 128 threads per system, H in shared memory (row stride padded
//   to an odd number of words), a row per thread, five barriers per step.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (pixsfm_tpu_torch/kernels/__init__.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// register variant
// ---------------------------------------------------------------------------

constexpr int kRegMaxN = 128;           // largest N it takes: a float4 per lane
constexpr int kRowsPerWarp = 16;
constexpr int kRowLanes = 32 / kRowsPerWarp;             // 2 lanes per row
constexpr int kRegMaxThreads = 32 * kRegMaxN / kRowsPerWarp;  // 256
constexpr int kRegSlots = kRegMaxThreads / 32;           // one per warp

__host__ __device__ inline bool register_takes(int n) {
  return n % 4 == 0 && n >= 4 && n <= kRegMaxN;
}

// Sum over the block of a value that the 2 lanes of a row hold alike:
// xor-shuffles over the warp's 16 rows, one slot per warp, one barrier, and
// every thread sums the 8 slots in one order (unused slots hold zeros).
static_assert(kRegSlots == 8, "row_block_sum reads two float4 of slots");
__device__ __forceinline__ float row_block_sum(float v, float* slots) {
#pragma unroll
  for (int o = kRowLanes; o < 32; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
  if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = v;
  __syncthreads();
  const float4* s = reinterpret_cast<const float4*>(slots);
  const float4 a = s[0], b = s[1];
  return ((a.x + a.y) + (a.z + a.w)) + ((b.x + b.y) + (b.z + b.w));
}

// One halving round of the row reduce-scatter: lanes with bit `o` set keep
// the upper HALF of d and add their partner's, the others the lower.
template <int HALF>
__device__ __forceinline__ void halve(float* d, int o) {
  const bool hi = threadIdx.x & o;
#pragma unroll
  for (int k = 0; k < HALF; ++k)
    d[k] = (hi ? d[k + HALF] : d[k]) +
           __shfl_xor_sync(kFull, hi ? d[k] : d[k + HALF], o);
}

// (H p)_i for i = the lane's row: lane l holds the 4 columns 4l..4l+3 of
// each of the warp's 16 rows (d[k] = their dot with p). Four halving rounds
// (8, 4, 2, 1 values) leave each lane one row's sum over 16 lanes (row
// lane / 2 of the warp); one more adds up the row's 2 lanes, which then hold
// the same value.
__device__ __forceinline__ float rows_reduce(float (&d)[kRowsPerWarp]) {
  halve<8>(d, 16);
  halve<4>(d, 8);
  halve<2>(d, 4);
  halve<1>(d, 2);
  return d[0] + __shfl_xor_sync(kFull, d[0], 1);
}

// blockDim.x = 32 ceil(N / 16); one block per system. Warp w holds rows
// 16w..16w+15 of H; the vector state of row i = 16w + lane / 2 lives in its
// 2 lanes.
__global__ void __launch_bounds__(kRegMaxThreads)
pcg_kernel_register(const float* __restrict__ H,
                    const float* __restrict__ damp,
                    const float* __restrict__ g, float* __restrict__ dx, int n,
                    int iters) {
  __shared__ __align__(16) float s_z[kRegMaxN];
  __shared__ __align__(16) float s_p[2][kRegMaxN];  // p_k in s_p[k & 1]
  __shared__ __align__(16) float s_red[2][kRegSlots];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int i = tid / kRowLanes;   // this lane's row of the vector state
  const bool row = i < n;          // the last warp may hold rows past n
  const bool owner = row && lane % kRowLanes == 0;
  const bool col = lane < (n >> 2);  // this lane's float4 of a row exists
  const size_t base = static_cast<size_t>(blockIdx.x) * n;

  // the whole system in one round trip: every load before any use; each
  // load instruction reads one row's contiguous 16-byte chunks
  float4 h[kRowsPerWarp];
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int rk = warp * kRowsPerWarp + k;
    h[k] = rk < n && col
               ? __ldg(reinterpret_cast<const float4*>(H + (base + rk) * n) +
                       lane)
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float hii = 0.f, di = 0.f, gi = 0.f;
  if (row) {
    hii = __ldg(H + (base + i) * n + i);
    di = damp ? __ldg(damp + base + i) : 0.f;
    gi = __ldg(g + base + i);
  }
  // p_{-1} = 0; slots of warps that do not exist stay 0 (only warp 0
  // writes here, and it owns slot 0, which it does not clear)
  for (int e = tid; e < kRegMaxN; e += blockDim.x) s_p[1][e] = 0.f;
  if (tid < kRegSlots && tid >= static_cast<int>(blockDim.x >> 5))
    s_red[0][tid] = s_red[1][tid] = 0.f;

  const float dinv = 1.0f / fmaxf(hii + di, 1e-12f);
  float x = 0.f, r = -gi, z = dinv * r, p = 0.f, beta = 0.f;
  if (owner) s_z[i] = z;
  float rz = row_block_sum(r * z, s_red[1]);

  for (int it = 0; it < iters; ++it) {
    p = fmaf(beta, p, z);  // this row's p_k
    if (owner) s_p[it & 1][i] = p;
    // this lane's 4 entries of p_k, formed as their rows form them
    float4 pk = make_float4(0.f, 0.f, 0.f, 0.f);
    if (col) {
      const float4 zq = reinterpret_cast<const float4*>(s_z)[lane];
      const float4 pq =
          reinterpret_cast<const float4*>(s_p[(it + 1) & 1])[lane];
      pk = make_float4(fmaf(beta, pq.x, zq.x), fmaf(beta, pq.y, zq.y),
                       fmaf(beta, pq.z, zq.z), fmaf(beta, pq.w, zq.w));
    }
    float d[kRowsPerWarp];
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k)
      d[k] = fmaf(h[k].w, pk.w,
                  fmaf(h[k].z, pk.z, fmaf(h[k].y, pk.y, h[k].x * pk.x)));
    const float Ap = fmaf(di, p, rows_reduce(d));
    const float alpha = rz / fmaxf(row_block_sum(p * Ap, s_red[0]), 1e-30f);
    x = fmaf(alpha, p, x);
    r = fmaf(-alpha, Ap, r);
    z = dinv * r;
    if (owner) s_z[i] = z;
    const float rz_new = row_block_sum(r * z, s_red[1]);
    beta = rz_new / fmaxf(rz, 1e-30f);
    rz = rz_new;
  }
  if (owner) dx[base + i] = x;
}

// ---------------------------------------------------------------------------
// general variant
// ---------------------------------------------------------------------------

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
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
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
pcg_kernel_general(const float* __restrict__ H, const float* __restrict__ damp,
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

// Largest N whose system fits the shared memory of one block (the general
// variant's limit, which is every N the kernels take).
int pixsfm_pcg_max_n() {
  int n = 1;
  while (shared_bytes(n + 1) <= kMaxSharedBytes) ++n;
  return n;
}

// Which variant pixsfm_pcg takes for N on a 16-byte aligned H (what torch
// allocates): 0 = register, 1 = general.
int pixsfm_pcg_variant(int n) { return register_takes(n) ? 0 : 1; }

// H [P, N, N], damp [P, N] or null, g [P, N], dx [P, N]; all float32,
// contiguous. variant: -1 = the automatic choice (register where N and H's
// alignment allow it, else general), 0 = register, 1 = general. Returns the
// cudaError_t of the launch (0 = success).
int pixsfm_pcg(const float* H, const float* damp, const float* g, float* dx,
               int P, int n, int iters, int variant, void* stream) {
  if (P == 0 || n == 0) return 0;
  const bool fits = register_takes(n) &&
                    reinterpret_cast<uintptr_t>(H) % 16 == 0;
  if (variant < 0) variant = fits ? 0 : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0) {
    if (!fits) return static_cast<int>(cudaErrorInvalidValue);
    const int threads = 32 * ((n + kRowsPerWarp - 1) / kRowsPerWarp);
    pcg_kernel_register<<<P, threads, 0, s>>>(H, damp, g, dx, n, iters);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant != 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = shared_bytes(n);
  if (bytes > static_cast<size_t>(kMaxSharedBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      pcg_kernel_general, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  pcg_kernel_general<<<P, kThreads, bytes, s>>>(H, damp, g, dx, n, iters);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
