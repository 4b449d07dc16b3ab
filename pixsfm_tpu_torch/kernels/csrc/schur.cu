// Schur-complement kernels of the grid-regime CG Schur solve (K3a/b/c).
//
// Replace the Pallas TPU kernels of pixsfm_tpu/ops/schur_pallas.py:
//   K3a pixsfm_schur_matvec  <- schur_term_matvec (:253, body _matvec_kernel :135)
//   K3b pixsfm_schur_rhs     <- schur_rhs         (:280, body _rhs_kernel :165)
//   K3c pixsfm_schur_backsub <- schur_backsub     (:302, body _backsub_kernel :183)
// called once per CG iteration (K3a) and once per Schur step (K3b, K3c) by
// pixsfm_tpu_torch/ops/schur.py.
//
// Layout (pack_grid_blocks in ops/schur_cuda.py): the observation axis is
// point-major, observation (p, j) = rank j of point p's track, T ranks per
// point. Btr [T, 3*NR, P] holds each observation's W block
// (B[a][c] = Btr[j, 3a+c, p], NR = 6 + k rows: 6 pose, k intrinsics);
// img_r / cam_r [T, P] its image / camera slot; Vinv [3, 3, P] the damped
// inverse point blocks. Tail points (p >= Np) and track holes have zero B
// blocks and point their indices at slot 0, so they add exactly nothing.
//
// What bounds them: bytes. Per launch each kernel must read Btr once
// (T * 3NR * P floats: 38 MB at T = 8, k = 4, P = 40 000) plus the index
// rows and Vinv; the arithmetic is ~2 FLOP per byte of Btr, far below the
// H100's ratio. The TPU kernels gather through one-hot MXU matmuls split
// into 3 bf16 passes to stay exact; here every gather is an indexed f32 load
// and every product an f32 FMA, so none of that is needed.
//
// Design (a simple correct kernel first; fewer atomics, bf16 Btr and
// TMA-fed tiles are later work):
// - one thread per point: each Btr[j, r, p] load is coalesced across the
//   warp (points are the minor axis), and the thread loops over the T ranks;
// - the pose/camera tables vpT [6, I], vcT [k, Nc] and the accumulators
//   up [6, I], uc [k, Nc] live in shared memory when they fit the default
//   48 KB (reads of the tables hit shared memory; accumulation is a shared
//   atomicAdd per observation row, then one global atomicAdd per non-zero
//   entry per block). Larger problems read the tables through the read-only
//   cache and accumulate straight into global memory;
// - K3a reads Btr twice (t = sum_j B_j^T rows_j needs every rank before
//   w = Vinv t can be scattered back); the second read partly hits L2.
// The caller zeroes up/uc. Atomic accumulation makes the float sum order,
// and so the last bits of up/uc, vary from run to run.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (pixsfm_tpu_torch/kernels/__init__.py).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr size_t kSharedLimit = 48 * 1024;  // no opt-in needed below this

// rows_j[a] of observation (j, p): pose rows a < 6, camera rows a >= 6
template <int K>
__device__ __forceinline__ void accumulate_bt_rows(
    const float* __restrict__ Btr, const float* vp, const float* vc, int i,
    int c, int I, int Nc, int P, size_t base, float t[3]) {
  constexpr int NR = 6 + K;
#pragma unroll
  for (int a = 0; a < NR; ++a) {
    const float v = a < 6 ? vp[a * I + i] : vc[(a - 6) * Nc + c];
    const float* b = Btr + base + static_cast<size_t>(3 * a) * P;
    t[0] = fmaf(b[0], v, t[0]);
    t[1] = fmaf(b[P], v, t[1]);
    t[2] = fmaf(b[2 * static_cast<size_t>(P)], v, t[2]);
  }
}

// u = B_j w scattered to the pose/camera accumulators
template <int K>
__device__ __forceinline__ void scatter_b_w(
    const float* __restrict__ Btr, const float w[3], int i, int c, int I,
    int Nc, int P, size_t base, float* ap, float* ac) {
  constexpr int NR = 6 + K;
#pragma unroll
  for (int a = 0; a < NR; ++a) {
    const float* b = Btr + base + static_cast<size_t>(3 * a) * P;
    const float u = fmaf(b[0], w[0],
                         fmaf(b[P], w[1], b[2 * static_cast<size_t>(P)] * w[2]));
    if (u != 0.f) {
      if (a < 6)
        atomicAdd(ap + a * I + i, u);
      else
        atomicAdd(ac + (a - 6) * Nc + c, u);
    }
  }
}

__device__ __forceinline__ void vinv_apply(const float* __restrict__ Vinv,
                                           int P, int p, const float t[3],
                                           float w[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float* v = Vinv + static_cast<size_t>(3 * a) * P + p;
    w[a] = fmaf(v[0], t[0], fmaf(v[P], t[1], v[2 * static_cast<size_t>(P)] * t[2]));
  }
}

__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  for (int e = threadIdx.x; e < n; e += kThreads) dst[e] = src ? src[e] : 0.f;
}

__device__ __forceinline__ void flush(float* dst, const float* src, int n) {
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const float v = src[e];
    if (v != 0.f) atomicAdd(dst + e, v);
  }
}

// K3a: (W V^-1 W^T) v accumulated into up [6, I], uc [K, Nc]
template <int K, bool SMEM>
__global__ void __launch_bounds__(kThreads)
matvec_kernel(const float* __restrict__ vpT, const float* __restrict__ vcT,
              const float* __restrict__ Btr, const int* __restrict__ img_r,
              const int* __restrict__ cam_r, const float* __restrict__ Vinv,
              int T, int I, int Nc, int P, float* up, float* uc) {
  extern __shared__ float smem[];
  const int nP = 6 * I, nC = K * Nc;
  const float* vp = vpT;
  const float* vc = vcT;
  float* ap = up;
  float* ac = uc;
  if (SMEM) {
    float* s_vp = smem;
    float* s_vc = s_vp + nP;
    ap = s_vc + nC;
    ac = ap + nP;
    stage(s_vp, vpT, nP);
    stage(s_vc, vcT, nC);
    stage(ap, nullptr, nP);
    stage(ac, nullptr, nC);
    __syncthreads();
    vp = s_vp;
    vc = s_vc;
  }
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p < P) {
    constexpr int R3 = 3 * (6 + K);
    float t[3] = {0.f, 0.f, 0.f};
    for (int j = 0; j < T; ++j) {
      const size_t o = static_cast<size_t>(j) * P + p;
      accumulate_bt_rows<K>(Btr, vp, vc, img_r[o], cam_r[o], I, Nc, P,
                            static_cast<size_t>(j) * R3 * P + p, t);
    }
    float w[3];
    vinv_apply(Vinv, P, p, t, w);
    for (int j = 0; j < T; ++j) {
      const size_t o = static_cast<size_t>(j) * P + p;
      scatter_b_w<K>(Btr, w, img_r[o], cam_r[o], I, Nc, P,
                     static_cast<size_t>(j) * R3 * P + p, ap, ac);
    }
  }
  if (SMEM) {
    __syncthreads();
    flush(up, ap, nP);
    flush(uc, ac, nC);
  }
}

// K3b: (W V^-1 g_x) accumulated into up [6, I], uc [K, Nc]
template <int K, bool SMEM>
__global__ void __launch_bounds__(kThreads)
rhs_kernel(const float* __restrict__ Btr, const int* __restrict__ img_r,
           const int* __restrict__ cam_r, const float* __restrict__ Vinv,
           const float* __restrict__ gx, int T, int I, int Nc, int P,
           float* up, float* uc) {
  extern __shared__ float smem[];
  const int nP = 6 * I, nC = K * Nc;
  float* ap = up;
  float* ac = uc;
  if (SMEM) {
    ap = smem;
    ac = ap + nP;
    stage(ap, nullptr, nP);
    stage(ac, nullptr, nC);
    __syncthreads();
  }
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p < P) {
    constexpr int R3 = 3 * (6 + K);
    const float g[3] = {gx[p], gx[static_cast<size_t>(P) + p],
                        gx[2 * static_cast<size_t>(P) + p]};
    float w[3];
    vinv_apply(Vinv, P, p, g, w);
    for (int j = 0; j < T; ++j) {
      const size_t o = static_cast<size_t>(j) * P + p;
      scatter_b_w<K>(Btr, w, img_r[o], cam_r[o], I, Nc, P,
                     static_cast<size_t>(j) * R3 * P + p, ap, ac);
    }
  }
  if (SMEM) {
    __syncthreads();
    flush(up, ap, nP);
    flush(uc, ac, nC);
  }
}

// K3c: t [3, P] = sum_j B_j^T (rows of v)
template <int K, bool SMEM>
__global__ void __launch_bounds__(kThreads)
backsub_kernel(const float* __restrict__ vpT, const float* __restrict__ vcT,
               const float* __restrict__ Btr, const int* __restrict__ img_r,
               const int* __restrict__ cam_r, int T, int I, int Nc, int P,
               float* __restrict__ tout) {
  extern __shared__ float smem[];
  const float* vp = vpT;
  const float* vc = vcT;
  if (SMEM) {
    float* s_vp = smem;
    float* s_vc = s_vp + 6 * I;
    stage(s_vp, vpT, 6 * I);
    stage(s_vc, vcT, K * Nc);
    __syncthreads();
    vp = s_vp;
    vc = s_vc;
  }
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  constexpr int R3 = 3 * (6 + K);
  float t[3] = {0.f, 0.f, 0.f};
  for (int j = 0; j < T; ++j) {
    const size_t o = static_cast<size_t>(j) * P + p;
    accumulate_bt_rows<K>(Btr, vp, vc, img_r[o], cam_r[o], I, Nc, P,
                          static_cast<size_t>(j) * R3 * P + p, t);
  }
  tout[p] = t[0];
  tout[static_cast<size_t>(P) + p] = t[1];
  tout[2 * static_cast<size_t>(P) + p] = t[2];
}

inline int grid_of(int P) { return (P + kThreads - 1) / kThreads; }

template <int K>
int launch(int which, const float* vpT, const float* vcT, const float* Btr,
           const int* img_r, const int* cam_r, const float* Vinv,
           const float* gx, int T, int I, int Nc, int P, float* up,
           float* uc, float* tout, cudaStream_t s) {
  const size_t table = sizeof(float) * (6 * static_cast<size_t>(I) +
                                        static_cast<size_t>(K) * Nc);
  const dim3 grid(grid_of(P));
  if (which == 0) {
    if (2 * table <= kSharedLimit)
      matvec_kernel<K, true><<<grid, kThreads, 2 * table, s>>>(
          vpT, vcT, Btr, img_r, cam_r, Vinv, T, I, Nc, P, up, uc);
    else
      matvec_kernel<K, false><<<grid, kThreads, 0, s>>>(
          vpT, vcT, Btr, img_r, cam_r, Vinv, T, I, Nc, P, up, uc);
  } else if (which == 1) {
    if (table <= kSharedLimit)
      rhs_kernel<K, true><<<grid, kThreads, table, s>>>(
          Btr, img_r, cam_r, Vinv, gx, T, I, Nc, P, up, uc);
    else
      rhs_kernel<K, false><<<grid, kThreads, 0, s>>>(
          Btr, img_r, cam_r, Vinv, gx, T, I, Nc, P, up, uc);
  } else {
    if (table <= kSharedLimit)
      backsub_kernel<K, true><<<grid, kThreads, table, s>>>(
          vpT, vcT, Btr, img_r, cam_r, T, I, Nc, P, tout);
    else
      backsub_kernel<K, false><<<grid, kThreads, 0, s>>>(
          vpT, vcT, Btr, img_r, cam_r, T, I, Nc, P, tout);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int which, const float* vpT, const float* vcT, const float* Btr,
             const int* img_r, const int* cam_r, const float* Vinv,
             const float* gx, int T, int k, int I, int Nc, int P, float* up,
             float* uc, float* tout, void* stream) {
  if (P == 0 || T == 0) return 0;
  if (T < 0 || I < 1 || Nc < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
#define PIXSFM_SCHUR_K(KV)                                                  \
  case KV:                                                                  \
    return launch<KV>(which, vpT, vcT, Btr, img_r, cam_r, Vinv, gx, T, I,   \
                      Nc, P, up, uc, tout, s);
    PIXSFM_SCHUR_K(1)
    PIXSFM_SCHUR_K(2)
    PIXSFM_SCHUR_K(3)
    PIXSFM_SCHUR_K(4)
    PIXSFM_SCHUR_K(5)
    PIXSFM_SCHUR_K(6)
    PIXSFM_SCHUR_K(7)
    PIXSFM_SCHUR_K(8)
#undef PIXSFM_SCHUR_K
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Largest number of camera parameters per camera the kernels take.
int pixsfm_schur_max_k() { return 8; }

// K3a. vpT [6, I], vcT [k, Nc], Btr [T, 3(6+k), P], img_r/cam_r [T, P]
// int32, Vinv [3, 3, P]; up [6, I] and uc [k, Nc] are accumulated into
// (zero them first). All float32 contiguous. Returns the cudaError_t of the
// launch (0 = success).
int pixsfm_schur_matvec(const float* vpT, const float* vcT, const float* Btr,
                        const int* img_r, const int* cam_r, const float* Vinv,
                        int T, int k, int I, int Nc, int P, float* up,
                        float* uc, void* stream) {
  return dispatch(0, vpT, vcT, Btr, img_r, cam_r, Vinv, nullptr, T, k, I, Nc,
                  P, up, uc, nullptr, stream);
}

// K3b. As K3a without vpT/vcT, plus gx [3, P].
int pixsfm_schur_rhs(const float* Btr, const int* img_r, const int* cam_r,
                     const float* Vinv, const float* gx, int T, int k, int I,
                     int Nc, int P, float* up, float* uc, void* stream) {
  return dispatch(1, nullptr, nullptr, Btr, img_r, cam_r, Vinv, gx, T, k, I,
                  Nc, P, up, uc, nullptr, stream);
}

// K3c. As K3a without Vinv; writes t [3, P].
int pixsfm_schur_backsub(const float* vpT, const float* vcT, const float* Btr,
                         const int* img_r, const int* cam_r, int T, int k,
                         int I, int Nc, int P, float* t, void* stream) {
  return dispatch(2, vpT, vcT, Btr, img_r, cam_r, nullptr, nullptr, T, k, I,
                  Nc, P, nullptr, nullptr, t, stream);
}

}  // extern "C"
