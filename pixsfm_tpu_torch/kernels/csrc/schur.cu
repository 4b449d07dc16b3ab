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
// (T * 3NR * P floats: 63 MB at T = 8, k = 4, P = 65 536) plus the index
// rows and Vinv; the arithmetic is ~2 FLOP per byte of Btr, far below the
// H100's ratio, so tensor cores have nothing to offer. The TPU kernels
// gather through one-hot MXU matmuls split into 3 bf16 passes to stay exact;
// here every gather is an indexed f32 load and every product an f32 FMA.
//
// The scatter (K3a, K3b). u = B_j w goes to up [6, I] by image slot and to
// uc [k, Nc] by camera slot. A float atomicAdd on shared memory is a
// compare-and-swap loop, so lanes that add to one address take turns: with
// one camera that is a 32-way turn per row and observation. scatter_rows
// therefore reduces inside the warp first: __match_any_sync groups the lanes
// by slot, the groups are summed with shuffles in ceil(log2(largest group))
// rounds (all lanes on one slot: an ordinary 5-round tree), and only each
// group's first lane adds, to an address no other lane of the warp touches.
// Holes and padding points (all-zero u) get a key of their own, so they
// neither lengthen a group nor add anything.
//
// K3a has two variants; pixsfm_schur_matvec picks by T (and P):
// - matvec_kernel_fused (T <= 16) reads Btr from device memory once. A block
//   is 32 points x RW warps, warp w owning rank w (T <= 8) or ranks w and
//   w + RW (T <= 16); every load of Btr[j, r, p] is a coalesced 128-byte row
//   along the point axis, and a thread keeps its ranks' 3 x NR blocks in
//   registers (30 floats per rank at k = 4). The warps' partial
//   t = B_j^T rows_j meet in a small shared array (double-buffered, one
//   __syncthreads per tile), every warp forms w = V^-1 t, and scatters its
//   own ranks from registers. T times more threads are in flight than with
//   one thread per point, which is what a 63 MB read needs. The grid is
//   persistent (blocks walk tiles of 32 points), so the tables are staged
//   and the accumulators flushed once per block, not once per 32 points.
//   Measured on the H100: with the bytes read once and the atomics out of
//   the way the kernel turned out to be bound by instruction rate, ~10
//   integer instructions of 64-bit address arithmetic per 4-byte load. A
//   rank's block is therefore addressed with 32-bit offsets from one 64-bit
//   base (one multiply-add per load), which took a seventh off the time.
//   Staging the next tile in a second register set was tried and was slower
//   (half the resident warps, and the scatter's latency shows).
// - matvec_kernel_twopass: one thread per point, Btr read a second time for
//   the scatter (partly from L2), 64-bit offsets. Takes T > 16 and rank
//   blocks of 2^31 floats or more.
// K3b has two variants; pixsfm_schur_rhs picks by T (and P):
// - rhs_kernel_fused (T <= 16): the fused K3a's body in its right-hand-side
//   mode (one template, two names so that a profile tells them apart).
//   w = V^-1 g_x depends on the point alone, so each warp forms it from its
//   lane's 9 Vinv and 3 g_x floats: no tables, no gather, no exchange of t
//   and no barrier inside the walk; only the accumulators live in shared
//   memory. The one-pass kernel, which this replaces at these T, has one
//   thread per point, one rank's loads in flight at a time and 64-bit
//   address arithmetic per load. Measured on an H100 SXM at 700 W at the BA
//   shape (T = 8, k = 4, P = 65 536, 70 MB): 35-36 us per call with the
//   wrapper's 2.3 us fill, against 44-45 us for the one-pass kernel; a
//   variant without the scatter (not kept) reads Btr in 26.7 us (2.6 TB/s),
//   so the scatter costs ~6.5 us, as in K3a.
// - rhs_kernel_onepass: the first design. Takes T > 16 and rank blocks of
//   2^31 floats or more, and can be forced for comparison.
// K3c keeps one thread per point and one read.
//
// Tables: vpT [6, I], vcT [k, Nc] and the accumulators live in shared memory
// when they fit the default 48 KB (then one global atomicAdd per non-zero
// entry per block at the end); larger problems read the tables through the
// read-only cache and the group leaders add straight to global memory. The
// 227 KB opt-in is not used: a block would spend more on staging and
// flushing such tables than it reads of Btr.
// The caller zeroes up/uc. Atomic accumulation makes the float sum order,
// and so the last bits of up/uc, vary from run to run.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (pixsfm_tpu_torch/kernels/__init__.py).

#include <cuda_runtime.h>
#include <stddef.h>

#include "device_info.h"

namespace {

constexpr int kThreads = 128;           // one-thread-per-point kernels
constexpr size_t kSharedLimit = 48 * 1024;  // no opt-in needed below this
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFusedWarps = 8;          // rank-warps per block, at most
constexpr int kFusedRanksPerWarp = 2;   // so the fused K3a takes T <= 16

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

// u = B_j w of observation (j, p), B read from device memory
template <int K>
__device__ __forceinline__ void b_times_w(const float* __restrict__ Btr,
                                          const float w[3], int P, size_t base,
                                          float (&u)[6 + K]) {
#pragma unroll
  for (int a = 0; a < 6 + K; ++a) {
    const float* b = Btr + base + static_cast<size_t>(3 * a) * P;
    u[a] = fmaf(b[0], w[0],
                fmaf(b[P], w[1], b[2 * static_cast<size_t>(P)] * w[2]));
  }
}

// Sum x over the lanes that share a key (peers: this lane's group, from
// __match_any_sync); the sums end in each group's lowest lane. Each round a
// lane adds the value of its next surviving peer above and every second
// peer drops out, so the largest group sets the number of rounds. Called by
// all 32 lanes.
template <int N>
__device__ __forceinline__ void reduce_by_key(unsigned peers, float (&x)[N]) {
  const int lane = threadIdx.x & 31;
  int rank = __popc(peers & ((1u << lane) - 1u));  // position in the group
  unsigned above = peers & (0xfffffffeu << lane);
  while (__any_sync(kFull, above != 0u)) {
    const int next = __ffs(above);  // 0: no peer left above
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float y = __shfl_sync(kFull, x[n], (next - 1) & 31);
      if (next) x[n] += y;
    }
    above &= __ballot_sync(kFull, (rank & 1) == 0);
    rank >>= 1;
  }
}

// x [N] of one observation per lane, added to acc [N, n_slots] at column
// `slot`: one add per distinct slot and row of the warp. When every lane
// with something to add names the same slot, an xor tree sums all 32 lanes
// (the others hold zeros) and lane 0 adds; otherwise the lanes are grouped
// by slot (a lane with nothing to add gets a key of its own) and each
// group's first lane adds. Called by all 32 lanes.
template <int N>
__device__ __forceinline__ void scatter_by_slot(float (&x)[N], bool nz,
                                                unsigned live, int slot,
                                                int n_slots, float* acc) {
  const int lane = threadIdx.x & 31;
  const int first = __shfl_sync(kFull, slot, __ffs(live) - 1);
  if (__all_sync(kFull, !nz || slot == first)) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int n = 0; n < N; ++n) x[n] += __shfl_xor_sync(kFull, x[n], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int n = 0; n < N; ++n)
        if (x[n] != 0.f) atomicAdd(acc + n * n_slots + first, x[n]);
    }
    return;
  }
  const unsigned peers = __match_any_sync(kFull, nz ? slot : n_slots + lane);
  reduce_by_key<N>(peers, x);
  if (lane == __ffs(peers) - 1) {
#pragma unroll
    for (int n = 0; n < N; ++n)
      if (x[n] != 0.f) atomicAdd(acc + n * n_slots + slot, x[n]);
  }
}

// u [6 + K] of one observation per lane, added to the pose accumulator
// ap [6, I] at image slot i and the camera accumulator ac [K, Nc] at camera
// slot c (shared or global memory). Called by all 32 lanes; a lane with
// nothing to add (a hole, a padding point) passes zeros.
template <int K>
__device__ __forceinline__ void scatter_rows(const float (&u)[6 + K], int i,
                                             int c, int I, int Nc, float* ap,
                                             float* ac) {
  bool nz = false;
#pragma unroll
  for (int a = 0; a < 6 + K; ++a) nz |= u[a] != 0.f;
  const unsigned live = __ballot_sync(kFull, nz);
  if (live == 0u) return;  // a warp of holes
  float xp[6], xc[K];
#pragma unroll
  for (int a = 0; a < 6; ++a) xp[a] = u[a];
#pragma unroll
  for (int a = 0; a < K; ++a) xc[a] = u[6 + a];
  scatter_by_slot<6>(xp, nz, live, i, I, ap);
  scatter_by_slot<K>(xc, nz, live, c, Nc, ac);
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
  for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = src ? src[e] : 0.f;
}

__device__ __forceinline__ void flush(float* dst, const float* src, int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const float v = src[e];
    if (v != 0.f) atomicAdd(dst + e, v);
  }
}

// What a thread of the fused kernel holds of one tile of 32 points: the W
// blocks of its ranks (warp w owns ranks w + rr * RW), their slots, its
// point's V^-1 and, in the K3b mode, its point's g_x.
template <int K, int RPW>
struct Tile {
  float B[RPW][3 * (6 + K)];
  float V[9];
  float gx[3];
  int img[RPW], cam[RPW];
};

// Request everything a thread needs of tile `tile`; nothing is used here, so
// all loads are in flight together. Lanes past P and ranks past T get zeros.
template <int K, int RPW, bool RHS>
__device__ __forceinline__ void load_tile(
    Tile<K, RPW>& x, const float* __restrict__ Btr,
    const int* __restrict__ img_r, const int* __restrict__ cam_r,
    const float* __restrict__ Vinv, const float* __restrict__ gx, int tile,
    int T, int P) {
  constexpr int R3 = 3 * (6 + K);
  const int p = tile * 32 + (threadIdx.x & 31);
  const int warp = threadIdx.x >> 5, RW = blockDim.x >> 5;
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int j = warp + rr * RW;
    const bool live = p < P && j < T;
    x.img[rr] = x.cam[rr] = 0;
    if (live) {
      const size_t o = static_cast<size_t>(j) * P + p;
      x.img[rr] = img_r[o];
      x.cam[rr] = cam_r[o];
    }
    // offsets inside one rank's block fit 32 bits (the dispatch sees to
    // it): one multiply-add forms each address
    const float* b = Btr + static_cast<size_t>(j) * R3 * P + p;
#pragma unroll
    for (int e = 0; e < R3; ++e) x.B[rr][e] = live ? b[e * P] : 0.f;
  }
  const float* v = Vinv + p;
#pragma unroll
  for (int e = 0; e < 9; ++e) x.V[e] = p < P ? v[e * P] : 0.f;
  if constexpr (RHS) {
#pragma unroll
    for (int a = 0; a < 3; ++a) x.gx[a] = p < P ? gx[a * P + p] : 0.f;
  }
}

// K3a: t = sum_j B_j^T rows_j across the block's warps (through s_t, one
// __syncthreads); K3b: t = g_x, which needs neither. Then w = V^-1 t and
// the scatter of this thread's ranks.
template <int K, int RPW, bool RHS>
__device__ __forceinline__ void process_tile(
    const Tile<K, RPW>& x, const float* vp, const float* vc, int I, int Nc,
    float (*s_t)[3][32], float* ap, float* ac) {
  constexpr int NR = 6 + K;
  float t[3] = {0.f, 0.f, 0.f};
  if constexpr (RHS) {
#pragma unroll
    for (int a = 0; a < 3; ++a) t[a] = x.gx[a];
  } else {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5, RW = blockDim.x >> 5;
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
#pragma unroll
      for (int a = 0; a < NR; ++a) {
        const float v =
            a < 6 ? vp[a * I + x.img[rr]] : vc[(a - 6) * Nc + x.cam[rr]];
        t[0] = fmaf(x.B[rr][3 * a], v, t[0]);
        t[1] = fmaf(x.B[rr][3 * a + 1], v, t[1]);
        t[2] = fmaf(x.B[rr][3 * a + 2], v, t[2]);
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) s_t[warp][a][lane] = t[a];
    __syncthreads();
    // every warp sums the partial t in the same order, so all hold one w
#pragma unroll
    for (int a = 0; a < 3; ++a) t[a] = s_t[0][a][lane];
#pragma unroll
    for (int ww = 1; ww < kFusedWarps; ++ww) {
      if (ww < RW) {
#pragma unroll
        for (int a = 0; a < 3; ++a) t[a] += s_t[ww][a][lane];
      }
    }
  }
  float w[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    w[a] = fmaf(x.V[3 * a], t[0],
                fmaf(x.V[3 * a + 1], t[1], x.V[3 * a + 2] * t[2]));
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    float u[NR];
#pragma unroll
    for (int a = 0; a < NR; ++a)
      u[a] = fmaf(x.B[rr][3 * a], w[0],
                  fmaf(x.B[rr][3 * a + 1], w[1], x.B[rr][3 * a + 2] * w[2]));
    scatter_rows<K>(u, x.img[rr], x.cam[rr], I, Nc, ap, ac);
  }
}

// The fused kernel, T <= kFusedWarps * RPW, Btr read once. K3a (RHS false):
// (W V^-1 W^T) v accumulated into up [6, I], uc [K, Nc] (gx is null);
// K3b (RHS true): W V^-1 g_x into the same (vpT, vcT are null, and shared
// memory holds only the accumulators). blockDim.x =
// 32 * RW; the block walks tiles blockIdx.x, blockIdx.x + gridDim.x, ... of
// 32 points. K3a's s_t is double-buffered, so one barrier per tile is
// enough: a warp can be at most one tile ahead of the slowest. K3b's warps
// never wait for each other inside the walk.
template <int K, bool SMEM, int RPW, bool RHS>
__device__ __forceinline__ void fused_body(
    const float* __restrict__ vpT, const float* __restrict__ vcT,
    const float* __restrict__ Btr, const int* __restrict__ img_r,
    const int* __restrict__ cam_r, const float* __restrict__ Vinv,
    const float* __restrict__ gx, int T, int I, int Nc, int P, int n_tiles,
    float* up, float* uc) {
  extern __shared__ float smem[];
  __shared__ float s_t[2][RHS ? 1 : kFusedWarps][3][32];
  const int nP = 6 * I, nC = K * Nc;
  const float* vp = vpT;
  const float* vc = vcT;
  float* ap = up;
  float* ac = uc;
  if (SMEM) {
    float* s = smem;
    if constexpr (!RHS) {
      stage(s, vpT, nP);
      stage(s + nP, vcT, nC);
      vp = s;
      vc = s + nP;
      s += nP + nC;
    }
    ap = s;
    ac = ap + nP;
    stage(ap, nullptr, nP);
    stage(ac, nullptr, nC);
    __syncthreads();
  }
  int buf = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    Tile<K, RPW> x;
    load_tile<K, RPW, RHS>(x, Btr, img_r, cam_r, Vinv, gx, tile, T, P);
    process_tile<K, RPW, RHS>(x, vp, vc, I, Nc, s_t[buf], ap, ac);
  }
  if (SMEM) {
    __syncthreads();
    flush(up, ap, nP);
    flush(uc, ac, nC);
  }
}

// K3a and K3b's fused variants: one body, two names, so that a profile
// tells them apart; both take the same arguments (unused ones null).
template <int K, bool SMEM, int RPW>
__global__ void __launch_bounds__(32 * kFusedWarps)
matvec_kernel_fused(const float* __restrict__ vpT,
                    const float* __restrict__ vcT,
                    const float* __restrict__ Btr,
                    const int* __restrict__ img_r,
                    const int* __restrict__ cam_r,
                    const float* __restrict__ Vinv,
                    const float* __restrict__ gx, int T, int I, int Nc,
                    int P, int n_tiles, float* up, float* uc) {
  fused_body<K, SMEM, RPW, false>(vpT, vcT, Btr, img_r, cam_r, Vinv, gx, T, I,
                                  Nc, P, n_tiles, up, uc);
}

template <int K, bool SMEM, int RPW>
__global__ void __launch_bounds__(32 * kFusedWarps)
rhs_kernel_fused(const float* __restrict__ vpT,
                 const float* __restrict__ vcT,
                 const float* __restrict__ Btr,
                 const int* __restrict__ img_r,
                 const int* __restrict__ cam_r,
                 const float* __restrict__ Vinv,
                 const float* __restrict__ gx, int T, int I, int Nc,
                 int P, int n_tiles, float* up, float* uc) {
  fused_body<K, SMEM, RPW, true>(vpT, vcT, Btr, img_r, cam_r, Vinv, gx, T, I,
                                 Nc, P, n_tiles, up, uc);
}

// K3a, any T: one thread per point, Btr read twice
template <int K, bool SMEM>
__global__ void __launch_bounds__(kThreads)
matvec_kernel_twopass(const float* __restrict__ vpT,
                      const float* __restrict__ vcT,
                      const float* __restrict__ Btr,
                      const int* __restrict__ img_r,
                      const int* __restrict__ cam_r,
                      const float* __restrict__ Vinv, int T, int I, int Nc,
                      int P, float* up, float* uc) {
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
  constexpr int R3 = 3 * (6 + K);
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool live = p < P;
  float w[3] = {0.f, 0.f, 0.f};
  if (live) {
    float t[3] = {0.f, 0.f, 0.f};
    for (int j = 0; j < T; ++j) {
      const size_t o = static_cast<size_t>(j) * P + p;
      accumulate_bt_rows<K>(Btr, vp, vc, img_r[o], cam_r[o], I, Nc, P,
                            static_cast<size_t>(j) * R3 * P + p, t);
    }
    vinv_apply(Vinv, P, p, t, w);
  }
  for (int j = 0; j < T; ++j) {  // whole warps: scatter_rows is collective
    float u[6 + K] = {};
    int i = 0, c = 0;
    if (live) {
      const size_t o = static_cast<size_t>(j) * P + p;
      i = img_r[o];
      c = cam_r[o];
      b_times_w<K>(Btr, w, P, static_cast<size_t>(j) * R3 * P + p, u);
    }
    scatter_rows<K>(u, i, c, I, Nc, ap, ac);
  }
  if (SMEM) {
    __syncthreads();
    flush(up, ap, nP);
    flush(uc, ac, nC);
  }
}

// K3b, any T: (W V^-1 g_x) accumulated into up [6, I], uc [K, Nc], one
// thread per point
template <int K, bool SMEM>
__global__ void __launch_bounds__(kThreads)
rhs_kernel_onepass(const float* __restrict__ Btr, const int* __restrict__ img_r,
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
  constexpr int R3 = 3 * (6 + K);
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool live = p < P;
  float w[3] = {0.f, 0.f, 0.f};
  if (live) {
    const float g[3] = {gx[p], gx[static_cast<size_t>(P) + p],
                        gx[2 * static_cast<size_t>(P) + p]};
    vinv_apply(Vinv, P, p, g, w);
  }
  for (int j = 0; j < T; ++j) {  // whole warps: scatter_rows is collective
    float u[6 + K] = {};
    int i = 0, c = 0;
    if (live) {
      const size_t o = static_cast<size_t>(j) * P + p;
      i = img_r[o];
      c = cam_r[o];
      b_times_w<K>(Btr, w, P, static_cast<size_t>(j) * R3 * P + p, u);
    }
    scatter_rows<K>(u, i, c, I, Nc, ap, ac);
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

// The fused K3a or K3b on a persistent grid: as many blocks as the card
// holds at once, then fewer so that every block walks the same number of
// tiles.
template <int K, bool SMEM, int RPW, bool RHS>
int launch_fused(const float* vpT, const float* vcT, const float* Btr,
                 const int* img_r, const int* cam_r, const float* Vinv,
                 const float* gx, int T, int I, int Nc, int P, float* up,
                 float* uc, size_t shared, cudaStream_t s) {
  auto* kernel = RHS ? rhs_kernel_fused<K, SMEM, RPW>
                     : matvec_kernel_fused<K, SMEM, RPW>;
  const int threads = 32 * ((T + RPW - 1) / RPW);
  const int n_tiles = (P + 31) / 32;
  // blocks per SM of this instantiation at the last (threads, shared) asked
  // for: a solve launches one shape hundreds of times
  static thread_local int cached_threads = 0, cached_per_sm = 0;
  static thread_local size_t cached_shared = 0;
  if (cached_threads != threads || cached_shared != shared) {
    int per_sm = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, threads, shared);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    cached_threads = threads;
    cached_shared = shared;
    cached_per_sm = per_sm;
  }
  int sms = 0;
  const cudaError_t err = pixsfm::sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int resident = sms * cached_per_sm;
  const int rounds = (n_tiles + resident - 1) / resident;
  const int blocks = (n_tiles + rounds - 1) / rounds;
  kernel<<<blocks, threads, shared, s>>>(vpT, vcT, Btr, img_r, cam_r, Vinv,
                                         gx, T, I, Nc, P, n_tiles, up, uc);
  return static_cast<int>(cudaGetLastError());
}

// Whether the fused kernel takes a shape: T <= 16, and the offsets inside a
// rank's [3 NR, P] block fit the 32 bits it forms addresses with.
inline bool fused_takes(int T, int K, int P) {
  return T <= kFusedWarps * kFusedRanksPerWarp &&
         3 * (6 + static_cast<size_t>(K)) * static_cast<size_t>(P) <=
             0x7fffffffu;
}

// Which K3a variant a shape takes: 0 / 1 = fused with one / two ranks per
// warp, 2 = two-pass (T > 16, or 2^31 floats or more per rank); + 4 when the
// tables and accumulators fit shared memory (the fused kernel also keeps the
// partial t there).
int matvec_variant(int T, int K, int I, int Nc, int P) {
  const size_t table = sizeof(float) * (6 * static_cast<size_t>(I) +
                                        static_cast<size_t>(K) * Nc);
  const size_t partial = sizeof(float) * 2 * kFusedWarps * 3 * 32;
  if (fused_takes(T, K, P))
    return (T <= kFusedWarps ? 0 : 1) +
           (2 * table + partial <= kSharedLimit ? 4 : 0);
  return 2 + (2 * table <= kSharedLimit ? 4 : 0);
}

// Which K3b variant a shape takes: 0 / 1 = fused with one / two ranks per
// warp, 2 = one-pass (T > 16, 2^31 floats or more per rank, or `onepass`
// forced); + 4 when the accumulators fit shared memory (beside the fused
// kernel's one-warp s_t, which K3b does not use).
int rhs_variant(int T, int K, int I, int Nc, int P, bool onepass) {
  const size_t table = sizeof(float) * (6 * static_cast<size_t>(I) +
                                        static_cast<size_t>(K) * Nc);
  const size_t partial = sizeof(float) * 2 * 3 * 32;
  if (!onepass && fused_takes(T, K, P))
    return (T <= kFusedWarps ? 0 : 1) +
           (table + partial <= kSharedLimit ? 4 : 0);
  return 2 + (table <= kSharedLimit ? 4 : 0);
}

template <int K>
int launch(int which, bool onepass, const float* vpT, const float* vcT,
           const float* Btr, const int* img_r, const int* cam_r,
           const float* Vinv, const float* gx, int T, int I, int Nc, int P,
           float* up, float* uc, float* tout, cudaStream_t s) {
  const size_t table = sizeof(float) * (6 * static_cast<size_t>(I) +
                                        static_cast<size_t>(K) * Nc);
  const dim3 grid(grid_of(P));
  if (which == 0) {
    switch (matvec_variant(T, K, I, Nc, P)) {
#define PIXSFM_FUSED(SMEM, RPW, SHARED)                                     \
  return launch_fused<K, SMEM, RPW, false>(vpT, vcT, Btr, img_r, cam_r,    \
                                           Vinv, nullptr, T, I, Nc, P, up, \
                                           uc, SHARED, s);
      case 0: PIXSFM_FUSED(false, 1, 0)
      case 1: PIXSFM_FUSED(false, kFusedRanksPerWarp, 0)
      case 4: PIXSFM_FUSED(true, 1, 2 * table)
      case 5: PIXSFM_FUSED(true, kFusedRanksPerWarp, 2 * table)
#undef PIXSFM_FUSED
      case 6:
        matvec_kernel_twopass<K, true><<<grid, kThreads, 2 * table, s>>>(
            vpT, vcT, Btr, img_r, cam_r, Vinv, T, I, Nc, P, up, uc);
        break;
      default:
        matvec_kernel_twopass<K, false><<<grid, kThreads, 0, s>>>(
            vpT, vcT, Btr, img_r, cam_r, Vinv, T, I, Nc, P, up, uc);
    }
  } else if (which == 1) {
    switch (rhs_variant(T, K, I, Nc, P, onepass)) {
#define PIXSFM_FUSED(SMEM, RPW, SHARED)                                  \
  return launch_fused<K, SMEM, RPW, true>(nullptr, nullptr, Btr, img_r, \
                                          cam_r, Vinv, gx, T, I, Nc, P, \
                                          up, uc, SHARED, s);
      case 0: PIXSFM_FUSED(false, 1, 0)
      case 1: PIXSFM_FUSED(false, kFusedRanksPerWarp, 0)
      case 4: PIXSFM_FUSED(true, 1, table)
      case 5: PIXSFM_FUSED(true, kFusedRanksPerWarp, table)
#undef PIXSFM_FUSED
      case 6:
        rhs_kernel_onepass<K, true><<<grid, kThreads, table, s>>>(
            Btr, img_r, cam_r, Vinv, gx, T, I, Nc, P, up, uc);
        break;
      default:
        rhs_kernel_onepass<K, false><<<grid, kThreads, 0, s>>>(
            Btr, img_r, cam_r, Vinv, gx, T, I, Nc, P, up, uc);
    }
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

int dispatch(int which, bool onepass, const float* vpT, const float* vcT,
             const float* Btr, const int* img_r, const int* cam_r,
             const float* Vinv, const float* gx, int T, int k, int I, int Nc,
             int P, float* up, float* uc, float* tout, void* stream) {
  if (P == 0 || T == 0) return 0;
  if (T < 0 || I < 1 || Nc < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
#define PIXSFM_SCHUR_K(KV)                                                  \
  case KV:                                                                  \
    return launch<KV>(which, onepass, vpT, vcT, Btr, img_r, cam_r, Vinv,  \
                      gx, T, I, Nc, P, up, uc, tout, s);
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

// Which variant pixsfm_schur_matvec takes (for tests and the smoke run):
// 0 / 1 = fused, one / two ranks per warp; 2 = two-pass; + 4 = tables in
// shared memory.
int pixsfm_schur_matvec_variant(int T, int k, int I, int Nc, int P) {
  return matvec_variant(T, k, I, Nc, P);
}

// Which variant pixsfm_schur_rhs takes when none is forced: 0 / 1 = fused,
// one / two ranks per warp; 2 = one-pass; + 4 = accumulators in shared
// memory.
int pixsfm_schur_rhs_variant(int T, int k, int I, int Nc, int P) {
  return rhs_variant(T, k, I, Nc, P, false);
}

// K3a. vpT [6, I], vcT [k, Nc], Btr [T, 3(6+k), P], img_r/cam_r [T, P]
// int32, Vinv [3, 3, P]; up [6, I] and uc [k, Nc] are accumulated into
// (zero them first). All float32 contiguous. Returns the cudaError_t of the
// launch (0 = success).
int pixsfm_schur_matvec(const float* vpT, const float* vcT, const float* Btr,
                        const int* img_r, const int* cam_r, const float* Vinv,
                        int T, int k, int I, int Nc, int P, float* up,
                        float* uc, void* stream) {
  return dispatch(0, false, vpT, vcT, Btr, img_r, cam_r, Vinv, nullptr, T, k,
                  I, Nc, P, up, uc, nullptr, stream);
}

// K3b. As K3a without vpT/vcT, plus gx [3, P]; onepass != 0 forces the
// one-pass variant where the fused one would be taken.
int pixsfm_schur_rhs(const float* Btr, const int* img_r, const int* cam_r,
                     const float* Vinv, const float* gx, int T, int k, int I,
                     int Nc, int P, int onepass, float* up, float* uc,
                     void* stream) {
  return dispatch(1, onepass != 0, nullptr, nullptr, Btr, img_r, cam_r, Vinv,
                  gx, T, k, I, Nc, P, up, uc, nullptr, stream);
}

// K3c. As K3a without Vinv; writes t [3, P].
int pixsfm_schur_backsub(const float* vpT, const float* vcT, const float* Btr,
                         const int* img_r, const int* cam_r, int T, int k,
                         int I, int Nc, int P, float* t, void* stream) {
  return dispatch(2, false, vpT, vcT, Btr, img_r, cam_r, nullptr, nullptr, T,
                  k, I, Nc, P, nullptr, nullptr, t, stream);
}

}  // extern "C"
