// Bicubic window interpolation with derivatives and the L2 chain rule (K1).
//
// Replaces the Pallas TPU kernel pixsfm_tpu/ops/interpolate_pallas.py
// (_make_call, driven by interpolate_rows_pallas) and serves the default
// KA and BA paths, whose XLA form is bicubic_window_eval_rows +
// l2_normalize_with_grad (pixsfm_tpu/base/interpolation.py:388, :428).
//
// Per query n: the patch starts at row row_base[n] of a flat [NR, W, C] row
// view; at patch coordinates (r[n], c[n]) read the 4x4 Catmull-Rom taps,
// clamped to the patch border (a clamped tap reads the border pixel again
// and its weight accumulates, as the dense clamped taps of the JAX
// package do), and write f, df/dr, df/dc as [N, C] float32, optionally
// L2-normalized with the chain rule applied to both derivatives.
//
// Bound on the card: bytes. Each query needs its 16 taps x C channels
// (4 KiB at C = 128 in bf16, in four 1 KiB runs) and writes 3 x C floats;
// the arithmetic is 3 FMAs per tap and channel. A launch is short (8192
// queries are ~12 us of memory traffic), so what decides its time is how
// the loads are made. Measured on the H100 with the general variant below
// at that shape (one warp per query, a 2-byte load per lane, tap and 32
// channels): without its loads it takes 11 us, without its arithmetic 32 us,
// and with loads alone 24 us of its 44 us. The 64 narrow loads per lane and
// their address arithmetic set its time, not the FMAs and not the bytes.
//
// Four variants; pixsfm_interp_rows picks one from C, the storage type and
// the pointers' alignment (the Python wrapper does not choose, but may force
// one for checks and timing):
//
// - vector: interp_kernel_vec<T, C>, for C = 128 (S2DNet, DSIFT, R2D2) and
//   C = 64 (VGGNet's conv1_2), bf16 or f32 rows, when rows and the outputs
//   are 16-byte aligned. A pixel is C * sizeof(T) / 16 16-byte units (16 or
//   32 at C = 128, 8 or 16 at C = 64) and each lane owns one unit (8 bf16 /
//   4 f32 channels), so one warp-wide ld.global.nc.v4 fetches 32 / units
//   taps of one row (bf16: 2 at C = 128, 4 at C = 64; f32: 1 and 2). All of
//   a query's loads (8 per lane in bf16 at C = 128, where the general
//   variant makes 64; 4 at C = 64, where it makes 32) are requested before
//   the first use; bf16 pairs are unpacked with a shift and a mask; sums
//   are float32. The lane groups' partial sums (different taps of the same
//   channels) are combined with xor shuffles, one step per doubling of the
//   groups (bf16: 1 at C = 128, 2 at C = 64; f32: 0 and 1); the L2 norm and
//   the two chain-rule dots are reductions over a pixel's lanes, and the
//   three outputs leave as float4 stores. The grid is persistent:
//   a warp walks queries q, q + stride, ...
//   and software-pipelines them in registers: while query q is reduced, the
//   taps of q + stride and the (r, c, row_base) of q + 2 stride are already
//   requested, so a warp has two queries' bytes in flight and its
//   index -> address -> taps -> store chain overlaps the next one's. The
//   number of warps is chosen so that every warp gets the same number of
//   queries (8192 queries -> 2048 warps x 4). At C = 64 in bf16, whose 4
//   loads per lane hold half the bytes and half the registers of C = 128's
//   8, an SM holds 20 warps instead of 16 (24 spill). The channel count is a
//   template parameter: no loop has a run-time predicate. Register
//   prefetching was chosen over a cp.async shared-memory ring: the taps are
//   used once, straight from the registers they arrive in, and at 16 warps
//   per SM two queries per warp already keep 128 KiB in flight per SM (8
//   warps for f32 rows, whose 16 loads per lane and query take twice the
//   registers). Measured in bf16 at C = 128: 16 warps per SM beat 8, 12, 20
//   and 24 (the last two spill), and walking queries beat one query per
//   warp by a quarter. The two tap buffers are separate arrays that swap
//   roles in an unrolled pair of steps: indexed as one array they went to
//   local memory and the kernel took twice as long.
//
// - wide: interp_kernel_wide<T, C>, the same 16-byte loads for the wider
//   maps of VGGNet and D2-Net: C = 256 and 512, bf16 or f32, on 16-byte
//   aligned bases. A pixel is 32 * kPer units (kPer = 1, 2 or 4) and lane l
//   owns units l, l + 32, ..., so each warp-wide load reads 512 contiguous
//   bytes of one tap. One warp per query; the taps are requested a batch of
//   rows at a time, 16 loads per lane in flight (4 rows at kPer = 1, 2 at
//   2, 1 at 4), and a lane keeps 8 or 16 channels of sums; the L2 norm and
//   the two chain-rule dots are warp sums. Bound by bytes like the
//   128-channel kernel (a query reads 16 taps x 512 or 1024 bytes in
//   bf16); it was written for being right and simple, not tuned.
//
// - narrow: interp_kernel_narrow<T, C>, for 1 <= C <= 8 (the 1-3 channels
//   of the image "features": the photometric preset's node windows in
//   patch-warp BA, its references, the photometric KA and patch-warp QBA),
//   bf16 or f32, any alignment. One warp per query would leave 29 of 32
//   lanes idle at C = 3, so here one thread serves one query and a warp 32
//   queries. A thread computes its own weights, requests all 16 x C tap
//   loads before the first use (C <= 4; two rows of taps at a time beyond,
//   so that no more than 64 values are in flight), keeps 3 x C sums in
//   registers and applies the L2 chain rule by itself. Its loads are
//   scalar, one per tap and channel, so what they cost is the distinct
//   cache lines a warp-wide load touches: the node windows of patch-warp
//   BA are 16 consecutive queries on one patch row (ops/interpolate_cuda.py
//   interpolate_node_rows), so a warp's taps fall on two observations'
//   7x7-pixel neighbourhoods and L1 serves most of them. Requesting the
//   taps a row at a time measured the same as all at once, and at the
//   photometric shape the kernel runs within 3x its byte bound, so the
//   windows are not staged in shared memory. The [32, C] outputs of a warp
//   go through shared memory and leave as C contiguous 128-byte stores per
//   output. With L2 on, a thread computes its weights, sums and chain rule
//   in double and rounds each output once: at 1-3 channels ||f|| comes near
//   0 on zero-crossing maps, the chain rule divides the rounding of f by
//   ||f||^2, and float32 sums in any order land up to 1e-2 from the float64
//   result (scripts/k1_l2_conditioning.py); summed in double, the kernel
//   gives the float64 result rounded to float32. L2 off (every path that
//   reads these widths) keeps float32 sums; no preset runs L2 at 1-3
//   channels.
//
// - general: interp_kernel_general<T, K>, everything else the function
//   takes: 9 <= C <= 512 other than 64, 128, 256 and 512, and misaligned
//   bases at C > 8. One warp per query, lane l owns channels l, l + 32,
//   ..., scalar loads; K = 8 channels per lane up to C = 256, 16 beyond.
//
// All variants take any H and W (W < 4: every column tap clamps) and
// offsets past 2^31.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (pixsfm_tpu_torch/kernels/__init__.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "device_info.h"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxChannels = 512;  // 32 lanes x 16 channels (general)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void catmull_rom(float t, float w[4], float dw[4]) {
  const float t2 = t * t;
  const float t3 = t2 * t;
  w[0] = -0.5f * t3 + t2 - 0.5f * t;
  w[1] = 1.5f * t3 - 2.5f * t2 + 1.0f;
  w[2] = -1.5f * t3 + 2.0f * t2 + 0.5f * t;
  w[3] = 0.5f * t3 - 0.5f * t2;
  dw[0] = -1.5f * t2 + 2.0f * t - 0.5f;
  dw[1] = 4.5f * t2 - 5.0f * t;
  dw[2] = -4.5f * t2 + 4.0f * t + 0.5f;
  dw[3] = 1.5f * t2 - t;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// vector variant
// ---------------------------------------------------------------------------

template <typename V>
__device__ __forceinline__ V sel4(const V v[4], int j) {
  return j == 0 ? v[0] : j == 1 ? v[1] : j == 2 ? v[2] : v[3];
}

// the channels of one 16-byte unit as floats
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[4],
                                       const float*) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8],
                                       const __nv_bfloat16*) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

struct Query {
  float r, c;
  int base;
};

__device__ __forceinline__ Query load_query(const int32_t* row_base,
                                            const float* rq, const float* cq,
                                            int q) {
  Query s;
  s.r = __ldg(rq + q);
  s.c = __ldg(cq + q);
  s.base = __ldg(row_base + q);
  return s;
}

template <typename T, int C>
struct VecShape {
  static constexpr int kVec = 16 / sizeof(T);     // channels per lane
  static constexpr int kLanes = C / kVec;         // lanes per pixel: 8-32
  static constexpr int kGroups = 32 / kLanes;     // taps per warp-wide load
  static constexpr int kLoads = 16 / kGroups;     // loads per lane and query
  static constexpr int kCols = 4 / kGroups;       // column taps of a lane
  // two queries' taps live in registers: 32 of them at 4 loads, 64 at 8,
  // 128 at 16; fewer registers leave room for more warps (at 4 loads, 6
  // blocks per SM spill)
  static constexpr int kBlocksPerSM = kLoads > 8 ? 2 : kLoads > 4 ? 4 : 5;
  static_assert(C % kVec == 0 &&
                    (kLanes == 8 || kLanes == 16 || kLanes == 32),
                "a pixel must be 8, 16 or 32 16-byte units");
};

// Request the lane's taps of one query: load i * kCols + jj is tap
// (i, jj * kGroups + group).
template <typename T, int C>
__device__ __forceinline__ void request_taps(
    const T* __restrict__ rows, const Query& s, int h, int w, int group,
    int unit, uint4 (&taps)[VecShape<T, C>::kLoads]) {
  using S = VecShape<T, C>;
  const int br = static_cast<int>(floorf(s.r));
  const int bc = static_cast<int>(floorf(s.c));
  int64_t col[S::kCols];
#pragma unroll
  for (int jj = 0; jj < S::kCols; ++jj) {
    const int ci = min(max(bc - 1 + jj * S::kGroups + group, 0), w - 1);
    col[jj] = static_cast<int64_t>(ci) * S::kLanes + unit;
  }
  const uint4* px = reinterpret_cast<const uint4*>(rows);
  const int64_t row_units = static_cast<int64_t>(w) * S::kLanes;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ri = min(max(br - 1 + i, 0), h - 1);
    const int64_t row = (static_cast<int64_t>(s.base) + ri) * row_units;
#pragma unroll
    for (int jj = 0; jj < S::kCols; ++jj)
      taps[i * S::kCols + jj] = __ldg(px + row + col[jj]);
  }
}

// A lane's channels of one output as one float4 store per lane. After the
// reduction every lane group holds the same sums: in f32 group 0 stores the
// lane's float4, in bf16 groups 0 and 1 store its first and second float4,
// and any further groups store nothing.
__device__ __forceinline__ void store4(float* __restrict__ out,
                                       const float (&x)[4], int group) {
  if (group) return;
  *reinterpret_cast<float4*>(out) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(float* __restrict__ out,
                                       const float (&x)[8], int group) {
  if (group > 1) return;
  const float4 v = group ? make_float4(x[4], x[5], x[6], x[7])
                         : make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(out + 4 * group) = v;
}

template <typename T, int C>
__device__ __forceinline__ void reduce_and_store(
    const Query& s, const uint4 (&taps)[VecShape<T, C>::kLoads], int q,
    int group, int unit, int l2, float* __restrict__ f_out,
    float* __restrict__ dr_out, float* __restrict__ dc_out) {
  using S = VecShape<T, C>;
  constexpr int V = S::kVec;
  float wr[4], dwr[4], wc[4], dwc[4];
  catmull_rom(s.r - floorf(s.r), wr, dwr);
  catmull_rom(s.c - floorf(s.c), wc, dwc);
  float my_wc[S::kCols], my_dwc[S::kCols];
#pragma unroll
  for (int jj = 0; jj < S::kCols; ++jj) {
    my_wc[jj] = sel4(wc, jj * S::kGroups + group);
    my_dwc[jj] = sel4(dwc, jj * S::kGroups + group);
  }

  float f[V], fdr[V], fdc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) f[k] = fdr[k] = fdc[k] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int jj = 0; jj < S::kCols; ++jj) {
      const float a = wr[i] * my_wc[jj];
      const float b = dwr[i] * my_wc[jj];
      const float d = wr[i] * my_dwc[jj];
      float v[V];
      unpack(taps[i * S::kCols + jj], v, static_cast<const T*>(nullptr));
#pragma unroll
      for (int k = 0; k < V; ++k) {
        f[k] = fmaf(a, v[k], f[k]);
        fdr[k] = fmaf(b, v[k], fdr[k]);
        fdc[k] = fmaf(d, v[k], fdc[k]);
      }
    }
  }
  // the lane groups hold different taps of the same channels
#pragma unroll
  for (int o = S::kLanes; o < 32; o <<= 1) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      f[k] += __shfl_xor_sync(kFull, f[k], o);
      fdr[k] += __shfl_xor_sync(kFull, fdr[k], o);
      fdc[k] += __shfl_xor_sync(kFull, fdc[k], o);
    }
  }

  if (l2) {
    // XLA form of the JAX package: 1 / max(||f||, 1e-20); a group's lanes
    // hold all C channels once
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) ss += f[k] * f[k];
#pragma unroll
    for (int o = S::kLanes / 2; o > 0; o >>= 1)
      ss += __shfl_xor_sync(kFull, ss, o);
    const float inv = 1.0f / fmaxf(sqrtf(ss), 1e-20f);
    float pr = 0.f, pc = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      f[k] *= inv;
      fdr[k] *= inv;
      fdc[k] *= inv;
      pr += f[k] * fdr[k];
      pc += f[k] * fdc[k];
    }
#pragma unroll
    for (int o = S::kLanes / 2; o > 0; o >>= 1) {
      pr += __shfl_xor_sync(kFull, pr, o);
      pc += __shfl_xor_sync(kFull, pc, o);
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      fdr[k] -= pr * f[k];
      fdc[k] -= pc * f[k];
    }
  }

  const int64_t o = static_cast<int64_t>(q) * C + unit * V;
  store4(f_out + o, f, group);
  store4(dr_out + o, fdr, group);
  store4(dc_out + o, fdc, group);
}

// What a warp carries from one query to the next.
struct Walk {
  int q, q1, stride;  // the query being reduced, the next one, the step
  Query cur, nxt;     // their (r, c, row_base)
};

// One step of the pipeline: request the taps of query q1 into `want` and the
// indices of the query after it, reduce query q from `have`, move on. False
// when q was the warp's last query.
template <typename T, int C>
__device__ __forceinline__ bool walk_step(
    const T* __restrict__ rows, const int32_t* __restrict__ row_base,
    const float* __restrict__ rq, const float* __restrict__ cq, int n, int h,
    int w, int l2, int group, int unit, Walk& s,
    const uint4 (&have)[VecShape<T, C>::kLoads],
    uint4 (&want)[VecShape<T, C>::kLoads], float* __restrict__ f_out,
    float* __restrict__ dr_out, float* __restrict__ dc_out) {
  const int q2 = s.q1 + s.stride;
  Query ahead = s.nxt;
  if (s.q1 < n) {
    request_taps<T, C>(rows, s.nxt, h, w, group, unit, want);
    if (q2 < n) ahead = load_query(row_base, rq, cq, q2);
  }
  reduce_and_store<T, C>(s.cur, have, s.q, group, unit, l2, f_out, dr_out,
                         dc_out);
  if (s.q1 >= n) return false;
  s.q = s.q1;
  s.q1 = q2;
  s.cur = s.nxt;
  s.nxt = ahead;
  return true;
}

template <typename T, int C>
__global__ void __launch_bounds__(32 * kWarpsPerBlock,
                                  VecShape<T, C>::kBlocksPerSM)
interp_kernel_vec(const T* __restrict__ rows,
                  const int32_t* __restrict__ row_base,
                  const float* __restrict__ rq, const float* __restrict__ cq,
                  int n, int h, int w, int l2, float* __restrict__ f_out,
                  float* __restrict__ dr_out, float* __restrict__ dc_out) {
  using S = VecShape<T, C>;
  const int lane = threadIdx.x & 31;
  const int group = lane / S::kLanes;
  const int unit = lane % S::kLanes;
  Walk s;
  s.stride = gridDim.x * kWarpsPerBlock;
  s.q = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (s.q >= n) return;  // whole warp leaves together

  // when the loop is entered the taps of q and the indices of q + stride
  // are in flight; the two tap buffers (registers) swap roles every step
  uint4 taps_a[S::kLoads], taps_b[S::kLoads];
  s.cur = load_query(row_base, rq, cq, s.q);
  request_taps<T, C>(rows, s.cur, h, w, group, unit, taps_a);
  s.q1 = s.q + s.stride;
  s.nxt = s.cur;
  if (s.q1 < n) s.nxt = load_query(row_base, rq, cq, s.q1);
  while (walk_step<T, C>(rows, row_base, rq, cq, n, h, w, l2, group, unit, s,
                         taps_a, taps_b, f_out, dr_out, dc_out) &&
         walk_step<T, C>(rows, row_base, rq, cq, n, h, w, l2, group, unit, s,
                         taps_b, taps_a, f_out, dr_out, dc_out)) {
  }
}

// ---------------------------------------------------------------------------
// wide vector variant (C = 256, 512)
// ---------------------------------------------------------------------------

template <typename T, int C>
struct WideShape {
  static constexpr int kVec = 16 / sizeof(T);       // channels per unit
  static constexpr int kUnits = C / kVec;           // units per pixel
  static constexpr int kPer = kUnits / 32;          // units per lane
  static constexpr int kCh = kVec * kPer;           // channels per lane
  static constexpr int kRowsPerBatch = 4 / kPer;    // 16 loads in flight
  static_assert(C % kVec == 0 && kUnits % 32 == 0 &&
                    (kPer == 1 || kPer == 2 || kPer == 4),
                "a pixel must be 32, 64 or 128 16-byte units");
};

// A lane's V channels of one output as V / 4 float4 stores.
template <int V>
__device__ __forceinline__ void store_unit(float* __restrict__ out,
                                           const float* x) {
#pragma unroll
  for (int k = 0; k < V; k += 4)
    *reinterpret_cast<float4*>(out + k) =
        make_float4(x[k], x[k + 1], x[k + 2], x[k + 3]);
}

template <typename T, int C>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
interp_kernel_wide(const T* __restrict__ rows,
                   const int32_t* __restrict__ row_base,
                   const float* __restrict__ rq, const float* __restrict__ cq,
                   int n, int h, int w, int l2, float* __restrict__ f_out,
                   float* __restrict__ dr_out, float* __restrict__ dc_out) {
  using S = WideShape<T, C>;
  constexpr int V = S::kVec;
  constexpr int B = S::kRowsPerBatch;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (q >= n) return;  // whole warp leaves together

  const Query s = load_query(row_base, rq, cq, q);
  const float fr = floorf(s.r);
  const float fc = floorf(s.c);
  float wr[4], dwr[4], wc[4], dwc[4];
  catmull_rom(s.r - fr, wr, dwr);
  catmull_rom(s.c - fc, wc, dwc);
  const int br = static_cast<int>(fr);
  const int bc = static_cast<int>(fc);
  int64_t col[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    col[j] = static_cast<int64_t>(min(max(bc - 1 + j, 0), w - 1)) *
                 S::kUnits + lane;
  const uint4* px = reinterpret_cast<const uint4*>(rows);
  const int64_t row_units = static_cast<int64_t>(w) * S::kUnits;

  float f[S::kCh], fdr[S::kCh], fdc[S::kCh];
#pragma unroll
  for (int k = 0; k < S::kCh; ++k) f[k] = fdr[k] = fdc[k] = 0.f;

#pragma unroll
  for (int i0 = 0; i0 < 4; i0 += B) {
    uint4 taps[B][4][S::kPer];
#pragma unroll
    for (int ii = 0; ii < B; ++ii) {
      const int ri = min(max(br - 1 + i0 + ii, 0), h - 1);
      const int64_t row = (static_cast<int64_t>(s.base) + ri) * row_units;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int p = 0; p < S::kPer; ++p)
          taps[ii][j][p] = __ldg(px + row + col[j] + 32 * p);
    }
#pragma unroll
    for (int ii = 0; ii < B; ++ii) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float a = wr[i0 + ii] * wc[j];
        const float b = dwr[i0 + ii] * wc[j];
        const float d = wr[i0 + ii] * dwc[j];
#pragma unroll
        for (int p = 0; p < S::kPer; ++p) {
          float v[V];
          unpack(taps[ii][j][p], v, static_cast<const T*>(nullptr));
#pragma unroll
          for (int k = 0; k < V; ++k) {
            f[p * V + k] = fmaf(a, v[k], f[p * V + k]);
            fdr[p * V + k] = fmaf(b, v[k], fdr[p * V + k]);
            fdc[p * V + k] = fmaf(d, v[k], fdc[p * V + k]);
          }
        }
      }
    }
  }

  if (l2) {
    // XLA form of the JAX package: 1 / max(||f||, 1e-20)
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < S::kCh; ++k) ss += f[k] * f[k];
    const float inv = 1.0f / fmaxf(sqrtf(warp_sum(ss)), 1e-20f);
    float pr = 0.f, pc = 0.f;
#pragma unroll
    for (int k = 0; k < S::kCh; ++k) {
      f[k] *= inv;
      fdr[k] *= inv;
      fdc[k] *= inv;
      pr += f[k] * fdr[k];
      pc += f[k] * fdc[k];
    }
    pr = warp_sum(pr);
    pc = warp_sum(pc);
#pragma unroll
    for (int k = 0; k < S::kCh; ++k) {
      fdr[k] -= pr * f[k];
      fdc[k] -= pc * f[k];
    }
  }

#pragma unroll
  for (int p = 0; p < S::kPer; ++p) {
    const int64_t o = static_cast<int64_t>(q) * C + (lane + 32 * p) * V;
    store_unit<V>(f_out + o, f + p * V);
    store_unit<V>(dr_out + o, fdr + p * V);
    store_unit<V>(dc_out + o, fdc + p * V);
  }
}

// ---------------------------------------------------------------------------
// narrow variant (1 <= C <= 8)
// ---------------------------------------------------------------------------

constexpr int kNarrowWarps = 4;

// One stored element as it arrives in a register, and as a float.
__device__ __forceinline__ float load_raw(const float* p) { return __ldg(p); }
__device__ __forceinline__ unsigned short load_raw(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(unsigned short x) {
  return __uint_as_float(static_cast<unsigned>(x) << 16);
}

// The Catmull-Rom weights, the FMA, the square root and the maximum in the
// narrow variant's sum type (float, or double with L2).
__device__ __forceinline__ void catmull_rom(double t, double w[4],
                                            double dw[4]) {
  const double t2 = t * t;
  const double t3 = t2 * t;
  w[0] = -0.5 * t3 + t2 - 0.5 * t;
  w[1] = 1.5 * t3 - 2.5 * t2 + 1.0;
  w[2] = -1.5 * t3 + 2.0 * t2 + 0.5 * t;
  w[3] = 0.5 * t3 - 0.5 * t2;
  dw[0] = -1.5 * t2 + 2.0 * t - 0.5;
  dw[1] = 4.5 * t2 - 5.0 * t;
  dw[2] = -4.5 * t2 + 4.0 * t + 0.5;
  dw[3] = 1.5 * t2 - t;
}
__device__ __forceinline__ float mad(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double mad(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ double inv_norm(double ss) {
  return 1.0 / fmax(sqrt(ss), 1e-20);
}

// One output of a warp's queries: the lanes' [32, C] sums through the warp's
// shared buffer, then C stores of 32 contiguous floats (count: the floats
// of the warp's queries that exist).
template <int C, typename A>
__device__ __forceinline__ void store_warp(float* __restrict__ out,
                                           float* buf, const A (&x)[C],
                                           int lane, int count) {
#pragma unroll
  for (int k = 0; k < C; ++k) buf[lane * C + k] = static_cast<float>(x[k]);
  __syncwarp();
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int i = lane + 32 * k;
    if (i < count) out[i] = buf[i];
  }
  __syncwarp();
}

// L2: normalize with the chain rule, summing in double (see the top).
template <typename T, int C, bool L2>
__global__ void __launch_bounds__(32 * kNarrowWarps)
interp_kernel_narrow(const T* __restrict__ rows,
                     const int32_t* __restrict__ row_base,
                     const float* __restrict__ rq,
                     const float* __restrict__ cq, int n, int h, int w,
                     float* __restrict__ f_out, float* __restrict__ dr_out,
                     float* __restrict__ dc_out) {
  using A = typename std::conditional<L2, double, float>::type;
  // all 16 taps in flight up to C = 4, two rows of them beyond
  constexpr int B = C <= 4 ? 4 : 2;
  __shared__ float stage[kNarrowWarps][32 * C];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = (blockIdx.x * kNarrowWarps + warp) * 32;
  if (first >= n) return;  // whole warp leaves together
  // lanes past the last query compute its value again and store nothing
  const int q = min(first + lane, n - 1);

  const Query s = load_query(row_base, rq, cq, q);
  const float fr = floorf(s.r);
  const float fc = floorf(s.c);
  // the offsets within the cell are exact in float
  A wr[4], dwr[4], wc[4], dwc[4];
  catmull_rom(static_cast<A>(s.r - fr), wr, dwr);
  catmull_rom(static_cast<A>(s.c - fc), wc, dwc);
  const int br = static_cast<int>(fr);
  const int bc = static_cast<int>(fc);
  int64_t col[4], row[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    col[k] = static_cast<int64_t>(min(max(bc - 1 + k, 0), w - 1)) * C;
    row[k] = (static_cast<int64_t>(s.base) + min(max(br - 1 + k, 0), h - 1)) *
             w * C;
  }

  A f[C], fdr[C], fdc[C];
#pragma unroll
  for (int k = 0; k < C; ++k) f[k] = fdr[k] = fdc[k] = 0;
#pragma unroll
  for (int i0 = 0; i0 < 4; i0 += B) {
    decltype(load_raw(rows)) taps[B][4][C];
#pragma unroll
    for (int ii = 0; ii < B; ++ii)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < C; ++k)
          taps[ii][j][k] = load_raw(rows + row[i0 + ii] + col[j] + k);
#pragma unroll
    for (int ii = 0; ii < B; ++ii) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const A a = wr[i0 + ii] * wc[j];
        const A b = dwr[i0 + ii] * wc[j];
        const A d = wr[i0 + ii] * dwc[j];
#pragma unroll
        for (int k = 0; k < C; ++k) {
          const A v = widen(taps[ii][j][k]);
          f[k] = mad(a, v, f[k]);
          fdr[k] = mad(b, v, fdr[k]);
          fdc[k] = mad(d, v, fdc[k]);
        }
      }
    }
  }

  if constexpr (L2) {
    // XLA form of the JAX package: 1 / max(||f||, 1e-20)
    double ss = 0.0;
#pragma unroll
    for (int k = 0; k < C; ++k) ss += f[k] * f[k];
    const double inv = inv_norm(ss);
    double pr = 0.0, pc = 0.0;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      f[k] *= inv;
      fdr[k] *= inv;
      fdc[k] *= inv;
      pr += f[k] * fdr[k];
      pc += f[k] * fdc[k];
    }
#pragma unroll
    for (int k = 0; k < C; ++k) {
      fdr[k] -= pr * f[k];
      fdc[k] -= pc * f[k];
    }
  }

  const int64_t o = static_cast<int64_t>(first) * C;
  const int count = min(32, n - first) * C;
  store_warp<C>(f_out + o, stage[warp], f, lane, count);
  store_warp<C>(dr_out + o, stage[warp], fdr, lane, count);
  store_warp<C>(dc_out + o, stage[warp], fdc, lane, count);
}

// ---------------------------------------------------------------------------
// general variant
// ---------------------------------------------------------------------------

template <typename T, int K>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
interp_kernel_general(const T* __restrict__ rows,
                      const int32_t* __restrict__ row_base,
                      const float* __restrict__ rq,
                      const float* __restrict__ cq, int n, int h, int w, int c,
                      int l2, float* __restrict__ f_out,
                      float* __restrict__ dr_out, float* __restrict__ dc_out) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (q >= n) return;  // whole warp leaves together

  const float r = rq[q];
  const float cc = cq[q];
  const float fr = floorf(r);
  const float fc = floorf(cc);
  float wr[4], dwr[4], wc[4], dwc[4];
  catmull_rom(r - fr, wr, dwr);
  catmull_rom(cc - fc, wc, dwc);
  const int br = static_cast<int>(fr);
  const int bc = static_cast<int>(fc);
  int ri[4], ci[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ri[k] = min(max(br - 1 + k, 0), h - 1);
    ci[k] = min(max(bc - 1 + k, 0), w - 1);
  }
  const int64_t base = static_cast<int64_t>(row_base[q]);

  float f[K], fdr[K],
      fdc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) f[k] = fdr[k] = fdc[k] = 0.f;

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const T* row = rows + (base + ri[i]) * w * c;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const T* px = row + static_cast<int64_t>(ci[j]) * c;
      const float a = wr[i] * wc[j];
      const float b = dwr[i] * wc[j];
      const float d = wr[i] * dwc[j];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int ch = lane + 32 * k;
        if (ch < c) {
          const float v = load_f(px + ch);
          f[k] = fmaf(a, v, f[k]);
          fdr[k] = fmaf(b, v, fdr[k]);
          fdc[k] = fmaf(d, v, fdc[k]);
        }
      }
    }
  }

  if (l2) {
    // XLA form of the JAX package: 1 / max(||f||, 1e-20)
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) ss += f[k] * f[k];
    const float inv = 1.0f / fmaxf(sqrtf(warp_sum(ss)), 1e-20f);
    float pr = 0.f, pc = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      f[k] *= inv;
      fdr[k] *= inv;
      fdc[k] *= inv;
      pr += f[k] * fdr[k];
      pc += f[k] * fdc[k];
    }
    pr = warp_sum(pr);
    pc = warp_sum(pc);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      fdr[k] -= pr * f[k];
      fdc[k] -= pc * f[k];
    }
  }

  const int64_t o = static_cast<int64_t>(q) * c;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int ch = lane + 32 * k;
    if (ch < c) {
      f_out[o + ch] = f[k];
      dr_out[o + ch] = fdr[k];
      dc_out[o + ch] = fdc[k];
    }
  }
}

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------

struct Args {
  const void* rows;
  const int32_t* row_base;
  const float* r;
  const float* c;
  int n, h, w, ch, l2;
  float* f;
  float* dfdr;
  float* dfdc;
  cudaStream_t stream;
};

template <typename T, int C>
int launch_vec(const Args& a) {
  // as many warps as the card holds at once, then fewer so that every warp
  // walks the same number of queries
  int sms = 0;
  const cudaError_t err = pixsfm::sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int resident = sms * VecShape<T, C>::kBlocksPerSM * kWarpsPerBlock;
  const int rounds = (a.n + resident - 1) / resident;
  const int warps = (a.n + rounds - 1) / rounds;
  const int blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  interp_kernel_vec<T, C><<<blocks, 32 * kWarpsPerBlock, 0, a.stream>>>(
      static_cast<const T*>(a.rows), a.row_base, a.r, a.c, a.n, a.h, a.w,
      a.l2, a.f, a.dfdr, a.dfdc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int C>
int launch_wide(const Args& a) {
  const int blocks = (a.n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  interp_kernel_wide<T, C><<<blocks, 32 * kWarpsPerBlock, 0, a.stream>>>(
      static_cast<const T*>(a.rows), a.row_base, a.r, a.c, a.n, a.h, a.w,
      a.l2, a.f, a.dfdr, a.dfdc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_general(const Args& a) {
  const int blocks = (a.n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (a.ch <= 256) {
    interp_kernel_general<T, 8><<<blocks, 32 * kWarpsPerBlock, 0, a.stream>>>(
        static_cast<const T*>(a.rows), a.row_base, a.r, a.c, a.n, a.h, a.w,
        a.ch, a.l2, a.f, a.dfdr, a.dfdc);
  } else {
    interp_kernel_general<T, 16>
        <<<blocks, 32 * kWarpsPerBlock, 0, a.stream>>>(
            static_cast<const T*>(a.rows), a.row_base, a.r, a.c, a.n, a.h,
            a.w, a.ch, a.l2, a.f, a.dfdr, a.dfdc);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int C>
int launch_narrow(const Args& a) {
  constexpr int per_block = 32 * kNarrowWarps;
  const int blocks = (a.n + per_block - 1) / per_block;
  const T* rows = static_cast<const T*>(a.rows);
  if (a.l2)
    interp_kernel_narrow<T, C, true><<<blocks, per_block, 0, a.stream>>>(
        rows, a.row_base, a.r, a.c, a.n, a.h, a.w, a.f, a.dfdr, a.dfdc);
  else
    interp_kernel_narrow<T, C, false><<<blocks, per_block, 0, a.stream>>>(
        rows, a.row_base, a.r, a.c, a.n, a.h, a.w, a.f, a.dfdr, a.dfdc);
  return static_cast<int>(cudaGetLastError());
}

// The variants by code (pixsfm_interp_variant's and pixsfm_interp_rows').
enum Variant { kGeneral = 0, kVector = 1, kWide = 2, kNarrow = 3 };

template <typename T>
int launch(int variant, const Args& a) {
  switch (variant) {
    case kVector:
      return a.ch == 64 ? launch_vec<T, 64>(a) : launch_vec<T, 128>(a);
    case kWide:
      return a.ch == 256 ? launch_wide<T, 256>(a) : launch_wide<T, 512>(a);
    case kNarrow:
      switch (a.ch) {
        case 1: return launch_narrow<T, 1>(a);
        case 2: return launch_narrow<T, 2>(a);
        case 3: return launch_narrow<T, 3>(a);
        case 4: return launch_narrow<T, 4>(a);
        case 5: return launch_narrow<T, 5>(a);
        case 6: return launch_narrow<T, 6>(a);
        case 7: return launch_narrow<T, 7>(a);
        default: return launch_narrow<T, 8>(a);
      }
    default:
      return launch_general<T>(a);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

int pixsfm_interp_max_channels() { return kMaxChannels; }

// Whether variant (0 = general, 1 = vector, 2 = wide, 3 = narrow) takes
// these arguments: general every C up to 512; narrow 1 <= C <= 8 at any
// alignment; vector C = 64 or 128 and wide C = 256 or 512, when rows and
// the outputs are 16-byte aligned (a null output pointer counts as
// aligned, as torch allocates them).
int pixsfm_interp_takes(int variant, const void* rows, int dtype, int ch,
                        const float* f, const float* dfdr,
                        const float* dfdc) {
  if ((dtype != 0 && dtype != 1) || ch < 1 || ch > kMaxChannels) return 0;
  const bool aligned = aligned16(rows) && aligned16(f) && aligned16(dfdr) &&
                       aligned16(dfdc);
  switch (variant) {
    case kGeneral: return 1;
    case kNarrow: return ch <= 8;
    case kVector: return aligned && (ch == 64 || ch == 128);
    case kWide: return aligned && (ch == 256 || ch == 512);
    default: return 0;
  }
}

// Which variant pixsfm_interp_rows takes for these arguments when none is
// forced: narrow up to 8 channels, else vector or wide where they take the
// arguments, else general (for tests and the smoke run; the launch's rule).
int pixsfm_interp_variant(const void* rows, int dtype, int ch, const float* f,
                          const float* dfdr, const float* dfdc) {
  const Variant order[3] = {kNarrow, kVector, kWide};
  for (int i = 0; i < 3; ++i)
    if (pixsfm_interp_takes(order[i], rows, dtype, ch, f, dfdr, dfdc))
      return order[i];
  return kGeneral;
}

// dtype: 0 = float32 rows, 1 = bfloat16 rows. variant: -1 = the automatic
// choice (pixsfm_interp_variant), else the variant to force (checks and
// timing), which must take the arguments. Returns the cudaError_t of the
// launch (0 = success).
int pixsfm_interp_rows(const void* rows, int dtype, const int32_t* row_base,
                       const float* r, const float* c, int n, int h, int w,
                       int ch, int l2, float* f, float* dfdr, float* dfdc,
                       int variant, void* stream) {
  if (variant < 0) variant = pixsfm_interp_variant(rows, dtype, ch, f, dfdr,
                                                   dfdc);
  if (!pixsfm_interp_takes(variant, rows, dtype, ch, f, dfdr, dfdc))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const Args a{rows, row_base, r, c, n, h, w, ch, l2, f, dfdr, dfdc,
               static_cast<cudaStream_t>(stream)};
  return dtype == 0 ? launch<float>(variant, a)
                    : launch<__nv_bfloat16>(variant, a);
}

}  // extern "C"
