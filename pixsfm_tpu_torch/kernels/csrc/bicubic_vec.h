// The vector read of kernel K1 (interpolate.cu, interp_kernel_vec) as device
// code that other kernels reuse: a warp reads one query's 4 x 4 Catmull-Rom
// taps of a bf16 or f32 pixel of C = 64 or 128 channels with 16-byte loads, a
// lane per 16 bytes of a pixel (VecShape), requested before the first use
// (request_taps), and reduces them to the value and both derivatives of the
// lane's channels, L2-normalized with the chain rule when asked
// (reduce_taps). interpolate.cu explains the design; the fused BA evaluation
// (ba_eval.cu, K4) reads its observations' patches through the same code.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pixsfm {

constexpr unsigned kFull = 0xffffffffu;

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

// The lane's channels of one query from its taps: the value f and the
// derivatives fdr (along rows) and fdc (along columns), summed in float32
// over the lane groups (every group ends with the same sums) and, with l2,
// L2-normalized with the chain rule applied to both derivatives.
template <typename T, int C>
__device__ __forceinline__ void reduce_taps(
    const Query& s, const uint4 (&taps)[VecShape<T, C>::kLoads], int group,
    int l2, float (&f)[VecShape<T, C>::kVec],
    float (&fdr)[VecShape<T, C>::kVec], float (&fdc)[VecShape<T, C>::kVec]) {
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
}

}  // namespace pixsfm
