// Bicubic window interpolation with derivatives and the L2 chain rule.
//
// Replaces the Pallas TPU kernel pixsfm_tpu/ops/interpolate_pallas.py
// (_make_call, driven by interpolate_rows_pallas) and serves the default
// KA path, whose XLA form is bicubic_window_eval_rows +
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
// (4 KiB at C = 128 in bf16) and writes 3 x C floats; the arithmetic is
// 3 FMAs per tap and channel. Design: one warp per query, channels across
// the lanes (lane l owns channels l, l + 32, ...), so every tap is one
// coalesced read of C contiguous values. The Catmull-Rom weights are
// computed in registers from r and c (the TPU kernel read precomputed dense
// [N, W] column weights). Accumulation is float32; the L2 norm and the two
// chain-rule dot products are warp shuffle reductions. Only the 16 taps are
// read, not the whole 4-row window the TPU kernel copied into VMEM.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (pixsfm_tpu_torch/kernels/__init__.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxChannelsPerLane = 8;  // C <= 256

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
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
interp_kernel(const T* __restrict__ rows, const int32_t* __restrict__ row_base,
              const float* __restrict__ rq, const float* __restrict__ cq,
              int n, int h, int w, int c, int l2, float* __restrict__ f_out,
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

  float f[kMaxChannelsPerLane], fdr[kMaxChannelsPerLane],
      fdc[kMaxChannelsPerLane];
#pragma unroll
  for (int k = 0; k < kMaxChannelsPerLane; ++k) f[k] = fdr[k] = fdc[k] = 0.f;

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
      for (int k = 0; k < kMaxChannelsPerLane; ++k) {
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
    for (int k = 0; k < kMaxChannelsPerLane; ++k) ss += f[k] * f[k];
    const float inv = 1.0f / fmaxf(sqrtf(warp_sum(ss)), 1e-20f);
    float pr = 0.f, pc = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxChannelsPerLane; ++k) {
      f[k] *= inv;
      fdr[k] *= inv;
      fdc[k] *= inv;
      pr += f[k] * fdr[k];
      pc += f[k] * fdc[k];
    }
    pr = warp_sum(pr);
    pc = warp_sum(pc);
#pragma unroll
    for (int k = 0; k < kMaxChannelsPerLane; ++k) {
      fdr[k] -= pr * f[k];
      fdc[k] -= pc * f[k];
    }
  }

  const int64_t o = static_cast<int64_t>(q) * c;
#pragma unroll
  for (int k = 0; k < kMaxChannelsPerLane; ++k) {
    const int ch = lane + 32 * k;
    if (ch < c) {
      f_out[o + ch] = f[k];
      dr_out[o + ch] = fdr[k];
      dc_out[o + ch] = fdc[k];
    }
  }
}

template <typename T>
int launch(const void* rows, const int32_t* row_base, const float* r,
           const float* c, int n, int h, int w, int ch, int l2, float* f,
           float* dfdr, float* dfdc, cudaStream_t stream) {
  if (n == 0) return 0;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  interp_kernel<T><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      static_cast<const T*>(rows), row_base, r, c, n, h, w, ch, l2, f, dfdr,
      dfdc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int pixsfm_interp_max_channels() { return 32 * kMaxChannelsPerLane; }

// dtype: 0 = float32 rows, 1 = bfloat16 rows. Returns the cudaError_t of
// the launch (0 = success).
int pixsfm_interp_rows(const void* rows, int dtype, const int32_t* row_base,
                       const float* r, const float* c, int n, int h, int w,
                       int ch, int l2, float* f, float* dfdr, float* dfdc,
                       void* stream) {
  if (ch > 32 * kMaxChannelsPerLane) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(rows, row_base, r, c, n, h, w, ch, l2, f, dfdr, dfdc, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(rows, row_base, r, c, n, h, w, ch, l2, f,
                                 dfdr, dfdc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
