// Fused evaluation of feature-reference bundle adjustment (K4).
//
// One launch evaluates a whole observation axis of ba_solve
// (pixsfm_tpu_torch/ops/schur.py) for the feature-reference residual
// r = read(patch, coords(project(pose, camera, point))) - target
// (bundle_adjustment/main.py, _build_feature_reference_jac), in place of the
// chunk loop's ~150 PyTorch launches a chunk: per observation slot it reads
// its pose, camera and point by index, projects with the closed-form
// Jacobian (base/projection.project_with_jac; SIMPLE_PINHOLE, PINHOLE,
// SIMPLE_RADIAL, RADIAL), maps to patch coordinates (_Patches.coords), reads
// the bicubic value and both derivatives of the C = 64 / 128 bf16 or f32
// patch row with K1's vector read (bicubic_vec.h), L2 chain rule included,
// subtracts the target, adds the check_bounds row when asked, and robustifies
// with the loss (base/losses.py; the Ceres rho on the squared norm and its
// derivative as the IRLS weight w).
//
// The normal-equation terms come without the [C, 6+k+3] Jacobian. Every row
// of the Jacobian is J[c] = a[c] Jc + b[c] Jr, with Jc and Jr the pixel
// Jacobian's two rows scaled into patch coordinates and (a, b) = (df/dc,
// df/dr) of channel c (the check_bounds row has the same form), so the
// Gram matrix w [J | r]^T [J | r] is exactly
//   G[i][j] = w (Saa Jc_i Jc_j + Sab (Jc_i Jr_j + Jr_i Jc_j) + Sbb Jr_i Jr_j)
//   G[i][r] = w (Sar Jc_i + Sbr Jr_i)
// from six sums over the channels: Saa = sum a^2, Sab = sum a b, Sbb = sum
// b^2, Sar = sum a r, Sbr = sum b r and Srr = sum r^2 (the squared norm).
// The sums and the entries are taken in float64, as a margin for entries
// much smaller than their three terms (where the rows a Jc + b Jr nearly
// cancel); on the card tests' random and smooth features a float32 variant
// reads the same within the rounding of the patch coordinates, which
// dominates there. The chunk loop sums the products of the rows themselves
// in float32.
//
// Three modes, the three evaluations ba_solve makes: cost (the cost alone),
// points (also each slot's point rows ptv [n, 12]: the 3 x 3 point block and
// the point gradient) and full (also the camera-point blocks B [n, 6+k, 3],
// and the image rows [I, 42 + 6k] and camera rows [Nc, k*k + k] of the
// normal equations, summed over the observations here with float atomics,
// as index_add_ sums them in the chunk loop, so no per-observation copy of
// them is kept). Slots that are not valid (grid holes, observations without
// a patch or a reference) write exact zeros to ptv and B and add nothing.
// The cost leaves as one float64 partial sum a block.
//
// Work split: a warp takes a tile of 32 consecutive slots. Each lane first
// prepares one slot: its indices, parameters, projection, Jacobian and patch
// coordinates, in parallel (the index -> parameter -> projection chain is
// paid once for 32 slots, and holes cost one byte-load); the scaled
// Jacobian rows go to the warp's shared memory. Then the warp walks the
// tile's valid slots, each read with K1's layout (a lane per 16 bytes of a
// pixel, all taps requested before the first use), reduces the six sums
// over a pixel's lanes, and has each lane compute a share of the slot's
// output entries from the sums and the shared Jacobian rows. Bound on the
// card: the patch bytes (16 taps x C channels a valid slot) and the target
// rows (C floats), as K1.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (pixsfm_tpu_torch/ops/ba_eval_cuda.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bicubic_vec.h"
#include "device_info.h"

namespace pixsfm {

// The launch's arguments (mirrored by ops/ba_eval_cuda.py's _Params); named
// outside the file's own namespace, as the C entry point takes them.
struct BaEvalParams {
  const uint8_t* valid;    // [n] bool
  const int64_t* img;      // [n] image slot
  const int64_t* cam;      // [n] camera slot
  const int64_t* pt;       // [n] point slot
  const int64_t* row;      // [n] patch of each slot
  const float* qvec;       // [I, 4]
  const float* tvec;       // [I, 3]
  const float* cams;       // [Nc, k]
  const float* xyz;        // [Np, 3]
  const float* corners;    // [B, 2] (x, y)
  const float* scales;     // [B, 2]
  const float* ups;        // [B]
  const float* target;     // [n, C]
  const void* rows;        // [B * h, w, C] bf16 or f32
  double* cost;            // [blocks] partial sums of loss(sq)
  float* ptv;              // [n, 12]            (points, full)
  float* B;                // [n, 6 + k, 3]      (full)
  float* img_acc;          // [I, 42 + 6k], zero (full)
  float* cam_acc;          // [Nc, k * k + k], zero (full)
  int64_t n;
  int mode, model, k, check_bounds, l2, loss, h, w;
  float loss_a, loss_a2, loss_scale;
};

}  // namespace pixsfm

namespace {

using Params = pixsfm::BaEvalParams;

using pixsfm::kFull;
using pixsfm::Query;
using pixsfm::reduce_taps;
using pixsfm::request_taps;
using pixsfm::VecShape;

constexpr int kWarps = 4;         // warps per block
constexpr int kMaxK = 5;          // camera parameters (RADIAL)
constexpr int kMaxD = 9 + kMaxK;  // tangent columns: pose 6, camera k, point 3

enum Mode { kModeCost = 0, kModePoints = 1, kModeFull = 2 };
enum Model { kSimplePinhole = 0, kPinhole = 1, kSimpleRadial = 2, kRadial = 3 };
enum Loss {
  kTrivial = 0, kScaled = 1, kHuber = 2, kSoftL1 = 3, kCauchy = 4,
  kArctan = 5, kTukey = 6
};


template <typename T, int C>
struct EvalShape {
  // f32 rows at C = 128 keep 16 loads a lane in flight (64 registers)
  static constexpr int kBlocksPerSM = VecShape<T, C>::kLoads > 8 ? 3 : 4;
};

// What a lane prepares of its slot and the warp later shuffles out.
struct Slot {
  float r, c;               // patch coordinates (row, column)
  int base;                 // first row of the slot's patch
  float viol, dvr, dvc;     // the check_bounds row: residual, d/dr, d/dc
  long long img, cam;
};

// rho(s) and rho'(s) of base/losses.py (unscaled); a2 = a * a.
__device__ __forceinline__ void robust(int loss, float a, float a2, float s,
                                       float& rho, float& w) {
  switch (loss) {
    case kScaled:
      rho = a * s;
      w = a;
      return;
    case kHuber:
      if (s <= a2) {
        rho = s;
        w = 1.f;
      } else {
        rho = 2.f * a * sqrtf(fmaxf(s, 0.f)) - a2;
        w = a / sqrtf(fmaxf(s, 1e-20f));
      }
      return;
    case kSoftL1: {
      const float t = 1.f + s / a2;
      rho = 2.f * a2 * (sqrtf(t) - 1.f);
      w = 1.f / sqrtf(t);
      return;
    }
    case kCauchy:
      rho = a2 * log1pf(s / a2);
      w = 1.f / (1.f + s / a2);
      return;
    case kArctan:
      rho = a * atan2f(s, a);
      w = a * a / (a * a + s * s);
      return;
    case kTukey:
      if (s <= a2) {
        const float t = 1.f - s / a2;
        rho = a2 / 3.f * (1.f - t * t * t);
        w = t * t;
      } else {
        rho = a2 / 3.f;
        w = 0.f;
      }
      return;
    default:  // trivial
      rho = s;
      w = 1.f;
  }
}

// Prepare slot s (valid): project its point with the closed-form Jacobian of
// base/projection.project_with_jac, scale the two pixel rows into patch
// coordinates and store them at jrow[0, D) (column row, Jc) and
// jrow[kMaxD, kMaxD + D) (row row, Jr) in the tangent layout [omega(3),
// dt(3), camera(k), point(3)].
__device__ __forceinline__ void prepare(const Params& p, int64_t s,
                                        float* jrow, Slot& o) {
  const int64_t im = p.img[s], cm = p.cam[s], pt = p.pt[s], rw = p.row[s];
  const int k = p.k;
  const float qw = __ldg(p.qvec + 4 * im), qx = __ldg(p.qvec + 4 * im + 1),
              qy = __ldg(p.qvec + 4 * im + 2), qz = __ldg(p.qvec + 4 * im + 3);
  float t[3], X[3], cp[kMaxK];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    t[i] = __ldg(p.tvec + 3 * im + i);
    X[i] = __ldg(p.xyz + 3 * pt + i);
  }
#pragma unroll
  for (int i = 0; i < kMaxK; ++i) cp[i] = i < k ? __ldg(p.cams + k * cm + i) : 0.f;

  const float nq = qw * qw + qx * qx + qy * qy + qz * qz;
  const float sq = nq > 0.f ? 2.f / nq : 0.f;
  const float wx = sq * qw * qx, wy = sq * qw * qy, wz = sq * qw * qz;
  const float xx = sq * qx * qx, xy = sq * qx * qy, xz = sq * qx * qz;
  const float yy = sq * qy * qy, yz = sq * qy * qz, zz = sq * qz * qz;
  const float R[3][3] = {{1.f - (yy + zz), xy - wz, xz + wy},
                         {xy + wz, 1.f - (xx + zz), yz - wx},
                         {xz - wy, yz + wx, 1.f - (xx + yy)}};
  float RX[3], xc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    RX[i] = R[i][0] * X[0] + R[i][1] * X[1] + R[i][2] * X[2];
    xc[i] = RX[i] + t[i];
  }
  const float zc = fabsf(xc[2]) < 1e-8f ? 1e-8f : xc[2];
  const float iz = 1.f / zc;
  const float u = xc[0] * iz, v = xc[1] * iz;

  // the camera model: distortion d(u, v), its 2 x 2 Jacobian, the
  // intrinsics' columns
  float fx, fy, cx, cy, du = u, dv = v;
  float J00 = 1.f, J01 = 0.f, J10 = 0.f, J11 = 1.f;   // d d / d uv
  float Jcam[2][kMaxK];
#pragma unroll
  for (int i = 0; i < kMaxK; ++i) Jcam[0][i] = Jcam[1][i] = 0.f;
  if (p.model == kPinhole) {
    fx = cp[0];
    fy = cp[1];
    cx = cp[2];
    cy = cp[3];
  } else {
    fx = fy = cp[0];
    cx = cp[1];
    cy = cp[2];
  }
  if (p.model == kSimpleRadial || p.model == kRadial) {
    const float r2 = u * u + v * v;
    float radial, drad;
    if (p.model == kSimpleRadial) {
      radial = 1.f + cp[3] * r2;
      drad = cp[3];
      Jcam[0][3] = fx * (u * r2);
      Jcam[1][3] = fy * (v * r2);
    } else {
      radial = 1.f + r2 * (cp[3] + cp[4] * r2);
      drad = cp[3] + 2.f * cp[4] * r2;
      Jcam[0][3] = fx * (u * r2);
      Jcam[1][3] = fy * (v * r2);
      Jcam[0][4] = fx * (u * (r2 * r2));
      Jcam[1][4] = fy * (v * (r2 * r2));
    }
    J00 = radial + 2.f * drad * u * u;
    J01 = 2.f * drad * u * v;
    J10 = 2.f * drad * u * v;
    J11 = radial + 2.f * drad * v * v;
    du = u * radial;
    dv = v * radial;
  }
  if (p.model == kPinhole) {
    Jcam[0][0] = du;
    Jcam[1][1] = dv;
    Jcam[0][2] = 1.f;
    Jcam[1][3] = 1.f;
  } else {
    Jcam[0][0] = du;
    Jcam[1][0] = dv;
    Jcam[0][1] = 1.f;
    Jcam[1][2] = 1.f;
  }
  const float pix0 = fx * du + cx, pix1 = fy * dv + cy;
  const float Juv[2][2] = {{fx * J00, fx * J01}, {fy * J10, fy * J11}};

  // patch coordinates and their derivative in the pixel
  const float sx = __ldg(p.scales + 2 * rw), sy = __ldg(p.scales + 2 * rw + 1);
  const float up = __ldg(p.ups + rw);
  o.c = (pix0 * sx - 0.5f - __ldg(p.corners + 2 * rw)) * up;
  o.r = (pix1 * sy - 0.5f - __ldg(p.corners + 2 * rw + 1)) * up;
  const float su[2] = {sx * up, sy * up};

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float* out = jrow + i * kMaxD;
    const float A0 = Juv[i][0] * iz, A1 = Juv[i][1] * iz;
    const float A2 = -(Juv[i][0] * u + Juv[i][1] * v) * iz;
    out[0] = su[i] * -(A1 * RX[2] - A2 * RX[1]);
    out[1] = su[i] * -(-A0 * RX[2] + A2 * RX[0]);
    out[2] = su[i] * -(A0 * RX[1] - A1 * RX[0]);
    out[3] = su[i] * A0;
    out[4] = su[i] * A1;
    out[5] = su[i] * A2;
#pragma unroll
    for (int e = 0; e < kMaxK; ++e)
      if (e < k) out[6 + e] = su[i] * Jcam[i][e];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[6 + k + j] = su[i] * (A0 * R[0][j] + A1 * R[1][j] + A2 * R[2][j]);
  }

  o.base = static_cast<int>(rw * p.h);
  const float hh = p.h - 1.f, ww = p.w - 1.f;
  o.viol = fmaxf(o.r - hh, 0.f) + fmaxf(-o.r, 0.f) + fmaxf(o.c - ww, 0.f) +
           fmaxf(-o.c, 0.f);
  o.dvr = static_cast<float>(o.r > hh) - static_cast<float>(o.r < 0.f);
  o.dvc = static_cast<float>(o.c > ww) - static_cast<float>(o.c < 0.f);
  o.img = im;
  o.cam = cm;
}

// Entry e of a slot's outputs: its Gram coordinates (i, j), j == D naming
// the residual column, and where it goes. Order: ptv (12: the point block
// row-major, then the point gradient), B (3 (6 + k): the camera-side rows
// against the point columns), the image row (36: pose block, 6: pose
// gradient, 6k: pose-intrinsics block) and the camera row (k * k:
// intrinsics block, k: intrinsics gradient).
struct Entry {
  int i, j;
  float* dst;
  bool add;
};

__device__ __forceinline__ Entry entry(const Params& p, int e, int64_t s,
                                       long long im, long long cm) {
  const int k = p.k, NR = 6 + k, D = NR + 3, nb = 3 * NR;
  const int n_img = 42 + 6 * k;
  Entry o;
  o.add = false;
  if (e < 12) {
    o.i = NR + (e < 9 ? e / 3 : e - 9);
    o.j = e < 9 ? NR + e % 3 : D;
    o.dst = p.ptv + s * 12 + e;
    return o;
  }
  e -= 12;
  if (e < nb) {
    o.i = e / 3;
    o.j = NR + e % 3;
    o.dst = p.B + s * nb + e;
    return o;
  }
  e -= nb;
  o.add = true;
  if (e < n_img) {
    if (e < 36) {
      o.i = e / 6;
      o.j = e % 6;
    } else if (e < 42) {
      o.i = e - 36;
      o.j = D;
    } else {
      o.i = (e - 42) / k;
      o.j = 6 + (e - 42) % k;
    }
    o.dst = p.img_acc + im * n_img + e;
    return o;
  }
  e -= n_img;
  if (e < k * k) {
    o.i = 6 + e / k;
    o.j = 6 + e % k;
  } else {
    o.i = 6 + e - k * k;
    o.j = D;
  }
  o.dst = p.cam_acc + cm * (k * k + k) + e;
  return o;
}

template <typename T, int C>
__global__ void __launch_bounds__(32 * kWarps, EvalShape<T, C>::kBlocksPerSM)
ba_eval_fused(const Params p) {
  using S = VecShape<T, C>;
  constexpr int V = S::kVec;
  __shared__ float jac[kWarps][32][2 * kMaxD];
  __shared__ double warp_cost[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = lane / S::kLanes;
  const int unit = lane % S::kLanes;
  const int k = p.k, NR = 6 + k, D = NR + 3, nb = 3 * NR;
  const int n_out = p.mode == kModeFull ? 12 + nb + 42 + 6 * k + k * k + k
                    : p.mode == kModePoints ? 12 : 0;
  const T* rows = static_cast<const T*>(p.rows);
  double cost = 0.0;

  const int64_t tiles = (p.n + 31) / 32;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t tile = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
       tile < tiles; tile += stride) {
    const int64_t s0 = tile * 32;
    const int64_t mine = s0 + lane;
    Slot sl{};
    const bool valid = mine < p.n && p.valid[mine];
    if (valid) prepare(p, mine, &jac[warp][lane][0], sl);
    __syncwarp();
    const unsigned live = __ballot_sync(kFull, valid);

    // holes: exact zeros in the per-slot outputs, as the masked chain gives
    if (p.mode != kModeCost) {
      const int in_tile = p.n - s0 < 32 ? static_cast<int>(p.n - s0) : 32;
      for (int e = lane; e < 32 * 12; e += 32) {
        const int j = e / 12;
        if (j < in_tile && !((live >> j) & 1u)) p.ptv[s0 * 12 + e] = 0.f;
      }
      if (p.mode == kModeFull)
        for (int e = lane; e < 32 * nb; e += 32) {
          const int j = e / nb;
          if (j < in_tile && !((live >> j) & 1u)) p.B[s0 * nb + e] = 0.f;
        }
    }

    unsigned todo = live;
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const int64_t s = s0 + j;
      Query q;
      q.r = __shfl_sync(kFull, sl.r, j);
      q.c = __shfl_sync(kFull, sl.c, j);
      q.base = __shfl_sync(kFull, sl.base, j);
      uint4 taps[S::kLoads];
      request_taps<T, C>(rows, q, p.h, p.w, group, unit, taps);
      float tg[V];
      const float4* tp =
          reinterpret_cast<const float4*>(p.target + s * C + unit * V);
#pragma unroll
      for (int m = 0; m < V / 4; ++m) {
        const float4 x = __ldg(tp + m);
        tg[4 * m] = x.x;
        tg[4 * m + 1] = x.y;
        tg[4 * m + 2] = x.z;
        tg[4 * m + 3] = x.w;
      }
      float f[V], fdr[V], fdc[V];
      reduce_taps<T, C>(q, taps, group, p.l2, f, fdr, fdc);

      // the six channel sums, in float64 (the Gram entries below combine
      // them with cancellation); every lane group holds all C channels once
      double Saa = 0.0, Sab = 0.0, Sbb = 0.0, Sar = 0.0, Sbr = 0.0,
             Srr = 0.0;
#pragma unroll
      for (int m = 0; m < V; ++m) {
        const double a = fdc[m], b = fdr[m], r = f[m] - tg[m];
        Saa = fma(a, a, Saa);
        Sab = fma(a, b, Sab);
        Sbb = fma(b, b, Sbb);
        Sar = fma(a, r, Sar);
        Sbr = fma(b, r, Sbr);
        Srr = fma(r, r, Srr);
      }
#pragma unroll
      for (int o = S::kLanes / 2; o > 0; o >>= 1) {
        Saa += __shfl_xor_sync(kFull, Saa, o);
        Sab += __shfl_xor_sync(kFull, Sab, o);
        Sbb += __shfl_xor_sync(kFull, Sbb, o);
        Sar += __shfl_xor_sync(kFull, Sar, o);
        Sbr += __shfl_xor_sync(kFull, Sbr, o);
        Srr += __shfl_xor_sync(kFull, Srr, o);
      }
      if (p.check_bounds) {
        const double a = __shfl_sync(kFull, sl.dvc, j);
        const double b = __shfl_sync(kFull, sl.dvr, j);
        const double r = __shfl_sync(kFull, sl.viol, j);
        Saa += a * a;
        Sab += a * b;
        Sbb += b * b;
        Sar += a * r;
        Sbr += b * r;
        Srr += r * r;
      }
      float rho, w;
      robust(p.loss, p.loss_a, p.loss_a2, static_cast<float>(Srr), rho, w);
      cost += static_cast<double>(p.loss_scale * rho);
      if (n_out == 0) continue;
      const double wd = static_cast<double>(w * p.loss_scale);

      const long long im = __shfl_sync(kFull, sl.img, j);
      const long long cm = __shfl_sync(kFull, sl.cam, j);
      const float* jc = &jac[warp][j][0];
      const float* jr = jc + kMaxD;
      for (int e = lane; e < n_out; e += 32) {
        const Entry t = entry(p, e, s, im, cm);
        const double ci = jc[t.i], ri = jr[t.i];
        double gd;
        if (t.j == D) {
          gd = Sar * ci + Sbr * ri;
        } else {
          const double cj = jc[t.j], rj = jr[t.j];
          gd = Saa * ci * cj + Sab * (ci * rj + ri * cj) + Sbb * ri * rj;
        }
        const float g = static_cast<float>(wd * gd);
        if (t.add)
          atomicAdd(t.dst, g);
        else
          *t.dst = g;
      }
    }
    __syncwarp();  // the tile's Jacobian rows are read before the next's land
  }

  // lane 0 of every warp holds the same sum as its other lanes
  if (lane == 0) warp_cost[warp] = cost;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) total += warp_cost[i];
    p.cost[blockIdx.x] = total;
  }
}

template <typename T, int C>
int grid_for(int64_t n, int* blocks) {
  int sms = 0;
  const cudaError_t err = pixsfm::sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t resident =
      static_cast<int64_t>(sms) * EvalShape<T, C>::kBlocksPerSM * kWarps;
  const int64_t tiles = (n + 31) / 32;
  const int64_t warps = tiles < resident ? tiles : resident;
  *blocks = static_cast<int>((warps + kWarps - 1) / kWarps);
  return 0;
}

template <typename T, int C>
int launch(const Params& p, int blocks, cudaStream_t stream) {
  ba_eval_fused<T, C><<<blocks, 32 * kWarps, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// The number of blocks (cost partial sums) of a launch over n slots, or
// minus a cudaError_t.
int pixsfm_ba_eval_blocks(long long n, int dtype, int ch) {
  int blocks = 0, err = 0;
  if (n <= 0) return 0;
  if (dtype == 0)
    err = ch == 64 ? grid_for<float, 64>(n, &blocks)
                   : grid_for<float, 128>(n, &blocks);
  else
    err = ch == 64 ? grid_for<__nv_bfloat16, 64>(n, &blocks)
                   : grid_for<__nv_bfloat16, 128>(n, &blocks);
  return err ? -err : blocks;
}

// Launch K4 with `blocks` from pixsfm_ba_eval_blocks over patch rows of
// this storage (0 = float32, 1 = bfloat16) and width (C = 64 or 128), rows
// and targets on 16-byte aligned bases. Returns the cudaError_t of the
// launch (0 = success).
int pixsfm_ba_eval(const Params* p, int dtype, int ch, int blocks,
                   void* stream) {
  if ((dtype != 0 && dtype != 1) || (ch != 64 && ch != 128) ||
      !aligned16(p->rows) || !aligned16(p->target) || p->k < 3 ||
      p->k > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p->n <= 0 || blocks <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return ch == 64 ? launch<float, 64>(*p, blocks, s)
                    : launch<float, 128>(*p, blocks, s);
  return ch == 64 ? launch<__nv_bfloat16, 64>(*p, blocks, s)
                  : launch<__nv_bfloat16, 128>(*p, blocks, s);
}

}  // extern "C"
