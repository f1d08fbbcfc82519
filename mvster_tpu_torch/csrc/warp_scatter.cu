// Warp-only bilinear gather (K2) and its scatter-add backward (K3), for
// NVIDIA Hopper (sm_90a).
//
// K2, mvster_warp_gather, replaces the TPU kernel
// mvster_tpu/kernels/pallas_warp.py::_warp_kernel in warp-only mode (the
// entry warp_pallas): the training-forward primal of grid_sample_zeros_vjp.
// K3, mvster_warp_scatter, replaces mvster_tpu/kernels/pallas_scatter.py::
// _scatter_kernel (entry scatter_grad_pallas): the source-feature gradient
// of that gather.  Both compute exactly what
// mvster_tpu_torch.kernels.warp_vjp's plain versions compute:
//
//   src (B, Hs, Ws, C) channels-last, coordinates x, y (B, N) in raw pixel
//   units (N = D * H * W of the reference frustum), per coordinate four
//   taps y0x0, y0x1, y1x0, y1x1 with x0 = floor(x), y0 = floor(y),
//   wx = x - x0, wy = y - y0, weights (1-wy)(1-wx), (1-wy)wx, wy(1-wx),
//   wy wx, each multiplied by its own validity (tap inside the image);
//   K2:  out[b, n, c]   = sum over taps, in that order, of src * weight
//   K3:  dsrc[b, tap, c] += cot[b, n, c] * weight, for every tap
//
// One thread per (b, n): it computes the four tap offsets and weights once
// and loops over C.  Channels-last, so a tap's C values are contiguous; when
// C % 4 == 0 (every dtu_default stage) they move as float4.
//
// Rounding: K2 repeats the plain version's operations with explicitly
// rounded intrinsics (__fmul_rn, __fadd_rn, __fsub_rn), which nvcc may not
// contract into FMAs, so K2 equals the plain version bit for bit.  K3 sums
// with atomicAdd in an order that changes from run to run, so it matches the
// plain index_add_ transpose to f32 tolerance only, as the TPU kernel does.
//
// What bounds them on the H100: each moves its unique bytes once (K2 reads
// src, x, y and writes the (B, N, C) volume; K3 reads the cotangent, x, y
// and writes dsrc): 24-126 MB per source view per DTU-mid stage at batch 2,
// 7-38 us at 3.35 TB/s.  The taps are gathers (K2) and atomics (K3) with
// locality only along W, so neither is expected near that bound; this
// first design is the simple one.  Shared-memory tiling of the source band
// and float4 atomics are left for later.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Tap offsets (in pixels, clamped into the image) and weight * validity.
struct Taps {
  int64_t off[4];
  float w[4];
};

__device__ __forceinline__ Taps make_taps(float x, float y, int Hs, int Ws) {
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float wx = __fsub_rn(x, x0);
  const float wy = __fsub_rn(y, y0);
  const float ox = __fsub_rn(1.f, wx);
  const float oy = __fsub_rn(1.f, wy);
  // clamp before the integer cast, as the plain version does: a far-off
  // coordinate stays outside the image (invalid) instead of overflowing
  const int xi = (int)fminf(fmaxf(x0, -2.f), (float)(Ws + 1));
  const int yi = (int)fminf(fmaxf(y0, -2.f), (float)(Hs + 1));
  const float wt[4] = {__fmul_rn(oy, ox), __fmul_rn(oy, wx),
                       __fmul_rn(wy, ox), __fmul_rn(wy, wx)};
  Taps t;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int ty = yi + (k >> 1);
    const int tx = xi + (k & 1);
    const bool valid = tx >= 0 && tx < Ws && ty >= 0 && ty < Hs;
    const int cy = min(max(ty, 0), Hs - 1);
    const int cx = min(max(tx, 0), Ws - 1);
    t.off[k] = (int64_t)cy * Ws + cx;
    t.w[k] = valid ? wt[k] : 0.f;
  }
  return t;
}

__device__ __forceinline__ float tap_sum(float v0, float v1, float v2,
                                         float v3, const float* w) {
  float s = __fmul_rn(v0, w[0]);
  s = __fadd_rn(s, __fmul_rn(v1, w[1]));
  s = __fadd_rn(s, __fmul_rn(v2, w[2]));
  return __fadd_rn(s, __fmul_rn(v3, w[3]));
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
warp_gather_kernel(const float* __restrict__ src,  // (B, Hs, Ws, C)
                   const float* __restrict__ xs,   // (B, N)
                   const float* __restrict__ ys,   // (B, N)
                   float* __restrict__ out,        // (B, N, C)
                   int B, int N, int Hs, int Ws, int C) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)B * N) return;
  const int b = (int)(i / N);
  const Taps t = make_taps(xs[i], ys[i], Hs, Ws);
  const float* S = src + (int64_t)b * Hs * Ws * C;
  const float* p0 = S + t.off[0] * C;
  const float* p1 = S + t.off[1] * C;
  const float* p2 = S + t.off[2] * C;
  const float* p3 = S + t.off[3] * C;
  float* o = out + i * C;
  if (kVec4) {
    for (int c = 0; c < C; c += 4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p0 + c));
      const float4 e = __ldg(reinterpret_cast<const float4*>(p1 + c));
      const float4 f = __ldg(reinterpret_cast<const float4*>(p2 + c));
      const float4 g = __ldg(reinterpret_cast<const float4*>(p3 + c));
      float4 r;
      r.x = tap_sum(a.x, e.x, f.x, g.x, t.w);
      r.y = tap_sum(a.y, e.y, f.y, g.y, t.w);
      r.z = tap_sum(a.z, e.z, f.z, g.z, t.w);
      r.w = tap_sum(a.w, e.w, f.w, g.w, t.w);
      *reinterpret_cast<float4*>(o + c) = r;
    }
  } else {
    for (int c = 0; c < C; ++c) {
      o[c] = tap_sum(__ldg(p0 + c), __ldg(p1 + c), __ldg(p2 + c),
                     __ldg(p3 + c), t.w);
    }
  }
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
warp_scatter_kernel(const float* __restrict__ cot,  // (B, N, C)
                    const float* __restrict__ xs,   // (B, N)
                    const float* __restrict__ ys,   // (B, N)
                    float* __restrict__ dsrc,       // (B, Hs, Ws, C), zeroed
                    int B, int N, int Hs, int Ws, int C) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)B * N) return;
  const int b = (int)(i / N);
  const Taps t = make_taps(xs[i], ys[i], Hs, Ws);
  float* D = dsrc + (int64_t)b * Hs * Ws * C;
  const float* g = cot + i * C;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float w = t.w[k];
    if (w == 0.f) continue;  // an invalid tap, or a zero weight: adds nothing
    float* d = D + t.off[k] * C;
    if (kVec4) {
      for (int c = 0; c < C; c += 4) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(g + c));
        atomicAdd(d + c + 0, __fmul_rn(v.x, w));
        atomicAdd(d + c + 1, __fmul_rn(v.y, w));
        atomicAdd(d + c + 2, __fmul_rn(v.z, w));
        atomicAdd(d + c + 3, __fmul_rn(v.w, w));
      }
    } else {
      for (int c = 0; c < C; ++c) atomicAdd(d + c, __fmul_rn(__ldg(g + c), w));
    }
  }
}

unsigned grid_for(int B, int N) {
  const int64_t n = (int64_t)B * N;
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C interface, loaded with ctypes.  Each returns the cudaError_t of
// its launch (0 on success).  The Python wrappers check device, dtype,
// shapes and contiguity before calling, and zero dsrc for the scatter;
// `vec4` asks for float4 access (C % 4 == 0 and 16-byte aligned pointers).
extern "C" int mvster_warp_gather(const void* src, const void* x,
                                  const void* y, void* out, int B, int N,
                                  int Hs, int Ws, int C, int vec4,
                                  void* stream) {
  auto s = static_cast<const float*>(src);
  auto xs = static_cast<const float*>(x);
  auto ys = static_cast<const float*>(y);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (vec4) {
    warp_gather_kernel<true><<<grid_for(B, N), kThreads, 0, st>>>(
        s, xs, ys, o, B, N, Hs, Ws, C);
  } else {
    warp_gather_kernel<false><<<grid_for(B, N), kThreads, 0, st>>>(
        s, xs, ys, o, B, N, Hs, Ws, C);
  }
  return (int)cudaGetLastError();
}

extern "C" int mvster_warp_scatter(const void* cot, const void* x,
                                   const void* y, void* dsrc, int B, int N,
                                   int Hs, int Ws, int C, int vec4,
                                   void* stream) {
  auto g = static_cast<const float*>(cot);
  auto xs = static_cast<const float*>(x);
  auto ys = static_cast<const float*>(y);
  auto d = static_cast<float*>(dsrc);
  auto st = static_cast<cudaStream_t>(stream);
  if (vec4) {
    warp_scatter_kernel<true><<<grid_for(B, N), kThreads, 0, st>>>(
        g, xs, ys, d, B, N, Hs, Ws, C);
  } else {
    warp_scatter_kernel<false><<<grid_for(B, N), kThreads, 0, st>>>(
        g, xs, ys, d, B, N, Hs, Ws, C);
  }
  return (int)cudaGetLastError();
}
