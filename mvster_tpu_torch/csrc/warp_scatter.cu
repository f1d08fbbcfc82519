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
// What bounds them on the H100: each moves its unique bytes once (K2 reads
// src, x, y and writes the (B, N, C) volume; K3 reads the cotangent, x, y
// and writes dsrc): 24-126 MB per source view per DTU-mid stage at batch 2,
// 7-38 us at 3.35 TB/s.  The taps are data-dependent gathers (K2) and
// atomic additions into dsrc (K3), with locality only along W, so K2 runs
// on the latency of its dependent loads and K3 on the L2's atomic units.
// A first design gave each thread one sample and a loop over C: a warp's
// 32 lanes then touched 32 different lines per access, and K3 issued one
// scalar RED per (sample, tap, channel), 1.9e8 per source view over the
// four DTU-mid stages.
//
// The design: channel-parallel lanes.  A sample's C / 4 float4 vectors (C
// floats where C % 4 != 0) go to 2^lanes_log2 consecutive threads, at most
// 32, each taking one vector (past C = 128, every lanes-th one); each lane
// computes the four taps itself (about 20 operations).  A warp then reads
// and writes contiguous channels of neighbouring samples: its loads, K2's
// stores and K3's atomics are 16 bytes a lane on neighbouring addresses,
// and small C no longer starves the card of threads.  Where a sample has
// fewer than 8 vectors, each lane takes spl samples, 256 / lanes apart.
// The Python planner (kernels/warp_vjp.py plan_launch) picks lanes and spl.
//
// K3 adds with Hopper's vector atomics, atomicAdd(float4*, float4) on global
// memory: one RED.128 per four channels instead of four scalar REDs, and a
// warp's RED covers whole lines.  A block that privatised its tile's
// footprint in shared memory and flushed it with one RED per touched float4
// issued 1.8-3.5x fewer global REDs but ran 2x slower at every DTU-mid
// stage (its shared-memory atomics and barriers cost more than the REDs
// they saved; PERF.md), so K3 adds straight into dsrc.  dsrc is zeroed by
// the caller.
//
// Rounding: K2 repeats the plain version's operations with explicitly
// rounded intrinsics (__fmul_rn, __fadd_rn, __fsub_rn), which nvcc may not
// contract into FMAs, so K2 equals the plain version bit for bit.  K3 sums
// with atomics in an order that changes from run to run, so it matches the
// plain index_add_ transpose to f32 tolerance only, as the TPU kernel does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

// The y0x0 tap (clamped to [-2, W + 1] x [-2, H + 1]) and the four weights
// times validity.
struct Taps {
  int x0, y0;
  float w[4];
};

// floor(v) clamped before the integer cast, as the plain version does: a
// far-off (or NaN) coordinate stays outside the image instead of overflowing
__device__ __forceinline__ int tap_origin(float v, int n) {
  return (int)fminf(fmaxf(floorf(v), -2.f), (float)(n + 1));
}

__device__ __forceinline__ Taps make_taps(float x, float y, int Hs, int Ws) {
  const float wx = __fsub_rn(x, floorf(x));
  const float wy = __fsub_rn(y, floorf(y));
  const float ox = __fsub_rn(1.f, wx);
  const float oy = __fsub_rn(1.f, wy);
  const float wt[4] = {__fmul_rn(oy, ox), __fmul_rn(oy, wx),
                       __fmul_rn(wy, ox), __fmul_rn(wy, wx)};
  Taps t;
  t.x0 = tap_origin(x, Ws);
  t.y0 = tap_origin(y, Hs);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int ty = t.y0 + (k >> 1);
    const int tx = t.x0 + (k & 1);
    t.w[k] = (tx >= 0 && tx < Ws && ty >= 0 && ty < Hs) ? wt[k] : 0.f;
  }
  return t;
}

// Pixel index of tap k, clamped into the image: an invalid tap reads a
// border pixel with weight 0, as the plain version does.
__device__ __forceinline__ int tap_pixel(const Taps& t, int k, int Hs, int Ws) {
  const int cy = min(max(t.y0 + (k >> 1), 0), Hs - 1);
  const int cx = min(max(t.x0 + (k & 1), 0), Ws - 1);
  return cy * Ws + cx;
}

// One lane's vector: a float, or a float4 (16-byte aligned).
__device__ __forceinline__ void ldv(const float* p, float& v) { v = __ldg(p); }
__device__ __forceinline__ void ldv(const float* p, float4& v) {
  v = __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void stv(float* p, float v) { *p = v; }
__device__ __forceinline__ void stv(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void red(float* p, float v) { atomicAdd(p, v); }
__device__ __forceinline__ void red(float* p, float4 v) {
  atomicAdd(reinterpret_cast<float4*>(p), v);  // sm_90: one vector RED
}
__device__ __forceinline__ float scale(float v, float w) { return __fmul_rn(v, w); }
__device__ __forceinline__ float4 scale(float4 v, float w) {
  return make_float4(__fmul_rn(v.x, w), __fmul_rn(v.y, w), __fmul_rn(v.z, w),
                     __fmul_rn(v.w, w));
}

__device__ __forceinline__ float tap_sum(float v0, float v1, float v2,
                                         float v3, const float* w) {
  float s = __fmul_rn(v0, w[0]);
  s = __fadd_rn(s, __fmul_rn(v1, w[1]));
  s = __fadd_rn(s, __fmul_rn(v2, w[2]));
  return __fadd_rn(s, __fmul_rn(v3, w[3]));
}
__device__ __forceinline__ float4 tap_sum(float4 a, float4 e, float4 f,
                                          float4 g, const float* w) {
  return make_float4(tap_sum(a.x, e.x, f.x, g.x, w), tap_sum(a.y, e.y, f.y, g.y, w),
                     tap_sum(a.z, e.z, f.z, g.z, w), tap_sum(a.w, e.w, f.w, g.w, w));
}

template <int VW>
using VecT = typename std::conditional<VW == 4, float4, float>::type;

// Samples: block (blockIdx.x, b) takes samples [blockIdx.x * per_block,
// + per_block) of batch b, per_block = 256 / lanes * spl; its groups of
// `lanes` threads take consecutive samples, spl rounds of them.

// K2
template <int VW>
__global__ void __launch_bounds__(kThreads)
warp_gather_kernel(const float* __restrict__ src,  // (B, Hs, Ws, C)
                   const float* __restrict__ xs,   // (B, N)
                   const float* __restrict__ ys,   // (B, N)
                   float* __restrict__ out,        // (B, N, C)
                   int N, int Hs, int Ws, int C, int lanes_log2, int spl) {
  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  const int groups = kThreads >> lanes_log2;
  const int nvec = C / VW;
  const int b = blockIdx.y;
  const float* S = src + (int64_t)b * Hs * Ws * C;
  int n = blockIdx.x * groups * spl + (threadIdx.x >> lanes_log2);
  for (int k = 0; k < spl && n < N; ++k, n += groups) {
    const int64_t i = (int64_t)b * N + n;
    const Taps t = make_taps(xs[i], ys[i], Hs, Ws);
    const float* p0 = S + (int64_t)tap_pixel(t, 0, Hs, Ws) * C;
    const float* p1 = S + (int64_t)tap_pixel(t, 1, Hs, Ws) * C;
    const float* p2 = S + (int64_t)tap_pixel(t, 2, Hs, Ws) * C;
    const float* p3 = S + (int64_t)tap_pixel(t, 3, Hs, Ws) * C;
    float* o = out + i * C;
    for (int q = lane; q < nvec; q += lanes) {
      const int c = q * VW;
      VecT<VW> a, e, f, g;
      ldv(p0 + c, a);
      ldv(p1 + c, e);
      ldv(p2 + c, f);
      ldv(p3 + c, g);
      stv(o + c, tap_sum(a, e, f, g, t.w));
    }
  }
}

// K3
template <int VW>
__global__ void __launch_bounds__(kThreads)
warp_scatter_kernel(const float* __restrict__ cot,  // (B, N, C)
                    const float* __restrict__ xs,   // (B, N)
                    const float* __restrict__ ys,   // (B, N)
                    float* __restrict__ dsrc,       // (B, Hs, Ws, C), zeroed
                    int N, int Hs, int Ws, int C, int lanes_log2, int spl) {
  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  const int groups = kThreads >> lanes_log2;
  const int nvec = C / VW;
  const int b = blockIdx.y;
  float* D = dsrc + (int64_t)b * Hs * Ws * C;
  int n = blockIdx.x * groups * spl + (threadIdx.x >> lanes_log2);
  for (int k = 0; k < spl && n < N; ++k, n += groups) {
    const int64_t i = (int64_t)b * N + n;
    const Taps t = make_taps(xs[i], ys[i], Hs, Ws);
    for (int q = lane; q < nvec; q += lanes) {
      const int c = q * VW;
      VecT<VW> g;
      ldv(cot + i * C + c, g);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float w = t.w[kk];
        if (w == 0.f) continue;  // an invalid tap, or a zero weight: adds nothing
        red(D + (int64_t)tap_pixel(t, kk, Hs, Ws) * C + c, scale(g, w));
      }
    }
  }
}

dim3 grid_for(int B, int N, int lanes_log2, int spl) {
  const int per_block = (kThreads >> lanes_log2) * spl;
  return dim3((unsigned)((N + per_block - 1) / per_block), (unsigned)B);
}

}  // namespace

// Plain C interface, loaded with ctypes.  Each returns the cudaError_t of
// its launch (0 on success).  The Python wrappers check device, dtype,
// shapes and contiguity before calling, zero dsrc for the scatter, and
// plan the launch (kernels/warp_vjp.py plan_launch): `vec4` asks for
// float4 access (C % 4 == 0 and 16-byte aligned pointers), lanes_log2 and
// spl as the kernels above take them.
extern "C" int mvster_warp_gather(const void* src, const void* x,
                                  const void* y, void* out, int B, int N,
                                  int Hs, int Ws, int C, int vec4,
                                  int lanes_log2, int spl, void* stream) {
  auto s = static_cast<const float*>(src);
  auto xs = static_cast<const float*>(x);
  auto ys = static_cast<const float*>(y);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(B, N, lanes_log2, spl);
  if (vec4) {
    warp_gather_kernel<4><<<grid, kThreads, 0, st>>>(s, xs, ys, o, N, Hs, Ws, C,
                                                     lanes_log2, spl);
  } else {
    warp_gather_kernel<1><<<grid, kThreads, 0, st>>>(s, xs, ys, o, N, Hs, Ws, C,
                                                     lanes_log2, spl);
  }
  return (int)cudaGetLastError();
}

extern "C" int mvster_warp_scatter(const void* cot, const void* x,
                                   const void* y, void* dsrc, int B, int N,
                                   int Hs, int Ws, int C, int vec4,
                                   int lanes_log2, int spl, void* stream) {
  auto g = static_cast<const float*>(cot);
  auto xs = static_cast<const float*>(x);
  auto ys = static_cast<const float*>(y);
  auto d = static_cast<float*>(dsrc);
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(B, N, lanes_log2, spl);
  if (vec4) {
    warp_scatter_kernel<4><<<grid, kThreads, 0, st>>>(g, xs, ys, d, N, Hs, Ws, C,
                                                      lanes_log2, spl);
  } else {
    warp_scatter_kernel<1><<<grid, kThreads, 0, st>>>(g, xs, ys, d, N, Hs, Ws, C,
                                                      lanes_log2, spl);
  }
  return (int)cudaGetLastError();
}
