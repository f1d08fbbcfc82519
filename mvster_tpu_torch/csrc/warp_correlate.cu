// Fused plane-sweep cost volume for one cascade stage, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mvster_tpu/kernels/pallas_warp.py::_warp_kernel
// (fused-correlation mode) together with the per-view attention fusion of
// mvster_tpu/kernels/pallas_warp.py::fused_cost_volume_geom.  It computes
// exactly mvster_tpu_torch.kernels.cost_volume.build_cost_volume with
// group_cor=True: for every reference pixel (b, h, w), every source view v
// and every depth hypothesis d,
//
//   (x, y)  = plane-sweep projection of (w, h) at depth hypo[b, d, h, w]
//             by rot[v, b], trans[v, b]  (z == 0 -> 1e-9)
//   warped  = bilinear, zero-padded sample of src[v, b] at (x, y): four
//             taps, each masked by its own validity, summed y0x0, y0x1,
//             y1x0, y1x1
//   cor[g]  = mean over the C/G sub-channels of group g of warped * ref
//
// then, per view, score_d = sum_g cor[d][g] and the view weight
//   attn_fuse_d:  w_d = softmax_d(score / attn_temp) / sqrt(C)
//   otherwise:    w_d = max_d softmax_d(score)   (the same for every d)
// accumulated online across views, and writes
//   out[b, d, h, w, g] = sum_v w_d * cor / (1e-8 + sum_v w_d).
//
// One thread per reference pixel; one launch covers every source view of
// the stage.  The warped (B, D, H, W, C) tensor and the per-view
// correlation live only in registers: the accumulators are templated on
// (D, G) so they stay there.
//
// What bounds it on the H100: at the DTU-mid stage 4 (512x640, C=8, D=4,
// G=4, four source views) the unique device-memory traffic is ~70 MB (four
// 512x640x8 f32 source maps, the reference, the hypotheses, the output),
// ~21 us at 3.35 TB/s.  The gathers are ~4 taps x C x D x V floats per
// pixel, ~670 MB through L1/L2, so the gathers and not DRAM set the pace.
// This first design keeps features channels-last, so each tap is one
// contiguous C-float row read and neighbouring threads read neighbouring
// rows.  Shared-memory tiles, float4 taps and TMA are left for later.
//
// Rounding: the coordinate math repeats, with explicitly rounded
// intrinsics, the sequence of mvster_tpu_torch.core.geometry
// .plane_sweep_coords (itself bit-exact with the JAX package), and the tap
// weights repeat core.sampling.grid_sample_zeros, so kernel and plain
// version sample at identical coordinates.  nvcc may not contract those
// operations into other fused multiply-adds.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <int D, int G>
__global__ void __launch_bounds__(kThreads)
warp_correlate_kernel(const float* __restrict__ ref,    // (B, H, W, C)
                      const float* __restrict__ src,    // (V, B, H, W, C)
                      const float* __restrict__ hypo,   // (B, D, H, W)
                      const float* __restrict__ rot,    // (V, B, 3, 3)
                      const float* __restrict__ trans,  // (V, B, 3)
                      float* __restrict__ out,          // (B, D, H, W, G)
                      int B, int V, int H, int W, int C,
                      int attn_fuse_d, float attn_temp, float sqrt_c) {
  const int64_t hw = (int64_t)H * W;
  const int64_t pix = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= (int64_t)B * hw) return;
  const int b = (int)(pix / hw);
  const int64_t p = pix - (int64_t)b * hw;
  const int py = (int)(p / W);
  const int px = (int)(p - (int64_t)py * W);
  const float fx = (float)px;
  const float fy = (float)py;
  const int sub = C / G;
  const float fsub = (float)sub;
  const float* ref_pix = ref + pix * C;

  float depth[D];
#pragma unroll
  for (int d = 0; d < D; ++d) depth[d] = hypo[((int64_t)b * D + d) * hw + p];

  float fsum[D][G];
  float wsum[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    wsum[d] = 1e-8f;
#pragma unroll
    for (int g = 0; g < G; ++g) fsum[d][g] = 0.f;
  }

  for (int v = 0; v < V; ++v) {
    const float* R = rot + ((int64_t)v * B + b) * 9;
    const float* T = trans + ((int64_t)v * B + b) * 3;
    const float* S = src + ((int64_t)v * B + b) * hw * C;
    float ray[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      ray[i] = __fadd_rn(__fmaf_rn(R[3 * i + 1], fy, __fmul_rn(R[3 * i], fx)),
                         R[3 * i + 2]);
    }

    float cor[D][G];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float p0 = __fadd_rn(__fmul_rn(ray[0], depth[d]), T[0]);
      const float p1 = __fadd_rn(__fmul_rn(ray[1], depth[d]), T[1]);
      float p2 = __fadd_rn(__fmul_rn(ray[2], depth[d]), T[2]);
      if (p2 == 0.f) p2 = 1e-9f;
      const float x = __fdiv_rn(p0, p2);
      const float y = __fdiv_rn(p1, p2);
      const float x0 = floorf(x);
      const float y0 = floorf(y);
      const float wx = __fsub_rn(x, x0);
      const float wy = __fsub_rn(y, y0);
      const float ox = __fsub_rn(1.f, wx);
      const float oy = __fsub_rn(1.f, wy);
      // validity on the floored float: exact for in-range values and safe
      // for coordinates far outside the image, where an int cast overflows
      const bool vx0 = x0 >= 0.f && x0 <= (float)(W - 1);
      const bool vx1 = x0 >= -1.f && x0 <= (float)(W - 2);
      const bool vy0 = y0 >= 0.f && y0 <= (float)(H - 1);
      const bool vy1 = y0 >= -1.f && y0 <= (float)(H - 2);
      // invalid taps read a clamped in-image row with weight zero
      const float w00 = (vy0 && vx0) ? __fmul_rn(oy, ox) : 0.f;
      const float w01 = (vy0 && vx1) ? __fmul_rn(oy, wx) : 0.f;
      const float w10 = (vy1 && vx0) ? __fmul_rn(wy, ox) : 0.f;
      const float w11 = (vy1 && vx1) ? __fmul_rn(wy, wx) : 0.f;
      const int ix0 = (int)fminf(fmaxf(x0, 0.f), (float)(W - 1));
      const int ix1 = (int)fminf(fmaxf(x0 + 1.f, 0.f), (float)(W - 1));
      const int iy0 = (int)fminf(fmaxf(y0, 0.f), (float)(H - 1));
      const int iy1 = (int)fminf(fmaxf(y0 + 1.f, 0.f), (float)(H - 1));
      const float* t00 = S + ((int64_t)iy0 * W + ix0) * C;
      const float* t01 = S + ((int64_t)iy0 * W + ix1) * C;
      const float* t10 = S + ((int64_t)iy1 * W + ix0) * C;
      const float* t11 = S + ((int64_t)iy1 * W + ix1) * C;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float acc = 0.f;
        for (int s = 0; s < sub; ++s) {
          const int c = g * sub + s;
          float val = __fmul_rn(__ldg(t00 + c), w00);
          val = __fadd_rn(val, __fmul_rn(__ldg(t01 + c), w01));
          val = __fadd_rn(val, __fmul_rn(__ldg(t10 + c), w10));
          val = __fadd_rn(val, __fmul_rn(__ldg(t11 + c), w11));
          acc = __fadd_rn(acc, __fmul_rn(val, __ldg(ref_pix + c)));
        }
        cor[d][g] = __fdiv_rn(acc, fsub);
      }
    }

    // the view's attention weight over the D hypotheses
    float wt[D];
    float mx = -INFINITY;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float score = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) score += cor[d][g];
      wt[d] = attn_fuse_d ? score / attn_temp : score;
      mx = fmaxf(mx, wt[d]);
    }
    float esum = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      wt[d] = expf(wt[d] - mx);
      esum += wt[d];
    }
    float wmax = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      wt[d] = wt[d] / esum;
      wmax = fmaxf(wmax, wt[d]);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float w = attn_fuse_d ? wt[d] / sqrt_c : wmax;
      wsum[d] += w;
#pragma unroll
      for (int g = 0; g < G; ++g) fsum[d][g] += w * cor[d][g];
    }
  }

#pragma unroll
  for (int d = 0; d < D; ++d) {
    float* o = out + (((int64_t)b * D + d) * hw + p) * G;
#pragma unroll
    for (int g = 0; g < G; ++g) o[g] = fsum[d][g] / wsum[d];
  }
}

template <int D, int G>
void launch(const float* ref, const float* src, const float* hypo,
            const float* rot, const float* trans, float* out, int B, int V,
            int H, int W, int C, int attn_fuse_d, float attn_temp,
            float sqrt_c, cudaStream_t stream) {
  const int64_t n = (int64_t)B * H * W;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  warp_correlate_kernel<D, G><<<blocks, kThreads, 0, stream>>>(
      ref, src, hypo, rot, trans, out, B, V, H, W, C, attn_fuse_d, attn_temp,
      sqrt_c);
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns the cudaError_t of the
// launch (0 on success), or cudaErrorInvalidValue for a (D, G) pair that is
// not instantiated; the Python wrapper checks shapes before calling.
extern "C" int mvster_warp_correlate(const void* ref, const void* src,
                                     const void* hypo, const void* rot,
                                     const void* trans, void* out, int B,
                                     int V, int D, int H, int W, int C, int G,
                                     int attn_fuse_d, float attn_temp,
                                     float sqrt_c, void* stream) {
  auto r = static_cast<const float*>(ref);
  auto s = static_cast<const float*>(src);
  auto h = static_cast<const float*>(hypo);
  auto ro = static_cast<const float*>(rot);
  auto t = static_cast<const float*>(trans);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
#define MVSTER_CASE(DD, GG)                                                   \
  if (D == DD && G == GG) {                                                   \
    launch<DD, GG>(r, s, h, ro, t, o, B, V, H, W, C, attn_fuse_d, attn_temp,  \
                   sqrt_c, st);                                               \
    return (int)cudaGetLastError();                                           \
  }
  MVSTER_CASE(4, 4)
  MVSTER_CASE(4, 8)
  MVSTER_CASE(8, 4)
  MVSTER_CASE(8, 8)
#undef MVSTER_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mvster_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
