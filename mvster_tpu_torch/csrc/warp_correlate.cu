// Fused plane-sweep cost volume for one cascade stage, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mvster_tpu/kernels/pallas_warp.py::_warp_kernel
// (fused-correlation mode) together with the per-view attention fusion of
// mvster_tpu/kernels/pallas_warp.py::fused_cost_volume_geom.  It computes
// exactly mvster_tpu_torch.kernels.cost_volume.build_cost_volume with
// group_cor=True: for every reference pixel (b, h, w), every source view v
// and every depth hypothesis d,
//
//   (x, y)  = plane-sweep projection of (w, row0 + h) at depth
//             hypo[b, d, h, w] by rot[v, b], trans[v, b]  (z == 0 -> 1e-9)
//   warped  = bilinear, zero-padded sample of the Hs x Ws map src[v, b] at
//             (x, y): four taps, each masked by its own validity, summed
//             y0x0, y0x1, y1x0, y1x1
//   cor[g]  = mean over the C/G sub-channels of group g of warped * ref
//
// then, per view, score_d = sum_g cor[d][g] and the view weight
//   attn_fuse_d:  w_d = softmax_d(score / attn_temp) / sqrt(C)
//   otherwise:    w_d = max_d softmax_d(score)   (the same for every d)
// accumulated online across views, and writes
//   out[b, d, h, w, g] = sum_v w_d * cor / (1e-8 + sum_v w_d).
// The reference (H x W) may be a band of rows of the image, from row0 on,
// while the sources are whole (mvster_tpu_torch/dist/spatial.py); with
// row0 = 0 and Hs, Ws = H, W this is the whole-image volume, and the
// arithmetic is the same operation for operation.
//
// What bounds it on the H100: the unique device-memory traffic (the
// reference and source maps, the hypotheses and the output, each once) is
// 0.0413 ms at 3.35 TB/s over the four DTU-mid stages.  The gathers are
// 4 taps x C floats per (pixel, view, hypothesis), ~1.5 GB over those
// stages (168 / 335 / 335 / 671 MB), served from L1 and L2: the cache
// lines that a warp's gathers touch, not DRAM, set the pace, and the
// small early stages (64x80 pixels at stage 1) must still fill 132 SMs.
//
// The design: one thread per (reference pixel, depth plane).  A block
// holds P pixels x D planes, P = max(1, 256 / D), the thread index d * P
// + p (the pixel fastest, so a warp's hypothesis reads, taps and output
// rows lie side by side); D and G are runtime arguments.
//   - Each thread walks its own plane's 4 taps x C channels, group by
//     group in channel order, with explicitly rounded operations.  Where
//     C % 4 == 0 (and the pointers are 16-byte aligned) the taps and the
//     reference row are loaded as float4; the threads of one pixel read
//     neighbouring tap rows, which L1 serves.  SPLIT says how a float4
//     meets the groups: 1 when C/G is a multiple of 4 (a float4 inside one
//     group), 2 when C/G == 2, 4 when C/G == 1; 0 is the scalar path
//     (C % 4 != 0, or another C/G).
//   - The per-group sums and the online accumulators live in register
//     arrays of a template capacity MAXG in {4, 8, 16, 32, 64} >= G.
//   - The softmax over D crosses threads: each thread writes its plane's
//     score to shared memory, (D, P) floats, double-buffered by view so one
//     barrier a view suffices; after it, each thread reads its pixel's D
//     scores in d order and forms the max, the sum of exponentials and its
//     own weight, each thread the whole softmax in the same order.
//   - Each thread writes its own out[b, d, h, w, 0:G] row.
// The wrapper's planner (kernels/warp_correlate.plan_launch) picks MAXG,
// SPLIT, P, the threads and the shared bytes; this file checks them.
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

constexpr int kMaxThreads = 256;  // P * D threads a block, at most

// The four taps of one (pixel, view, hypothesis): rows of C floats and
// their weights (zero for an invalid tap, whose row is a clamped one).
struct Taps {
  const float* t00;
  const float* t01;
  const float* t10;
  const float* t11;
  float w00, w01, w10, w11;
};

// One channel's warped value times the reference, rounded op by op as the
// plain version computes it.
__device__ __forceinline__ float product(const Taps& tp, float a, float b,
                                         float c, float e, float r) {
  float val = __fmul_rn(a, tp.w00);
  val = __fadd_rn(val, __fmul_rn(b, tp.w01));
  val = __fadd_rn(val, __fmul_rn(c, tp.w10));
  val = __fadd_rn(val, __fmul_rn(e, tp.w11));
  return __fmul_rn(val, r);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// The products of channels c .. c + 3 (c a multiple of 4), from float4 loads.
__device__ __forceinline__ void products4(const Taps& tp, const float* ref,
                                          int c, float* prod) {
  const float4 a = ldg4(tp.t00 + c);
  const float4 b = ldg4(tp.t01 + c);
  const float4 e = ldg4(tp.t10 + c);
  const float4 f = ldg4(tp.t11 + c);
  const float4 r = ldg4(ref + c);
  prod[0] = product(tp, a.x, b.x, e.x, f.x, r.x);
  prod[1] = product(tp, a.y, b.y, e.y, f.y, r.y);
  prod[2] = product(tp, a.z, b.z, e.z, f.z, r.z);
  prod[3] = product(tp, a.w, b.w, e.w, f.w, r.w);
}

// cor[g] for g < G: each group's channels summed in channel order from 0,
// then divided by C/G.
template <int MAXG, int SPLIT>
__device__ __forceinline__ void correlate(const Taps& tp, const float* ref,
                                          int G, int sub, float* cor) {
  const float fsub = (float)sub;
  if constexpr (SPLIT <= 1) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      float acc = 0.f;
      if constexpr (SPLIT == 1) {
        float prod[4];
        for (int s = 0; s < sub; s += 4) {
          products4(tp, ref, g * sub + s, prod);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc = __fadd_rn(acc, prod[j]);
        }
      } else {
        for (int s = 0; s < sub; ++s) {
          const int c = g * sub + s;
          acc = __fadd_rn(acc, product(tp, __ldg(tp.t00 + c), __ldg(tp.t01 + c),
                                       __ldg(tp.t10 + c), __ldg(tp.t11 + c),
                                       __ldg(ref + c)));
        }
      }
      cor[g] = __fdiv_rn(acc, fsub);
    }
  } else {  // a float4 spans SPLIT groups of 4 / SPLIT channels each
    constexpr int kPer = 4 / SPLIT;
#pragma unroll
    for (int g = 0; g < MAXG; g += SPLIT) {
      if (g >= G) break;
      float prod[4];
      products4(tp, ref, g * kPer, prod);
#pragma unroll
      for (int k = 0; k < SPLIT; ++k) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < kPer; ++j) acc = __fadd_rn(acc, prod[k * kPer + j]);
        cor[g + k] = __fdiv_rn(acc, fsub);
      }
    }
  }
}

template <int MAXG, int SPLIT>
__global__ void __launch_bounds__(kMaxThreads)
warp_correlate_kernel(const float* __restrict__ ref,    // (B, H, W, C)
                      const float* __restrict__ src,    // (V, B, Hs, Ws, C)
                      const float* __restrict__ hypo,   // (B, D, H, W)
                      const float* __restrict__ rot,    // (V, B, 3, 3)
                      const float* __restrict__ trans,  // (V, B, 3)
                      float* __restrict__ out,          // (B, D, H, W, G)
                      int B, int V, int D, int H, int W, int Hs, int Ws,
                      int row0, int C, int G, int P,
                      int attn_fuse_d, float attn_temp, float sqrt_c) {
  extern __shared__ float scores[];  // (2, D, P): a view's weights' logits
  const int d = threadIdx.x / P;
  const int q = threadIdx.x - d * P;  // the pixel's slot in the block
  const int64_t hw = (int64_t)H * W;
  const int64_t npix = (int64_t)B * hw;
  const int64_t slot = (int64_t)blockIdx.x * P + q;
  // a slot past the last pixel computes that pixel, joins the barriers and
  // writes nothing
  const bool live = slot < npix;
  const int64_t pix = live ? slot : npix - 1;
  const int b = (int)(pix / hw);
  const int64_t p = pix - (int64_t)b * hw;
  const int py = (int)(p / W);
  const int px = (int)(p - (int64_t)py * W);
  const float fx = (float)px;
  const float fy = (float)(py + row0);  // the pixel's row in the image
  const int64_t shw = (int64_t)Hs * Ws;
  const int sub = C / G;
  const float* ref_pix = ref + pix * C;
  const float depth = hypo[((int64_t)b * D + d) * hw + p];

  float fsum[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) fsum[g] = 0.f;
  float wsum = 1e-8f;

  for (int v = 0; v < V; ++v) {
    const float* R = rot + ((int64_t)v * B + b) * 9;
    const float* T = trans + ((int64_t)v * B + b) * 3;
    const float* S = src + ((int64_t)v * B + b) * shw * C;
    float ray[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      ray[i] = __fadd_rn(__fmaf_rn(R[3 * i + 1], fy, __fmul_rn(R[3 * i], fx)),
                         R[3 * i + 2]);
    }
    const float p0 = __fadd_rn(__fmul_rn(ray[0], depth), T[0]);
    const float p1 = __fadd_rn(__fmul_rn(ray[1], depth), T[1]);
    float p2 = __fadd_rn(__fmul_rn(ray[2], depth), T[2]);
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
    const bool vx0 = x0 >= 0.f && x0 <= (float)(Ws - 1);
    const bool vx1 = x0 >= -1.f && x0 <= (float)(Ws - 2);
    const bool vy0 = y0 >= 0.f && y0 <= (float)(Hs - 1);
    const bool vy1 = y0 >= -1.f && y0 <= (float)(Hs - 2);
    const int ix0 = (int)fminf(fmaxf(x0, 0.f), (float)(Ws - 1));
    const int ix1 = (int)fminf(fmaxf(x0 + 1.f, 0.f), (float)(Ws - 1));
    const int iy0 = (int)fminf(fmaxf(y0, 0.f), (float)(Hs - 1));
    const int iy1 = (int)fminf(fmaxf(y0 + 1.f, 0.f), (float)(Hs - 1));
    // invalid taps read a clamped in-image row with weight zero
    Taps tp;
    tp.t00 = S + ((int64_t)iy0 * Ws + ix0) * C;
    tp.t01 = S + ((int64_t)iy0 * Ws + ix1) * C;
    tp.t10 = S + ((int64_t)iy1 * Ws + ix0) * C;
    tp.t11 = S + ((int64_t)iy1 * Ws + ix1) * C;
    tp.w00 = (vy0 && vx0) ? __fmul_rn(oy, ox) : 0.f;
    tp.w01 = (vy0 && vx1) ? __fmul_rn(oy, wx) : 0.f;
    tp.w10 = (vy1 && vx0) ? __fmul_rn(wy, ox) : 0.f;
    tp.w11 = (vy1 && vx1) ? __fmul_rn(wy, wx) : 0.f;

    float cor[MAXG];
    correlate<MAXG, SPLIT>(tp, ref_pix, G, sub, cor);

    // the view's attention weight over the pixel's D hypotheses
    float score = 0.f;
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      score += cor[g];
    }
    float* logit = scores + (v & 1) * D * P + q;  // logit[k * P]: plane k
    logit[d * P] = attn_fuse_d ? score / attn_temp : score;
    __syncthreads();
    float mx = -INFINITY;
    for (int k = 0; k < D; ++k) mx = fmaxf(mx, logit[k * P]);
    float esum = 0.f;
    for (int k = 0; k < D; ++k) esum += expf(logit[k * P] - mx);
    float w;
    if (attn_fuse_d) {
      w = expf(logit[d * P] - mx) / esum / sqrt_c;
    } else {
      w = 0.f;
      for (int k = 0; k < D; ++k) w = fmaxf(w, expf(logit[k * P] - mx) / esum);
    }
    wsum += w;
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      fsum[g] += w * cor[g];
    }
  }

  if (!live) return;
  float* o = out + (((int64_t)b * D + d) * hw + p) * G;
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
    o[g] = fsum[g] / wsum;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  The first arguments are the
// tensors and sizes (the reference's H x W from image row row0, the
// sources' Hs x Ws); the launch plan of kernels/warp_correlate.plan_launch
// follows: the capacity MAXG, SPLIT, the pixels P a block, its threads
// (P * D) and its dynamic shared bytes (2 * P * D floats).  Returns the
// cudaError_t of the launch (0 on success), or cudaErrorInvalidValue for a
// plan that does not fit these sizes; the Python wrapper checks the tensors
// before calling.
extern "C" int mvster_warp_correlate(const void* ref, const void* src,
                                     const void* hypo, const void* rot,
                                     const void* trans, void* out, int B,
                                     int V, int D, int H, int W, int Hs,
                                     int Ws, int row0, int C, int G,
                                     int attn_fuse_d, float attn_temp,
                                     float sqrt_c, int maxg, int split,
                                     int pixels, int threads, int smem_bytes,
                                     void* stream) {
  const int sub = G >= 1 ? C / G : 0;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(ref) | reinterpret_cast<uintptr_t>(src)) & 15) == 0;
  const bool split_ok =
      split == 0 || (aligned && C % 4 == 0 &&
                     ((split == 1 && sub % 4 == 0) || (split == 2 && sub == 2) ||
                      (split == 4 && sub == 1)));
  if (B < 1 || V < 1 || D < 1 || H < 1 || W < 1 || Hs < 1 || Ws < 1 ||
      row0 < 0 || G < 1 || G > maxg ||
      C % G != 0 || !split_ok || pixels < 1 || threads != pixels * D ||
      threads > kMaxThreads || smem_bytes != 2 * threads * (int)sizeof(float)) {
    return (int)cudaErrorInvalidValue;
  }
  auto r = static_cast<const float*>(ref);
  auto s = static_cast<const float*>(src);
  auto h = static_cast<const float*>(hypo);
  auto ro = static_cast<const float*>(rot);
  auto t = static_cast<const float*>(trans);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const int64_t npix = (int64_t)B * H * W;
  const unsigned blocks = (unsigned)((npix + pixels - 1) / pixels);
#define MVSTER_CASE(MG, SP)                                                    \
  if (maxg == MG && split == SP) {                                             \
    warp_correlate_kernel<MG, SP><<<blocks, threads, smem_bytes, st>>>(        \
        r, s, h, ro, t, o, B, V, D, H, W, Hs, Ws, row0, C, G, pixels,          \
        attn_fuse_d, attn_temp, sqrt_c);                                       \
    return (int)cudaGetLastError();                                            \
  }
#define MVSTER_SPLITS(MG) \
  MVSTER_CASE(MG, 0) MVSTER_CASE(MG, 1) MVSTER_CASE(MG, 2) MVSTER_CASE(MG, 4)
  MVSTER_SPLITS(4)
  MVSTER_SPLITS(8)
  MVSTER_SPLITS(16)
  MVSTER_SPLITS(32)
  MVSTER_SPLITS(64)
#undef MVSTER_SPLITS
#undef MVSTER_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mvster_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
