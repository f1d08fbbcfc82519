// The weight gradient of Reg2d's planar convolutions (K6), for NVIDIA
// Hopper (sm_90a).
//
// K6 replaces no TPU kernel: the JAX package leaves this gradient to XLA.
// It was added because cuDNN's float32 weight gradient for these shapes
// (wgrad2d_grouped_direct) runs at about 0.1% of the card's FP32 peak and
// held half of a train step's device time.  It computes, for a (1, 3, 3)
// kernel with stride (1, S, S) and padding (0, ph, pw),
//
//   dW[m, c, 0, kh, kw] = sum over b, d, y, x of
//       g[b, m, d, y, x] * in[b, c, d, y*S + kh - ph, x*S + kw - pw]
//
// with `in` zero outside its H x W.  For Conv3d, g is the output gradient
// (M = C_out) and `in` the input (C = C_in).  A ConvTranspose3d's weight
// gradient is the same sum with the roles swapped: its input is g (M =
// C_in) and its output gradient is `in` (C = C_out), and its weight
// (C_in, C_out, 1, 3, 3) has the layout of dW.  The output padding only
// sets the output gradient's size, which the kernel takes as it is, so
// one kernel serves both.  The D planes are more batch.  Both tensors are
// read through their NCDHW strides as they come.
//
// What bounds it on the H100: Reg2d's planar blocks need about 15 GFLOP
// of weight gradient over ~0.8 GB of activations and gradients a DTU-mid
// train step (512x640, batch 2): 0.22 ms at 67 TFLOP/s of float32 FFMA
// and 0.24 ms at 3.35 TB/s, so the kernel is near the line between the
// two; float32 FFMA only (the configurations state float32 with TF32
// off: no tensor cores).
//
// The design: a split-K product, M x (C * 9) over K = B * D * Ho * Wo
// output pixels.
//   - Persistent blocks, two an SM, each walking tiles of TY x TX output
//     pixels of one (b, d) plane (tile t, t + gridDim.x, ...).
//   - A tile's g (M x TY*TX) and its input patch with the halo (C x
//     ((TY-1)S+3) x ((TX-1)S+3)) are staged into shared memory by
//     cp.async, 4 bytes a copy in the tensors' own strides, zero-filled
//     outside the image and past the plane's edge, in a ring of two
//     buffers: the next tile's copies fly while this one's FFMAs run.
//   - Each thread keeps a register block of dW: 4 m x 2 c x 9 taps, 72
//     sums.  The M/4 * C/2 thread blocks of dW cover it once; the block's
//     256 threads hold 256 / that many copies, which take the tile's
//     pixels in turns (pixel groups).  A pixel costs a thread 4 + 18
//     shared-memory loads for 72 FFMAs; the staged rows are padded so
//     that a warp's loads fall in distinct banks or broadcast.
//   - Partial sums are combined deterministically: a butterfly of warp
//     shuffles over the pixel groups that share a warp, then the copies
//     in shared memory in a fixed order, into a scratch of one partial
//     dW a block (from torch.empty, at most 16 MB); a second kernel sums
//     the blocks' partials in block order.  A fixed order makes the
//     gradient the same bits from run to run, where float atomics (as K3
//     uses) would not, for one more launch of a few microseconds.
//   - A thread's serial sum is its share of the block's tiles: ~155
//     terms at the largest DTU-mid shape, then a tree of at most 3 levels,
//     up to 8 copies and up to 264 blocks, so float32 rounding stays at a
//     few ulps of the sum's magnitude.
// Instances: stride 1 with (M, C) = (8, 4), (8, 8) (conv0 after group
// correlation of 4 or 8 groups) and stride 2 with (16, 8), (32, 16), (64,
// 32) (conv1/3/5 and the transposed conv11/9/7, base 8).  The wrapper
// (kernels/conv_wgrad.py) raises on anything else; the tile of each
// instance is also stated there, for the plain version, and checked here.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 4;  // dW rows (m) a thread
constexpr int kTC = 2;  // dW input channels (c) a thread
constexpr int kTaps = 9;

template <int S, int M, int CN>
struct Plan {
  static constexpr int MT = M / kTM, CT = CN / kTC, Q = MT * CT;  // thread blocks of dW
  static constexpr int P = kThreads / Q;                          // pixel groups
  static constexpr int NPIX = 8 * P > 32 ? 8 * P : 32;            // output pixels a tile
  static constexpr int TX = NPIX < 64 ? NPIX : 64;
  static constexpr int TY = NPIX / TX;
  static constexpr int XR = (TY - 1) * S + 3, XC = (TX - 1) * S + 3;  // input patch
  static constexpr int GSTR = NPIX + 2;  // a staged g channel (+2: banks)
  static constexpr int XPL = XR * XC;    // a staged input channel
  static constexpr int STAGE = M * GSTR + CN * XPL;  // floats a ring buffer
  static constexpr int PGW = Q < 32 ? 32 / Q : 1;    // pixel groups a warp
  static constexpr int R = P / PGW;                  // copies after the warp's tree
  static constexpr int NACC = kTM * kTC * kTaps;
  static constexpr int RED = R > 1 ? R * Q * NACC : 0;
  static constexpr int SMEM_FLOATS = 2 * STAGE > RED ? 2 * STAGE : RED;
  static_assert(M % kTM == 0 && CN % kTC == 0, "channels per thread");
  static_assert(Q <= kThreads && kThreads % Q == 0, "dW must split over the block");
  static_assert((NPIX & (NPIX - 1)) == 0 && NPIX % P == 0, "tile");
};

struct Args {
  const float* g;
  long long gb, gc, gd, gh, gw;  // g's strides (elements)
  const float* x;
  long long xb, xc, xd, xh, xw;  // in's strides
  float* part;                   // (gridDim.x, M * CN * 9)
  int D, Ho, Wo, Hi, Wi, ph, pw;
  int tiles_x, tiles_y, ntiles;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(saddr), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issue the copies of tile t into one ring buffer: g as [m][pixel], the
// input patch as [c][row][col]; zeros outside the image.
template <int S, int M, int CN>
__device__ __forceinline__ void stage_tile(float* buf, const Args& a, int t) {
  using PL = Plan<S, M, CN>;
  const int tx = t % a.tiles_x;
  const int r = t / a.tiles_x;
  const int ty = r % a.tiles_y;
  const int plane = r / a.tiles_y;
  const int b = plane / a.D, d = plane % a.D;
  const int y0 = ty * PL::TY, x0 = tx * PL::TX;
  const float* gp = a.g + b * a.gb + d * a.gd;
  for (int e = threadIdx.x; e < M * PL::NPIX; e += kThreads) {
    const int m = e / PL::NPIX, p = e % PL::NPIX;
    const int y = y0 + p / PL::TX, x = x0 + p % PL::TX;
    const bool ok = y < a.Ho && x < a.Wo;
    cp_async4(buf + m * PL::GSTR + p, ok ? gp + m * a.gc + y * a.gh + x * a.gw : a.g, ok);
  }
  float* sx = buf + M * PL::GSTR;
  const int iy0 = y0 * S - a.ph, ix0 = x0 * S - a.pw;
  const float* xp = a.x + b * a.xb + d * a.xd;
  for (int e = threadIdx.x; e < CN * PL::XPL; e += kThreads) {
    const int c = e / PL::XPL, rc = e % PL::XPL;
    const int iy = iy0 + rc / PL::XC, ix = ix0 + rc % PL::XC;
    const bool ok = iy >= 0 && iy < a.Hi && ix >= 0 && ix < a.Wi;
    cp_async4(sx + c * PL::XPL + rc, ok ? xp + c * a.xc + iy * a.xh + ix * a.xw : a.x, ok);
  }
}

template <int S, int M, int CN>
__global__ void __launch_bounds__(kThreads, 2) conv_wgrad_kernel(const Args a) {
  using PL = Plan<S, M, CN>;
  extern __shared__ float smem[];
  const int q = threadIdx.x % PL::Q, pg = threadIdx.x / PL::Q;
  const int m0 = (q / PL::CT) * kTM, c0 = (q % PL::CT) * kTC;
  float acc[PL::NACC];
#pragma unroll
  for (int v = 0; v < PL::NACC; ++v) acc[v] = 0.f;

  int t = blockIdx.x;
  if (t < a.ntiles) stage_tile<S, M, CN>(smem, a, t);
  cp_async_commit();
  int cur = 0;
  for (; t < a.ntiles; t += gridDim.x) {
    const int tn = t + gridDim.x;
    if (tn < a.ntiles) stage_tile<S, M, CN>(smem + (cur ^ 1) * PL::STAGE, a, tn);
    cp_async_commit();
    cp_async_wait<1>();  // tile t has landed (this thread's copies)
    __syncthreads();     // ... and every thread's
    const float* sg = smem + cur * PL::STAGE + m0 * PL::GSTR;
    const float* sx = smem + cur * PL::STAGE + M * PL::GSTR + c0 * PL::XPL;
#pragma unroll 2
    for (int k = 0; k < PL::NPIX / PL::P; ++k) {
      const int p = k * PL::P + pg;
      const int py = p / PL::TX, px = p % PL::TX;
      float gv[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i) gv[i] = sg[i * PL::GSTR + p];
      const float* xr = sx + py * S * PL::XC + px * S;
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            const float xv = xr[j * PL::XPL + kh * PL::XC + kw];
#pragma unroll
            for (int i = 0; i < kTM; ++i) {
              float& s = acc[(i * kTC + j) * kTaps + kh * 3 + kw];
              s = fmaf(gv[i], xv, s);
            }
          }
        }
      }
    }
    __syncthreads();  // the buffer is read: the next iteration may refill it
    cur ^= 1;
  }
  cp_async_wait<0>();

  float* out = a.part + (size_t)blockIdx.x * (M * CN * kTaps);
  if constexpr (PL::P == 1) {
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTC; ++j)
#pragma unroll
        for (int tap = 0; tap < kTaps; ++tap)
          out[((m0 + i) * CN + c0 + j) * kTaps + tap] = acc[(i * kTC + j) * kTaps + tap];
  } else {
    if constexpr (PL::PGW > 1) {
      // lanes pgl * Q + q: xor over the pgl bits sums the warp's groups
#pragma unroll
      for (int off = PL::Q; off < 32; off <<= 1)
#pragma unroll
        for (int v = 0; v < PL::NACC; ++v) acc[v] += __shfl_xor_sync(0xffffffffu, acc[v], off);
    }
    float* red = smem;  // the ring is free: the loop ended on a barrier
    const int slot = PL::PGW > 1 ? threadIdx.x / 32 : pg;
    if (PL::PGW == 1 || (threadIdx.x & 31) < PL::Q) {
#pragma unroll
      for (int v = 0; v < PL::NACC; ++v) red[(slot * PL::Q + q) * PL::NACC + v] = acc[v];
    }
    __syncthreads();
    for (int o = threadIdx.x; o < M * CN * kTaps; o += kThreads) {
      const int tap = o % kTaps, mc = o / kTaps;
      const int c = mc % CN, m = mc / CN;
      const int qq = (m / kTM) * PL::CT + c / kTC;
      const int v = ((m % kTM) * kTC + c % kTC) * kTaps + tap;
      float s = 0.f;
      for (int r = 0; r < PL::R; ++r) s += red[(r * PL::Q + qq) * PL::NACC + v];
      out[o] = s;
    }
  }
}

// dW[o] = the blocks' partials summed in block order.
__global__ void conv_wgrad_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                                         int n, int blocks) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n) return;
  float s = 0.f;
  for (int k = 0; k < blocks; ++k) s += part[(size_t)k * n + o];
  dw[o] = s;
}

template <int S, int M, int CN>
int launch(Args a, int planes, int ty, int tx, int blocks, float* dw, cudaStream_t st) {
  using PL = Plan<S, M, CN>;
  if (ty != PL::TY || tx != PL::TX || blocks < 1) return (int)cudaErrorInvalidValue;
  a.tiles_x = (a.Wo + PL::TX - 1) / PL::TX;
  a.tiles_y = (a.Ho + PL::TY - 1) / PL::TY;
  a.ntiles = a.tiles_x * a.tiles_y * planes;
  const int smem = PL::SMEM_FLOATS * (int)sizeof(float);
  const cudaError_t attr = cudaFuncSetAttribute(
      conv_wgrad_kernel<S, M, CN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  conv_wgrad_kernel<S, M, CN><<<blocks, kThreads, smem, st>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = M * CN * kTaps;
  conv_wgrad_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(a.part, dw, n, blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes; returns the cudaError_t of its
// launches (0 on success), cudaErrorInvalidValue for an (S, M, C) with no
// instance or a tile that is not the instance's.  The wrapper checks the
// tensors and sizes; part holds `blocks` partials of M * C * 9 floats, dw
// (M, C, 1, 3, 3) is written whole.
extern "C" int mvster_conv_wgrad(const void* g, const void* x, void* part, void* dw, int B,
                                 int D, int M, int CN, int stride, int Ho, int Wo, int Hi,
                                 int Wi, int ph, int pw, long long gb, long long gc,
                                 long long gd, long long gh, long long gw, long long xb,
                                 long long xc, long long xd, long long xh, long long xw,
                                 int ty, int tx, int blocks, void* stream) {
  Args a;
  a.g = static_cast<const float*>(g);
  a.gb = gb, a.gc = gc, a.gd = gd, a.gh = gh, a.gw = gw;
  a.x = static_cast<const float*>(x);
  a.xb = xb, a.xc = xc, a.xd = xd, a.xh = xh, a.xw = xw;
  a.part = static_cast<float*>(part);
  a.D = D, a.Ho = Ho, a.Wo = Wo, a.Hi = Hi, a.Wi = Wi, a.ph = ph, a.pw = pw;
  a.tiles_x = a.tiles_y = a.ntiles = 0;
  auto w = static_cast<float*>(dw);
  auto st = static_cast<cudaStream_t>(stream);
#define K6_CASE(S_, M_, CN_) \
  if (stride == S_ && M == M_ && CN == CN_) return launch<S_, M_, CN_>(a, B * D, ty, tx, blocks, w, st);
  K6_CASE(1, 8, 4)
  K6_CASE(1, 8, 8)
  K6_CASE(2, 16, 8)
  K6_CASE(2, 32, 16)
  K6_CASE(2, 64, 32)
#undef K6_CASE
  return (int)cudaErrorInvalidValue;
}
