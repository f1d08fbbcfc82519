// The DCN heads' deformable sampling and contraction (K7), for NVIDIA
// Hopper (sm_90a).
//
// K7 replaces no TPU kernel: the JAX package computes the modulated
// deformable conv (mvster_tpu/nn/dcn.py) with gathers and one dense
// contraction, and XLA fuses them.  It was added because the port's plain
// version of the same arithmetic runs ~74 launches a head and writes a
// (N, H, W, 9, C) tap tensor through HBM (1.38 GB at DTU's test size at
// stride 1): 56.7 of a served --dcn view's ~103 device ms.  It computes
// what nn/dcn.DeformConv2d.forward defines after its offset and
// modulation convs, for a 3x3 kernel, stride 1, padding 1 and O = C:
//
//   out[b, o, y, x] = sum over taps k = 3 ki + kj and channels c of
//       W[o, c, ki, kj] * sigmoid(mod[b, k, y, x])
//       * bilinear(xpad[b, :, :, c], row + row0 + ki + dy, x + kj + dx)
//
// with dy = off[b, k, y, x], dx = off[b, 9 + k, y, x] (p_conv's raw
// output, [dy x 9 | dx x 9]), mod m_conv's raw output, xpad the whole map
// zero-padded by one pixel, and each tap's position clamped to the padded
// map's border before its four corners are read (nn/dcn._clamped_bilinear).
// On a band of image rows (dist/spatial.py) the offsets and the output are
// the band's h rows and the map is the whole map of Hw rows, gathered;
// row0 is the band's first row.
//
// What bounds it on the H100: per output pixel 2 x 9C x C FLOPs of
// contraction and ~72 C of sampling, over the map (4C bytes a pixel, read
// once), the offsets and modulation (108 bytes) and the output (4C): at
// the four heads of a served view (C = 64, 32, 16, 8 at strides 8 to 1,
// 832x1152, 5 images) ~0.53 ms, FLOP-bound at the three coarse heads
// (67 TFLOP/s of float32 FFMA) and byte-bound at stride 1 (3.35 TB/s).
// Float32 FFMA only: the configurations state float32 with TF32 off.
//
// The design:
//   - One thread per output pixel, all O outputs of it in registers; two
//     pixels a thread at C >= 32 (kThreads apart, so a warp's loads of
//     offsets and its stores stay coalesced).  No taps reach HBM.
//   - The map is read channels last (B, Hw, W, C), so a corner is one run
//     of C floats read as C / 4 16-byte loads; each pixel reads 36 corners
//     whatever its offsets.  A corner in the zero padding is read at a
//     clamped address with its weight set to 0 (a select, no branch), so
//     every pixel, tile and seed does the same work.
//   - The (9C x C) weight is staged once a block into shared memory as
//     [tap][c][o] (147 KB at C = 64, set as the kernel's attribute once
//     by mvster_deform_conv_prepare); a warp reads it as broadcast 16-byte
//     loads, each feeding 4 FFMAs a pixel.
//   - Sums in a fixed order per pixel (taps, then channels; no atomics,
//     no reduction across threads), so the output is the same bits from
//     run to run.  The bilinear weights take the modulation before they
//     meet the corners: the plain version multiplies after, and sums the
//     taps in one GEMM, so the two differ by float32 rounding.
//   - A pixel past the last (the ragged tile) computes the last pixel's
//     value again and stores nothing.
// What likely holds it above the bound (by count, not measured apart): at
// C = 64 a warp's 16-byte corner load touches 32 cache lines, one a
// pixel, so the L1's requests rather than the FFMAs set the pace at the
// coarse heads; at C = 8 the gathers' latency.  Splitting the outputs
// over blocks, or more pixels a thread at C <= 16, measured slower on the
// H100 (PERF.md).
// Instances: C = 8, 16, 32, 64 (the FPN4 heads at base 8).  The wrapper
// (kernels/deform_conv.py) raises on anything else.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTaps = 9;

struct Args {
  const float* x;    // (B, Hw, W, C): the whole map, channels last
  const float* off;  // (B, 18, h, W): p_conv's raw output
  const float* mod;  // (B, 9, h, W): m_conv's raw output
  const float* w;    // (C, C, 3, 3): (O, C, ki, kj)
  float* out;        // (B, C, h, W)
  int h, W, Hw, row0, npix;
};

// Per instance, as measured fastest on the H100 with offsets of 1 and of
// 4 pixels (PERF.md): output pixels a thread, blocks an SM for the
// register budget, and the channel groups of 4 unrolled a tap (~512 FFMAs
// a loop body).
__host__ __device__ constexpr int pix_of(int c) { return c >= 32 ? 2 : 1; }
__host__ __device__ constexpr int min_blocks_of(int c) { return c == 8 ? 4 : c == 16 ? 2 : 1; }
__host__ __device__ constexpr int c4_unroll(int c) {
  return c / 4 < 128 / (c * pix_of(c)) ? c / 4 : 128 / (c * pix_of(c));
}

template <int C>
constexpr int smem_bytes() {
  return kTaps * C * C * (int)sizeof(float);
}

template <int C>
__global__ void __launch_bounds__(kThreads, min_blocks_of(C)) deform_conv_kernel(const Args a) {
  constexpr int kPix = pix_of(C);
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);  // [tap][c][o]
  for (int e = threadIdx.x; e < kTaps * C * C; e += kThreads) {
    const int k = e % kTaps, c = (e / kTaps) % C, o = e / (kTaps * C);
    sw[(k * C + c) * C + o] = a.w[e];
  }
  __syncthreads();

  const int hw = a.h * a.W;
  const float last_row = (float)(a.Hw + 1), last_col = (float)(a.W + 1);  // padded map
  int r[kPix], y[kPix], xx[kPix], base[kPix];
  const float* img[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    int p = blockIdx.x * (kThreads * kPix) + i * kThreads + threadIdx.x;
    p = p < a.npix ? p : a.npix - 1;
    const int b = p / hw;
    r[i] = p - b * hw;
    y[i] = r[i] / a.W;
    xx[i] = r[i] - y[i] * a.W;
    base[i] = b * hw;  // off is b * 18 hw + k hw + r, mod b * 9 hw + k hw + r
    img[i] = a.x + (size_t)b * a.Hw * a.W * C;
  }

  float acc[kPix][C];
#pragma unroll
  for (int i = 0; i < kPix; ++i)
#pragma unroll
    for (int o = 0; o < C; ++o) acc[i][o] = 0.f;

  const float4* sw4 = smem4;
  constexpr int kUnrollC4 = c4_unroll(C);
#pragma unroll 1
  for (int k = 0; k < kTaps; ++k) {
    const int ki = k / 3, kj = k - 3 * ki;
    int c00[kPix], c01[kPix], c10[kPix], c11[kPix];  // corners: element offsets in img
    float w00[kPix], w01[kPix], w10[kPix], w11[kPix];
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      const float dy = __ldg(a.off + 18 * base[i] + k * hw + r[i]);
      const float dx = __ldg(a.off + 18 * base[i] + (kTaps + k) * hw + r[i]);
      const float mr = __ldg(a.mod + 9 * base[i] + k * hw + r[i]);
      const float m = 1.f / (1.f + expf(-mr));
      // the tap's position in the padded map, as the plain version rounds it
      float py = (float)(y[i] + a.row0 + ki) + dy;
      float px = (float)(xx[i] + kj) + dx;
      py = fminf(fmaxf(py, 0.f), last_row);
      px = fminf(fmaxf(px, 0.f), last_col);
      const float fy = floorf(py), fx = floorf(px);
      const float wy = py - fy, wx = px - fx;
      const int y0 = (int)fy, x0 = (int)fx;
      const int y1 = min(y0 + 1, a.Hw + 1), x1 = min(x0 + 1, a.W + 1);
      // padded rows 1..Hw and columns 1..W hold the map; the rest is zero
      const bool vy0 = y0 >= 1 && y0 <= a.Hw, vy1 = y1 >= 1 && y1 <= a.Hw;
      const bool vx0 = x0 >= 1 && x0 <= a.W, vx1 = x1 >= 1 && x1 <= a.W;
      const int ry0 = min(max(y0 - 1, 0), a.Hw - 1), ry1 = min(max(y1 - 1, 0), a.Hw - 1);
      const int rx0 = min(max(x0 - 1, 0), a.W - 1), rx1 = min(max(x1 - 1, 0), a.W - 1);
      c00[i] = (ry0 * a.W + rx0) * C;
      c01[i] = (ry0 * a.W + rx1) * C;
      c10[i] = (ry1 * a.W + rx0) * C;
      c11[i] = (ry1 * a.W + rx1) * C;
      w00[i] = vy0 && vx0 ? (1.f - wy) * (1.f - wx) * m : 0.f;
      w01[i] = vy0 && vx1 ? (1.f - wy) * wx * m : 0.f;
      w10[i] = vy1 && vx0 ? wy * (1.f - wx) * m : 0.f;
      w11[i] = vy1 && vx1 ? wy * wx * m : 0.f;
    }
#pragma unroll (kUnrollC4)
    for (int c4 = 0; c4 < C / 4; ++c4) {
      float s[kPix][4];
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        const float4 v00 = __ldg(reinterpret_cast<const float4*>(img[i] + c00[i]) + c4);
        const float4 v01 = __ldg(reinterpret_cast<const float4*>(img[i] + c01[i]) + c4);
        const float4 v10 = __ldg(reinterpret_cast<const float4*>(img[i] + c10[i]) + c4);
        const float4 v11 = __ldg(reinterpret_cast<const float4*>(img[i] + c11[i]) + c4);
        s[i][0] = fmaf(v11.x, w11[i], fmaf(v10.x, w10[i], fmaf(v01.x, w01[i], v00.x * w00[i])));
        s[i][1] = fmaf(v11.y, w11[i], fmaf(v10.y, w10[i], fmaf(v01.y, w01[i], v00.y * w00[i])));
        s[i][2] = fmaf(v11.z, w11[i], fmaf(v10.z, w10[i], fmaf(v01.z, w01[i], v00.z * w00[i])));
        s[i][3] = fmaf(v11.w, w11[i], fmaf(v10.w, w10[i], fmaf(v01.w, w01[i], v00.w * w00[i])));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4* wrow = sw4 + ((k * C + 4 * c4 + j) * C) / 4;
#pragma unroll
        for (int o4 = 0; o4 < C / 4; ++o4) {
          const float4 wv = wrow[o4];
#pragma unroll
          for (int i = 0; i < kPix; ++i) {
            acc[i][4 * o4 + 0] = fmaf(s[i][j], wv.x, acc[i][4 * o4 + 0]);
            acc[i][4 * o4 + 1] = fmaf(s[i][j], wv.y, acc[i][4 * o4 + 1]);
            acc[i][4 * o4 + 2] = fmaf(s[i][j], wv.z, acc[i][4 * o4 + 2]);
            acc[i][4 * o4 + 3] = fmaf(s[i][j], wv.w, acc[i][4 * o4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int p = blockIdx.x * (kThreads * kPix) + i * kThreads + threadIdx.x;
    if (p < a.npix) {
      float* dst = a.out + (size_t)base[i] * C + r[i];
#pragma unroll
      for (int o = 0; o < C; ++o) dst[(size_t)o * hw] = acc[i][o];
    }
  }
}

template <int C>
int prepare() {
  return (int)cudaFuncSetAttribute(deform_conv_kernel<C>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<C>());
}

template <int C>
int launch(const Args& a, cudaStream_t st) {
  const int blocks = (a.npix + kThreads * pix_of(C) - 1) / (kThreads * pix_of(C));
  deform_conv_kernel<C><<<blocks, kThreads, smem_bytes<C>(), st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Sets each instance's shared-memory attribute on the current device;
// called once a device before the first launch.  Returns the first
// nonzero cudaError_t, or 0.
extern "C" int mvster_deform_conv_prepare() {
  int rc = prepare<8>();
  if (rc == 0) rc = prepare<16>();
  if (rc == 0) rc = prepare<32>();
  if (rc == 0) rc = prepare<64>();
  return rc;
}

// Plain C interface, loaded with ctypes; returns the cudaError_t of the
// launch (0 on success), cudaErrorInvalidValue for a C with no instance or
// an empty output.  The wrapper checks the tensors: x (B, Hw, W, C)
// channels last, off (B, 18, h, W), mod (B, 9, h, W), w (C, C, 3, 3) and
// out (B, C, h, W), each contiguous float32, row0 + h <= Hw.
extern "C" int mvster_deform_conv(const void* x, const void* off, const void* mod,
                                  const void* w, void* out, int B, int C, int h, int W, int Hw,
                                  int row0, void* stream) {
  Args a;
  a.x = static_cast<const float*>(x);
  a.off = static_cast<const float*>(off);
  a.mod = static_cast<const float*>(mod);
  a.w = static_cast<const float*>(w);
  a.out = static_cast<float*>(out);
  a.h = h, a.W = W, a.Hw = Hw, a.row0 = row0, a.npix = B * h * W;
  if (a.npix <= 0) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 8: return launch<8>(a, st);
    case 16: return launch<16>(a, st);
    case 32: return launch<32>(a, st);
    case 64: return launch<64>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
