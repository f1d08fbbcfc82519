// The discrete Sinkhorn OT depth loss (K4) and its hand-derived backward
// (K5), for NVIDIA Hopper (sm_90a).
//
// K4, mvster_sinkhorn_fwd, replaces the TPU kernel
// mvster_tpu/kernels/pallas_sinkhorn.py::_fwd_kernel (launched in
// _call_fwd); K5, mvster_sinkhorn_bwd, replaces ::_bwd_kernel (launched in
// _sinkhorn_pixels_bwd).  Both compute exactly what
// mvster_tpu_torch.kernels.sinkhorn_ot's plain versions compute, per pixel:
//
//   S_ij = |i - j| / eps, cost_ij = S_ij * eps   (i, j in [0, D))
//   log nu_i = log(pred_i + 1e-12)
//   log mu_j = log(1 + 1e-12) at the GT bin, log(1e-12) elsewhere
//   u = v = 0; iters times:
//     v_j = log mu_j - LSE_i(S_ij + u_i)
//     u_i = log nu_i - LSE_j(S_ij + v_j)
//   K4: loss = sum_ij exp(S_ij + u_i + v_j) * cost_ij
//   K5: dL/dpred for the per-pixel cotangent g, by replaying the forward
//       and running the reverse sweep of _bwd_kernel
//
// Each log-sum-exp subtracts its maximum first, as the TPU kernel does, and
// uses the accurate expf and logf (the library is built without
// --use_fast_math).
//
// Layout: pred is the model's attention (B, D, N) as it lies, N = H * W; one
// thread per pixel, so thread p reads pred[b, d, p] for each d and
// neighbouring threads read neighbouring addresses.  D is a template
// parameter: u, v, log nu, log mu and the cost row stay in registers.  The
// GT bin index (argmin over D of |hypo - gt|, first minimum) comes from the
// wrapper, as the JAX package computes it outside its kernel too.
//
// K5 needs (u_t, v_t) of every iteration in its reverse sweep: iters * 2 * D
// floats per thread, 640 bytes at D = 8 and iters = 10, too many for
// registers.  They live in dynamic shared memory, (iters, 2, D, threads)
// with the thread index fastest, so a warp's 32 accesses fall in 32 banks.
// The wrapper sizes the block from iters (at most 48 KB where a block of 32
// threads allows it) and passes the bytes; above 48 KB the launch first
// raises the kernel's dynamic shared-memory limit.
//
// What bounds them on the H100: exp and log, not bytes.  K4 moves D + 2
// words per pixel and does iters * (2 D^2 exp + 2 D log) + D^2 exp + D log
// special-function operations; K5 about twice that.  They run on the SMs'
// special-function units (MUFU, 16 per clock per SM).  This first design is
// the simple one: one thread does a pixel's whole iteration in series.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kFwdThreads = 128;
// math.log(1.0 + 1e-12) and math.log(1e-12), rounded to float32 as the
// JAX package's kernel and the plain version round them
constexpr float kLogOne = (float)1.000088900581841e-12;
constexpr float kLogEps = (float)-27.631021115928547;

// The D distinct values of S: sc[k] = k / eps (S_ij = sc[|i - j|]).
template <int D>
__device__ __forceinline__ void scaled_row(float eps, float* sc) {
#pragma unroll
  for (int k = 0; k < D; ++k) sc[k] = (float)k / eps;
}

template <int D>
__device__ __forceinline__ float S(const float* sc, int i, int j) {
  return sc[i > j ? i - j : j - i];
}

// One Sinkhorn iteration: v from u, then u from v.
template <int D>
__device__ __forceinline__ void iterate(const float* sc, const float* log_mu,
                                        const float* log_nu, float* u,
                                        float* v) {
#pragma unroll
  for (int j = 0; j < D; ++j) {  // v_j = log_mu_j - LSE_i(S_ij + u_i)
    float m = S<D>(sc, 0, j) + u[0];
#pragma unroll
    for (int i = 1; i < D; ++i) m = fmaxf(m, S<D>(sc, i, j) + u[i]);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < D; ++i) s += expf((S<D>(sc, i, j) + u[i]) - m);
    v[j] = log_mu[j] - (logf(s) + m);
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {  // u_i = log_nu_i - LSE_j(S_ij + v_j)
    float m = S<D>(sc, i, 0) + v[0];
#pragma unroll
    for (int j = 1; j < D; ++j) m = fmaxf(m, S<D>(sc, i, j) + v[j]);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < D; ++j) s += expf((S<D>(sc, i, j) + v[j]) - m);
    u[i] = log_nu[i] - (logf(s) + m);
  }
}

// log nu from the pixel's D predictions, log mu from its GT bin.
template <int D>
__device__ __forceinline__ void marginals(const float* P, int64_t N, int gt,
                                          float* log_nu, float* log_mu) {
#pragma unroll
  for (int k = 0; k < D; ++k) {
    log_nu[k] = logf(P[k * N] + 1e-12f);
    log_mu[k] = k == gt ? kLogOne : kLogEps;
  }
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads)
sinkhorn_fwd_kernel(const float* __restrict__ pred,  // (B, D, N)
                    const int* __restrict__ gt_idx,  // (B, N)
                    float* __restrict__ loss,        // (B, N)
                    int B, int N, int iters, float eps) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)B * N) return;
  const int64_t b = i / N;
  const float* P = pred + b * D * (int64_t)N + (i - b * N);
  float sc[D], log_nu[D], log_mu[D], u[D], v[D];
  scaled_row<D>(eps, sc);
  marginals<D>(P, N, gt_idx[i], log_nu, log_mu);
#pragma unroll
  for (int k = 0; k < D; ++k) u[k] = v[k] = 0.f;
  for (int t = 0; t < iters; ++t) iterate<D>(sc, log_mu, log_nu, u, v);
  float total = 0.f;
#pragma unroll
  for (int r = 0; r < D; ++r) {
#pragma unroll
    for (int c = 0; c < D; ++c) {
      const float s = S<D>(sc, r, c);
      total += expf((s + u[r]) + v[c]) * (s * eps);
    }
  }
  loss[i] = total;
}

template <int D>
__global__ void sinkhorn_bwd_kernel(const float* __restrict__ pred,  // (B, D, N)
                                    const int* __restrict__ gt_idx,  // (B, N)
                                    const float* __restrict__ g,     // (B, N)
                                    float* __restrict__ dpred,       // (B, D, N)
                                    int B, int N, int iters, float eps) {
  extern __shared__ float hist[];  // (iters, 2, D, blockDim.x): u_t, v_t
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int64_t i = (int64_t)blockIdx.x * nt + tid;
  if (i >= (int64_t)B * N) return;
  const int64_t b = i / N;
  const int64_t off = b * D * (int64_t)N + (i - b * N);
  const float* P = pred + off;
  float sc[D], log_nu[D], log_mu[D], u[D], v[D];
  scaled_row<D>(eps, sc);
  marginals<D>(P, N, gt_idx[i], log_nu, log_mu);
#pragma unroll
  for (int k = 0; k < D; ++k) u[k] = v[k] = 0.f;
  // hist[((t * 2 + which) * D + k) * nt + tid], which 0 = u, 1 = v
  for (int t = 0; t < iters; ++t) {
    iterate<D>(sc, log_mu, log_nu, u, v);
    float* h = hist + (int64_t)t * 2 * D * nt + tid;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      h[k * nt] = u[k];
      h[(D + k) * nt] = v[k];
    }
  }

  // the loss sum_ij T_ij C_ij, T = exp(S + u + v), gives du_i = g sum_j
  // T_ij C_ij and dv_j = g sum_i T_ij C_ij
  const float gi = g[i];
  float du[D], dv[D], dlog_nu[D];
#pragma unroll
  for (int k = 0; k < D; ++k) du[k] = dv[k] = dlog_nu[k] = 0.f;
#pragma unroll
  for (int r = 0; r < D; ++r) {
#pragma unroll
    for (int c = 0; c < D; ++c) {
      const float s = S<D>(sc, r, c);
      const float tc = expf((s + u[r]) + v[c]) * (s * eps);
      du[r] += tc;
      dv[c] += tc;
    }
  }
#pragma unroll
  for (int k = 0; k < D; ++k) {
    du[k] *= gi;
    dv[k] *= gi;
  }

  // reverse sweep, t = iters - 1 .. 0; du, dv hold the cotangents of u_t, v_t
  for (int t = iters - 1; t >= 0; --t) {
    const float* h = hist + (int64_t)t * 2 * D * nt + tid;
    float vt[D], row[D], acc[D], dvt[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      vt[k] = h[(D + k) * nt];
      acc[k] = 0.f;
      dlog_nu[k] += du[k];
    }
    // u_t = log_nu - LSE_j(S_ij + v_t_j): dv_t_j -= sum_i du_i P_ij, with
    // P = softmax over j of S_ij + v_t_j
#pragma unroll
    for (int r = 0; r < D; ++r) {
      float m = S<D>(sc, r, 0) + vt[0];
#pragma unroll
      for (int c = 1; c < D; ++c) m = fmaxf(m, S<D>(sc, r, c) + vt[c]);
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        row[c] = expf((S<D>(sc, r, c) + vt[c]) - m);
        s += row[c];
      }
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] += du[r] * (row[c] / s);
    }
#pragma unroll
    for (int c = 0; c < D; ++c) dvt[c] = dv[c] - acc[c];
    if (t == 0) break;  // u_{-1} = 0 is a constant: nothing flows further
    // v_t = log_mu - LSE_i(S_ij + u_{t-1}_i): du_{t-1}_i = -sum_j dv_t_j
    // Q_ij, with Q = softmax over i of S_ij + u_{t-1}_i
    const float* hp = h - 2 * D * nt;
    float up[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      up[k] = hp[k * nt];
      du[k] = 0.f;
      dv[k] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < D; ++c) {
      float m = S<D>(sc, 0, c) + up[0];
#pragma unroll
      for (int r = 1; r < D; ++r) m = fmaxf(m, S<D>(sc, r, c) + up[r]);
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < D; ++r) {
        row[r] = expf((S<D>(sc, r, c) + up[r]) - m);
        s += row[r];
      }
#pragma unroll
      for (int r = 0; r < D; ++r) du[r] += dvt[c] * (row[r] / s);
    }
#pragma unroll
    for (int k = 0; k < D; ++k) du[k] = -du[k];
  }
#pragma unroll
  for (int k = 0; k < D; ++k) dpred[off + k * (int64_t)N] = dlog_nu[k] / (P[k * (int64_t)N] + 1e-12f);
}

unsigned blocks_for(int B, int N, int threads) {
  const int64_t n = (int64_t)B * N;
  return (unsigned)((n + threads - 1) / threads);
}

template <int D>
int launch_fwd(const float* pred, const int* gt, float* loss, int B, int N,
               int iters, float eps, cudaStream_t st) {
  sinkhorn_fwd_kernel<D><<<blocks_for(B, N, kFwdThreads), kFwdThreads, 0, st>>>(
      pred, gt, loss, B, N, iters, eps);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd(const float* pred, const int* gt, const float* g, float* dpred,
               int B, int N, int iters, float eps, int threads, int smem,
               cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sinkhorn_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  sinkhorn_bwd_kernel<D><<<blocks_for(B, N, threads), threads, smem, st>>>(
      pred, gt, g, dpred, B, N, iters, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Each returns the cudaError_t of
// its launch (0 on success; cudaErrorInvalidValue for a D it is not
// instantiated for).  The Python wrappers check device, dtype, shapes,
// contiguity and D before calling, and size K5's block and shared memory.
extern "C" int mvster_sinkhorn_fwd(const void* pred, const void* gt_idx,
                                   void* loss, int B, int N, int D, int iters,
                                   float eps, void* stream) {
  auto p = static_cast<const float*>(pred);
  auto gt = static_cast<const int*>(gt_idx);
  auto out = static_cast<float*>(loss);
  auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 4: return launch_fwd<4>(p, gt, out, B, N, iters, eps, st);
    case 8: return launch_fwd<8>(p, gt, out, B, N, iters, eps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int mvster_sinkhorn_bwd(const void* pred, const void* gt_idx,
                                   const void* g, void* dpred, int B, int N,
                                   int D, int iters, float eps, int threads,
                                   int smem_bytes, void* stream) {
  auto p = static_cast<const float*>(pred);
  auto gt = static_cast<const int*>(gt_idx);
  auto cot = static_cast<const float*>(g);
  auto out = static_cast<float*>(dpred);
  auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 4: return launch_bwd<4>(p, gt, cot, out, B, N, iters, eps, threads, smem_bytes, st);
    case 8: return launch_bwd<8>(p, gt, cot, out, B, N, iters, eps, threads, smem_bytes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
