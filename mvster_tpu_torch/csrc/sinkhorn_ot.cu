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
// neighbouring threads read neighbouring addresses.  D is a runtime
// argument, 1 <= D <= 64; the per-bin arrays (u, v, log nu, log mu, the
// cost row) are sized by a template capacity MAXD in {4, 8, 16, 32, 64},
// the smallest that holds D, and every loop over bins runs k = 0 .. D - 1
// in order.  In the instances of up to 8 bins the loops are
// unrolled, so the arrays stay in registers; above that they are plain
// loops and the arrays live in local memory.  D = 4 and D = 8, the
// counts of dtu_default, run instances (EXACT) in which D is the constant
// MAXD, so the guards fold away and the code is that of a kernel
// instantiated on D alone.  The
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

// Calls f(k) for k = 0 .. D - 1, in order.  In the instances of up to 8
// bins the loop is unrolled over the capacity, each call under k < D, so
// the arrays of MAXD floats are indexed by constants and stay in registers
// (at D = MAXD these are the operations of a kernel instantiated on D);
// above 8 it is a plain loop and those arrays live in local memory.
template <int MAXD, class F>
__device__ __forceinline__ void bins(int D, F&& f) {
  if constexpr (MAXD <= 8) {
#pragma unroll
    for (int k = 0; k < MAXD; ++k) {
      if (k < D) f(k);
    }
  } else {
    for (int k = 0; k < D; ++k) f(k);
  }
}

// The D distinct values of S: sc[k] = k / eps (S_ij = sc[|i - j|]).
template <int MAXD>
__device__ __forceinline__ void scaled_row(float eps, int D, float* sc) {
  bins<MAXD>(D, [&](int k) { sc[k] = (float)k / eps; });
}

__device__ __forceinline__ float S(const float* sc, int i, int j) {
  return sc[i > j ? i - j : j - i];
}

// One Sinkhorn iteration: v from u, then u from v.
template <int MAXD>
__device__ __forceinline__ void iterate(const float* sc, const float* log_mu,
                                        const float* log_nu, int D, float* u,
                                        float* v) {
  bins<MAXD>(D, [&](int j) {  // v_j = log_mu_j - LSE_i(S_ij + u_i)
    float m = S(sc, 0, j) + u[0];
    bins<MAXD>(D, [&](int i) {
      if (i > 0) m = fmaxf(m, S(sc, i, j) + u[i]);
    });
    float s = 0.f;
    bins<MAXD>(D, [&](int i) { s += expf((S(sc, i, j) + u[i]) - m); });
    v[j] = log_mu[j] - (logf(s) + m);
  });
  bins<MAXD>(D, [&](int i) {  // u_i = log_nu_i - LSE_j(S_ij + v_j)
    float m = S(sc, i, 0) + v[0];
    bins<MAXD>(D, [&](int j) {
      if (j > 0) m = fmaxf(m, S(sc, i, j) + v[j]);
    });
    float s = 0.f;
    bins<MAXD>(D, [&](int j) { s += expf((S(sc, i, j) + v[j]) - m); });
    u[i] = log_nu[i] - (logf(s) + m);
  });
}

// log nu from the pixel's D predictions, log mu from its GT bin.
template <int MAXD>
__device__ __forceinline__ void marginals(const float* P, int64_t N, int gt,
                                          int D, float* log_nu, float* log_mu) {
  bins<MAXD>(D, [&](int k) {
    log_nu[k] = logf(P[k * N] + 1e-12f);
    log_mu[k] = k == gt ? kLogOne : kLogEps;
  });
}

template <int MAXD, bool EXACT>
__global__ void __launch_bounds__(kFwdThreads)
sinkhorn_fwd_kernel(const float* __restrict__ pred,  // (B, D, N)
                    const int* __restrict__ gt_idx,  // (B, N)
                    float* __restrict__ loss,        // (B, N)
                    int B, int N, int D, int iters, float eps) {
  if (EXACT) D = MAXD;  // a constant: every bin guard folds away
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)B * N) return;
  const int64_t b = i / N;
  const float* P = pred + b * D * (int64_t)N + (i - b * N);
  float sc[MAXD], log_nu[MAXD], log_mu[MAXD], u[MAXD], v[MAXD];
  scaled_row<MAXD>(eps, D, sc);
  marginals<MAXD>(P, N, gt_idx[i], D, log_nu, log_mu);
  bins<MAXD>(D, [&](int k) { u[k] = v[k] = 0.f; });
  for (int t = 0; t < iters; ++t) iterate<MAXD>(sc, log_mu, log_nu, D, u, v);
  float total = 0.f;
  bins<MAXD>(D, [&](int r) {
    bins<MAXD>(D, [&](int c) {
      const float s = S(sc, r, c);
      total += expf((s + u[r]) + v[c]) * (s * eps);
    });
  });
  loss[i] = total;
}

template <int MAXD, bool EXACT>
__global__ void sinkhorn_bwd_kernel(const float* __restrict__ pred,  // (B, D, N)
                                    const int* __restrict__ gt_idx,  // (B, N)
                                    const float* __restrict__ g,     // (B, N)
                                    float* __restrict__ dpred,       // (B, D, N)
                                    int B, int N, int D, int iters,
                                    float eps) {
  if (EXACT) D = MAXD;
  extern __shared__ float hist[];  // (iters, 2, D, blockDim.x): u_t, v_t
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int64_t i = (int64_t)blockIdx.x * nt + tid;
  if (i >= (int64_t)B * N) return;
  const int64_t b = i / N;
  const int64_t off = b * D * (int64_t)N + (i - b * N);
  const float* P = pred + off;
  float sc[MAXD], log_nu[MAXD], log_mu[MAXD], u[MAXD], v[MAXD];
  scaled_row<MAXD>(eps, D, sc);
  marginals<MAXD>(P, N, gt_idx[i], D, log_nu, log_mu);
  bins<MAXD>(D, [&](int k) { u[k] = v[k] = 0.f; });
  // hist[((t * 2 + which) * D + k) * nt + tid], which 0 = u, 1 = v
  for (int t = 0; t < iters; ++t) {
    iterate<MAXD>(sc, log_mu, log_nu, D, u, v);
    float* h = hist + (int64_t)t * 2 * D * nt + tid;
    bins<MAXD>(D, [&](int k) {
      h[k * nt] = u[k];
      h[(D + k) * nt] = v[k];
    });
  }

  // the loss sum_ij T_ij C_ij, T = exp(S + u + v), gives du_i = g sum_j
  // T_ij C_ij and dv_j = g sum_i T_ij C_ij
  const float gi = g[i];
  float du[MAXD], dv[MAXD], dlog_nu[MAXD];
  bins<MAXD>(D, [&](int k) { du[k] = dv[k] = dlog_nu[k] = 0.f; });
  bins<MAXD>(D, [&](int r) {
    bins<MAXD>(D, [&](int c) {
      const float s = S(sc, r, c);
      const float tc = expf((s + u[r]) + v[c]) * (s * eps);
      du[r] += tc;
      dv[c] += tc;
    });
  });
  bins<MAXD>(D, [&](int k) {
    du[k] *= gi;
    dv[k] *= gi;
  });

  // reverse sweep, t = iters - 1 .. 0; du, dv hold the cotangents of u_t, v_t
  for (int t = iters - 1; t >= 0; --t) {
    const float* h = hist + (int64_t)t * 2 * D * nt + tid;
    float vt[MAXD], row[MAXD], acc[MAXD], dvt[MAXD];
    bins<MAXD>(D, [&](int k) {
      vt[k] = h[(D + k) * nt];
      acc[k] = 0.f;
      dlog_nu[k] += du[k];
    });
    // u_t = log_nu - LSE_j(S_ij + v_t_j): dv_t_j -= sum_i du_i P_ij, with
    // P = softmax over j of S_ij + v_t_j
    bins<MAXD>(D, [&](int r) {
      float m = S(sc, r, 0) + vt[0];
      bins<MAXD>(D, [&](int c) {
        if (c > 0) m = fmaxf(m, S(sc, r, c) + vt[c]);
      });
      float s = 0.f;
      bins<MAXD>(D, [&](int c) {
        row[c] = expf((S(sc, r, c) + vt[c]) - m);
        s += row[c];
      });
      bins<MAXD>(D, [&](int c) { acc[c] += du[r] * (row[c] / s); });
    });
    bins<MAXD>(D, [&](int c) { dvt[c] = dv[c] - acc[c]; });
    if (t == 0) break;  // u_{-1} = 0 is a constant: nothing flows further
    // v_t = log_mu - LSE_i(S_ij + u_{t-1}_i): du_{t-1}_i = -sum_j dv_t_j
    // Q_ij, with Q = softmax over i of S_ij + u_{t-1}_i
    const float* hp = h - 2 * D * nt;
    float up[MAXD];
    bins<MAXD>(D, [&](int k) {
      up[k] = hp[k * nt];
      du[k] = 0.f;
      dv[k] = 0.f;
    });
    bins<MAXD>(D, [&](int c) {
      float m = S(sc, 0, c) + up[0];
      bins<MAXD>(D, [&](int r) {
        if (r > 0) m = fmaxf(m, S(sc, r, c) + up[r]);
      });
      float s = 0.f;
      bins<MAXD>(D, [&](int r) {
        row[r] = expf((S(sc, r, c) + up[r]) - m);
        s += row[r];
      });
      bins<MAXD>(D, [&](int r) { du[r] += dvt[c] * (row[r] / s); });
    });
    bins<MAXD>(D, [&](int k) { du[k] = -du[k]; });
  }
  bins<MAXD>(D, [&](int k) {
    dpred[off + k * (int64_t)N] = dlog_nu[k] / (P[k * (int64_t)N] + 1e-12f);
  });
}

unsigned blocks_for(int B, int N, int threads) {
  const int64_t n = (int64_t)B * N;
  return (unsigned)((n + threads - 1) / threads);
}

template <int MAXD, bool EXACT>
int launch_fwd(const float* pred, const int* gt, float* loss, int B, int N,
               int D, int iters, float eps, cudaStream_t st) {
  sinkhorn_fwd_kernel<MAXD, EXACT><<<blocks_for(B, N, kFwdThreads), kFwdThreads, 0, st>>>(
      pred, gt, loss, B, N, D, iters, eps);
  return (int)cudaGetLastError();
}

template <int MAXD, bool EXACT>
int launch_bwd(const float* pred, const int* gt, const float* g, float* dpred,
               int B, int N, int D, int iters, float eps, int threads, int smem,
               cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sinkhorn_bwd_kernel<MAXD, EXACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  sinkhorn_bwd_kernel<MAXD, EXACT><<<blocks_for(B, N, threads), threads, smem, st>>>(
      pred, gt, g, dpred, B, N, D, iters, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Each returns the cudaError_t of
// its launch (0 on success; cudaErrorInvalidValue for a capacity that is
// not instantiated or a D outside [1, capacity]).  The Python wrappers check
// device, dtype, shapes and contiguity, pick the capacity
// (kernels/sinkhorn_ot.capacity) and size K5's block and shared memory.
// D = 4 and D = 8 (dtu_default's counts) run instances with D a constant.
#define MVSTER_DISPATCH_MAXD(CALL)                                   \
  if (D < 1 || D > maxd) return (int)cudaErrorInvalidValue;          \
  switch (maxd) {                                                    \
    case 4: return D == 4 ? CALL(4, true) : CALL(4, false);          \
    case 8: return D == 8 ? CALL(8, true) : CALL(8, false);          \
    case 16: return CALL(16, false);                                 \
    case 32: return CALL(32, false);                                 \
    case 64: return CALL(64, false);                                 \
    default: return (int)cudaErrorInvalidValue;                      \
  }

extern "C" int mvster_sinkhorn_fwd(const void* pred, const void* gt_idx,
                                   void* loss, int B, int N, int D, int iters,
                                   float eps, int maxd, void* stream) {
  auto p = static_cast<const float*>(pred);
  auto gt = static_cast<const int*>(gt_idx);
  auto out = static_cast<float*>(loss);
  auto st = static_cast<cudaStream_t>(stream);
#define MVSTER_FWD(M, E) launch_fwd<M, E>(p, gt, out, B, N, D, iters, eps, st)
  MVSTER_DISPATCH_MAXD(MVSTER_FWD)
#undef MVSTER_FWD
}

extern "C" int mvster_sinkhorn_bwd(const void* pred, const void* gt_idx,
                                   const void* g, void* dpred, int B, int N,
                                   int D, int iters, float eps, int threads,
                                   int smem_bytes, int maxd, void* stream) {
  auto p = static_cast<const float*>(pred);
  auto gt = static_cast<const int*>(gt_idx);
  auto cot = static_cast<const float*>(g);
  auto out = static_cast<float*>(dpred);
  auto st = static_cast<cudaStream_t>(stream);
#define MVSTER_BWD(M, E) \
  launch_bwd<M, E>(p, gt, cot, out, B, N, D, iters, eps, threads, smem_bytes, st)
  MVSTER_DISPATCH_MAXD(MVSTER_BWD)
#undef MVSTER_BWD
}

#undef MVSTER_DISPATCH_MAXD
