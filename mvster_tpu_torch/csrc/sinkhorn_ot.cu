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
// --use_fast_math).  The GT bin index (argmin over D of |hypo - gt|, first
// minimum) comes from the wrapper, as the JAX package computes it outside
// its kernel too.
//
// What bounds them on the H100: operations, not bytes.  K4 reads D + 1
// words a pixel and does iters * (2 D^2 exp + 2 D log) + D^2 exp; K5 about
// twice that.  An accurate expf is ~7 float32-pipe instructions and one
// MUFU, a logf ~15, so the float32 pipe (128 a clock per SM) sets the
// bound, and every exp and log is a chain of dependent instructions.
//
// Two designs; kernels/sinkhorn_ot.plan_launch picks one per launch.
//
// "lanes", D lanes a pixel (every D <= 32 unless the rule below says
// otherwise).  A pixel gets L threads, L the smallest power of two >= D,
// and lane k owns bin k: u_k, v_k, log nu_k, log mu_k and the row S_k (S is
// symmetric, so that row is also its column).  Lanes k >= D hold no bin.
// It replaces, where it is faster, the first design, in which one thread
// walked a pixel's D^2 exps of an iteration in series: at the D = 8 stages
// that left a third of the card idle (80 blocks at 64x80) and every SM a
// few warps to hide the MUFU and FMA latencies of those chains, and K5's
// history of 2 iters D floats a thread capped an SM at ~10 warps.  With
// lanes those stages get 8x the threads, each chain is D times shorter,
// and K5's history is 2 iters floats a lane.  A pixel's L lanes are
// contiguous in the warp (shuffles of width L, 32 / L pixels a warp), so
// lane k indexes its pixel's lanes and its transpose tile by k alone; a
// pixel-fastest order would read each bin's row of pred in runs of 32 / L
// floats, the same sectors.  The grid is (pixel blocks, B).
//
// "thread", one thread a pixel (the first design, kept as it was): D in
// 33..64, and where the pixels fill the card (B * N >= 132 x 1024; K4 at
// D = 5 from 40,960) at 3 <= D <= 8 for K4 and 3 <= D <= 5 for K5, as
// measured (kernels/sinkhorn_ot.THREAD_FROM).  There it already keeps the
// SMs issuing every cycle (D independent chains a thread), and lanes only
// add their exchange: 9% more instructions a pixel at D = 4 (SASS), and
// idle lanes where D is no power of two.  Measured in turns on one card
// (scripts/torch_sinkhorn_ab.py, PERF.md): lanes 10-12% slower at D = 4
// from 163,840 pixels on, 1.3-2.5x faster below 41,000.  K5's history
// caps the thread design's occupancy from D = 6 on, so there lanes win at
// every size.
//
// With lanes the order of every sum is the first design's:
//   v_k: lane k gathers u_0 .. u_{D-1} (D shuffles) and takes the max over
//        i, then s = sum_i expf((S_ik + u_i) - m) in i order; u_k the same
//        from v.
//   K4:  lane r sums its row sum_c exp(S_rc + u_r + v_c) cost_rc in c
//        order; the D row sums add up in r order (shuffles, on every lane;
//        lane 0 stores).  That order differs from the first design's flat
//        (r, c) sum: K4 agrees with plain within its tolerance, not bitwise.
//   K5:  a sum over a column of a D x D matrix (the plan's dv, the row
//        softmax P's sum_r du_r P_rc) goes through a per-pixel tile in
//        shared memory: the lane of row r writes its D entries, __syncwarp
//        (a pixel's lanes are in one warp), the lane of column c adds them
//        in r order.  The column softmax Q is the mirror.  The tile's rows
//        are L + 1 floats apart, so neither its row nor its column accesses
//        fall twice in one bank.
// So K5 equals the first design's bitwise where nvcc fuses the same
// multiply-adds (it does at every D when both are built with -fmad=false);
// built as the library is, they differ by ~1e-9 at D = 4 and 8.
// K5 keeps (u_t, v_t) of every iteration for its reverse sweep in dynamic
// shared memory, (iters, 2, threads) with the thread fastest, then the
// tiles: 4 (2 iters + L + 1) bytes a thread, 29 KB for 256 threads at D = 8
// and 10 iterations.  The planner sizes the block: the largest of 256,
// 128, 64, 32 threads within 48 KB, else 32 threads with the kernel's
// limit raised.
//
// In both designs the per-bin arrays have a template capacity (lanes: L;
// thread: 4, 8 or 64) and every loop over bins is unrolled over it with
// each step under k < D, so up to 32 they are indexed by constants and
// stay in registers; the thread design's capacity 64 is a plain loop, its
// arrays in local memory.  D = 4 and D = 8, the counts of dtu_default, run
// instances in which D is the constant capacity, so the guards fold away.
// With lanes no thread returns early: a tail pixel's lanes, and lanes
// k >= D, reach every full-mask __shfl_sync and __syncwarp with their
// loads and stores masked.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // lanes: K4's block; K5's largest
constexpr int kThreadFwd = 128;  // thread: K4's block
constexpr unsigned kFull = 0xffffffffu;
// math.log(1.0 + 1e-12) and math.log(1e-12), rounded to float32 as the
// JAX package's kernel and the plain version round them
constexpr float kLogOne = (float)1.000088900581841e-12;
constexpr float kLogEps = (float)-27.631021115928547;

// Calls f(k) for k = 0 .. D - 1, in order.  Up to 32 bins the loop is
// unrolled over the capacity, each call under k < D, so arrays of MAXD
// floats are indexed by constants and stay in registers (at D = MAXD these
// are the operations of a kernel instantiated on D); above that it is a
// plain loop and those arrays live in local memory.
template <int MAXD, class F>
__device__ __forceinline__ void bins(int D, F&& f) {
  if constexpr (MAXD <= 32) {
#pragma unroll
    for (int k = 0; k < MAXD; ++k) {
      if (k < D) f(k);
    }
  } else {
    for (int k = 0; k < D; ++k) f(k);
  }
}

// ---- lanes: L threads a pixel, lane k owns bin k (D <= L <= 32) ----

// x[i] = the value of lane i of this pixel, i < D
template <int L>
__device__ __forceinline__ void gather(float val, int D, float* x) {
  bins<L>(D, [&](int i) { x[i] = __shfl_sync(kFull, val, i, L); });
}

// log_m - LSE_i(srow[i] + x[i]), the first design's order
template <int L>
__device__ __forceinline__ float lse_update(const float* srow, const float* x,
                                            int D, float log_m) {
  float m = srow[0] + x[0];
  bins<L>(D, [&](int i) {
    if (i > 0) m = fmaxf(m, srow[i] + x[i]);
  });
  float s = 0.f;
  bins<L>(D, [&](int i) { s += expf((srow[i] + x[i]) - m); });
  return log_m - (logf(s) + m);
}

// One lane's view of a pixel: its bin k, the row S_k (= the column S_.k),
// its marginals and the offsets of its loads and stores.  The grid is
// (pixel blocks, B), so the batch index needs no division.
template <int L>
struct Lane {
  int k;
  int64_t i;     // the pixel, b * N + n
  bool pixel;    // n < N
  bool bin;      // pixel and k < D
  int64_t off;   // pred[b, k, n]
  float p;       // pred there (1 where the lane holds no bin)
  float log_nu, log_mu;
  float srow[L];  // srow[j] = S_kj = S_jk

  __device__ __forceinline__ Lane(const float* pred, const int* gt_idx, int N,
                                  int D, float eps) {
    k = threadIdx.x & (L - 1);
    const int n = blockIdx.x * (blockDim.x / L) + threadIdx.x / L;
    const int64_t b = blockIdx.y;
    i = b * N + n;
    pixel = n < N;
    bin = pixel && k < D;
    off = (b * D + k) * N + n;
    p = bin ? pred[off] : 1.f;
    log_nu = logf(p + 1e-12f);
    log_mu = pixel && k == gt_idx[i] ? kLogOne : kLogEps;
    // S_kj = sc[|k - j|] with sc[d] = d / eps, lane d's one division
    const float sc = (float)k / eps;
    bins<L>(D, [&](int j) { srow[j] = __shfl_sync(kFull, sc, j > k ? j - k : k - j, L); });
  }

  // one Sinkhorn iteration: v from u, then u from v; x is scratch
  __device__ __forceinline__ void iterate(int D, float& u, float& v, float* x) const {
    gather<L>(u, D, x);
    v = lse_update<L>(srow, x, D, log_mu);
    gather<L>(v, D, x);
    u = lse_update<L>(srow, x, D, log_nu);
  }
};

template <int L, bool EXACT>
__global__ void __launch_bounds__(kThreads)
sinkhorn_fwd_lanes(const float* __restrict__ pred,  // (B, D, N)
                   const int* __restrict__ gt_idx,  // (B, N)
                   float* __restrict__ loss,        // (B, N)
                   int B, int N, int D, int iters, float eps) {
  if (EXACT) D = L;  // a constant: every bin guard folds away
  const Lane<L> ln(pred, gt_idx, N, D, eps);
  float x[L];
  float u = 0.f, v = 0.f;
  for (int t = 0; t < iters; ++t) ln.iterate(D, u, v, x);
  gather<L>(v, D, x);
  float row = 0.f;  // row k of the transport cost, in c order
  bins<L>(D, [&](int c) { row += expf((ln.srow[c] + u) + x[c]) * (ln.srow[c] * eps); });
  float total = 0.f;  // the row sums in r order
  bins<L>(D, [&](int r) { total += __shfl_sync(kFull, row, r, L); });
  if (ln.pixel && ln.k == 0) loss[ln.i] = total;
}

template <int L, bool EXACT>
__global__ void __launch_bounds__(kThreads)
sinkhorn_bwd_lanes(const float* __restrict__ pred,  // (B, D, N)
                   const int* __restrict__ gt_idx,  // (B, N)
                   const float* __restrict__ g,     // (B, N)
                   float* __restrict__ dpred,       // (B, D, N)
                   int B, int N, int D, int iters, float eps) {
  if (EXACT) D = L;
  constexpr int kRow = L + 1;  // the tile's row stride
  extern __shared__ float smem[];
  const int nt = blockDim.x, tid = threadIdx.x;
  float* hist = smem;  // hist[(2 t + which) * nt + tid], which 0 = u_t, 1 = v_t
  float* tile = smem + (int64_t)2 * iters * nt + (tid / L) * (L * kRow);
  const Lane<L> ln(pred, gt_idx, N, D, eps);
  const int k = ln.k;
  float x[L], row[L];
  float u = 0.f, v = 0.f;
  for (int t = 0; t < iters; ++t) {
    ln.iterate(D, u, v, x);
    hist[2 * t * nt + tid] = u;
    hist[(2 * t + 1) * nt + tid] = v;
  }

  // the loss sum_rc T_rc C_rc, T = exp(S + u + v), gives du_r = g sum_c
  // T_rc C_rc and dv_c = g sum_r T_rc C_rc
  const float gi = ln.pixel ? g[ln.i] : 0.f;
  gather<L>(v, D, x);
  float du = 0.f;
  bins<L>(D, [&](int c) {
    const float tc = expf((ln.srow[c] + u) + x[c]) * (ln.srow[c] * eps);
    du += tc;
    tile[k * kRow + c] = tc;
  });
  __syncwarp();
  float dv = 0.f;
  bins<L>(D, [&](int r) { dv += tile[r * kRow + k]; });
  du *= gi;
  dv *= gi;

  // reverse sweep, t = iters - 1 .. 0; du, dv hold the cotangents of u_t, v_t
  float dlog_nu = 0.f;
  for (int t = iters - 1; t >= 0; --t) {
    dlog_nu += du;
    // u_t = log_nu - LSE_j(S_ij + v_t_j): dv_t_c -= sum_r du_r P_rc, with
    // P = softmax over c of S_rc + v_t_c; this lane's row r = k
    gather<L>(hist[(2 * t + 1) * nt + tid], D, x);
    float m = ln.srow[0] + x[0];
    bins<L>(D, [&](int c) {
      if (c > 0) m = fmaxf(m, ln.srow[c] + x[c]);
    });
    float s = 0.f;
    bins<L>(D, [&](int c) {
      row[c] = expf((ln.srow[c] + x[c]) - m);
      s += row[c];
    });
    __syncwarp();  // the tile's last reads are done
    bins<L>(D, [&](int c) { tile[k * kRow + c] = row[c] / s; });
    __syncwarp();
    float acc = 0.f;  // this lane's column c = k, in r order
    bins<L>(D, [&](int r) { acc += __shfl_sync(kFull, du, r, L) * tile[r * kRow + k]; });
    const float dvt = dv - acc;
    if (t == 0) break;  // u_{-1} = 0 is a constant: nothing flows further
    // v_t = log_mu - LSE_i(S_ij + u_{t-1}_i): du_{t-1}_r = -sum_c dv_t_c
    // Q_rc, with Q = softmax over r of S_rc + u_{t-1}_r; this lane's column
    // c = k
    gather<L>(hist[2 * (t - 1) * nt + tid], D, x);
    m = ln.srow[0] + x[0];
    bins<L>(D, [&](int r) {
      if (r > 0) m = fmaxf(m, ln.srow[r] + x[r]);
    });
    s = 0.f;
    bins<L>(D, [&](int r) {
      row[r] = expf((ln.srow[r] + x[r]) - m);
      s += row[r];
    });
    __syncwarp();
    bins<L>(D, [&](int r) { tile[r * kRow + k] = row[r] / s; });
    __syncwarp();
    acc = 0.f;  // this lane's row r = k, in c order
    bins<L>(D, [&](int c) { acc += __shfl_sync(kFull, dvt, c, L) * tile[k * kRow + c]; });
    du = -acc;
    dv = 0.f;
  }
  if (ln.bin) dpred[ln.off] = dlog_nu / (ln.p + 1e-12f);
}

// ---- thread: one thread a pixel (the first design) ----

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
__global__ void __launch_bounds__(kThreadFwd)
sinkhorn_fwd_thread(const float* __restrict__ pred, const int* __restrict__ gt_idx,
                    float* __restrict__ loss, int B, int N, int D, int iters,
                    float eps) {
  if (EXACT) D = MAXD;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)B * N) return;  // no shuffles or barriers below
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
__global__ void sinkhorn_bwd_thread(const float* __restrict__ pred,
                                    const int* __restrict__ gt_idx,
                                    const float* __restrict__ g,
                                    float* __restrict__ dpred, int B, int N,
                                    int D, int iters, float eps) {
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

  for (int t = iters - 1; t >= 0; --t) {
    const float* h = hist + (int64_t)t * 2 * D * nt + tid;
    float vt[MAXD], row[MAXD], acc[MAXD], dvt[MAXD];
    bins<MAXD>(D, [&](int k) {
      vt[k] = h[(D + k) * nt];
      acc[k] = 0.f;
      dlog_nu[k] += du[k];
    });
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
    if (t == 0) break;
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

unsigned blocks_for(int B, int N, int pixels_per_block) {
  const int64_t n = (int64_t)B * N;
  return (unsigned)((n + pixels_per_block - 1) / pixels_per_block);
}

// lanes: a row of pixel blocks for each batch element
dim3 lane_grid(int B, int N, int pixels_per_block) {
  return dim3((unsigned)((N + pixels_per_block - 1) / pixels_per_block), (unsigned)B);
}

template <class K, class... A>
int launch(K kernel, dim3 blocks, int threads, int smem, cudaStream_t st, A... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<blocks, threads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Each returns the cudaError_t of
// its launch (0 on success; cudaErrorInvalidValue for a design, capacity or
// block it does not take).  The Python wrappers check device, dtype, shapes
// and contiguity, and kernels/sinkhorn_ot.plan_launch picks the design
// (0 lanes, 1 thread), the capacity (lanes: L in 1, 2, 4, 8, 16, 32;
// thread: 4, 8, 64), the block and K5's shared memory.  D = 4 and D = 8
// (dtu_default's counts) run instances with D a constant in both designs.
#define MVSTER_DISPATCH(LANES, THREAD)                                      \
  if (D < 1 || D > maxd || threads % 32 || threads < 32 || threads > kThreads) \
    return (int)cudaErrorInvalidValue;                                      \
  if (design == 0 && B <= 65535) {                                          \
    switch (maxd) {                                                         \
      case 1: return LANES(1, false);                                       \
      case 2: return LANES(2, false);                                       \
      case 4: return D == 4 ? LANES(4, true) : LANES(4, false);             \
      case 8: return D == 8 ? LANES(8, true) : LANES(8, false);             \
      case 16: return LANES(16, false);                                     \
      case 32: return LANES(32, false);                                     \
    }                                                                       \
  } else if (design == 1) {                                                 \
    switch (maxd) {                                                         \
      case 4: return D == 4 ? THREAD(4, true) : THREAD(4, false);           \
      case 8: return D == 8 ? THREAD(8, true) : THREAD(8, false);           \
      case 64: return THREAD(64, false);                                    \
    }                                                                       \
  }                                                                         \
  return (int)cudaErrorInvalidValue;

extern "C" int mvster_sinkhorn_fwd(const void* pred, const void* gt_idx,
                                   void* loss, int B, int N, int D, int iters,
                                   float eps, int design, int maxd, int threads,
                                   void* stream) {
  auto p = static_cast<const float*>(pred);
  auto gt = static_cast<const int*>(gt_idx);
  auto out = static_cast<float*>(loss);
  auto st = static_cast<cudaStream_t>(stream);
#define MVSTER_FWD_LANES(M, E)                                                    \
  launch(sinkhorn_fwd_lanes<M, E>, lane_grid(B, N, threads / M), threads, 0, st, p, \
         gt, out, B, N, D, iters, eps)
#define MVSTER_FWD_THREAD(M, E)                                                   \
  launch(sinkhorn_fwd_thread<M, E>, dim3(blocks_for(B, N, threads)), threads, 0, st, \
         p, gt, out, B, N, D, iters, eps)
  MVSTER_DISPATCH(MVSTER_FWD_LANES, MVSTER_FWD_THREAD)
#undef MVSTER_FWD_LANES
#undef MVSTER_FWD_THREAD
}

extern "C" int mvster_sinkhorn_bwd(const void* pred, const void* gt_idx,
                                   const void* g, void* dpred, int B, int N,
                                   int D, int iters, float eps, int design,
                                   int maxd, int threads, int smem_bytes,
                                   void* stream) {
  auto p = static_cast<const float*>(pred);
  auto gt = static_cast<const int*>(gt_idx);
  auto cot = static_cast<const float*>(g);
  auto out = static_cast<float*>(dpred);
  auto st = static_cast<cudaStream_t>(stream);
#define MVSTER_BWD_LANES(M, E)                                                 \
  launch(sinkhorn_bwd_lanes<M, E>, lane_grid(B, N, threads / M), threads,     \
         smem_bytes, st, p, gt, cot, out, B, N, D, iters, eps)
#define MVSTER_BWD_THREAD(M, E)                                                \
  launch(sinkhorn_bwd_thread<M, E>, dim3(blocks_for(B, N, threads)), threads, \
         smem_bytes, st, p, gt, cot, out, B, N, D, iters, eps)
  MVSTER_DISPATCH(MVSTER_BWD_LANES, MVSTER_BWD_THREAD)
#undef MVSTER_BWD_LANES
#undef MVSTER_BWD_THREAD
}

#undef MVSTER_DISPATCH
