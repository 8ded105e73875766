// Hand-written Hopper (sm_90a) kernels for the OnAlgo hot loop.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/onalgo_step.py:
//   onalgo_duals_kernel           <- onalgo_duals_pallas   (_onalgo_kernel)
//   onalgo_chunked_kernel         <- onalgo_chunked_pallas (_onalgo_chunked_kernel), scalar mu
//   onalgo_tiled_phase1/phase2    <- onalgo_tiled_pallas   (_onalgo_tiled_kernel), scalar mu
//   onalgo_chunked_topo_kernel    <- onalgo_chunked_pallas with assoc / H_k (K1-topo)
//   onalgo_tiled_topo_phase1/2/3  <- onalgo_tiled_pallas with assoc / H_k   (K2-topo)
//
// What bounds them on the card: bytes.  Per slot every device row of the
// (N, M) visit counts and of the preconditioned power table o / B_n is
// read once and compared against the (M,) cycle and gain tables, a handful
// of f32 operations per element; an H100 does ~20 f32 operations per byte
// of HBM traffic before compute binds.  What the design does about it:
//   * one warp per device, lanes striding over its contiguous M-row, so
//     every row read is coalesced;
//   * the (M,) tables are taken with row stride 0 (no (N, M) broadcast)
//     and stay in L1/L2;
//   * only the one visited count of a row is written back per slot;
//   * K1 runs the whole horizon in ONE cooperative launch: each block owns
//     a fixed device range for all T slots, and the only per-slot traffic
//     besides the rows is the grid-wide mu reduction (one grid.sync());
//   * K2 needs no co-residency: two launches per slot, a tile pass and a
//     one-warp mu reduction.
// This first version re-reads counts and o from HBM every slot; keeping a
// block's rows in shared memory across slots is the next step.
//
// The topology forms (K cloudlets, mu a (K,) vector, device n priced by
// mu[assoc[n]]) add per slot a gather and a per-cloudlet reduction.  The
// TPU kernels do both through VMEM- and MXU-shaped layouts: a one-hot
// (N, K_pad) mask, or above K = 512 the binned (hi, lo) pair of
// dot_generals (the reference's topo_binned).  Here ONE kernel serves both
// layouts: mu is read with a direct gather (__ldcg of mu[assoc[n]] from
// L2), and each block reduces its devices' row loads into a dense row of
// K doubles in shared memory in device order (one thread, no atomics),
// writes it to a [G][K] partial array, and after a grid sync block b
// reduces its contiguous cloudlet range over the G partials in a fixed
// order (warp w sums blocks w, w + 16, ...; the 16 warp sums are added in
// warp order) and takes the mu_k ascent; a second sync publishes mu, and
// block 0 forms ||(lam, mu)||.  K2-topo runs the same steps as three
// launches per slot.  No float atomics anywhere: two runs give the same
// bits.  The cost the design adds grows with K: G * K doubles written and
// read per slot (17 MB at K = 4096 and 528 blocks, mostly L2-resident),
// and K doubles of shared memory per block (K <= ~28000).
//
// Summation order is part of the contract with the plain PyTorch versions
// (repro_torch/kernels/onalgo_step.py): a row sum over M is lane-strided
// (lane l adds columns l, l + 32, ... in order) then halved by
// __shfl_down_sync(16, 8, 4, 2, 1); sums over devices run in double and
// are rounded to f32 once.  Built with -fmad=false, so every a * b + c is
// two rounded operations, as in eager PyTorch.  Together these make the
// kernels' decisions and duals bit-identical to the plain versions.
//
// Plain C interface for ctypes: every entry point returns the CUDA error
// code of its launches (0 = success) and allocates nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / kWarp;
constexpr unsigned kFull = 0xffffffffu;

struct Tables {
  const float* o;
  long long os;  // row stride: M for an (N, M) table, 0 for a shared (M,) one
  const float* h;
  long long hs;
  const float* w;
  long long ws;
};

struct Rollout {
  const int* j;        // (T, N) state indices
  const float* svo;    // (T, N) overlay values or nullptr
  const float* svh;
  const float* svw;
  Tables tb;
  const float* B;      // (N,)
  const float* H;      // (1,)
  const float* a_seq;  // (T,) step sizes a / t^beta
  const float* inv_t;  // (T,) 1 / t in f32
  float* lam;          // (N,) in/out
  float* mu;           // (1,) in/out; (K,) in the topology forms
  float* counts;       // (N, M) in/out
  unsigned char* off;  // (T, N) bool
  float* mu_seq;       // (T,); (T, K) in the topology forms
  float* lnorm;        // (T,)
  double* partials;    // K1: [2][grid][2]; K2: [n_tiles][2]
  int T, N, M;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int d = kWarp / 2; d > 0; d >>= 1) v += __shfl_down_sync(kFull, v, d);
  return v;  // lane 0
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int d = kWarp / 2; d > 0; d >>= 1) v += __shfl_down_sync(kFull, v, d);
  return v;  // lane 0
}

// One device's slot (one warp): record the visit, form rho = counts / t,
// the full threshold policy y over M states under the device's price mu,
// and the rho-weighted row sums of o * y and h * y; lane 0 takes the
// realized decision under (lam_t, mu), the lam ascent, adds lam^2 to the
// warp's double accumulator and returns the device's load row sum(h * ry)
// (on lane 0).
__device__ __forceinline__ float device_slot(const Rollout& p, int s, int n,
                                             float mu, float a_t,
                                             float inv_t, double& acc_lam2) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long sn = (long long)s * p.N + n;
  const int j = p.j[sn];
  const float lam = p.lam[n];
  float* crow = p.counts + (long long)n * p.M;
  const float* orow = p.tb.o + n * p.tb.os;
  const float* hrow = p.tb.h + n * p.tb.hs;
  const float* wrow = p.tb.w + n * p.tb.ws;
  float so = 0.f, sh = 0.f;
  for (int m = lane; m < p.M; m += kWarp) {
    float c = crow[m];
    if (m == j) {
      c += 1.f;
      crow[m] = c;
    }
    const float rho = c * inv_t;
    const float o = orow[m], h = hrow[m], w = wrow[m];
    const float price = lam * o + mu * h;
    const float ry = (price < w && w > 0.f) ? rho : 0.f;
    so += o * ry;
    sh += h * ry;
  }
  so = warp_sum(so);
  sh = warp_sum(sh);
  if (lane == 0) {
    float o_now, h_now, w_now;
    bool task;
    if (p.svo != nullptr) {
      o_now = p.svo[sn];
      h_now = p.svh[sn];
      w_now = p.svw[sn];
      task = j > 0;
    } else {
      o_now = orow[j];
      h_now = hrow[j];
      w_now = wrow[j];
      task = true;
    }
    const float price_now = lam * o_now + mu * h_now;
    p.off[sn] = (price_now < w_now && w_now > 0.f && task) ? 1 : 0;
    const float lam_new = fmaxf(lam + a_t * (so - p.B[n]), 0.f);
    p.lam[n] = lam_new;
    acc_lam2 += (double)(lam_new * lam_new);
  }
  return sh;
}

// Sum the block's per-warp accumulators (warp order) into out[0..1].
__device__ __forceinline__ void block_partial(double acc_load, double acc_lam2,
                                              double* out) {
  __shared__ double s_acc[kWarps][2];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x & (kWarp - 1);
  if (lane == 0) {
    s_acc[warp][0] = acc_load;
    s_acc[warp][1] = acc_lam2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double l = 0.0, q = 0.0;
    for (int i = 0; i < kWarps; ++i) {
      l += s_acc[i][0];
      q += s_acc[i][1];
    }
    __stcg(out, l);
    __stcg(out + 1, q);
  }
  __syncthreads();
}

// One warp: reduce n partial pairs in a fixed order (lane-strided, then
// halved) and take the mu ascent.  Returns mu_{t+1} on lane 0 and writes
// the series entries when `write` is set.
__device__ __forceinline__ float mu_step(const double* part, int n, float mu,
                                         float a_t, float H, float* mu_seq,
                                         float* lnorm, bool write) {
  const int lane = threadIdx.x & (kWarp - 1);
  double l = 0.0, q = 0.0;
  for (int i = lane; i < n; i += kWarp) {
    l += __ldcg(part + 2 * i);
    q += __ldcg(part + 2 * i + 1);
  }
  l = warp_sum(l);
  q = warp_sum(q);
  const float mu_new = fmaxf(mu + a_t * ((float)l - H), 0.f);
  if (write && lane == 0) {
    *mu_seq = mu_new;
    *lnorm = sqrtf((float)q + mu_new * mu_new);
  }
  return mu_new;
}

// K1: the whole horizon in one cooperative launch.  Block b owns devices
// [b * per, (b + 1) * per) for all T slots; per slot, every block writes
// its (load, lam^2) partial to partials[s & 1][b], the grid syncs, and
// every block reduces all partials in the same order, so mu_{t+1} is
// identical in every block without a second sync.  Double-buffering by
// slot parity makes one grid.sync() per slot enough.
__global__ void __launch_bounds__(kThreads)
    onalgo_chunked_kernel(Rollout p) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float s_mu;
  const int warp = threadIdx.x / kWarp;
  const int G = gridDim.x;
  const int per = (p.N + G - 1) / G;
  const int n0 = blockIdx.x * per;
  const int n1 = min(p.N, n0 + per);
  const float H = p.H[0];
  float mu = p.mu[0];
  for (int s = 0; s < p.T; ++s) {
    const float a_t = p.a_seq[s], inv_t = p.inv_t[s];
    double acc_load = 0.0, acc_lam2 = 0.0;
    for (int n = n0 + warp; n < n1; n += kWarps) {
      const float sh = device_slot(p, s, n, mu, a_t, inv_t, acc_lam2);
      if ((threadIdx.x & (kWarp - 1)) == 0) acc_load += (double)sh;
    }
    double* part = p.partials + (long long)(s & 1) * G * 2;
    block_partial(acc_load, acc_lam2, part + 2 * blockIdx.x);
    grid.sync();
    if (warp == 0) {
      const float mu_new = mu_step(part, G, mu, a_t, H, p.mu_seq + s,
                                   p.lnorm + s, blockIdx.x == 0);
      if (threadIdx.x == 0) s_mu = mu_new;
    }
    __syncthreads();
    // s_mu is next written after the next slot's block_partial barriers,
    // which every thread reaches only after this read.
    mu = s_mu;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) p.mu[0] = mu;
}

// K2 phase 1: tile blockIdx.x of block_n devices, one slot.
__global__ void __launch_bounds__(kThreads)
    onalgo_tiled_phase1(Rollout p, int s, int block_n) {
  const int warp = threadIdx.x / kWarp;
  const int n0 = blockIdx.x * block_n;
  const int n1 = min(p.N, n0 + block_n);
  const float mu = p.mu[0];
  double acc_load = 0.0, acc_lam2 = 0.0;
  for (int n = n0 + warp; n < n1; n += kWarps) {
    const float sh = device_slot(p, s, n, mu, p.a_seq[s], p.inv_t[s],
                                 acc_lam2);
    if ((threadIdx.x & (kWarp - 1)) == 0) acc_load += (double)sh;
  }
  block_partial(acc_load, acc_lam2, p.partials + 2 * blockIdx.x);
}

// K2 phase 2: one warp reduces the tile partials in tile order into mu.
__global__ void onalgo_tiled_phase2(Rollout p, int s, int n_tiles) {
  const float mu_new = mu_step(p.partials, n_tiles, p.mu[0], p.a_seq[s],
                               p.H[0], p.mu_seq + s, p.lnorm + s, true);
  if (threadIdx.x == 0) p.mu[0] = mu_new;
}

// ---------------------------------------------------------------------------
// Topology forms (K1-topo, K2-topo).

struct Topo {
  const int* assoc;    // (N,) static or (T, N) cloudlet ids in [0, K)
  long long a_ts;      // assoc's slot stride: 0 static, N time-varying
  const float* H_k;    // (K,) capacities (dual space)
  float* rowload;      // (N,) scratch: each device's load row this slot
  double* kpart;       // [G][K] per-block per-cloudlet load partials
  double* lam2p;       // per-block lam^2 partials (K1: [2][G] by parity)
  double* mu2p;        // per-block mu_k^2 partials (K1: [2][G] by parity)
  int K;
};

// Sum one double per warp (lane 0's) in warp order; thread 0 stores it.
__device__ __forceinline__ void block_sum_store(double v, double* out) {
  __shared__ double s_w[kWarps];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x & (kWarp - 1);
  if (lane == 0) s_w[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;
    for (int i = 0; i < kWarps; ++i) t += s_w[i];
    __stcg(out, t);
  }
  __syncthreads();
}

// Phase A of a topology slot over devices [n0, n1): each warp's devices
// priced by their cloudlet's dual; the row loads are summed into a dense
// shared row of K doubles in device order by one thread and written to
// kpart_row; the block's lam^2 goes to *lam2_out.
__device__ __forceinline__ void topo_devices(const Rollout& p, const Topo& q,
                                             int s, int n0, int n1,
                                             double* kpart_row,
                                             double* lam2_out) {
  extern __shared__ double s_acc[];  // K doubles
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x & (kWarp - 1);
  const int* a_row = q.assoc + s * q.a_ts;
  const float a_t = p.a_seq[s], inv_t = p.inv_t[s];
  for (int k = threadIdx.x; k < q.K; k += kThreads) s_acc[k] = 0.0;
  double acc_lam2 = 0.0;
  for (int n = n0 + warp; n < n1; n += kWarps) {
    const float mu_n = __ldcg(p.mu + a_row[n]);
    const float sh = device_slot(p, s, n, mu_n, a_t, inv_t, acc_lam2);
    if (lane == 0) q.rowload[n] = sh;
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int n = n0; n < n1; ++n) s_acc[a_row[n]] += (double)q.rowload[n];
  __syncthreads();
  for (int k = threadIdx.x; k < q.K; k += kThreads) __stcg(kpart_row + k,
                                                         s_acc[k]);
  block_sum_store(acc_lam2, lam2_out);
}

// Phase B for cloudlets [k0, k1): load_k = the G partials of cloudlet k
// summed in a fixed order (warp w adds blocks w, w + 16, ... in turn; the
// 16 warp sums are added in warp order), then the mu_k ascent, mu_seq,
// and the block's sum of mu_k^2 (k ascending) stored to *mu2_out.
__device__ __forceinline__ void topo_cloudlets(const Rollout& p,
                                               const Topo& q, int s, int G,
                                               int k0, int k1,
                                               double* mu2_out) {
  __shared__ double s_red[kWarps][kWarp];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x & (kWarp - 1);
  const float a_t = p.a_seq[s];
  double mu2 = 0.0;
  for (int kb = k0; kb < k1; kb += kWarp) {
    const int k = kb + lane;
    double l = 0.0;
    if (k < k1)
      for (int g = warp; g < G; g += kWarps)
        l += __ldcg(q.kpart + (long long)g * q.K + k);
    s_red[warp][lane] = l;
    __syncthreads();
    if (warp == 0) {
      double load = 0.0;
      for (int w = 0; w < kWarps; ++w) load += s_red[w][lane];
      double v = 0.0;
      if (k < k1) {
        const float mu_new =
            fmaxf(__ldcg(p.mu + k) + a_t * ((float)load - q.H_k[k]), 0.f);
        __stcg(p.mu + k, mu_new);
        p.mu_seq[(long long)s * q.K + k] = mu_new;
        v = (double)(mu_new * mu_new);
      }
      v = warp_sum(v);
      if (lane == 0) mu2 += v;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) __stcg(mu2_out, mu2);
}

// ||(lam, mu)|| from n_lam lam^2 and n_mu mu_k^2 partials (one warp, fixed
// order: lane-strided, then halved), each sum rounded to f32 once.
__device__ __forceinline__ void topo_lnorm(const double* lam2, int n_lam,
                                           const double* mu2, int n_mu,
                                           float* out) {
  const int lane = threadIdx.x & (kWarp - 1);
  double q = 0.0, m = 0.0;
  for (int i = lane; i < n_lam; i += kWarp) q += __ldcg(lam2 + i);
  for (int i = lane; i < n_mu; i += kWarp) m += __ldcg(mu2 + i);
  q = warp_sum(q);
  m = warp_sum(m);
  if (lane == 0) *out = sqrtf((float)q + (float)m);
}

// K1-topo: the whole horizon in one cooperative launch.  Block b owns
// devices [b * per, (b + 1) * per) and cloudlets [b * cpb, (b + 1) * cpb)
// for all T slots.  Per slot: phase A, grid.sync(), phase B (mu updated
// in place: block b alone reads and writes its cloudlets' mu), a second
// grid.sync() so every block prices the next slot with the new mu, and
// block 0 forms lnorm from the parity-buffered lam^2 / mu^2 partials.
__global__ void __launch_bounds__(kThreads)
    onalgo_chunked_topo_kernel(Rollout p, Topo q) {
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x;
  const int per = (p.N + G - 1) / G;
  const int n0 = blockIdx.x * per;
  const int n1 = min(p.N, n0 + per);
  const int cpb = (q.K + G - 1) / G;
  const int k0 = min(q.K, blockIdx.x * cpb);
  const int k1 = min(q.K, k0 + cpb);
  for (int s = 0; s < p.T; ++s) {
    double* lam2 = q.lam2p + (long long)(s & 1) * G;
    double* mu2 = q.mu2p + (long long)(s & 1) * G;
    topo_devices(p, q, s, n0, n1, q.kpart + (long long)blockIdx.x * q.K,
                 lam2 + blockIdx.x);
    grid.sync();
    topo_cloudlets(p, q, s, G, k0, k1, mu2 + blockIdx.x);
    grid.sync();
    // the partials of slot s are next written in slot s + 2, after the
    // next slot's first grid.sync(), which block 0 reaches after this
    if (blockIdx.x == 0 && threadIdx.x < kWarp)
      topo_lnorm(lam2, G, mu2, G, p.lnorm + s);
  }
}

// K2-topo phase 1: tile blockIdx.x of block_n devices, one slot.
__global__ void __launch_bounds__(kThreads)
    onalgo_tiled_topo_phase1(Rollout p, Topo q, int s, int block_n) {
  const int n0 = blockIdx.x * block_n;
  topo_devices(p, q, s, n0, min(p.N, n0 + block_n),
               q.kpart + (long long)blockIdx.x * q.K, q.lam2p + blockIdx.x);
}

// K2-topo phase 2: block r reduces cloudlets [r * 32, r * 32 + 32).
__global__ void __launch_bounds__(kThreads)
    onalgo_tiled_topo_phase2(Rollout p, Topo q, int s, int n_tiles) {
  const int k0 = blockIdx.x * kWarp;
  topo_cloudlets(p, q, s, n_tiles, k0, min(q.K, k0 + kWarp),
                 q.mu2p + blockIdx.x);
}

// K2-topo phase 3: one warp forms lnorm.
__global__ void onalgo_tiled_topo_phase3(Rollout p, Topo q, int s,
                                         int n_tiles, int n_red) {
  topo_lnorm(q.lam2p, n_tiles, q.mu2p, n_red, p.lnorm + s);
}

// K3: one slot's policy and dual subgradients.  Warp per device; g_pow per
// device and one double load partial per block (summed by the caller).
__global__ void __launch_bounds__(kThreads)
    onalgo_duals_kernel(const float* lam, const float* mu, const float* rho,
                        Tables tb, const float* B, float* g_pow,
                        double* load_part, int N, int M, int block_n) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x & (kWarp - 1);
  const int n0 = blockIdx.x * block_n;
  const int n1 = min(N, n0 + block_n);
  const float mu_t = mu[0];
  double acc = 0.0;
  for (int n = n0 + warp; n < n1; n += kWarps) {
    const float lam_n = lam[n];
    const float* rrow = rho + (long long)n * M;
    float so = 0.f, sh = 0.f;
    for (int m = lane; m < M; m += kWarp) {
      const float o = tb.o[n * tb.os + m], h = tb.h[n * tb.hs + m],
                  w = tb.w[n * tb.ws + m];
      const float price = lam_n * o + mu_t * h;
      const float ry = (price < w && w > 0.f) ? rrow[m] : 0.f;
      so += o * ry;
      sh += h * ry;
    }
    so = warp_sum(so);
    sh = warp_sum(sh);
    if (lane == 0) {
      g_pow[n] = so - B[n];
      acc += (double)sh;
    }
  }
  __shared__ double s_acc[kWarps];
  if (lane == 0) s_acc[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double l = 0.0;
    for (int i = 0; i < kWarps; ++i) l += s_acc[i];
    load_part[blockIdx.x] = l;
  }
}

Rollout make_rollout(const int* j, const float* svo, const float* svh,
                     const float* svw, const float* o, long long os,
                     const float* h, long long hs, const float* w,
                     long long ws, const float* B, const float* H,
                     const float* a_seq, const float* inv_t, float* lam,
                     float* mu, float* counts, unsigned char* off,
                     float* mu_seq, float* lnorm, double* partials, int T,
                     int N, int M) {
  Rollout p;
  p.j = j;
  p.svo = svo;
  p.svh = svh;
  p.svw = svw;
  p.tb = Tables{o, os, h, hs, w, ws};
  p.B = B;
  p.H = H;
  p.a_seq = a_seq;
  p.inv_t = inv_t;
  p.lam = lam;
  p.mu = mu;
  p.counts = counts;
  p.off = off;
  p.mu_seq = mu_seq;
  p.lnorm = lnorm;
  p.partials = partials;
  p.T = T;
  p.N = N;
  p.M = M;
  return p;
}

Topo make_topo(const int* assoc, long long a_ts, const float* H_k,
               float* rowload, double* kpart, double* lam2p, double* mu2p,
               int K) {
  Topo q;
  q.assoc = assoc;
  q.a_ts = a_ts;
  q.H_k = H_k;
  q.rowload = rowload;
  q.kpart = kpart;
  q.lam2p = lam2p;
  q.mu2p = mu2p;
  q.K = K;
  return q;
}

// Dynamic shared memory of the topology kernels (the dense K-row), opted
// in above the 48 KB default.
cudaError_t topo_smem(const void* fn, int K, size_t* bytes) {
  *bytes = (size_t)K * sizeof(double);
  if (*bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*bytes);
}

}  // namespace

extern "C" {

const char* onalgo_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int onalgo_threads_per_block() { return kThreads; }

int onalgo_duals_launch(const float* lam, const float* mu, const float* rho,
                        const float* o, long long os, const float* h,
                        long long hs, const float* w, long long ws,
                        const float* B, float* g_pow, double* load_part, int N,
                        int M, int block_n, void* stream) {
  const int tiles = (N + block_n - 1) / block_n;
  onalgo_duals_kernel<<<tiles, kThreads, 0, (cudaStream_t)stream>>>(
      lam, mu, rho, Tables{o, os, h, hs, w, ws}, B, g_pow, load_part, N, M,
      block_n);
  return (int)cudaGetLastError();
}

// Co-resident block limit of the cooperative kernel on the current device.
int onalgo_chunked_max_blocks(int* out) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, onalgo_chunked_kernel, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  *out = per_sm * sms;
  return 0;
}

int onalgo_chunked_launch(const int* j, const float* svo, const float* svh,
                          const float* svw, const float* o, long long os,
                          const float* h, long long hs, const float* w,
                          long long ws, const float* B, const float* H,
                          const float* a_seq, const float* inv_t, float* lam,
                          float* mu, float* counts, unsigned char* off,
                          float* mu_seq, float* lnorm, double* partials, int T,
                          int N, int M, int grid, void* stream) {
  Rollout p = make_rollout(j, svo, svh, svw, o, os, h, hs, w, ws, B, H, a_seq,
                           inv_t, lam, mu, counts, off, mu_seq, lnorm,
                           partials, T, N, M);
  void* args[] = {&p};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)onalgo_chunked_kernel, dim3(grid), dim3(kThreads), args, 0,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int onalgo_tiled_launch(const int* j, const float* svo, const float* svh,
                        const float* svw, const float* o, long long os,
                        const float* h, long long hs, const float* w,
                        long long ws, const float* B, const float* H,
                        const float* a_seq, const float* inv_t, float* lam,
                        float* mu, float* counts, unsigned char* off,
                        float* mu_seq, float* lnorm, double* partials, int T,
                        int N, int M, int block_n, void* stream) {
  Rollout p = make_rollout(j, svo, svh, svw, o, os, h, hs, w, ws, B, H, a_seq,
                           inv_t, lam, mu, counts, off, mu_seq, lnorm,
                           partials, T, N, M);
  const int n_tiles = (N + block_n - 1) / block_n;
  cudaStream_t st = (cudaStream_t)stream;
  for (int s = 0; s < T; ++s) {
    onalgo_tiled_phase1<<<n_tiles, kThreads, 0, st>>>(p, s, block_n);
    onalgo_tiled_phase2<<<1, kWarp, 0, st>>>(p, s, n_tiles);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// Largest K whose dense shared row fits a block of either topology
// kernel (opt-in shared memory less the kernels' static shared memory).
int onalgo_topo_max_k(int* out) {
  int dev = 0, optin = 0;
  cudaFuncAttributes a1, a2;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&a1, onalgo_chunked_topo_kernel);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&a2, onalgo_tiled_topo_phase1);
  if (e != cudaSuccess) return (int)e;
  const size_t stat = a1.sharedSizeBytes > a2.sharedSizeBytes
                          ? a1.sharedSizeBytes
                          : a2.sharedSizeBytes;
  *out = (int)((optin - (long long)stat) / (long long)sizeof(double));
  return 0;
}

// Co-resident block limit of the K1-topo cooperative kernel for K
// cloudlets (its dynamic shared memory depends on K).
int onalgo_chunked_topo_max_blocks(int K, int* out) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  size_t smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = topo_smem((const void*)onalgo_chunked_topo_kernel, K, &smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, onalgo_chunked_topo_kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  *out = per_sm * sms;
  return 0;
}

int onalgo_chunked_topo_launch(
    const int* j, const float* svo, const float* svh, const float* svw,
    const float* o, long long os, const float* h, long long hs,
    const float* w, long long ws, const float* B, const float* H,
    const float* a_seq, const float* inv_t, float* lam, float* mu,
    float* counts, unsigned char* off, float* mu_seq, float* lnorm,
    double* partials, int T, int N, int M, const int* assoc, long long a_ts,
    const float* H_k, float* rowload, double* kpart, double* lam2p,
    double* mu2p, int K, int grid, void* stream) {
  Rollout p = make_rollout(j, svo, svh, svw, o, os, h, hs, w, ws, B, H, a_seq,
                           inv_t, lam, mu, counts, off, mu_seq, lnorm,
                           partials, T, N, M);
  Topo q = make_topo(assoc, a_ts, H_k, rowload, kpart, lam2p, mu2p, K);
  size_t smem = 0;
  cudaError_t e = topo_smem((const void*)onalgo_chunked_topo_kernel, K, &smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&p, &q};
  e = cudaLaunchCooperativeKernel((const void*)onalgo_chunked_topo_kernel,
                                  dim3(grid), dim3(kThreads), args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int onalgo_tiled_topo_launch(
    const int* j, const float* svo, const float* svh, const float* svw,
    const float* o, long long os, const float* h, long long hs,
    const float* w, long long ws, const float* B, const float* H,
    const float* a_seq, const float* inv_t, float* lam, float* mu,
    float* counts, unsigned char* off, float* mu_seq, float* lnorm,
    double* partials, int T, int N, int M, const int* assoc, long long a_ts,
    const float* H_k, float* rowload, double* kpart, double* lam2p,
    double* mu2p, int K, int block_n, void* stream) {
  Rollout p = make_rollout(j, svo, svh, svw, o, os, h, hs, w, ws, B, H, a_seq,
                           inv_t, lam, mu, counts, off, mu_seq, lnorm,
                           partials, T, N, M);
  Topo q = make_topo(assoc, a_ts, H_k, rowload, kpart, lam2p, mu2p, K);
  const int n_tiles = (N + block_n - 1) / block_n;
  const int n_red = (K + kWarp - 1) / kWarp;
  size_t smem = 0;
  cudaError_t e = topo_smem((const void*)onalgo_tiled_topo_phase1, K, &smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  for (int s = 0; s < T; ++s) {
    onalgo_tiled_topo_phase1<<<n_tiles, kThreads, smem, st>>>(p, q, s,
                                                              block_n);
    onalgo_tiled_topo_phase2<<<n_red, kThreads, 0, st>>>(p, q, s, n_tiles);
    onalgo_tiled_topo_phase3<<<1, kWarp, 0, st>>>(p, q, s, n_tiles, n_red);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // extern "C"
