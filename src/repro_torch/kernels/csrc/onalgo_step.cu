// Hand-written Hopper (sm_90a) kernels for the OnAlgo hot loop.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/onalgo_step.py:
//   onalgo_duals_kernel           <- onalgo_duals_pallas   (_onalgo_kernel)
//   onalgo_resident_kernel<false> <- onalgo_chunked_pallas (_onalgo_chunked_kernel), scalar mu
//   onalgo_chunked_kernel            (K1; the resident route, and the streaming one)
//   onalgo_tiled_phase1/phase2    <- onalgo_tiled_pallas   (_onalgo_tiled_kernel), scalar mu
//   onalgo_resident_kernel<true>  <- onalgo_chunked_pallas with assoc / H_k
//   onalgo_chunked_topo_kernel       (K1-topo; the two routes)
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
// The streaming kernels (onalgo_chunked_kernel, onalgo_chunked_topo_kernel
// and K2) re-read counts and o from device memory every slot.  K1 and
// K1-topo take them only where a fleet does not fit on chip (the size
// route, onalgo_step.chunked_plan in Python); otherwise the resident kernel
// keeps each block's counts, lam and tables in shared memory for all T
// slots (its note below).  There a slot's device phase is set by the
// instructions a thread issues per state (about 13), not by bytes: on an
// H100 the same call with o shared instead of (N, M) takes an eighth less.
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
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

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
  unsigned long long* stamps;  // (T, kStamps) or nullptr: see stamp()
  int T, N, M;
};

// Per-slot timestamps for measuring a rollout's slot split: thread 0 of
// block 0 writes %globaltimer (ns) into stamps[s * kStamps + i] at the
// points each kernel numbers i; a null pointer costs one branch per point.
constexpr int kStamps = 8;

__device__ __forceinline__ void stamp(const Rollout& p, int s, int i) {
  if (p.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p.stamps[(long long)s * kStamps + i] = t;
  }
}

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
  // the loads of eight strides issued together, added in stride order
  for (int i0 = lane; i0 < n; i0 += 8 * kWarp) {
    double lv[8], qv[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * kWarp;
      lv[u] = i < n ? __ldcg(part + 2 * i) : 0.0;
      qv[u] = i < n ? __ldcg(part + 2 * i + 1) : 0.0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (i0 + u * kWarp < n) {
        l += lv[u];
        q += qv[u];
      }
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
    stamp(p, s, 0);
    const float a_t = p.a_seq[s], inv_t = p.inv_t[s];
    double acc_load = 0.0, acc_lam2 = 0.0;
    for (int n = n0 + warp; n < n1; n += kWarps) {
      const float sh = device_slot(p, s, n, mu, a_t, inv_t, acc_lam2);
      if ((threadIdx.x & (kWarp - 1)) == 0) acc_load += (double)sh;
    }
    double* part = p.partials + (long long)(s & 1) * G * 2;
    block_partial(acc_load, acc_lam2, part + 2 * blockIdx.x);
    stamp(p, s, 1);
    grid.sync();
    stamp(p, s, 2);
    if (warp == 0) {
      const float mu_new = mu_step(part, G, mu, a_t, H, p.mu_seq + s,
                                   p.lnorm + s, blockIdx.x == 0);
      if (threadIdx.x == 0) s_mu = mu_new;
    }
    __syncthreads();
    stamp(p, s, 3);
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
  stamp(p, s, 1);
  if (threadIdx.x == 0)
    for (int n = n0; n < n1; ++n) s_acc[a_row[n]] += (double)q.rowload[n];
  __syncthreads();
  stamp(p, s, 2);
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
    stamp(p, s, 0);
    topo_devices(p, q, s, n0, n1, q.kpart + (long long)blockIdx.x * q.K,
                 lam2 + blockIdx.x);
    stamp(p, s, 3);
    grid.sync();
    stamp(p, s, 4);
    topo_cloudlets(p, q, s, G, k0, k1, mu2 + blockIdx.x);
    stamp(p, s, 5);
    grid.sync();
    stamp(p, s, 6);
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

// ---------------------------------------------------------------------------
// Resident route of K1 and K1-topo: each block's device state on chip for
// all T slots.  One cooperative block per SM owns `per` devices (a multiple
// of 32).  Shared memory holds, from the first slot to the last:
//   * its visit counts as uint16 (exact while max(counts0) + T <= 65535; the
//     counts are integers, so rho = float(c) * inv_t rounds as before), in
//     rows of Mp >= M entries (Mp = 2 mod 4, so the 32 rows a warp reads
//     fall in 32 distinct banks), loaded from counts0 once and written
//     back as float32 once;
//   * its lam and B, and the shared (M,) tables: (h, w') pairs, w' = w
//     where w > 0 and -inf elsewhere, and o when it is shared;
//   * K1-topo: the block's dense row of K float64 cloudlet loads.
// The (N, M) table o / B_n is the only per-device row left in device memory:
// a tile of 32 * warps contiguous rows is brought by one 1-D bulk copy
// (TMA) on an mbarrier, two tiles in flight (where a block's rows fit two
// tiles they are loaded once).  Each thread takes one device of a tile: it
// carries the 32 lane partials of the row sums in registers in the order
// of the warp form (partial l adds columns l, l + 32, ... in turn; then
// halved 16, 8, 4, 2, 1 as __shfl_down_sync does), so no lane idles on the
// per-device tail and no shuffle is spent on the row sums.  The per-slot streams j, the overlay and assoc are read
// one tile ahead into registers (one coalesced 128-byte load per warp and
// stream).  The slot boundary is the scalar kernel's: a float64 partial
// pair per block, one grid.sync(), every block reducing the G partials in
// the same order.  K1-topo sums each tile's row loads by cloudlet without
// float atomics: a warp groups its 32 devices by cloudlet
// (__match_any_sync), the lowest lane of each group adds the group's loads
// in four fixed lane quarters, and warp 0 adds the warps' group sums into
// the K-row in warp order; the cloudlet phase and the second grid.sync()
// are those of the streaming kernel.  Every order is fixed by the data, so
// two runs give the same bits.

constexpr int kResMaxWarps = 4;

struct ResLayout {  // byte offsets into the resident kernel's dynamic smem
  int Mp, Mq;
  unsigned long long bar, cnt, lam, B, tab, ring, acc, lkey, lval, red, bytes;
};

__host__ __device__ inline unsigned long long res_take(unsigned long long& at,
                                                       unsigned long long n) {
  const unsigned long long here = at;
  at += (n + 15) / 16 * 16;
  return here;
}

// The layout for `per` devices of M states, K cloudlets (0: scalar mu),
// `warps` warps a block and o per device (o_dev) or shared.  Mirrored by
// onalgo_step.resident_smem in Python.
__host__ __device__ inline ResLayout res_layout(int per, int M, int K,
                                                int warps, bool o_dev) {
  ResLayout L;
  L.Mp = M + (6 - M % 4) % 4;
  L.Mq = (M + 3) / 4 * 4;
  const unsigned long long lists = K ? 2ull * warps * kWarp : 0;
  unsigned long long at = 0;
  L.bar = res_take(at, 16);
  L.cnt = res_take(at, (unsigned long long)per * L.Mp * 2);
  L.lam = res_take(at, (unsigned long long)per * 4);
  L.B = res_take(at, (unsigned long long)per * 4);
  L.tab = res_take(at, 3ull * L.Mq * 4);
  L.ring = res_take(at, o_dev ? 2ull * warps * kWarp * M * 4 : 0);
  L.acc = res_take(at, (unsigned long long)K * 8);
  L.lkey = res_take(at, lists * 4);
  L.lval = res_take(at, lists * 8);
  L.red = res_take(at, (unsigned long long)warps * 16 + 16);
  L.bytes = at;
  return L;
}

// One thread's device of a tile: its slot's stream values.
struct ResIn {
  int j, a;
  float so, sh, sw;
  bool ok;
};

__device__ __forceinline__ ResIn res_in(const Rollout& p, const Topo& q,
                                        bool topo, int s, int n, int n1) {
  ResIn r{0, 0, 0.f, 0.f, 0.f, n < n1};
  if (r.ok && s < p.T) {
    const long long sn = (long long)s * p.N + n;
    r.j = __ldcs(p.j + sn);
    if (p.svo != nullptr) {
      r.so = __ldcs(p.svo + sn);
      r.sh = __ldcs(p.svh + sn);
      r.sw = __ldcs(p.svw + sn);
    }
    if (topo) r.a = q.assoc[s * q.a_ts + n];
  }
  return r;
}

// Thread 0: bring tile `ti` of the block's o rows into ring buffer `b`.  The
// bulk copy takes the 16-byte multiple; a ragged end of at most three
// floats is copied here and ordered by the __syncthreads() that separates
// the issue from the tile's use.
__device__ __forceinline__ void res_issue(const Rollout& p, float* ring,
                                          uint32_t bar0, int n0, int n1,
                                          int ti, int b, int TW) {
  const int start = n0 + ti * TW;
  const unsigned long long bytes =
      (unsigned long long)min(TW, n1 - start) * p.M * 4;
  const unsigned long long bulk = bytes & ~15ull;
  float* dst = ring + (long long)b * TW * p.M;
  const float* src = p.tb.o + (long long)start * p.M;
  const uint32_t bar = bar0 + 8 * b;
  sm90::fence_proxy_async();
  sm90::mbar_expect_tx(bar, (uint32_t)bulk);
  if (bulk) sm90::bulk_load(sm90::smem_u32(dst), src, (uint32_t)bulk, bar);
  for (unsigned long long e = bulk / 4; e < bytes / 4; ++e) dst[e] = src[e];
}

// Columns c0 .. c0 + 31 of one device's row: partial l adds column c0 + l
// (o * ry and h * ry, ry = rho where lam * o + mu * h < w and w > 0).
// `hw` holds (h, w') with w' = w where w > 0 and -inf elsewhere, so one
// compare decides (the same for every price, NaN included).  Full chunks
// (kTail false) have no guards: 32 independent columns the compiler can
// interleave.
template <bool kTail>
__device__ __forceinline__ void row_chunk(float (&po)[kWarp],
                                          float (&ph)[kWarp],
                                          const unsigned short* crow,
                                          const float* orow, const float2* hw,
                                          int c0, int M, float lam, float mu,
                                          float inv_t) {
#pragma unroll
  for (int l = 0; l < kWarp; l += 2) {
    const int m = c0 + l;
    if (kTail && m >= M) break;
    const uint32_t cc = *reinterpret_cast<const uint32_t*>(crow + m);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (kTail && m + u >= M) break;
      const float rho = (float)(u ? cc >> 16 : cc & 0xffffu) * inv_t;
      const float o = orow[m + u];
      const float2 t = hw[m + u];
      const float price = lam * o + mu * t.x;
      const float ry = price < t.y ? rho : 0.f;
      po[l + u] += o * ry;
      ph[l + u] += t.x * ry;
    }
  }
}

// One halving step of the lane partials (lane l += lane l + D, l < D), as
// v += __shfl_down_sync(v, D) leaves lanes 0..D-1; constant indices keep the
// partials in registers.
template <int D>
__device__ __forceinline__ void halve(float (&a)[kWarp], float (&b)[kWarp]) {
#pragma unroll
  for (int l = 0; l < D; ++l) {
    a[l] += a[l + D];
    b[l] += b[l + D];
  }
}

template <bool kTopo>
__global__ void __launch_bounds__(kResMaxWarps* kWarp, 1)
    onalgo_resident_kernel(Rollout p, Topo q, int per) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(128) unsigned char smem[];
  const int TW = blockDim.x, W = TW / kWarp;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x & (kWarp - 1);
  const int G = gridDim.x, M = p.M, N = p.N, K = kTopo ? q.K : 0;
  const bool o_dev = p.tb.os != 0;
  const ResLayout L = res_layout(per, M, K, W, o_dev);
  const int Mp = L.Mp;
  unsigned short* s_cnt = reinterpret_cast<unsigned short*>(smem + L.cnt);
  float* s_lam = reinterpret_cast<float*>(smem + L.lam);
  float* s_B = reinterpret_cast<float*>(smem + L.B);
  float2* s_hw = reinterpret_cast<float2*>(smem + L.tab);  // (h, w')
  float* s_o = reinterpret_cast<float*>(s_hw + L.Mq);
  float* s_ring = reinterpret_cast<float*>(smem + L.ring);
  double* s_acc = reinterpret_cast<double*>(smem + L.acc);
  int* s_lkey = reinterpret_cast<int*>(smem + L.lkey);        // [2][W][32]
  double* s_lval = reinterpret_cast<double*>(smem + L.lval);  // [2][W][32]
  double* s_red = reinterpret_cast<double*>(smem + L.red);    // [W][2]
  float* s_mu = reinterpret_cast<float*>(s_red + 2 * W);
  const uint32_t bar0 = sm90::smem_u32(smem + L.bar);

  const int n0 = blockIdx.x * per, n1 = min(N, n0 + per), nb = n1 - n0;
  const int nt = (nb + TW - 1) / TW;  // tiles a slot
  const bool ring = o_dev && nt > 2;  // else the o tiles stay loaded

  for (int m = threadIdx.x; m < L.Mq; m += TW) {
    const float w = m < M ? p.tb.w[m] : 0.f;
    s_hw[m] = make_float2(m < M ? p.tb.h[m] : 0.f, w > 0.f ? w : -INFINITY);
    s_o[m] = (!o_dev && m < M) ? p.tb.o[m] : 0.f;
  }
  for (int i = threadIdx.x; i < nb; i += TW) {
    s_lam[i] = p.lam[n0 + i];
    s_B[i] = p.B[n0 + i];
  }
  const float* c_in = p.counts + (long long)n0 * M;
  for (int e = threadIdx.x; e < nb * M; e += TW) {
    const int i = e / M;
    s_cnt[i * Mp + e - i * M] = (unsigned short)c_in[e];
  }
  if (kTopo)
    for (int k = threadIdx.x; k < K; k += TW) s_acc[k] = 0.0;
  if (threadIdx.x == 0) {
    sm90::mbar_init(bar0, 1);
    sm90::mbar_init(bar0 + 8, 1);
    sm90::fence_mbar_init();
  }
  __syncthreads();
  if (o_dev && threadIdx.x == 0)
    for (int ti = 0; ti < min(nt, 2); ++ti)
      res_issue(p, s_ring, bar0, n0, n1, ti, ti, TW);
  __syncthreads();

  float mu = kTopo ? 0.f : p.mu[0];
  const float H = kTopo ? 0.f : p.H[0];
  ResIn cur = res_in(p, q, kTopo, 0, n0 + threadIdx.x, n1);
  float mu_cur = (kTopo && cur.ok) ? __ldcg(p.mu + cur.a) : mu;
  long long qi = 0;  // tiles taken so far, over all slots
  for (int s = 0; s < p.T; ++s) {
    stamp(p, s, 0);
    const float a_t = p.a_seq[s], inv_t = p.inv_t[s];
    double acc_load = 0.0, acc_lam2 = 0.0;
    for (int ti = 0; ti < nt; ++ti, ++qi) {
      const bool last = ti + 1 == nt;
      const ResIn nxt = res_in(p, q, kTopo, last ? s + 1 : s,
                               n0 + (last ? 0 : ti + 1) * TW + threadIdx.x,
                               n1);
      const int b = ring ? (int)(qi & 1) : ti;
      if (o_dev)
        sm90::mbar_wait(bar0 + 8 * b, ring ? (uint32_t)((qi >> 1) & 1) : 0u);
      const int lt = ti * TW + threadIdx.x;  // the device, block-local
      float sh = 0.f;
      if (cur.ok) {
        unsigned short* crow = s_cnt + lt * Mp;
        crow[cur.j] += 1;
        const float lam = s_lam[lt];
        const float mu_n = mu_cur;
        const float* orow =
            o_dev ? s_ring + ((long long)b * TW + threadIdx.x) * M : s_o;
        float po[kWarp], ph[kWarp];
#pragma unroll
        for (int l = 0; l < kWarp; ++l) po[l] = ph[l] = 0.f;
        int c0 = 0;
        for (; c0 + kWarp <= M; c0 += kWarp)
          row_chunk<false>(po, ph, crow, orow, s_hw, c0, M, lam, mu_n, inv_t);
        if (c0 < M)
          row_chunk<true>(po, ph, crow, orow, s_hw, c0, M, lam, mu_n, inv_t);
        halve<16>(po, ph);
        halve<8>(po, ph);
        halve<4>(po, ph);
        halve<2>(po, ph);
        halve<1>(po, ph);
        float o_now, h_now, w_now;
        bool task;
        if (p.svo != nullptr) {
          o_now = cur.so;
          h_now = cur.sh;
          w_now = cur.sw;
          task = cur.j > 0;
        } else {  // w' <= 0 only where it is -inf: the same decision
          o_now = orow[cur.j];
          h_now = s_hw[cur.j].x;
          w_now = s_hw[cur.j].y;
          task = true;
        }
        const float price_now = lam * o_now + mu_n * h_now;
        p.off[(long long)s * N + n0 + lt] =
            (price_now < w_now && w_now > 0.f && task) ? 1 : 0;
        const float lam_new = fmaxf(lam + a_t * (po[0] - s_B[lt]), 0.f);
        s_lam[lt] = lam_new;
        acc_lam2 += (double)(lam_new * lam_new);
        acc_load += (double)ph[0];
        sh = ph[0];
      }
      float mu_nxt = mu;
      if (kTopo) {
        // the next tile of this slot is priced by the same mu: gather now
        if (!last && nxt.ok) mu_nxt = __ldcg(p.mu + nxt.a);
        const int lb = (int)(qi & 1) * W + warp;
        double* lval = s_lval + lb * kWarp;
        const int key = cur.ok ? cur.a : -1;
        lval[lane] = (double)sh;
        __syncwarp();
        const unsigned peers = __match_any_sync(kFull, key);
        const int leader = __ffs(peers) - 1;
        double sum = (double)sh;
        if (lane == leader && __popc(peers) > 1) {
          double part[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
          for (int i = 0; i < kWarp; ++i)
            if ((peers >> i) & 1u) part[i >> 3] += lval[i];
          sum = (part[0] + part[1]) + (part[2] + part[3]);
        }
        __syncwarp();
        s_lkey[lb * kWarp + lane] = (lane == leader && key >= 0) ? key : -1;
        if (lane == leader) lval[lane] = sum;
      }
      __syncthreads();
      if (ring && threadIdx.x == 0 && qi + 2 < (long long)p.T * nt)
        res_issue(p, s_ring, bar0, n0, n1, (int)((qi + 2) % nt), b, TW);
      if (kTopo && warp == 0) {
        const int lb = (int)(qi & 1) * W;
        for (int w = 0; w < W; ++w) {
          const int key = s_lkey[(lb + w) * kWarp + lane];
          if (key >= 0) s_acc[key] += s_lval[(lb + w) * kWarp + lane];
          __syncwarp();
        }
      }
      cur = nxt;
      if (kTopo && !last) mu_cur = mu_nxt;
    }
    stamp(p, s, 1);
    const double l_w = warp_sum(acc_load), q_w = warp_sum(acc_lam2);
    if (lane == 0) {
      s_red[2 * warp] = l_w;
      s_red[2 * warp + 1] = q_w;
    }
    __syncthreads();
    double* part = p.partials + (long long)(s & 1) * G * 2;
    if (threadIdx.x == 0) {
      double l = 0.0, q2 = 0.0;
      for (int i = 0; i < W; ++i) {
        l += s_red[2 * i];
        q2 += s_red[2 * i + 1];
      }
      if (kTopo) {
        __stcg(q.lam2p + (long long)(s & 1) * G + blockIdx.x, q2);
      } else {
        __stcg(part + 2 * blockIdx.x, l);
        __stcg(part + 2 * blockIdx.x + 1, q2);
      }
    }
    if (kTopo)
      for (int k = threadIdx.x; k < K; k += TW) {
        __stcg(q.kpart + (long long)blockIdx.x * K + k, s_acc[k]);
        s_acc[k] = 0.0;
      }
    stamp(p, s, 2);
    grid.sync();
    stamp(p, s, 3);
    if (!kTopo) {
      if (warp == 0) {
        const float mu_new = mu_step(part, G, mu, a_t, H, p.mu_seq + s,
                                     p.lnorm + s, blockIdx.x == 0);
        if (lane == 0) *s_mu = mu_new;
      }
      __syncthreads();
      // *s_mu is next written after the next slot's partial barrier
      mu = mu_cur = *s_mu;
      stamp(p, s, 4);
      continue;
    }
    // K1-topo: block b owns cloudlets [k0, k1), taken TW at a time.  For
    // nk of them the threads form S <= 32 slices of nk; slice r adds the
    // partials of blocks r, r + S, ... (16 loads issued together, added
    // in order), the S slice sums are added in slice order, then the mu_k
    // ascent; the block's mu_k^2 is halved within each warp, the warps
    // added in order.
    const int cpb = (K + G - 1) / G;
    const int k0 = min(K, blockIdx.x * cpb), k1 = min(K, k0 + cpb);
    double mu2 = 0.0;
    for (int kb = k0; kb < k1; kb += TW) {
      const int nk = min(TW, k1 - kb);
      const int S = min(kWarp, TW / nk);
      const int r = threadIdx.x / nk, k = kb + threadIdx.x % nk;
      float mu_k = 0.f, H_k = 0.f;
      if (threadIdx.x < nk) {
        mu_k = __ldcg(p.mu + k);
        H_k = q.H_k[k];
      }
      if (r < S) {
        double l = 0.0;
        for (int g0 = r; g0 < G; g0 += 16 * S) {
          double v[16];
#pragma unroll
          for (int u = 0; u < 16; ++u) {
            const int g = g0 + u * S;
            v[u] = g < G ? __ldcg(q.kpart + (long long)g * K + k) : 0.0;
          }
#pragma unroll
          for (int u = 0; u < 16; ++u)
            if (g0 + u * S < G) l += v[u];
        }
        s_lval[threadIdx.x] = l;  // slice r, cloudlet k
      }
      __syncthreads();
      double v = 0.0;
      if (threadIdx.x < nk) {
        double load = 0.0;
        for (int i = 0; i < S; ++i) load += s_lval[i * nk + threadIdx.x];
        const float mu_new = fmaxf(mu_k + a_t * ((float)load - H_k), 0.f);
        __stcg(p.mu + k, mu_new);
        p.mu_seq[(long long)s * K + k] = mu_new;
        v = (double)(mu_new * mu_new);
      }
      v = warp_sum(v);
      if (lane == 0) s_lval[TW + warp] = v;
      __syncthreads();
      if (threadIdx.x == 0)
        for (int i = 0; i < W; ++i) mu2 += s_lval[TW + i];
    }
    if (threadIdx.x == 0)
      __stcg(q.mu2p + (long long)(s & 1) * G + blockIdx.x, mu2);
    stamp(p, s, 4);
    grid.sync();
    stamp(p, s, 5);
    // lnorm by the last block, the one with the fewest devices; the
    // partials of slot s are next written in slot s + 2, after the next
    // slot's first grid.sync(), which that block reaches after this
    if (blockIdx.x == G - 1 && threadIdx.x < kWarp)
      topo_lnorm(q.lam2p + (long long)(s & 1) * G, G,
                 q.mu2p + (long long)(s & 1) * G, G, p.lnorm + s);
    if (cur.ok) mu_cur = __ldcg(p.mu + cur.a);
  }

  float* c_out = p.counts + (long long)n0 * M;
  for (int e = threadIdx.x; e < nb * M; e += TW) {
    const int i = e / M;
    c_out[e] = (float)s_cnt[i * Mp + e - i * M];
  }
  for (int i = threadIdx.x; i < nb; i += TW) p.lam[n0 + i] = s_lam[i];
  if (!kTopo && blockIdx.x == 0 && threadIdx.x == 0) p.mu[0] = mu;
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
  p.stamps = nullptr;
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
                          int N, int M, unsigned long long* stamps, int grid,
                          void* stream) {
  Rollout p = make_rollout(j, svo, svh, svw, o, os, h, hs, w, ws, B, H, a_seq,
                           inv_t, lam, mu, counts, off, mu_seq, lnorm,
                           partials, T, N, M);
  p.stamps = stamps;
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

// Dynamic shared memory of the resident kernel (res_layout).
long long onalgo_resident_smem(int per, int M, int K, int warps, int o_dev) {
  return (long long)res_layout(per, M, K, warps, o_dev != 0).bytes;
}

// SM count and opt-in shared memory per block of the current device.
int onalgo_device_limits(int* sms, int* smem_optin) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)e;
}

// K1 (K = 0) or K1-topo on the resident route: `grid` cooperative blocks of
// `warps` warps, `per` devices each.  The h and w tables must be (M,).
int onalgo_resident_launch(
    const int* j, const float* svo, const float* svh, const float* svw,
    const float* o, long long os, const float* h, long long hs,
    const float* w, long long ws, const float* B, const float* H,
    const float* a_seq, const float* inv_t, float* lam, float* mu,
    float* counts, unsigned char* off, float* mu_seq, float* lnorm,
    double* partials, int T, int N, int M, const int* assoc, long long a_ts,
    const float* H_k, double* kpart, double* lam2p, double* mu2p, int K,
    unsigned long long* stamps, int per, int warps, int grid, void* stream) {
  if (hs != 0 || ws != 0 || warps < 1 || warps > kResMaxWarps || per % kWarp)
    return (int)cudaErrorInvalidValue;
  Rollout p = make_rollout(j, svo, svh, svw, o, os, h, hs, w, ws, B, H, a_seq,
                           inv_t, lam, mu, counts, off, mu_seq, lnorm,
                           partials, T, N, M);
  p.stamps = stamps;
  Topo q = make_topo(assoc, a_ts, H_k, nullptr, kpart, lam2p, mu2p, K);
  const size_t smem = res_layout(per, M, K, warps, os != 0).bytes;
  const void* fn = K ? (const void*)onalgo_resident_kernel<true>
                     : (const void*)onalgo_resident_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&p, &q, &per};
  e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(warps * kWarp), args,
                                  smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
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
    double* mu2p, int K, unsigned long long* stamps, int grid,
    void* stream) {
  Rollout p = make_rollout(j, svo, svh, svw, o, os, h, hs, w, ws, B, H, a_seq,
                           inv_t, lam, mu, counts, off, mu_seq, lnorm,
                           partials, T, N, M);
  p.stamps = stamps;
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
