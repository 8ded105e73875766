// Hand-written Hopper (sm_90a) kernels for the OnAlgo hot loop.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/onalgo_step.py:
//   onalgo_duals_kernel           <- onalgo_duals_pallas   (_onalgo_kernel)
//   onalgo_resident_kernel<false> <- onalgo_chunked_pallas (_onalgo_chunked_kernel), scalar mu
//   onalgo_chunked_kernel            (K1; the resident route, and the streaming one)
//   onalgo_tiled_kernel<C, false> <- onalgo_tiled_pallas   (_onalgo_tiled_kernel), scalar mu (K2)
//   onalgo_resident_kernel<true>  <- onalgo_chunked_pallas with assoc / H_k
//   onalgo_chunked_topo_kernel       (K1-topo; the two routes)
//   onalgo_tiled_kernel<C, true>  <- onalgo_tiled_pallas with assoc / H_k   (K2-topo,
//   + onalgo_tiled_cloudlets         with its per-cloudlet pass)
//   onalgo_cells_kernel           <- jax.vmap of onalgo_chunked_pallas (the chunked
//                                    sweep: K1 with a cell axis); K2's cell axis is
//                                    onalgo_tiled_kernel<C, false, false, true>
//
// What bounds them on the card.  Per slot every device's row of the (N, M)
// visit counts is read and compared, state by state, against its row of
// the preconditioned power table o / B_n and the (M,) cycle and gain
// tables: about 13 instructions a state.  Where the rows stream from
// device memory every slot (the streaming K1 kernels, and K2, which takes
// fleets of any size and so holds nothing on chip across slots) the bytes
// bound it: o and the counts are ~44 MB a slot at the service width.  What
// the designs do about it:
//   * the (M,) tables are taken with row stride 0 (no (N, M) broadcast);
//   * only the one visited count of a row is written back per slot;
//   * K1 runs the whole horizon in ONE cooperative launch: each block owns
//     a fixed device range for all T slots, and the only per-slot traffic
//     besides the rows is the grid-wide mu reduction (one grid.sync());
//     where a fleet fits on chip (the size route,
//     onalgo_step.chunked_plan in Python) the resident kernel keeps each
//     block's counts, lam and tables in shared memory for all T slots (its
//     note below): there a slot is set by the instructions a thread issues
//     per state, not by bytes (an H100 runs the same call with o shared
//     instead of (N, M) an eighth faster);
//   * K3 (one slot, rho and o read once: 58 MB at the service width) is
//     one launch: each block's rows arrive by a 1-D bulk copy (TMA), one
//     thread per device, and the last block reduces the load (its note
//     below);
//   * K2 needs no co-residency: one launch a slot (K2-topo: two), each
//     block's rows brought by bulk copies (TMA) two units ahead, one
//     thread per device, the counts kept for the call as uint16 (half the
//     bytes), the mu reduction folded into the next slot's launch, and
//     each slot launched as a programmatic dependent of the last, so a
//     block's first o copies and stream reads overlap the previous slot
//     (its note below).
//
// The topology forms (K cloudlets, mu a (K,) vector, device n priced by
// mu[assoc[n]]) add per slot a gather and a per-cloudlet reduction.  The
// TPU kernels do both through VMEM- and MXU-shaped layouts: a one-hot
// (N, K_pad) mask, or above K = 512 the binned (hi, lo) pair of
// dot_generals (the reference's topo_binned).  Here ONE kernel serves both
// layouts: mu is read with a direct gather (__ldcg of mu[assoc[n]] from
// L2), and each block (K2-topo: each tile) reduces its devices' row loads
// into a dense row of K doubles in a fixed order (no atomics), writes it
// to a [G][K] partial array, and after a grid sync (K2-topo: in a second
// launch) block b reduces its cloudlet range over the G partials in a
// fixed order (warp w sums rows w, w + 16, ...; the 16 warp sums are
// added in warp order) and takes the mu_k ascent; a second sync publishes
// mu, and one block forms ||(lam, mu)||.  No float atomics anywhere: two
// runs give the same bits.  The cost the design adds grows with K: G * K
// doubles written and read per slot (17 MB at K = 4096 and 528 blocks,
// mostly L2-resident), and in the K1-topo kernels K doubles of shared
// memory per block (K <= ~28000).
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
  int* bad;            // (1,) range flags: see in_range()
  int T, N, M;
};

// A state index (bit 1 of *bad) or cloudlet id (bit 2) read from the
// caller's streams, held to [0, bound): one out of range sets its bit,
// which the caller reads after the call or at its run's end and raises
// on, and is clamped so that no access leaves its table meanwhile.
__device__ __forceinline__ int in_range(int v, int bound, int* bad, int bit) {
  if ((unsigned)v >= (unsigned)bound) {
    atomicOr(bad, bit);
    v = v < 0 ? 0 : bound - 1;
  }
  return v;
}

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
  const int j = in_range(p.j[sn], p.M, p.bad, 1);
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
    const float mu_n = __ldcg(p.mu + in_range(a_row[n], q.K, p.bad, 2));
    const float sh = device_slot(p, s, n, mu_n, a_t, inv_t, acc_lam2);
    if (lane == 0) q.rowload[n] = sh;
  }
  __syncthreads();
  stamp(p, s, 1);
  if (threadIdx.x == 0)
    for (int n = n0; n < n1; ++n)
      s_acc[in_range(a_row[n], q.K, p.bad, 2)] += (double)q.rowload[n];
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

// A unit's stream values held to their ranges (in_range) when the unit
// takes them, not when res_in loads them a unit ahead: a check there
// would wait for the load.
__device__ __forceinline__ ResIn res_checked(ResIn r, const Rollout& p,
                                             const Topo& q, bool topo) {
  if (r.ok) {
    r.j = in_range(r.j, p.M, p.bad, 1);
    if (topo) r.a = in_range(r.a, q.K, p.bad, 2);
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

// ---------------------------------------------------------------------------
// K3: one slot's policy and dual subgradients.  Block b takes the
// contiguous devices [b * TW, b * TW + TW), one thread each.  Where TW whole
// rows fit (CM == M, every M up to about 880 with o per device), its rows of
// rho, and of o where o is per device, arrive in shared memory by one 1-D
// bulk copy (TMA) each on an mbarrier (stage_floats: the 16-byte-aligned
// middle; the ends and any misalignment by plain loads).  Wider rows come in
// chunks of CM columns (a multiple of 32) by plain loads, in rows of CM + 1
// floats.  The shared (M,) tables come by plain loads, chunk by chunk.  Each
// thread forms sum o * ry and sum h * ry from its row (32 rows in 32 banks
// for odd M or chunks) with the 32 lane partials of row_sum's order in
// registers (duals_chunk over the chunks, then halve), so g_pow equals the
// plain version's bit for bit.  The load: the block's row loads are summed
// in float64 in thread order into one partial, and the last block to finish
// (a done counter, reset by it for the next call) sums the G partials in a
// fixed order (lane-strided, then halved) and writes the float32 load, so
// the caller launches nothing after the kernel and two calls give the same
// bits.

constexpr int kDualsRows = 128;  // devices (threads) a block at most

struct DualsLayout {  // byte offsets into K3's dynamic shared memory
  unsigned rho, o, h, w, bytes;
};

// The mbarrier; the rows of rho (and of o when o_dev): whole, with 16 bytes
// of slack for misalignment, or one chunk of CM columns in rows of CM | 1;
// a chunk of the (M,) o, h and w tables.  onalgo_step.duals_smem mirrors it.
__host__ __device__ inline DualsLayout duals_layout(int rows, int M, int CM,
                                                    bool o_dev) {
  DualsLayout L;
  unsigned long long at = 16;  // the mbarrier
  const unsigned long long tile =
      CM == M ? (unsigned long long)rows * M * 4 + 16
              : (unsigned long long)rows * (CM | 1) * 4;
  const unsigned long long chunk = (unsigned long long)CM * 4;
  L.rho = (unsigned)res_take(at, tile);
  L.o = (unsigned)res_take(at, o_dev ? tile : chunk);
  L.h = (unsigned)res_take(at, chunk);
  L.w = (unsigned)res_take(at, chunk);
  L.bytes = (unsigned)at;
  return L;
}

// `count` floats from `src` to shared memory at `buf` (16-byte aligned, 16
// bytes of slack), placed so that src and its copy agree mod 16 bytes: the
// aligned middle by a bulk copy on `bar` (staged_bytes counts it), the at
// most 3 + 3 floats around it by plain loads, ordered by a later
// __syncthreads().  Only the thread with `issue` copies; every caller gets
// where src[0] lands.
__device__ __forceinline__ float* stage_floats(float* buf, const float* src,
                                               long long count, uint32_t bar,
                                               bool issue) {
  const int off = (int)((reinterpret_cast<uintptr_t>(src) & 15) / 4);
  float* dst = buf + off;
  if (!issue) return dst;
  const long long head = min((long long)((4 - off) & 3), count);
  const long long mid = (count - head) & ~3ll;
  for (long long e = 0; e < head; ++e) dst[e] = src[e];
  for (long long e = head + mid; e < count; ++e) dst[e] = src[e];
  if (mid) sm90::bulk_load(sm90::smem_u32(dst + head), src + head,
                           (uint32_t)(mid * 4), bar);
  return dst;
}

// Bytes that stage_floats moves by its bulk copy.
__device__ __forceinline__ uint32_t staged_bytes(const float* src,
                                                 long long count) {
  const int off = (int)((reinterpret_cast<uintptr_t>(src) & 15) / 4);
  const long long head = min((long long)((4 - off) & 3), count);
  return (uint32_t)(((count - head) & ~3ll) * 4);
}

// `cm` columns from column c0 of `rows` rows of an (N, M) table to shared
// memory in rows of `pitch` floats, by the block's threads.
__device__ __forceinline__ void stage_chunk(float* dst, const float* src,
                                            int rows, int M, int c0, int cm,
                                            int pitch) {
  for (int e = threadIdx.x; e < rows * cm; e += blockDim.x) {
    const int i = e / cm, c = e - i * cm;
    dst[i * pitch + c] = src[(long long)i * M + c0 + c];
  }
}

// 32 columns of one device's row from the pointers on (`cnt` of them when
// kTail): partial l adds column l (o * ry and h * ry, ry = rho where
// lam * o + mu * h < w and w > 0), the order of row_sum when the columns
// start at a multiple of 32.  Full chunks (kTail false) have no guards.
template <bool kTail>
__device__ __forceinline__ void duals_chunk(float (&po)[kWarp],
                                            float (&ph)[kWarp],
                                            const float* rrow,
                                            const float* orow,
                                            const float* hrow,
                                            const float* wrow, int cnt,
                                            float lam, float mu) {
#pragma unroll
  for (int l = 0; l < kWarp; ++l) {
    if (kTail && l >= cnt) break;
    const float o = orow[l], h = hrow[l], w = wrow[l];
    const float price = lam * o + mu * h;
    const float ry = (price < w && w > 0.f) ? rrow[l] : 0.f;
    po[l] += o * ry;
    ph[l] += h * ry;
  }
}

__global__ void __launch_bounds__(kDualsRows)
    onalgo_duals_kernel(const float* lam, const float* mu, const float* rho,
                        Tables tb, const float* B, float* g_pow,
                        double* load_part, unsigned* done, float* load, int N,
                        int M, int TW, int CM) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double s_acc[kDualsRows / kWarp];
  __shared__ bool s_last;
  const bool o_dev = tb.os != 0, whole = CM == M;
  const DualsLayout L = duals_layout(TW, M, CM, o_dev);
  const int pitch = whole ? M : (CM | 1);  // floats a staged row
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int n0 = blockIdx.x * TW, rows = min(N - n0, TW);
  const uint32_t bar = sm90::smem_u32(smem);
  float* s_rho = reinterpret_cast<float*>(smem + L.rho);
  float* s_o = reinterpret_cast<float*>(smem + L.o);
  float* s_h = reinterpret_cast<float*>(smem + L.h);
  float* s_w = reinterpret_cast<float*>(smem + L.w);
  const float* src_r = rho + (long long)n0 * M;
  const float* src_o = tb.o + (long long)n0 * M;
  if (whole) {
    const long long count = (long long)rows * M;
    if (tid == 0) {
      sm90::mbar_init(bar, 1);
      sm90::fence_mbar_init();
      sm90::mbar_expect_tx(bar, staged_bytes(src_r, count) +
                                    (o_dev ? staged_bytes(src_o, count) : 0u));
    }
    s_rho = stage_floats(s_rho, src_r, count, bar, tid == 0);
    if (o_dev) s_o = stage_floats(s_o, src_o, count, bar, tid == 0);
  }
  const float mu_t = mu[0];
  const int n = n0 + tid;
  const float lam_n = tid < rows ? lam[n] : 0.f;
  float po[kWarp], ph[kWarp];
#pragma unroll
  for (int l = 0; l < kWarp; ++l) po[l] = ph[l] = 0.f;
  for (int c0 = 0; c0 < M; c0 += CM) {
    const int cm = min(CM, M - c0);
    if (!whole) {
      __syncthreads();  // every row of the last chunk is read
      stage_chunk(s_rho, src_r, rows, M, c0, cm, pitch);
      if (o_dev) stage_chunk(s_o, src_o, rows, M, c0, cm, pitch);
    }
    for (int m = tid; m < cm; m += blockDim.x) {
      if (!o_dev) s_o[m] = tb.o[c0 + m];
      if (!tb.hs) s_h[m] = tb.h[c0 + m];
      if (!tb.ws) s_w[m] = tb.w[c0 + m];
    }
    __syncthreads();
    if (whole) sm90::mbar_wait(bar, 0);
    if (tid < rows) {
      const float* rrow = s_rho + tid * pitch;
      const float* orow = o_dev ? s_o + tid * pitch : s_o;
      const float* hrow = tb.hs ? tb.h + (long long)n * tb.hs + c0 : s_h;
      const float* wrow = tb.ws ? tb.w + (long long)n * tb.ws + c0 : s_w;
      int k = 0;
      for (; k + kWarp <= cm; k += kWarp)
        duals_chunk<false>(po, ph, rrow + k, orow + k, hrow + k, wrow + k,
                           kWarp, lam_n, mu_t);
      if (k < cm)
        duals_chunk<true>(po, ph, rrow + k, orow + k, hrow + k, wrow + k,
                          cm - k, lam_n, mu_t);
    }
  }
  float sh = 0.f;
  if (tid < rows) {
    halve<16>(po, ph);
    halve<8>(po, ph);
    halve<4>(po, ph);
    halve<2>(po, ph);
    halve<1>(po, ph);
    g_pow[n] = po[0] - B[n];
    sh = ph[0];
  }
  // the block's load in thread order, then the last block's sum over blocks
  const double wsum = warp_sum((double)sh);
  if (lane == 0) s_acc[warp] = wsum;
  __syncthreads();
  if (tid == 0) {
    double l = 0.0;
    for (int i = 0; i < (int)blockDim.x / kWarp; ++i) l += s_acc[i];
    __stcg(load_part + blockIdx.x, l);
    __threadfence();
    s_last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (s_last && warp == 0) {
    __threadfence();
    double v = 0.0;
    for (int i = lane; i < (int)gridDim.x; i += kWarp)
      v += __ldcg(load_part + i);
    v = warp_sum(v);
    if (lane == 0) {
      *load = (float)v;
      *done = 0u;  // ready for the next call on this counter
    }
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
  ResIn cur = res_checked(res_in(p, q, kTopo, 0, n0 + threadIdx.x, n1), p,
                          q, kTopo);
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
        if (!last && nxt.ok)
          mu_nxt = __ldcg(p.mu + in_range(nxt.a, q.K, p.bad, 2));
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
      cur = res_checked(nxt, p, q, kTopo);
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

// ---------------------------------------------------------------------------
// K1 with a cell axis (the chunked sweep).  Replaces jax.vmap of
// onalgo_chunked_pallas (src/repro/kernels/onalgo_step.py) in the
// reference's chunked sweep (src/repro/scenarios/sweeps.py): G cells, each
// its own step rule, budgets and so its own o' = o / B_g[n], h' = h / H_g,
// lam, mu and visit counts, over one shared trace j, in ONE cooperative
// launch.  Only the scalar-mu form with (M,) h and w and no overlay (what
// the sweeps run); o per cell is an (N, M) table at a cell stride that
// keeps each cell 16-byte aligned.
//
// What bounds it on this card.  The operations: ~10 per device, state and
// slot, 0.38 ms at 16 cells of N=8192, M=37, T=512 at the float32 rate.
// The o' rows: every slot reads each cell's whole (N, M) o', G N M 4 bytes
// (19.4 MB at that grid), which the 50 MB L2 holds but which at the HBM
// rate alone would take 2.97 ms over T=512.  And each slot's mu is a
// grid-wide dependency: every cell's next slot waits for all of its
// blocks' partials.
//
// What the design does about each.  Every cell is cut into the Gc blocks
// of `per` devices that a single-cell resident call of its N takes
// (onalgo_step.chunked_plan), and every such block is a virtual block
// here, with its own shared-memory counts (uint16), lam, B and (h, w')
// row for all T slots; physical block b holds virtual blocks [b V, b V +
// V).  The block's threads form P lane groups of gw = min(per, the single
// call's block width) threads, and group q walks virtual blocks q, q + P,
// ... in ceil(V / P) passes a slot, each device on one thread as the
// single call maps it (thread t of a tile takes device ti gw + t), so the
// groups' warps issue side by side and a pass of narrow virtual blocks
// keeps every scheduler busy.  Within a slot a group synchronises only
// itself (named barrier 1 + q of gw threads); the slot's grid.sync() and
// the hand-off of mu after it are the only points where the block joins.
// Where every cell lies whole in one block (V a multiple of Gc, as in a
// sweep of small fleets: a block a cell) no cell's mu needs another
// block: the partials stay in shared memory and a block barrier takes
// the grid.sync()'s place.  Each group stages its own o' tiles through S
// mbarrier-tracked stages of 1-D bulk copies (TMA), from L2 where the
// grid's o' fits it: where its tiles a slot number at most S they are
// loaded once and stay for all T slots, else the ring refills a stage as
// soon as the group has left it, S items ahead.  After the slot's sync
// each distinct cell of the block takes one mu_step (warp w takes cells
// w, w + warps, ...) and hands mu to its virtual blocks.
//
// Exactness.  A group's partial is formed as the single call's block
// partial: each thread adds its tiles in order in float64, each warp
// halves, the group's warps are added in order (the single call's extra
// warps, and threads past the last device, add exactly +0.0, since loads
// and lam^2 are non-negative), and a cell's mu is mu_step over its Gc
// partials in the single call's order (mu_step_shared, the same order,
// where they stay in shared memory), so every cell is bit for bit a
// single-cell resident call.

constexpr int kCellsMaxGroups = 15;    // named barriers 1..15
constexpr int kCellsMaxThreads = 512;  // the widest cell-axis block

struct Cells {
  int G;           // cells in this launch
  int Gc;          // virtual blocks a cell (ceil(N / per))
  int V;           // virtual blocks a physical block
  int per;         // devices a virtual block (a multiple of 32)
  int gw;          // threads a lane group: min(per, the single call's block)
  int P;           // lane groups a block
  int S;           // o' stages a group
  long long o_cs;  // o's cell stride in floats (0: one o for every cell)
  long long h_cs;  // h's cell stride in floats (0: one h for every cell)
};

struct CellsLayout {  // byte offsets into the cell-axis kernel's smem
  int Mp, Mq;
  unsigned long long bar, cnt, lam, B, hw, os, ring, red, part, mu, bytes;
};

// Mirrored by onalgo_step.cells_smem in Python.
__host__ __device__ inline CellsLayout cells_layout(int per, int M, int gw,
                                                    int P, int S, int V,
                                                    bool o_dev) {
  CellsLayout L;
  L.Mp = M + (6 - M % 4) % 4;
  L.Mq = (M + 3) / 4 * 4;
  const unsigned long long dev = (unsigned long long)V * per;
  unsigned long long at = 0;
  L.bar = res_take(at, o_dev ? 8ull * P * S : 0);
  L.cnt = res_take(at, dev * L.Mp * 2);
  L.lam = res_take(at, dev * 4);
  L.B = res_take(at, dev * 4);
  L.hw = res_take(at, (unsigned long long)V * L.Mq * 8);
  L.os = res_take(at, o_dev ? 0 : (unsigned long long)L.Mq * 4);
  L.ring = res_take(at, o_dev ? (unsigned long long)P * S * gw * M * 4 : 0);
  L.red = res_take(at, (unsigned long long)P * (gw / kWarp) * 16);
  L.part = res_take(at, (unsigned long long)V * 16);
  L.mu = res_take(at, (unsigned long long)V * 4);
  L.bytes = at;
  return L;
}

// mu_step over a cell's n partials in shared memory (a cell whole in one
// block): each lane adds its strided partials in order, then the warp
// halves, as mu_step does, so the cell's mu is the same bits.
__device__ __forceinline__ float mu_step_shared(const double* part, int n,
                                                float mu, float a_t, float H,
                                                float* mu_seq, float* lnorm,
                                                bool write) {
  const int lane = threadIdx.x & (kWarp - 1);
  double l = 0.0, q = 0.0;
  for (int i = lane; i < n; i += kWarp) {
    l += part[2 * i];
    q += part[2 * i + 1];
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

// At most 512 threads, so 128 registers a thread: the 64 lane partials
// stay in registers (ptxas: no stack, no spills).
__global__ void __launch_bounds__(kCellsMaxThreads, 1)
    onalgo_cells_kernel(Rollout p, Cells c) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(128) unsigned char smem[];
  const int NT = blockDim.x, tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid & (kWarp - 1);
  const int M = p.M, N = p.N, T = p.T, per = c.per, Gc = c.Gc;
  const int gw = c.gw, P = c.P, S = c.S;
  const int q = tid / gw, gt = tid - q * gw;  // lane group, thread in it
  const bool o_dev = p.tb.os != 0;
  const CellsLayout L = cells_layout(per, M, gw, P, S, c.V, o_dev);
  const int Mp = L.Mp, Mq = L.Mq;
  unsigned short* s_cnt = reinterpret_cast<unsigned short*>(smem + L.cnt);
  float* s_lam = reinterpret_cast<float*>(smem + L.lam);
  float* s_B = reinterpret_cast<float*>(smem + L.B);
  float2* s_hw = reinterpret_cast<float2*>(smem + L.hw);  // [V][Mq]
  float* s_o = reinterpret_cast<float*>(smem + L.os);
  float* g_ring =  // this group's S stages of gw rows
      reinterpret_cast<float*>(smem + L.ring) + (long long)q * S * gw * M;
  double* g_red =  // this group's [gw / 32][2]
      reinterpret_cast<double*>(smem + L.red) + 2 * q * (gw / kWarp);
  double* s_part =  // [V][2]: the partials, where every cell is whole
      reinterpret_cast<double*>(smem + L.part);
  float* s_mu = reinterpret_cast<float*>(smem + L.mu);  // [local cell]
  const uint32_t g_bar = sm90::smem_u32(smem + L.bar) + 8 * q * S;

  // virtual block i of this block: cell vc(i), devices [vn0(i), + vnb(i))
  const int v0 = blockIdx.x * c.V;
  const int nv = min(c.V, c.G * Gc - v0);
  const int g0 = v0 / Gc, ncell = (v0 + nv - 1) / Gc - g0 + 1;
  auto vc = [&](int i) { return (v0 + i) / Gc; };
  auto vn0 = [&](int i) { return ((v0 + i) % Gc) * per; };
  auto vnb = [&](int i) { return min(N, vn0(i) + per) - vn0(i); };
  auto vnt = [&](int i) { return (vnb(i) + gw - 1) / gw; };
  int n_items = 0;  // the group's tiles a slot
  for (int i = q; i < nv; i += P) n_items += vnt(i);
  const bool ring = o_dev && n_items > S;  // else its o tiles stay loaded
  // every cell lies whole in one block (V a multiple of Gc): its mu needs
  // no other block's partials
  const bool whole = c.V % Gc == 0;

  for (int i = 0; i < nv; ++i) {
    const int g = vc(i), n0 = vn0(i), nb = vnb(i);
    const float* h = p.tb.h + g * c.h_cs;
    for (int m = tid; m < Mq; m += NT) {
      const float w = m < M ? p.tb.w[m] : 0.f;
      s_hw[i * Mq + m] =
          make_float2(m < M ? h[m] : 0.f, w > 0.f ? w : -INFINITY);
    }
    for (int d = tid; d < nb; d += NT) {
      s_lam[i * per + d] = p.lam[(long long)g * N + n0 + d];
      s_B[i * per + d] = p.B[(long long)g * N + n0 + d];
    }
    const float* c_in = p.counts + ((long long)g * N + n0) * M;
    for (int e = tid; e < nb * M; e += NT) {
      const int r = e / M;
      s_cnt[(i * per + r) * Mp + e - r * M] = (unsigned short)c_in[e];
    }
  }
  for (int lc = tid; lc < ncell; lc += NT) s_mu[lc] = p.mu[g0 + lc];
  if (!o_dev)
    for (int m = tid; m < Mq; m += NT) s_o[m] = m < M ? p.tb.o[m] : 0.f;
  if (o_dev && tid < P * S) {
    for (int b = tid; b < P * S; b += NT)
      sm90::mbar_init(sm90::smem_u32(smem + L.bar) + 8 * b, 1);
    sm90::fence_mbar_init();
  }
  __syncthreads();

  // the group's thread 0: its slot item k (of n_items) -- virtual block i,
  // tile ti -- into stage b.  The ragged end of at most three floats is
  // stored first, so the stage's arrive releases it with the copy.
  auto issue = [&](int k, int b) {
    int i = q;
    while (k >= vnt(i)) {
      k -= vnt(i);
      i += P;
    }
    const int start = vn0(i) + k * gw;
    const unsigned long long bytes =
        (unsigned long long)min(gw, vn0(i) + vnb(i) - start) * M * 4;
    const unsigned long long bulk = bytes & ~15ull;
    float* dst = g_ring + (long long)b * gw * M;
    const float* src = p.tb.o + vc(i) * c.o_cs + (long long)start * M;
    for (unsigned long long e = bulk / 4; e < bytes / 4; ++e) dst[e] = src[e];
    const uint32_t bar = g_bar + 8 * b;
    sm90::fence_proxy_async();
    sm90::mbar_expect_tx(bar, (uint32_t)bulk);
    if (bulk) sm90::bulk_load(sm90::smem_u32(dst), src, (uint32_t)bulk, bar);
  };
  // one thread's device of an item: its state index (0 where it has none)
  auto j_at = [&](int s, int i, int ti, bool& ok) {
    const int d = ti * gw + gt;
    ok = i < nv && d < vnb(i);
    return (ok && s < T) ? p.j[(long long)s * N + vn0(i) + d] : 0;
  };
  if (o_dev && gt == 0)
    for (int k = 0; k < min(n_items, S); ++k) issue(k, k);

  bool ok_cur;
  int j_cur = j_at(0, q, 0, ok_cur);
  if (ok_cur) j_cur = in_range(j_cur, M, p.bad, 1);
  // the ring's state: the next item's stage and phase, the slot item the
  // next copy brings and the copies left (T n_items < 2^31: T < 65536)
  int b_ring = 0, k_copy = ring ? S : 0, copies = ring ? T * n_items - S : 0;
  uint32_t phase = 0;
  float inv_t = p.inv_t[0];
  for (int s = 0; s < T; ++s) {
    stamp(p, s, 0);
    const float inv_t_nxt = s + 1 < T ? p.inv_t[s + 1] : 0.f;
    int k = 0;  // the item within the group's slot
    double* part = p.partials + (long long)(s & 1) * c.G * Gc * 2;
    for (int i = q; i < nv; i += P) {
      const int g = vc(i), n0 = vn0(i), nt = vnt(i);
      const float a_t = p.a_seq[(long long)g * T + s];
      const float mu = s_mu[g - g0];
      const float2* hw = s_hw + i * Mq;
      double acc_load = 0.0, acc_lam2 = 0.0;
      for (int ti = 0; ti < nt; ++ti, ++k) {
        // the next item's state index, read one item ahead
        const bool last_i = ti + 1 == nt, last = last_i && i + P >= nv;
        bool ok_nxt;
        const int j_nxt = j_at(last ? s + 1 : s, last_i ? (last ? q : i + P) : i,
                               last_i ? 0 : ti + 1, ok_nxt);
        const int b = ring ? b_ring : k;
        if (o_dev) sm90::mbar_wait(g_bar + 8 * b, ring ? phase : 0u);
        const int lt = i * per + ti * gw + gt;  // the device, block-local
        if (ok_cur) {
          unsigned short* crow = s_cnt + lt * Mp;
          crow[j_cur] += 1;
          const float lam = s_lam[lt];
          const float* orow = o_dev ? g_ring + (b * gw + gt) * M : s_o;
          float po[kWarp], ph[kWarp];
#pragma unroll
          for (int l = 0; l < kWarp; ++l) po[l] = ph[l] = 0.f;
          int c0 = 0;
          for (; c0 + kWarp <= M; c0 += kWarp)
            row_chunk<false>(po, ph, crow, orow, hw, c0, M, lam, mu, inv_t);
          if (c0 < M)
            row_chunk<true>(po, ph, crow, orow, hw, c0, M, lam, mu, inv_t);
          halve<16>(po, ph);
          halve<8>(po, ph);
          halve<4>(po, ph);
          halve<2>(po, ph);
          halve<1>(po, ph);
          // w' <= 0 only where it is -inf: the same decision
          const float price_now = lam * orow[j_cur] + mu * hw[j_cur].x;
          const float w_now = hw[j_cur].y;
          p.off[((long long)g * T + s) * N + n0 + ti * gw + gt] =
              (price_now < w_now && w_now > 0.f) ? 1 : 0;
          const float lam_new = fmaxf(lam + a_t * (po[0] - s_B[lt]), 0.f);
          s_lam[lt] = lam_new;
          acc_lam2 += (double)(lam_new * lam_new);
          acc_load += (double)ph[0];
        }
        sm90::named_bar_sync(1 + q, gw);  // the group has left stage b
        if (ring) {
          if (copies > 0) {
            if (gt == 0) issue(k_copy, b);
            --copies;
            if (++k_copy == n_items) k_copy = 0;
          }
          if (++b_ring == S) {
            b_ring = 0;
            phase ^= 1u;
          }
        }
        j_cur = ok_nxt ? in_range(j_nxt, M, p.bad, 1) : 0;
        ok_cur = ok_nxt;
      }
      // the virtual block's partial, in the single-cell kernel's order; the
      // group's next write of g_red follows its next barrier
      const double l_w = warp_sum(acc_load), q_w = warp_sum(acc_lam2);
      if (lane == 0) {
        g_red[2 * (gt / kWarp)] = l_w;
        g_red[2 * (gt / kWarp) + 1] = q_w;
      }
      sm90::named_bar_sync(1 + q, gw);
      if (gt == 0) {
        double l = 0.0, q2 = 0.0;
        for (int w = 0; w < gw / kWarp; ++w) {
          l += g_red[2 * w];
          q2 += g_red[2 * w + 1];
        }
        if (whole) {
          s_part[2 * i] = l;
          s_part[2 * i + 1] = q2;
        } else {
          __stcg(part + 2 * (v0 + i), l);
          __stcg(part + 2 * (v0 + i) + 1, q2);
        }
      }
    }
    stamp(p, s, 1);
    if (whole)
      __syncthreads();
    else
      grid.sync();
    stamp(p, s, 2);
    // each distinct cell's mu from its Gc partials, once (the block that
    // holds the cell's first virtual block writes its series)
    for (int lc = warp; lc < ncell; lc += NT / kWarp) {
      const int g = g0 + lc;
      const float a_t = p.a_seq[(long long)g * T + s];
      float* mu_seq = p.mu_seq + (long long)g * T + s;
      float* lnorm = p.lnorm + (long long)g * T + s;
      const float mu_new =
          whole ? mu_step_shared(s_part + 2 * (g * Gc - v0), Gc, s_mu[lc],
                                 a_t, p.H[g], mu_seq, lnorm, true)
                : mu_step(part + 2ll * g * Gc, Gc, s_mu[lc], a_t, p.H[g],
                          mu_seq, lnorm, g * Gc >= v0);
      if (lane == 0) s_mu[lc] = mu_new;
    }
    __syncthreads();
    stamp(p, s, 3);
    inv_t = inv_t_nxt;
  }

  for (int i = 0; i < nv; ++i) {
    const int g = vc(i), n0 = vn0(i), nb = vnb(i);
    float* c_out = p.counts + ((long long)g * N + n0) * M;
    for (int e = tid; e < nb * M; e += NT) {
      const int r = e / M;
      c_out[e] = (float)s_cnt[(i * per + r) * Mp + e - r * M];
    }
    for (int d = tid; d < nb; d += NT)
      p.lam[(long long)g * N + n0 + d] = s_lam[i * per + d];
  }
  for (int lc = tid; lc < ncell; lc += NT)
    if ((g0 + lc) * Gc >= v0) p.mu[g0 + lc] = s_mu[lc];
}

// ---------------------------------------------------------------------------
// K2 and K2-topo: the rollout tiled over N, for fleets of any size (no
// co-residency), one launch per slot (K2-topo: two).  What bounds it: a
// slot streams every device's o row and count row from device memory
// (~44 MB at the service width) and spends ~13 instructions a state on
// them, and each slot boundary is a device-wide dependency (mu).  What
// the design does about it:
//   * Units: tpb whole tiles of block_n devices (tpb * block_n <= the
//     block's threads), or one tile wider than the block taken in passes;
//     one block per SM takes units b, b + G, ... with one thread per
//     device through a two-stage ring: thread 0 brings a unit's
//     contiguous o rows and count rows into shared memory by 1-D bulk
//     copies (TMA) on an mbarrier per stage and table, so the copies of
//     the next unit run under the arithmetic of this one.
//   * Each thread evaluates its device's row in the warp form's order as
//     the resident kernel does (the 32 lane partials in registers, 32
//     independent states a chunk, then halved as __shfl_down_sync would);
//     j, the overlay, assoc, B and lam are read one coalesced element per
//     thread, the next unit's (and its mu[assoc] gather) during this unit.
//   * The visit counts live for the call in an (N, S) scratch of uint16
//     (S = Mp as in the resident layout; exact while max(counts0) + T <=
//     65535) or, past that, float32 (S odd), so 32 rows fall in 32 banks:
//     the call's first slot converts counts0 into it, every slot writes
//     back only the visited entry, the last writes float32 into counts0.
//   * Tile sums run in float64 in a fixed order (groups of 32 devices
//     from the tile's start, each halved as __shfl_down_sync does, then
//     the groups in turn), one partial per tile, whichever block takes it.
//   * K2: every block of slot s + 1 reduces slot s's tile partials in
//     mu_step's order (so all hold the same mu; partials and mu kept by
//     slot parity) while its count copies fly, and block 0 writes
//     mu_seq[s] and lnorm[s]; in the call's last slot the block that
//     draws the last ticket does it.  (A last-block reduction every slot
//     waited behind the next slot's o copies.)
//   * K2-topo: each warp groups its devices by (tile, cloudlet)
//     (__match_any_sync, the leader adding the group in four fixed lane
//     quarters) and warp 0 adds the group sums into the unit's dense
//     float64 K-rows in warp order, in the free part of its o stage where
//     they fit (else in place in device memory); a second launch reduces
//     each cloudlet over the tile rows in topo_cloudlets' order, and its
//     last block forms lnorm.
//   * Slots are programmatic dependent launches: a block sets up its
//     tables, issues its first two o copies and reads its first streams,
//     then waits for the previous slot (griddepcontrol.wait) before it
//     reads counts, lam, mu or partials, and lets the next slot launch
//     once its last unit's data are in.

constexpr int kTiledThreads = 256;  // the widest tiled block

struct TiledLayout {  // byte offsets into a tiled block's dynamic smem
  unsigned long long bar, o, o_stage, cnt, c_stage, hw, os, red, mu, bytes;
};

// Four mbarriers; two stages of `threads` rows of M floats of o (when o
// is (N, M)), each of which after its unit's device phase holds the
// reduction scratch (48 bytes a thread); two stages of as many rows of S
// count entries of `esize` bytes; a 16-byte lead in every stage for a
// start off the 16-byte grid; the (h, w') pairs (a row of them a cell)
// and the shared o; the reduction scratch; with a cell axis, each cell's
// mu of the slot.  Mirrored by onalgo_step.tiled_smem in Python.
__host__ __device__ inline TiledLayout tiled_layout(int threads, int M, int S,
                                                    int esize, bool o_dev,
                                                    int cells) {
  TiledLayout L;
  const unsigned long long n = threads, Mq = (M + 3) / 4 * 4;
  const unsigned long long o_rows = o_dev ? n * M * 4 : 0, red = n * 48;
  unsigned long long at = 0;
  L.bar = res_take(at, 32);
  L.o_stage = ((o_rows > red ? o_rows : red) + 16 + 15) / 16 * 16;
  L.o = res_take(at, 2 * L.o_stage);
  L.c_stage = (n * S * esize + 16 + 15) / 16 * 16;
  L.cnt = res_take(at, 2 * L.c_stage);
  L.hw = res_take(at, Mq * 8 * cells);
  L.os = res_take(at, o_dev ? 0 : Mq * 4);
  L.red = res_take(at, n * 16);
  L.mu = res_take(at, cells > 1 ? (unsigned long long)cells * 4 : 0);
  L.bytes = at;
  return L;
}

struct Tiled {
  void* cnt;             // (N, S) visit counts for the call: uint16 / float32
  float* mus;            // [2]: K2's mu of slots of each parity
  unsigned int* ticket;  // [2], zero between slots: K2's last slot's,
                         // K2-topo's cloudlet pass's last-block tickets
  int S, block_n, tpb, n_tiles;
  int s, first, last;    // the slot; the call's first / last slot
  int G;                 // cells (the sweeps' cell axis; 1 otherwise)
  long long o_cs, h_cs;  // o's and h's cell strides in floats (0: shared)
};

// Thread 0 of any block: a per-slot timestamp (see stamp()).
__device__ __forceinline__ void stamp_here(const Rollout& p, int s, int i) {
  if (p.stamps != nullptr && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p.stamps[(long long)s * kStamps + i] = t;
  }
}

// Thread 0: `bytes` (a multiple of 4) from global `src` (4-byte aligned)
// into shared `dst` (16-byte aligned) by one bulk copy on `bar`.  The copy
// starts at src's 16-byte floor, so src lands at dst + (src & 15); the
// ragged end (under 16 bytes) is copied here and ordered before its use by
// a __syncthreads().
__device__ __forceinline__ void tiled_stage(unsigned char* dst, const void* src,
                                            unsigned long long bytes,
                                            uint32_t bar) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(src);
  const unsigned long long lead = at & 15, total = lead + bytes;
  const unsigned long long bulk = total & ~15ull;
  const unsigned char* src0 = reinterpret_cast<const unsigned char*>(at - lead);
  sm90::fence_proxy_async();
  sm90::mbar_expect_tx(bar, (uint32_t)bulk);
  if (bulk) sm90::bulk_load(sm90::smem_u32(dst), src0, (uint32_t)bulk, bar);
  for (unsigned long long e = bulk; e < total; e += 4)
    *reinterpret_cast<uint32_t*>(dst + e) =
        *reinterpret_cast<const uint32_t*>(src0 + e);
}

// Where a bulk copy of src landed in dst (tiled_stage).
template <typename T>
__device__ __forceinline__ T* staged(unsigned char* dst, const void* src) {
  return reinterpret_cast<T*>(dst + (reinterpret_cast<uintptr_t>(src) & 15));
}

// One step of a block's walk over its units: unit u, pass ps; its
// devices [n, n + rows) of its cell (rows 0: none).
struct TiledItem {
  int u, ps;
  long long n;
  int rows;
};

// The units of cell g are g * upc .. g * upc + upc - 1 (upc units a cell):
// unit u's cell and its first tile in the cell.
__device__ __forceinline__ int unit_cell(int u, const Tiled& a) {
  return u / ((a.n_tiles + a.tpb - 1) / a.tpb);
}
__device__ __forceinline__ int unit_tile(int u, const Tiled& a) {
  const int upc = (a.n_tiles + a.tpb - 1) / a.tpb;
  return (u - u / upc * upc) * a.tpb;
}

// Pass ps of unit u (tpb tiles, or one tile of passes of TW devices).
__device__ __forceinline__ TiledItem tiled_item(int u, int ps, int TW,
                                                const Tiled& a, int N) {
  TiledItem it{u, ps, 0, 0};
  if (u < a.G * ((a.n_tiles + a.tpb - 1) / a.tpb)) {
    const int t0 = unit_tile(u, a);
    const long long bn = a.block_n, d0 = (long long)t0 * bn;
    const long long d1 =
        min((long long)N, (long long)min(a.n_tiles, t0 + a.tpb) * bn);
    it.n = d0 + (long long)ps * TW;
    it.rows = (int)max(0ll, min((long long)TW, d1 - it.n));
  }
  return it;
}

// One device's slot streams.
struct TiledIn {
  int j, a;
  float so, sh, sw, B;
};

template <bool kTopo>
__device__ __forceinline__ TiledIn tiled_in(const Rollout& p, const Topo& q,
                                            int s, int g, long long n,
                                            bool ok) {
  TiledIn r{0, 0, 0.f, 0.f, 0.f, 0.f};
  if (ok) {
    const long long sn = (long long)s * p.N + n;
    r.j = __ldcs(p.j + sn);
    if (p.svo != nullptr) {
      r.so = __ldcs(p.svo + sn);
      r.sh = __ldcs(p.svh + sn);
      r.sw = __ldcs(p.svw + sn);
    }
    r.B = p.B[(long long)g * p.N + n];
    if (kTopo) r.a = q.assoc[s * q.a_ts + n];
  }
  return r;
}

// As res_checked, for the tiled kernels (an absent device reads zeros).
template <bool kTopo>
__device__ __forceinline__ TiledIn tiled_checked(TiledIn r, const Rollout& p,
                                                 const Topo& q) {
  r.j = in_range(r.j, p.M, p.bad, 1);
  if (kTopo) r.a = in_range(r.a, q.K, p.bad, 2);
  return r;
}

// A visit count as float: exact, without the quarter-rate conversion
// (2^23 + c as a float, less 2^23; c < 2^16).
__device__ __forceinline__ float count_f(unsigned short c) {
  return __int_as_float(0x4B000000 | (unsigned)c) - 8388608.f;
}
__device__ __forceinline__ float count_f(float c) { return c; }

// One device's row: counts, o, and the (h, w') pairs, or with kHwDev the
// device's own h and w rows in device memory.
template <typename C, bool kHwDev>
struct TiledRow {
  const C* c;
  const float* o;
  const float2* hw;
  const float* h;
  const float* w;
  int M;
  float lam, mu, inv_t;
};

// State m of a row into (po, ph): o * ry and h * ry, ry = rho where
// lam * o + mu * h < w' (w' = w where w > 0 and -inf elsewhere: the same
// decision as price < w && w > 0).
template <typename C, bool kHwDev>
__device__ __forceinline__ void row_state(const TiledRow<C, kHwDev>& r, int m,
                                          float cm, float& po, float& ph) {
  const float rho = cm * r.inv_t;
  const float o = r.o[m];
  float h, wq;
  if (kHwDev) {
    h = __ldg(r.h + m);
    const float w = __ldg(r.w + m);
    wq = w > 0.f ? w : -INFINITY;
  } else {
    const float2 t = r.hw[m];
    h = t.x;
    wq = t.y;
  }
  const float price = r.lam * o + r.mu * h;
  const float ry = price < wq ? rho : 0.f;
  po += o * ry;
  ph += h * ry;
}

// Columns c0 .. c0 + 31 of a row: lane partial l adds column c0 + l, as
// row_chunk does for the resident kernel (uint16 counts read in pairs).
template <bool kTail, typename C, bool kHwDev>
__device__ __forceinline__ void tiled_chunk(float (&po)[kWarp],
                                            float (&ph)[kWarp],
                                            const TiledRow<C, kHwDev>& r,
                                            int c0) {
#pragma unroll
  for (int l = 0; l < kWarp; l += 2) {
    const int m = c0 + l;
    if (kTail && m >= r.M) break;
    float c_lo, c_hi;
    if constexpr (sizeof(C) == 2) {  // c0 and l even: a 4-byte pair
      const uint32_t cc = *reinterpret_cast<const uint32_t*>(r.c + m);
      c_lo = count_f((unsigned short)(cc & 0xffffu));
      c_hi = count_f((unsigned short)(cc >> 16));
    } else {
      c_lo = count_f(r.c[m]);
      c_hi = kTail && m + 1 >= r.M ? 0.f : count_f(r.c[m + 1]);
    }
    row_state(r, m, c_lo, po[l], ph[l]);
    if (kTail && m + 1 >= r.M) break;
    row_state(r, m + 1, c_hi, po[l + 1], ph[l + 1]);
  }
}

// The (load, lam^2) sums of n tile partials in mu_step's order (lane l
// adds partials l, l + 32, ... in turn, then the lanes are halved), the
// partials brought TW at a time by the whole block into s_p (TW double2);
// every thread gets the sums.
__device__ __forceinline__ double2 tiled_partials(const double* part, int n,
                                                  double2* s_p) {
  const int TW = blockDim.x, tid = threadIdx.x, lane = tid & (kWarp - 1);
  double l = 0.0, q2 = 0.0;
  for (int c0 = 0; c0 < n; c0 += TW) {
    const int nc = min(TW, n - c0);
    if (tid < nc)
      s_p[tid] = make_double2(__ldcg(part + 2 * (c0 + tid)),
                              __ldcg(part + 2 * (c0 + tid) + 1));
    __syncthreads();
    if (tid < kWarp)
      for (int e = lane; e < nc; e += kWarp) {
        l += s_p[e].x;
        q2 += s_p[e].y;
      }
    __syncthreads();
  }
  if (tid < kWarp) {
    l = warp_sum(l);
    q2 = warp_sum(q2);
    if (tid == 0) s_p[0] = make_double2(l, q2);
  }
  __syncthreads();
  const double2 r = s_p[0];
  __syncthreads();
  return r;
}

// kCells: the cell axis (a.G cells; K2 with (M,) h and w only); a single
// call (a.G == 1) takes kCells false.
template <typename C, bool kTopo, bool kHwDev, bool kCells>
__global__ void __launch_bounds__(kTiledThreads, 1)
    onalgo_tiled_kernel(Rollout p, Topo q, Tiled a) {
  static_assert(!kCells || (!kTopo && !kHwDev), "no cell axis here");
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_last;
  __shared__ float s_mu;  // the mu of a single call
  const int TW = blockDim.x, W = TW / kWarp, tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid & (kWarp - 1);
  const int M = p.M, N = p.N, T = p.T, S = a.S, s = a.s, bn = a.block_n;
  const int G = gridDim.x, nG = kCells ? a.G : 1;
  const bool o_dev = p.tb.os != 0;
  const TiledLayout L = tiled_layout(TW, M, S, (int)sizeof(C), o_dev, nG);
  const uint32_t bar0 = sm90::smem_u32(smem + L.bar);  // o: +8b; counts: +16+8b
  float2* s_hw = reinterpret_cast<float2*>(smem + L.hw);
  float* s_os = reinterpret_cast<float*>(smem + L.os);
  float* s_mus =  // [nG] with kCells (the layout has no room for one)
      nG > 1 ? reinterpret_cast<float*>(smem + L.mu) : &s_mu;
  C* const cnt = reinterpret_cast<C*>(a.cnt);
  const float a_t1 = kCells ? 0.f : p.a_seq[s], inv_t = p.inv_t[s];
  auto cell_of = [&](int u) { return kCells ? unit_cell(u, a) : 0; };
  auto o_buf = [&](int b) { return smem + L.o + b * L.o_stage; };
  auto c_buf = [&](int b) { return smem + L.cnt + b * L.c_stage; };
  auto issue_o = [&](const TiledItem& it, int b) {
    if (o_dev && it.rows > 0)
      tiled_stage(o_buf(b),
                  p.tb.o + cell_of(it.u) * a.o_cs + it.n * M,
                  (unsigned long long)it.rows * M * 4, bar0 + 8 * b);
  };
  auto issue_c = [&](const TiledItem& it, int b) {
    if (it.rows > 0)
      tiled_stage(c_buf(b),
                  cnt + ((long long)cell_of(it.u) * N + it.n) * S,
                  (unsigned long long)it.rows * S * sizeof(C),
                  bar0 + 16 + 8 * b);
  };

  // The item after x: its unit's next pass, else the block's next unit
  // (block b takes units b, b + G, ...).
  const int bid = blockIdx.x;
  auto after = [&](const TiledItem& x) {
    const TiledItem y = tiled_item(x.u, x.ps + 1, TW, a, N);
    return y.rows > 0 || x.rows == 0 ? y : tiled_item(x.u + G, 0, TW, a, N);
  };

  // what does not depend on the previous slot: tables, the first two o
  // stages, the first unit's streams
  const int Mq = (M + 3) / 4 * 4;
  if (kCells)
    for (int e = tid; e < nG * Mq; e += TW) {
      const int g = e / Mq, m = e - g * Mq;
      const float w = m < M ? p.tb.w[m] : 0.f;
      s_hw[e] = make_float2(m < M ? p.tb.h[g * a.h_cs + m] : 0.f,
                            w > 0.f ? w : -INFINITY);
    }
  for (int m = tid; m < Mq; m += TW) {
    if (!kHwDev && !kCells) {
      const float w = m < M ? p.tb.w[m] : 0.f;
      s_hw[m] = make_float2(m < M ? p.tb.h[m] : 0.f, w > 0.f ? w : -INFINITY);
    }
    if (!o_dev) s_os[m] = m < M ? p.tb.o[m] : 0.f;
  }
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) sm90::mbar_init(bar0 + 8 * i, 1);
    sm90::fence_mbar_init();
  }
  __syncthreads();
  TiledItem it = tiled_item(bid, 0, TW, a, N);
  TiledItem ahead = after(it);  // the other stage's item
  if (tid == 0) {
    issue_o(it, 0);
    issue_o(ahead, 1);
  }
  TiledIn in = tiled_checked<kTopo>(
      tiled_in<kTopo>(p, q, s, cell_of(it.u), it.n + tid, tid < it.rows),
      p, q);
  const float a_prev = !kCells && s > 0 ? p.a_seq[s - 1] : 0.f,
              H = kCells ? 0.f : p.H[0];

  sm90::grid_dep_wait();  // counts, lam and mu of the previous slot
  stamp(p, s, 0);
  if (s > 0) stamp(p, s - 1, kTopo ? 6 : 4);
  const float mu_prev = kTopo || kCells
                            ? 0.f
                            : __ldcg(a.first ? p.mu : a.mus + ((s & 1) ^ 1));
  // the device's lam and price, each unit's taken during the unit before
  float lam_cur =
      tid < it.rows ? p.lam[(long long)cell_of(it.u) * N + it.n + tid]
                    : 0.f;
  float mu_cur = kTopo && tid < it.rows ? __ldcg(p.mu + in.a) : 0.f;
  if (!a.first && tid == 0) {
    issue_c(it, 0);
    issue_c(ahead, 1);
  }
  // K2: each cell's mu of this slot, from the cell's tile partials of the
  // previous slot, reduced by every block in the same order (so every
  // block holds the same mu) while the count copies fly; block 0 records
  // the previous slot's mu_seq and lnorm, and this slot's mu for the next.
  // Partials [2][G][n_tiles][2] and mus [2][G] by slot parity.
  double2* s_p = reinterpret_cast<double2*>(smem + L.red);
  auto part_of = [&](int slot, int g) {
    return p.partials + 2ll * a.n_tiles * ((long long)nG * (slot & 1) + g);
  };
  float mu_sc = 0.f;
  if (!kTopo && !kCells) {
    if (a.first) {
      mu_sc = mu_prev;
    } else {
      const double2 r = tiled_partials(part_of(s + 1, 0), a.n_tiles, s_p);
      if (tid == 0) {
        s_mu = fmaxf(mu_prev + a_prev * ((float)r.x - H), 0.f);
        if (bid == 0) {
          p.mu_seq[s - 1] = s_mu;
          p.lnorm[s - 1] = sqrtf((float)r.y + s_mu * s_mu);
        }
      }
      __syncthreads();
      mu_sc = s_mu;
    }
    if (bid == 0 && tid == 0) a.mus[s & 1] = mu_sc;
    mu_cur = mu_sc;
    stamp(p, s, 1);
  }
  if (kCells) {
    for (int g = 0; g < nG; ++g) {
      float mu_g = __ldcg(a.first ? p.mu + g
                                  : a.mus + ((s & 1) ^ 1) * a.G + g);
      if (!a.first) {
        const double2 r = tiled_partials(part_of(s + 1, g), a.n_tiles, s_p);
        mu_g = fmaxf(mu_g + p.a_seq[(long long)g * T + s - 1] *
                                ((float)r.x - p.H[g]),
                     0.f);
        if (bid == 0 && tid == 0) {
          p.mu_seq[(long long)g * T + s - 1] = mu_g;
          p.lnorm[(long long)g * T + s - 1] = sqrtf((float)r.y + mu_g * mu_g);
        }
      }
      if (tid == 0) s_mus[g] = mu_g;
      if (bid == 0 && tid == 0) a.mus[(s & 1) * nG + g] = mu_g;
    }
    __syncthreads();
    mu_cur = s_mus[cell_of(it.u)];
    stamp(p, s, 1);
  }
  // K2-topo: a unit's K-rows are summed in the free part of its o stage
  // where they fit, else in place in device memory
  const unsigned long long k_room = L.o_stage - 16 - 48ull * TW;
  auto k_smem = [&](int nt) {
    return bn <= TW && (unsigned long long)nt * q.K * 8 <= k_room;
  };
  double t_l = 0.0, t_q = 0.0;  // thread 0: a tile wider than the block
  for (int i = 0; it.rows > 0; ++i) {
    const int b = i & 1;
    const uint32_t par = (i >> 1) & 1;
    const int rows = it.rows, g = cell_of(it.u);
    const bool ok = tid < rows;
    const long long n = it.n + tid, gn = (long long)g * N;  // in the cell
    unsigned char* s_otile = o_buf(b);
    C* cbase;
    if (a.first) {  // from counts0, converted
      cbase = reinterpret_cast<C*>(c_buf(b));
      const float* src = p.counts + (gn + it.n) * M;
      for (int e = tid; e < rows * M; e += TW) {
        const int r = e / M;
        cbase[r * S + e - r * M] = (C)src[e];
      }
    } else {
      cbase = staged<C>(c_buf(b), cnt + (gn + it.n) * S);
    }
    __syncthreads();  // the converted rows; the copies' ragged ends
    if (o_dev) sm90::mbar_wait(bar0 + 8 * b, par);
    if (!a.first) sm90::mbar_wait(bar0 + 16 + 8 * b, par);
    if (ahead.rows == 0) sm90::grid_dep_launch();  // the block's last item
    const int g_ahead = cell_of(ahead.u);
    const TiledIn nin = tiled_in<kTopo>(p, q, s, g_ahead, ahead.n + tid,
                                        tid < ahead.rows);
    const float* obase =
        o_dev ? staged<const float>(s_otile, p.tb.o + g * a.o_cs + it.n * M)
              : s_os;

    float sh = 0.f;
    double v_l = 0.0, v_q = 0.0;
    if (ok) {
      C* crow = cbase + tid * S;
      const C c = (C)(crow[in.j] + 1);
      crow[in.j] = c;
      if (!a.first && !a.last) cnt[(gn + n) * S + in.j] = c;
      const float lam = lam_cur;
      const float mu_n = mu_cur;
      const float* orow = o_dev ? obase + tid * M : obase;
      const float* hrow = p.tb.h + n * p.tb.hs;
      const float2* hw = s_hw + g * Mq;
      const float* wrow = p.tb.w + n * p.tb.ws;
      const TiledRow<C, kHwDev> r{crow, orow, hw,   hrow, wrow,
                                  M,    lam,  mu_n, inv_t};
      float po[kWarp], ph[kWarp];
#pragma unroll
      for (int l = 0; l < kWarp; ++l) po[l] = ph[l] = 0.f;
      int c0 = 0;
      for (; c0 + kWarp <= M; c0 += kWarp) tiled_chunk<false>(po, ph, r, c0);
      if (c0 < M) tiled_chunk<true>(po, ph, r, c0);
      halve<16>(po, ph);
      halve<8>(po, ph);
      halve<4>(po, ph);
      halve<2>(po, ph);
      halve<1>(po, ph);
      const float so = po[0];
      sh = ph[0];
      float o_now, h_now, w_now;
      bool task;
      if (p.svo != nullptr) {
        o_now = in.so;
        h_now = in.sh;
        w_now = in.sw;
        task = in.j > 0;
      } else {  // w' <= 0 only where it is -inf: the same decision
        o_now = orow[in.j];
        h_now = kHwDev ? hrow[in.j] : hw[in.j].x;
        w_now = kHwDev ? wrow[in.j] : hw[in.j].y;
        task = true;
      }
      const float price_now = lam * o_now + mu_n * h_now;
      p.off[((long long)g * T + s) * N + n] =
          (price_now < w_now && w_now > 0.f && task) ? 1 : 0;
      const float a_t = kCells ? p.a_seq[(long long)g * T + s] : a_t1;
      const float lam_new = fmaxf(lam + a_t * (so - in.B), 0.f);
      p.lam[gn + n] = lam_new;
      v_l = (double)sh;
      v_q = (double)(lam_new * lam_new);
    }
    if (tid < ahead.rows) {
      lam_cur = p.lam[(long long)g_ahead * N + ahead.n + tid];
      if (kTopo) mu_cur = __ldcg(p.mu + in_range(nin.a, q.K, p.bad, 2));
    }
    if (kCells && ahead.rows > 0) mu_cur = s_mus[g_ahead];
    // the unit's first tile in its cell
    const int tb0 = kCells ? unit_tile(it.u, a) : it.u * a.tpb;
    const int nt = min(a.n_tiles - tb0, a.tpb);
    const bool krow_here = kTopo && k_smem(nt);
    if (kTopo && !krow_here && it.ps == 0)  // the unit's K-rows, zeroed
      for (long long e = tid; e < (long long)nt * q.K; e += TW)
        __stcg(q.kpart + (long long)tb0 * q.K + e, 0.0);
    __syncthreads();  // the device phase is done: the o rows turn scratch
    if (ahead.rows == 0) stamp(p, s, kTopo ? 1 : 2);
    double2* s_v = reinterpret_cast<double2*>(s_otile);  // [TW]
    double2* s_g = s_v + TW;                              // [TW] group sums
    int* s_lkey = reinterpret_cast<int*>(s_g + TW);       // [W][32]
    double* s_lval = reinterpret_cast<double*>(s_lkey + TW);  // [W][32]
    double* s_krow = s_lval + TW;  // [nt][K] where k_smem(nt)
    s_v[tid] = make_double2(v_l, v_q);
    if (krow_here)
      for (int e = tid; e < nt * q.K; e += TW) s_krow[e] = 0.0;
    const int i0 = it.ps * TW;     // the item's first device in its unit
    if (kTopo) {  // group the warp's devices by (tile, cloudlet)
      const int key = ok ? (i0 + tid) / bn * q.K + in.a : -1;
      double* lval = s_lval + warp * kWarp;
      lval[lane] = (double)sh;
      __syncwarp();
      const unsigned peers = __match_any_sync(kFull, key);
      const int leader = __ffs(peers) - 1;
      double sum = (double)sh;
      if (lane == leader && __popc(peers) > 1) {
        double qs[4] = {0.0, 0.0, 0.0, 0.0};  // lane quarters
#pragma unroll
        for (int k = 0; k < kWarp; ++k)
          if ((peers >> k) & 1u) qs[k >> 3] += lval[k];
        sum = (qs[0] + qs[1]) + (qs[2] + qs[3]);
      }
      __syncwarp();
      s_lkey[tid] = (lane == leader && key >= 0) ? key : -1;
      if (lane == leader) lval[lane] = sum;
    }
    __syncthreads();
    // group sums: groups of 32 devices from each tile's start
    const int gpt = (bn + kWarp - 1) / kWarp;  // groups a tile
    const int nu = i0 + rows;  // the unit's devices up to this item's end
    const int ng = bn <= TW ? nt * gpt : (rows + kWarp - 1) / kWarp;
    for (int g = warp; g < ng; g += W) {
      int lo, hi;  // unit-local devices of group g
      if (bn <= TW) {
        const int t = g / gpt;
        lo = t * bn + (g - t * gpt) * kWarp;
        hi = min(min(lo + kWarp, (t + 1) * bn), nu);
      } else {
        lo = i0 + g * kWarp;
        hi = min(lo + kWarp, nu);
      }
      double l = 0.0, q2 = 0.0;
      if (lo + lane < hi) {
        const double2 v = s_v[lo + lane - i0];
        l = v.x;
        q2 = v.y;
      }
      l = warp_sum(l);
      q2 = warp_sum(q2);
      if (lane == 0) s_g[g] = make_double2(l, q2);
    }
    if (kTopo && warp == 0) {  // the K-rows, in warp order
      double* krow = q.kpart + (long long)tb0 * q.K;
      for (int w = 0; w < W; ++w) {
        const int key = s_lkey[w * kWarp + lane];
        if (key >= 0 && krow_here)
          s_krow[key] += s_lval[w * kWarp + lane];
        else if (key >= 0)
          __stcg(krow + key, __ldcg(krow + key) + s_lval[w * kWarp + lane]);
        __syncwarp();
      }
    }
    __syncthreads();
    if (krow_here)
      for (int e = tid; e < nt * q.K; e += TW)
        __stcg(q.kpart + (long long)tb0 * q.K + e, s_krow[e]);
    const bool unit_done = ahead.u != it.u;
    double* const part = part_of(s, g);
    if (bn <= TW) {  // one partial per tile, its groups in turn
      if (tid < nt) {
        double l = 0.0, q2 = 0.0;
        for (int g = tid * gpt; g < (tid + 1) * gpt; ++g) {
          l += s_g[g].x;
          q2 += s_g[g].y;
        }
        if (kTopo) {
          __stcg(q.lam2p + tb0 + tid, q2);
        } else {
          __stcg(part + 2 * (tb0 + tid), l);
          __stcg(part + 2 * (tb0 + tid) + 1, q2);
        }
      }
    } else if (tid == 0) {
      if (it.ps == 0) t_l = t_q = 0.0;
      for (int g = 0; g < ng; ++g) {
        t_l += s_g[g].x;
        t_q += s_g[g].y;
      }
      if (unit_done) {
        if (kTopo) {
          __stcg(q.lam2p + tb0, t_q);
        } else {
          __stcg(part + 2 * tb0, t_l);
          __stcg(part + 2 * tb0 + 1, t_q);
        }
      }
    }
    if (a.last) {  // the call's counts back into counts0
      float* dst = p.counts + (gn + it.n) * M;
      for (int e = tid; e < rows * M; e += TW) {
        const int r = e / M;
        dst[e] = (float)cbase[r * S + e - r * M];
      }
    } else if (a.first) {  // the whole rows into the scratch
      C* dst = cnt + (gn + it.n) * S;
      for (int e = tid; e < rows * S; e += TW) dst[e] = cbase[e];
    }
    __syncthreads();  // before the stage takes the item two ahead
    const TiledItem nxt = after(ahead);
    if (tid == 0) {
      issue_o(nxt, b);
      if (!a.first) issue_c(nxt, b);
    }
    it = ahead;
    ahead = nxt;
    in = tiled_checked<kTopo>(nin, p, q);
  }
  if (kTopo) {
    stamp(p, s, 2);
    return;
  }
  stamp(p, s, 3);
  if (!a.last) return;
  // the call's last slot: the block that finishes last reduces its
  // partials into the final mu
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (!kCells) {
    const double2 r = tiled_partials(part_of(s, 0), a.n_tiles, s_p);
    if (tid == 0) {
      const float mu_new = fmaxf(mu_sc + a_t1 * ((float)r.x - H), 0.f);
      p.mu_seq[s] = mu_new;
      p.lnorm[s] = sqrtf((float)r.y + mu_new * mu_new);
      *p.mu = mu_new;
    }
    return;
  }
  for (int g = 0; g < nG; ++g) {
    const double2 r = tiled_partials(part_of(s, g), a.n_tiles, s_p);
    if (tid == 0) {
      const long long gs = (long long)g * T + s;
      const float mu_new =
          fmaxf(s_mus[g] + p.a_seq[gs] * ((float)r.x - p.H[g]), 0.f);
      p.mu_seq[gs] = mu_new;
      p.lnorm[gs] = sqrtf((float)r.y + mu_new * mu_new);
      p.mu[g] = mu_new;
    }
  }
}

// Sum x[0], x[stride], ... (n terms) in that order, 32 loads in flight.
__device__ __forceinline__ double strided_sum(const double* x, int n,
                                              long long stride) {
  double acc = 0.0;
  for (int i0 = 0; i0 < n; i0 += kWarp) {
    double v[kWarp];
#pragma unroll
    for (int u = 0; u < kWarp; ++u)
      v[u] = i0 + u < n ? __ldcg(x + (long long)(i0 + u) * stride) : 0.0;
#pragma unroll
    for (int u = 0; u < kWarp; ++u)
      if (i0 + u < n) acc += v[u];
  }
  return acc;
}

// K2-topo's second launch a slot: block r takes cloudlets [32 r, 32 r +
// 32) in topo_cloudlets' order (warp w adds tile rows w, w + 16, ... in
// turn, the 16 warp sums are added in warp order), with the loads of 32
// rows and the cloudlets' mu in flight together, and their mu_k ascent;
// the block that finishes last forms lnorm in topo_lnorm's order.
__global__ void __launch_bounds__(kThreads)
    onalgo_tiled_cloudlets(Rollout p, Topo q, Tiled a) {
  __shared__ double s_red[kWarps][kWarp];
  __shared__ int s_last;
  const int s = a.s, G = a.n_tiles, K = q.K;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x & (kWarp - 1);
  const int k = blockIdx.x * kWarp + lane;
  const float a_t = p.a_seq[s], H_k = k < K ? q.H_k[k] : 0.f;
  sm90::grid_dep_wait();  // the device pass's K-rows and lam^2 partials
  sm90::grid_dep_launch();
  stamp(p, s, 3);
  const float mu_k = warp == 0 && k < K ? __ldcg(p.mu + k) : 0.f;
  const int rows = warp < G ? (G - warp + kWarps - 1) / kWarps : 0;
  s_red[warp][lane] =
      k < K ? strided_sum(q.kpart + (long long)warp * K + k, rows,
                              (long long)kWarps * K)
            : 0.0;
  __syncthreads();
  if (warp == 0) {
    double load = 0.0;
    for (int w = 0; w < kWarps; ++w) load += s_red[w][lane];
    double v = 0.0;
    if (k < K) {
      const float mu_new = fmaxf(mu_k + a_t * ((float)load - H_k), 0.f);
      __stcg(p.mu + k, mu_new);
      p.mu_seq[(long long)s * K + k] = mu_new;
      v = (double)(mu_new * mu_new);
    }
    v = warp_sum(v);
    if (lane == 0) {
      __stcg(q.mu2p + blockIdx.x, v);
      __threadfence();
      s_last = atomicAdd(a.ticket + 1, 1u) == gridDim.x - 1;
    }
  }
  stamp(p, s, 4);
  __syncthreads();
  if (s_last && warp == 0) {
    __threadfence();
    const int n_red = gridDim.x;  // lane-strided, then halved
    const int nl = lane < G ? (G - lane + kWarp - 1) / kWarp : 0;
    const int nm = lane < n_red ? (n_red - lane + kWarp - 1) / kWarp : 0;
    const double lam2 = warp_sum(strided_sum(q.lam2p + lane, nl, kWarp));
    const double mu2 = warp_sum(strided_sum(q.mu2p + lane, nm, kWarp));
    if (lane == 0) {
      p.lnorm[s] = sqrtf((float)lam2 + (float)mu2);
      a.ticket[1] = 0;
      stamp_here(p, s, 5);
    }
  }
}

using TiledFn = void (*)(Rollout, Topo, Tiled);

template <typename C>
TiledFn tiled_fn_of(bool topo, bool hw_dev, bool cells) {
  if (cells) return &onalgo_tiled_kernel<C, false, false, true>;
  if (topo)
    return hw_dev ? &onalgo_tiled_kernel<C, true, true, false>
                  : &onalgo_tiled_kernel<C, true, false, false>;
  return hw_dev ? &onalgo_tiled_kernel<C, false, true, false>
                : &onalgo_tiled_kernel<C, false, false, false>;
}

// The instance for the counts' type, the topology form, per-device h / w
// and the cell axis.
TiledFn tiled_fn(bool cnt16, bool topo, bool hw_dev, bool cells) {
  return cnt16 ? tiled_fn_of<unsigned short>(topo, hw_dev, cells)
               : tiled_fn_of<float>(topo, hw_dev, cells);
}

// One launch, with the programmatic-serialization attribute when `pdl`.
template <typename... Args>
cudaError_t launch_ex(void (*fn)(Args...), int grid, int threads,
                      size_t smem, cudaStream_t st, bool pdl, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, fn, args...);
}

Rollout make_rollout(const int* j, const float* svo, const float* svh,
                     const float* svw, const float* o, long long os,
                     const float* h, long long hs, const float* w,
                     long long ws, const float* B, const float* H,
                     const float* a_seq, const float* inv_t, float* lam,
                     float* mu, float* counts, unsigned char* off,
                     float* mu_seq, float* lnorm, double* partials, int T,
                     int N, int M, int* bad) {
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
  p.bad = bad;
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

// K3 with TW devices a block and rows in chunks of CM columns (CM == M:
// whole rows), as onalgo_step.duals_plan chooses; `done` is a counter that
// is zero between calls and that no concurrent call shares.
int onalgo_duals_launch(const float* lam, const float* mu, const float* rho,
                        const float* o, long long os, const float* h,
                        long long hs, const float* w, long long ws,
                        const float* B, float* g_pow, double* load_part,
                        unsigned* done, float* load, int N, int M, int TW,
                        int CM, void* stream) {
  if (N < 1 || TW < kWarp || TW > kDualsRows || TW % kWarp || CM < 1 ||
      CM > M || (CM < M && CM % kWarp))
    return (int)cudaErrorInvalidValue;
  const unsigned smem = duals_layout(TW, M, CM, os != 0).bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        onalgo_duals_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  onalgo_duals_kernel<<<(N + TW - 1) / TW, TW, smem, (cudaStream_t)stream>>>(
      lam, mu, rho, Tables{o, os, h, hs, w, ws}, B, g_pow, load_part, done,
      load, N, M, TW, CM);
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
                          int N, int M, int* bad, unsigned long long* stamps,
                          int grid, void* stream) {
  Rollout p = make_rollout(j, svo, svh, svw, o, os, h, hs, w, ws, B, H, a_seq,
                           inv_t, lam, mu, counts, off, mu_seq, lnorm,
                           partials, T, N, M, bad);
  p.stamps = stamps;
  void* args[] = {&p};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)onalgo_chunked_kernel, dim3(grid), dim3(kThreads), args, 0,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
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
    double* partials, int T, int N, int M, int* bad, const int* assoc,
    long long a_ts, const float* H_k, double* kpart, double* lam2p,
    double* mu2p, int K, unsigned long long* stamps, int per, int warps,
    int grid, void* stream) {
  if (hs != 0 || ws != 0 || warps < 1 || warps > kResMaxWarps || per % kWarp)
    return (int)cudaErrorInvalidValue;
  Rollout p = make_rollout(j, svo, svh, svw, o, os, h, hs, w, ws, B, H, a_seq,
                           inv_t, lam, mu, counts, off, mu_seq, lnorm,
                           partials, T, N, M, bad);
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

// Dynamic shared memory of the cell-axis kernel (cells_layout).
long long onalgo_cells_smem(int per, int M, int gw, int P, int S, int V,
                            int o_dev) {
  return (long long)cells_layout(per, M, gw, P, S, V, o_dev != 0).bytes;
}

// K1 with a cell axis: G cells of Gc virtual blocks of `per` devices, V
// virtual blocks a physical block, `grid` = ceil(G Gc / V) cooperative
// blocks of P lane groups of gw threads (gw = min(per, the single call's
// block), a multiple of 32), S o' stages a group.  Per cell: B, lam (G,
// N), H, mu (G,), a_seq, mu_seq, lnorm (G, T), counts (G, N, M), off (G,
// T, N); o at cell stride o_cs (16-byte aligned; 0 shared) and row stride
// os; h (M,) at cell stride h_cs; w (M,); j and inv_t shared; partials
// [2][G Gc][2]; stamps (T, kStamps) or nullptr (block 0's group 0).
int onalgo_cells_launch(
    const int* j, const float* o, long long os, long long o_cs,
    const float* h, long long h_cs, const float* w, const float* B,
    const float* H, const float* a_seq, const float* inv_t, float* lam,
    float* mu, float* counts, unsigned char* off, float* mu_seq, float* lnorm,
    double* partials, int T, int N, int M, int* bad, int G, int Gc, int V,
    int per, int gw, int P, int S, unsigned long long* stamps, void* stream) {
  if (G < 1 || Gc < 1 || V < 1 || per % kWarp || gw < kWarp || gw % kWarp ||
      gw > per || gw > kResMaxWarps * kWarp || P < 1 ||
      P > kCellsMaxGroups || P > V || P * gw > kCellsMaxThreads || S < 1 ||
      (o_cs * 4) % 16 || (os == 0 && o_cs != 0))
    return (int)cudaErrorInvalidValue;
  Rollout p = make_rollout(j, nullptr, nullptr, nullptr, o, os, h, 0, w, 0,
                           B, H, a_seq, inv_t, lam, mu, counts, off, mu_seq,
                           lnorm, partials, T, N, M, bad);
  p.stamps = stamps;
  Cells c{G, Gc, V, per, gw, P, S, o_cs, h_cs};
  const size_t smem = cells_layout(per, M, gw, P, S, V, os != 0).bytes;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)onalgo_cells_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&p, &c};
  const int grid = (G * Gc + V - 1) / V;
  e = cudaLaunchCooperativeKernel((const void*)onalgo_cells_kernel,
                                  dim3(grid), dim3(P * gw), args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Largest K whose dense shared row fits a block of the streaming K1-topo
// kernel (opt-in shared memory less its static shared memory); the
// topology wrappers take no larger K.
int onalgo_topo_max_k(int* out) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&attr, onalgo_chunked_topo_kernel);
  if (e != cudaSuccess) return (int)e;
  *out = (int)((optin - (long long)attr.sharedSizeBytes) /
               (long long)sizeof(double));
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
    double* partials, int T, int N, int M, int* bad, const int* assoc,
    long long a_ts, const float* H_k, float* rowload, double* kpart,
    double* lam2p, double* mu2p, int K, unsigned long long* stamps, int grid,
    void* stream) {
  Rollout p = make_rollout(j, svo, svh, svw, o, os, h, hs, w, ws, B, H, a_seq,
                           inv_t, lam, mu, counts, off, mu_seq, lnorm,
                           partials, T, N, M, bad);
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

// K2 (K = 0) or K2-topo over T slots: per slot one launch of `grid`
// blocks of `threads` threads walking units of `tpb` tiles of block_n
// devices (K2-topo: and one launch of the cloudlet pass).  `cnt` is the
// (G N, S) count scratch (uint16 when cnt16, else float32); `ticket` two
// zeroed ints; `mus` 2 G floats.  Every launch after the call's first is a
// programmatic dependent launch.  G > 1 (K2 only) is the sweeps' cell
// axis: per cell B, lam (G, N), H, mu (G,), a_seq, mu_seq, lnorm (G, T),
// counts (G, N, M), off (G, T, N), partials [2][G][n_tiles][2]; o and
// the (M,) h at cell strides o_cs and h_cs (0: shared); w and h (M,) only
// (the (N, M) h / w kernels take no cell axis).
int onalgo_tiled_launch(
    const int* j, const float* svo, const float* svh, const float* svw,
    const float* o, long long os, const float* h, long long hs,
    const float* w, long long ws, const float* B, const float* H,
    const float* a_seq, const float* inv_t, float* lam, float* mu,
    float* counts, unsigned char* off, float* mu_seq, float* lnorm,
    double* partials, int T, int N, int M, int* bad, const int* assoc,
    long long a_ts, const float* H_k, double* kpart, double* lam2p,
    double* mu2p, int K, void* cnt, int cnt16, int S, int block_n, int tpb,
    int threads, int grid, float* mus, unsigned int* ticket, unsigned long long* stamps,
    int G, long long o_cs, long long h_cs, void* stream) {
  if (threads < kWarp || threads > kTiledThreads || threads % kWarp ||
      block_n < 1 || tpb < 1 || (block_n > threads && tpb != 1) || grid < 1 ||
      G < 1 || (G > 1 && (K || hs || ws)))
    return (int)cudaErrorInvalidValue;

  Rollout p = make_rollout(j, svo, svh, svw, o, os, h, hs, w, ws, B, H, a_seq,
                           inv_t, lam, mu, counts, off, mu_seq, lnorm,
                           partials, T, N, M, bad);
  p.stamps = stamps;
  Topo q = make_topo(assoc, a_ts, H_k, nullptr, kpart, lam2p, mu2p, K);
  const TiledFn fn = tiled_fn(cnt16 != 0, K != 0, hs != 0 || ws != 0, G > 1);
  const size_t smem =
      tiled_layout(threads, M, S, cnt16 ? 2 : 4, os != 0, G).bytes;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = (int)(((long long)N + block_n - 1) / block_n);
  const int n_red = (K + kWarp - 1) / kWarp;
  cudaStream_t st = (cudaStream_t)stream;
  for (int s = 0; s < T && e == cudaSuccess; ++s) {
    const Tiled a{cnt, mus,     ticket, S,      block_n,    tpb,  n_tiles,
                  s,   s == 0,  s == T - 1,    G,  o_cs, h_cs};
    e = launch_ex(fn, grid, threads, smem, st, s > 0, p, q, a);
    if (e == cudaSuccess && K)
      e = launch_ex(onalgo_tiled_cloudlets, n_red, kThreads, 0, st, true, p,
                    q, a);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a tiled block (tiled_layout).
long long onalgo_tiled_smem(int threads, int M, int S, int esize, int o_dev,
                            int cells) {
  return (long long)tiled_layout(threads, M, S, esize, o_dev != 0, cells)
      .bytes;
}

}  // extern "C"
