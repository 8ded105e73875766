// Hand-written Hopper (sm_90a) kernel for the Mamba2 / SSD chunk (K4).
//
// Replaces the Pallas TPU kernel
//   ssd_chunk_kernel  <- src/repro/kernels/ssd_chunk.py ssd_chunk_pallas
//                        (_ssd_kernel)
// and computes what its body computes, for one (batch * chunk) cell of
// Q <= 128 positions and each head:
//   xbar = x * dt,  cs = cumsum(dt * A),  decay = exp(cs[Q-1] - cs),
//   S = C B^T,  y_diag[i, :] = sum_{j <= i} S[i, j] exp(cs[i] - cs[j]) xbar[j, :],
//   states[:, :] = (xbar * decay)^T B.
// Layouts are the model's: x and y (BC, Q, H, P), dt (BC, Q, H), A (H,),
// B and C (BC, Q, G, N) with G dividing H (G == H is the reference's
// head-expanded form; head h reads group h / (H / G)), states
// (BC, H, P, N); all contiguous, float32.
//
// What bounds it on the card.  Per (cell, head) the causal products need
// (N + P) Q (Q + 1) + 2 Q P N flops against x, dt, B, C read once and y,
// states written once.  At mamba2-370m's long forward (BC = 4 x 16 chunks
// of Q = 128, H = 32, P = 64, N = 128, G = 1) that is 10.8 GFLOP against
// 211 MB: 0.063 ms at 3.35 TB/s, while the products at the tensor cores'
// tf32 rate taken three times (below) need 0.066 ms, and 0.161 ms on the
// CUDA cores.  At the serving wave (BC = 16, Q = 16) the bytes bound: 21 MB,
// mostly the states written.
//
// Arithmetic: 3xTF32 on the tensor cores (mma.sync m16n8k8).  Every
// operand is split into hi = v rounded to tf32 and lo = v - hi truncated
// to tf32 (sm90.cuh::split_tf32) and a product is taken as hi*hi + hi*lo
// + lo*hi with float32 accumulation: about 2^-21 of each product, where
// tf32 alone (2^-11) misses the float32 bar of rtol = atol = 1e-4 and bf16
// hi + lo (2^-17 per operand) barely holds it (tests/test_torch_ssm.py
// emulates the schemes on the CPU).
//
// Design:
//   * one block of 8 warps takes a cell, a group and a run of `hb` heads of
//     that group (ssd_chunk.ssd_plan in Python picks hb), so C B^T is formed
//     once per block and shared by its heads.  Warp w owns the 16-row strip
//     w (w < 4) or 11 - w of S, so the two warps of each SM sub-partition
//     hold strips k and 7 - k: the causal work is even across the four
//     tensor units.  A strip's S (its causal n8 tiles only) stays in the
//     warp's accumulator registers for all the block's heads.
//   * B and C arrive by TMA (tensor maps over the model's layout, boxes of
//     32 columns and Q rows, 128-byte swizzled so that every fragment load
//     below hits 32 distinct banks; rows past Q and columns past N arrive
//     as zeros) on an mbarrier; the block's dt columns are read once, and
//     each head's cumsum is one warp's shuffle scan.
//   * per unit (a head, and a column chunk of at most 64 of its P): its x
//     tile arrives the same way into a two-slot ring, the next unit's tile
//     in flight while this one computes.  xbar = x * dt and xbar * decay are
//     formed while the fragments are loaded, never stored.  y: the strip's
//     S tiles times L, masked, become the A operand in registers (the
//     accumulator layout read as a tf32 A fragment with its k order
//     permuted, the same permutation on x's rows; dt folded into L), times
//     x.  states: (x * dt * decay)^T B, the P x N output split over the 8
//     warps, with B split into its tf32 hi and lo parts once per block
//     (the lo parts where C was, once C B^T is formed).
//   * no product is under a runtime condition (a guarded mma.sync costs a
//     branch and a warp sync each): the column chunk is a template
//     parameter, and tiles past a warp's range are computed on valid rows
//     and not stored.
//   * Q is padded to a multiple of 16 and N to 32 with those zeros, and
//     only rows < Q and columns < N are written back.
// The order of every sum is fixed by the code and independent of hb, so a
// head's result is the same bits whether its group is shared or not.
//
// Plain C interface for ctypes: the entry point returns the CUDA error
// code of its launch (0 = success) and allocates nothing.  The tensor maps
// are encoded on the host for each call through the driver entry point
// that the runtime hands out (cudaGetDriverEntryPoint).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxQ = 128;
constexpr int kMaxN = 128;
constexpr int kStrips = kMaxQ / 16;    // 16-row strips of S
constexpr int kMaxHeads = 2 * kWarps;  // heads a block
constexpr int kPC = 64;                // head-dim columns a unit
constexpr float kLog2e = 1.4426950408889634f;

struct SsdLayout {  // byte offsets from the 1024-byte-aligned base
  int QP, NB, XB, PC;
  unsigned Bs, Cs, X, dt, cs, dec, bars, bytes;
};

__host__ __device__ inline unsigned take(unsigned& at, unsigned n) {
  const unsigned here = at;
  at += (n + 15) / 16 * 16;
  return here;
}

// B, C and the two x slots are stacks of 32-float boxes of QP rows (the
// TMA boxes, 128-byte swizzled, each a multiple of 1024 bytes); then dt, cs
// and decay of the block's heads and the three mbarriers.  The dynamic
// size adds 1024 bytes for aligning the base.  Mirrored by
// ssd_chunk.ssd_smem in Python.
__host__ __device__ inline SsdLayout ssd_layout(int Q, int P, int N, int hb) {
  SsdLayout L;
  L.QP = (Q + 15) / 16 * 16;
  L.NB = (N + 31) / 32;
  L.PC = P < kPC ? P : kPC;
  L.XB = (L.PC + 31) / 32;
  const unsigned box = 128u * L.QP;
  unsigned at = 0;
  L.Bs = take(at, L.NB * box);
  L.Cs = take(at, L.NB * box);
  L.X = take(at, 2 * L.XB * box);
  L.dt = take(at, 4u * hb * L.QP);
  L.cs = take(at, 4u * hb * L.QP);
  L.dec = take(at, 4u * hb * L.QP);
  L.bars = take(at, 3 * 8);
  L.bytes = at + 1024;
  return L;
}

// Float offset of element (r, c) in a stack of 32-float boxes of QP rows
// written by TMA with the 128-byte swizzle (16-byte chunk (c / 4) % 8 of
// row r sits at chunk ((c / 4) % 8) ^ (r % 8)), less r * 32: the part that
// depends on the column and on r % 8 = rr only, so that a loop over rows of
// one residue adds r * 32 to a value it computes once.  Every fragment
// load below hits 32 distinct banks.
__device__ __forceinline__ int swc(int c, int rr, int QP) {
  return (c >> 5) * QP * 32 + ((((c >> 2) & 7) ^ rr) << 2) + (c & 3);
}

// exp(d) as 2^(d log2 e) on the special-function unit (about 2 ulp).
__device__ __forceinline__ float exp_sfu(float d) {
  return sm90::ex2_approx(d * kLog2e);
}

__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) sm90::split_tf32(v[r], hi[r], lo[r]);
}

// d[q] += a b[q] in 3xTF32 for the NQ tiles, b[q] given as its tf32 hi
// and lo parts: hi_a lo_b, lo_a hi_b and hi_a hi_b, each pass over every
// tile before the next, so no product waits on the one before it in the
// same accumulator.  No product is under a condition: a guarded mma.sync
// costs a branch and a warp sync each.
template <int NQ>
__device__ __forceinline__ void mma3(float (&d)[NQ][4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[NQ][2],
                                     const uint32_t (&bl)[NQ][2]) {
#pragma unroll
  for (int q = 0; q < NQ; ++q)
    sm90::mma_tf32_1688(d[q], ah, bl[q][0], bl[q][1]);
#pragma unroll
  for (int q = 0; q < NQ; ++q)
    sm90::mma_tf32_1688(d[q], al, bh[q][0], bh[q][1]);
#pragma unroll
  for (int q = 0; q < NQ; ++q)
    sm90::mma_tf32_1688(d[q], ah, bh[q][0], bh[q][1]);
}

// The same with b[q] = (b0[q], b1[q]) split here.
template <int NQ>
__device__ __forceinline__ void mma3(float (&d)[NQ][4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const float (&b0)[NQ],
                                     const float (&b1)[NQ]) {
  uint32_t bh[NQ][2], bl[NQ][2];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    sm90::split_tf32(b0[q], bh[q][0], bl[q][0]);
    sm90::split_tf32(b1[q], bh[q][1], bl[q][1]);
  }
  mma3<NQ>(d, ah, al, bh, bl);
}

// Thread 0: bring unit u's x tile (head h0 + u / nchunk, columns
// (u % nchunk) * PC ..) into ring slot u & 1, one TMA box of 32 columns and
// QP rows (rows past Q and columns past P arrive as zeros) at a time.
__device__ __forceinline__ void issue_x(const SsdLayout& L, float* Xs,
                                        uint32_t bar_x, const CUtensorMap* tx,
                                        int bc, int u, int nchunk, int h0) {
  const int slot = u & 1, hd = h0 + u / nchunk, c0 = (u % nchunk) * L.PC;
  const uint32_t bar = bar_x + 8 * slot;
  float* dst = Xs + slot * L.XB * L.QP * 32;
  sm90::fence_proxy_async();  // the slot was last read by generic loads
  sm90::mbar_expect_tx(bar, 128u * L.QP * L.XB);
  for (int b = 0; b < L.XB; ++b)
    sm90::tma_load_4d(sm90::smem_u32(dst + b * L.QP * 32), tx, bar,
                      c0 + 32 * b, hd, 0, bc);
}

template <int PC>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_chunk_kernel(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tb,
                     const __grid_constant__ CUtensorMap tc,
                     const float* __restrict__ dt,
                     const float* __restrict__ A, float* __restrict__ y,
                     float* __restrict__ st, int Q, int H, int G, int P,
                     int N, int hb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  const SsdLayout L = ssd_layout(Q, P, N, hb);
  const int QP = L.QP;
  constexpr int MT = PC / 16, nstep = kWarps / MT;  // states' row tiles
  float* Bs = reinterpret_cast<float*>(smem + L.Bs);      // NB boxes
  float* Cs = reinterpret_cast<float*>(smem + L.Cs);      // NB boxes
  float* Xs = reinterpret_cast<float*>(smem + L.X);       // [2][XB boxes]
  float* s_dt = reinterpret_cast<float*>(smem + L.dt);    // [hb][QP]
  float* s_cs = reinterpret_cast<float*>(smem + L.cs);    // [hb][QP]
  float* s_dec = reinterpret_cast<float*>(smem + L.dec);  // [hb][QP] dt decay
  // mbarriers: B and C; the two x slots
  const uint32_t bar_bc = sm90::smem_u32(smem + L.bars), bar_x = bar_bc + 8;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int hpg = H / G, nb = (hpg + hb - 1) / hb;
  const int hblk = blockIdx.x % nb, grp = (blockIdx.x / nb) % G;
  const int bc = blockIdx.x / nb / G;
  const int h0 = grp * hpg + hblk * hb, nh = min(hb, hpg - hblk * hb);
  const int nchunk = P / PC, U = nh * nchunk;

  if (tid == 0) {
    sm90::mbar_init(bar_bc, 1);
    sm90::mbar_init(bar_x, 1);
    sm90::mbar_init(bar_x + 8, 1);
    sm90::fence_mbar_init();
    sm90::mbar_expect_tx(bar_bc, 2u * 128u * QP * L.NB);
    for (int b = 0; b < L.NB; ++b) {
      sm90::tma_load_4d(sm90::smem_u32(Bs + b * QP * 32), &tb, bar_bc, 32 * b,
                        grp, 0, bc);
      sm90::tma_load_4d(sm90::smem_u32(Cs + b * QP * 32), &tc, bar_bc, 32 * b,
                        grp, 0, bc);
    }
    issue_x(L, Xs, bar_x, &tx, bc, 0, nchunk, h0);
    if (U > 1) issue_x(L, Xs, bar_x, &tx, bc, 1, nchunk, h0);
  }
  for (int e = tid; e < QP * nh; e += kThreads) {
    const int j = e / nh, k = e - j * nh;
    s_dt[k * QP + j] = j < Q ? dt[((long long)bc * Q + j) * H + h0 + k] : 0.f;
  }
  __syncthreads();
  // cs = cumsum(dt * A) for head h0 + k, k = warp, warp + 8: 4 positions a
  // lane, then a shuffle scan of the lane sums; decay = exp(cs[Q-1] - cs)
  for (int k = warp; k < nh; k += kWarps) {
    const float a = A[h0 + k];
    const float* d = s_dt + k * QP;
    float* c = s_cs + k * QP;
    float v[4], s = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = 4 * lane + r;
      s += j < QP ? d[j] * a : 0.f;
      v[r] = s;
    }
    float incl = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float up = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += up;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = 4 * lane + r;
      if (j < QP) c[j] = excl + v[r];
    }
    __syncwarp();
    const float last = c[Q - 1];
    for (int j = lane; j < QP; j += 32)
      s_dec[k * QP + j] = d[j] * expf(last - c[j]);  // dt * decay
  }
  sm90::mbar_wait(bar_bc, 0);
  __syncthreads();

  // ---- S = C B^T for this warp's strip: rows i0 .. i0 + 15, its causal
  //      n8 tiles (columns 0 .. i0 + 15), K = N in steps of 8
  const int strip = warp < 4 ? warp : 11 - warp;
  const bool has_rows = strip < QP / 16;
  const int i0 = 16 * strip, ntile = 2 * (strip + 1);
  float sacc[2][kStrips][4];  // tile nt in sacc[nt / 8][nt % 8]
#pragma unroll
  for (int nt = 0; nt < 2 * kStrips; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) sacc[nt / 8][nt % 8][r] = 0.f;
  if (has_rows) {
    const float* ci = Cs + (i0 + g) * 32;  // rows i0 + g, + 8 (r % 8 = g)
    for (int k0 = 0; k0 < N; k0 += 8) {
      const int ka = swc(k0 + t, g, QP), kb = swc(k0 + t + 4, g, QP);
      const float av[4] = {ci[ka], ci[256 + ka], ci[kb], ci[256 + kb]};
      uint32_t ah[4], al[4];
      split4(av, ah, al);
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // 8 tiles at a time
        if (8 * half < ntile) {
          // all 8 tiles of the half (past the strip's causal ones they are
          // never read), rows kept inside the QP staged ones
          float b0[8], b1[8];
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const float* bj = Bs + min(8 * (8 * half + q) + g, QP - 1) * 32;
            b0[q] = bj[ka];
            b1[q] = bj[kb];
          }
          mma3<8>(sacc[half], ah, al, b0, b1);
        }
      }
    }
  }

  // C is done with: B becomes its tf32 hi parts in place and its lo parts
  // where C was, split once for all the block's heads
  __syncthreads();
  for (int e = tid; e < L.NB * QP * 32; e += kThreads) {
    uint32_t hi, lo;
    sm90::split_tf32(Bs[e], hi, lo);
    Bs[e] = __uint_as_float(hi);
    Cs[e] = __uint_as_float(lo);
  }
  __syncthreads();
  const uint32_t* Bhi = reinterpret_cast<const uint32_t*>(Bs);
  const uint32_t* Blo = reinterpret_cast<const uint32_t*>(Cs);

  const int NT = (N + 7) / 8;
  const int mt = warp % MT, nt0 = warp / MT, m = 16 * mt + g;
  // this warp's state tiles nt0 + q nstep < NT; the other q run on tile
  // NT - 1 and are not stored
  const int nq = nt0 < NT ? (NT - nt0 + nstep - 1) / nstep : 0;
  // per-lane offsets of the fragment loads below on row 2t of each group
  // of 8 positions: xbar's columns 8 nt + g (y's B), m and m + 8 (states'
  // A), B's columns of this warp's state tiles (states' B).  Every such
  // column has (c / 4) % 2 = g / 4, so on row 2t + 1 the swizzle flips
  // that bit: the offset there is this one plus dab.
  const int dab = 32 + ((g ^ 4) - g);
  int ya[PC / 8], sa[2], ba[kWarps];
#pragma unroll
  for (int nt = 0; nt < PC / 8; ++nt)
    ya[nt] = 2 * t * 32 + swc(8 * nt + g, 2 * t, QP);
#pragma unroll
  for (int r = 0; r < 2; ++r) sa[r] = 2 * t * 32 + swc(m + 8 * r, 2 * t, QP);
#pragma unroll
  for (int q = 0; q < kWarps; ++q)
    ba[q] = 2 * t * 32 + swc(8 * min(nt0 + q * nstep, NT - 1) + g, 2 * t,
                             QP);
  for (int u = 0; u < U; ++u) {
    const int k = u / nchunk, c0 = (u % nchunk) * PC;
    const long long hd = h0 + k;
    sm90::mbar_wait(bar_x + 8 * (u & 1), (u >> 1) & 1);
    const float* X = Xs + (u & 1) * L.XB * QP * 32;  // this unit's x
    const float* dtk = s_dt + k * QP;
    const float* csk = s_cs + k * QP;
    const float* deck = s_dec + k * QP;

    // ---- y rows of this strip: (S o L) xbar over the strip's causal keys.
    //      A fragment from tile kk: logical k = t is key 8 kk + 2t, k = t + 4
    //      is key 8 kk + 2t + 1 (the accumulator's own columns); xbar's rows
    //      are taken in the same order.
    if (has_rows) {
      float yacc[PC / 8][4];
#pragma unroll
      for (int nt = 0; nt < PC / 8; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) yacc[nt][r] = 0.f;
      const int ia = i0 + g, ib = ia + 8;
      const float cia = csk[ia], cib = csk[ib];
#pragma unroll
      for (int kk = 0; kk < 2 * kStrips; ++kk) {
        if (kk < ntile) {
          const int ja = 8 * kk + 2 * t, jb = ja + 1;
          const float cja = csk[ja], cjb = csk[jb];
          // S o L times dt_j, so that x is read as it is: (S o L) xbar =
          // (S o L dt^T) x
          const float* sk = sacc[kk / 8][kk % 8];
          const float da = dtk[ja], db = dtk[jb];
          const float pv[4] = {
              ja <= ia ? sk[0] * exp_sfu(cia - cja) * da : 0.f,
              ja <= ib ? sk[2] * exp_sfu(cib - cja) * da : 0.f,
              jb <= ia ? sk[1] * exp_sfu(cia - cjb) * db : 0.f,
              jb <= ib ? sk[3] * exp_sfu(cib - cjb) * db : 0.f};
          uint32_t ah[4], al[4];
          split4(pv, ah, al);
          float b0[PC / 8], b1[PC / 8];
#pragma unroll
          for (int nt = 0; nt < PC / 8; ++nt) {
            b0[nt] = X[256 * kk + ya[nt]];
            b1[nt] = X[256 * kk + ya[nt] + dab];
          }
          mma3<PC / 8>(yacc, ah, al, b0, b1);
        }
      }
#pragma unroll
      for (int nt = 0; nt < PC / 8; ++nt) {
        const long long col = c0 + 8 * nt + 2 * t;
        if (ia < Q)
          *reinterpret_cast<float2*>(y + (((long long)bc * Q + ia) * H + hd) *
                                             P + col) =
              make_float2(yacc[nt][0], yacc[nt][1]);
        if (ib < Q)
          *reinterpret_cast<float2*>(y + (((long long)bc * Q + ib) * H + hd) *
                                             P + col) =
              make_float2(yacc[nt][2], yacc[nt][3]);
      }
    }

    // ---- states rows c0 + 16 mt .. +15, n8 tiles nt0, nt0 + nstep, ...:
    //      (x * dt * decay)^T B over all positions, logical k = t / t + 4
    //      as positions j0 + 2t / j0 + 2t + 1
    {
      float tacc[kWarps][4];
#pragma unroll
      for (int q = 0; q < kWarps; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r) tacc[q][r] = 0.f;
      for (int j0 = 0; j0 < QP; j0 += 8) {
        const int ja = j0 + 2 * t, jb = ja + 1;
        const float ea = deck[ja], eb = deck[jb];
        const float* xj = X + 32 * j0;
        const float av[4] = {xj[sa[0]] * ea, xj[sa[1]] * ea,
                             xj[sa[0] + dab] * eb, xj[sa[1] + dab] * eb};
        uint32_t ah[4], al[4];
        split4(av, ah, al);
        uint32_t bh[kWarps][2], bl[kWarps][2];
#pragma unroll
        for (int q = 0; q < kWarps; ++q) {
          const int o = 32 * j0 + ba[q];
          bh[q][0] = Bhi[o];
          bh[q][1] = Bhi[o + dab];
          bl[q][0] = Blo[o];
          bl[q][1] = Blo[o + dab];
        }
        mma3<kWarps>(tacc, ah, al, bh, bl);
      }
      float* so = st + (((long long)bc * H + hd) * P + c0 + m) * N;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) {
        const int n = 8 * (nt0 + q * nstep) + 2 * t;
        if (q < nq && n < N) {
          *reinterpret_cast<float2*>(so + n) =
              make_float2(tacc[q][0], tacc[q][1]);
          *reinterpret_cast<float2*>(so + 8 * N + n) =
              make_float2(tacc[q][2], tacc[q][3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this slot
    if (tid == 0 && u + 2 < U)
      issue_x(L, Xs, bar_x, &tx, bc, u + 2, nchunk, h0);
  }
}

// cuTensorMapEncodeTiled from the driver, through the runtime (the library
// does not link libcuda).
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A float32 (BC, Q, K, W) tensor (x: K = H heads of W = P; B and C: K = G
// groups of W = N) as a 4-D map over (W, K, Q, BC), boxes of 32 columns of
// one head or group and QP positions, 128-byte swizzled; out-of-range
// elements arrive as zeros.
bool encode_rows(CUtensorMap* map, const void* ptr, int BC, int Q, int K,
                 int W, int QP) {
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)K, (cuuint64_t)Q,
                              (cuuint64_t)BC};
  const cuuint64_t strides[3] = {(cuuint64_t)W * 4, (cuuint64_t)K * W * 4,
                                 (cuuint64_t)Q * K * W * 4};
  const cuuint32_t box[4] = {32, 1, (cuuint32_t)QP, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

const char* ssd_chunk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int ssd_chunk_launch(const void* x, const void* dt, const void* A,
                     const void* Bm, const void* Cm, void* y, void* st,
                     int BC, int Q, int H, int G, int P, int N, int hb,
                     void* stream) {
  if (Q < 1 || Q > kMaxQ || N < 4 || N > kMaxN || N % 4 || G < 1 ||
      H % G || hb < 1 || hb > kMaxHeads ||
      (P != 16 && P != 32 && P != 64 && P != 128))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)BC * G * ((H / G + hb - 1) / hb);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const int QP = (Q + 15) / 16 * 16;
  CUtensorMap tx, tb, tc;
  if (!encode_rows(&tx, x, BC, Q, H, P, QP) ||
      !encode_rows(&tb, Bm, BC, Q, G, N, QP) ||
      !encode_rows(&tc, Cm, BC, Q, G, N, QP))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)ssd_layout(Q, P, N, hb).bytes;
  auto kernel = P == 16 ? ssd_chunk_kernel<16>
                : P == 32 ? ssd_chunk_kernel<32> : ssd_chunk_kernel<kPC>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      tx, tb, tc, static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<float*>(y),
      static_cast<float*>(st), Q, H, G, P, N, hb);
  return (int)cudaGetLastError();
}

}  // extern "C"
