// Hand-written Hopper (sm_90a) attention kernels for the cloudlet LM.
//
// Replaces the Pallas TPU kernels
//   flash_attention_tc_kernel (bf16), flash_attention_kernel (float32)
//       <- src/repro/kernels/flash_attention.py flash_attention_pallas
//          (_flash_kernel)
//   decode_attention_tc_kernel (bf16), decode_attention_kernel (float32),
//   decode_merge_kernel
//       <- src/repro/kernels/decode_attention.py decode_attention_pallas
//          (_decode_kernel)
// and computes what their bodies compute: scores (q . k) * D^-0.5 in
// float32, causal positions from 0, keys past the end (or past
// cache_len) left out, the online softmax (m, l, acc) in float32, l
// floored at 1e-30, the output cast to q's dtype.  GQA is by index: query
// head h reads KV head h / (Hq / Hkv) of its batch row; K/V are never
// repeated.  Layouts are the model's: q and out (B, Sq, Hq, D), k and v
// (B, Skv, Hkv, D), all contiguous.
//
// What bounds them on the card.
//   flash_attention: operations.  4 B Hq Sq Skv D flops (about half when
//     causal) against q/k/v/out read and written once; at B=4, S=2048,
//     Hq=16, D=128 causal in bfloat16 that is 6.9e10 flops (0.0695 ms at
//     989 TFLOP/s on the tensor cores) against 0.040 ms of bytes.
//   decode_attention: bytes.  G query rows against the cache_len keys of
//     their KV head: each K and V row below cache_len is read once, 2G
//     flops per element read, far below the 295 flops a byte where the
//     tensor cores would bound it; at B=16, cache_len=4096, Hkv=16, D=128
//     in bfloat16 that is 537 MB, 0.160 ms at 3.35 TB/s (Hkv=4: 134 MB,
//     0.040 ms).
//
// flash_attention in bfloat16 (flash_attention_tc_kernel): the tensor
//   cores through wgmma.  One block of three warpgroups per (b * Hq + h,
//   128-row query tile); query tiles run heaviest first (the last under
//   the causal mask).  Warpgroup 2 is the producer: it gives up its
//   registers (setmaxnreg 24) and one thread brings Q once and then the
//   K and V tiles of 128 keys by TMA (4-D tensor maps over (D, H, S, B),
//   so the head stride is the map's and no transposed copy is made) into
//   a ring of three stages; K and V each have a "full" and an "empty"
//   mbarrier per stage, so K(t + 3) can load once S(t) is done.
//   Warpgroups 0 and 1 are consumers (setmaxnreg 240) of 64 query rows
//   each: S = Q K^T as D/16 wgmma m64n128k16 with Q and K both K-major
//   from shared memory; the mask (only on the last tile: causal blocks
//   stop at the diagonal, and every earlier tile is wholly visible to
//   every row), the row max, p = 2^(s * scale * log2 e - m) (one FFMA
//   and one ex2 a score) and the online-softmax update on the accumulator
//   fragment in registers; P converted in registers to the bf16 A operand
//   of O += P V, V the shared-memory B operand read N-major through the
//   transpose bit (its tile is stored D-contiguous).  Each consumer
//   issues S(t) and O += P(t-1) V(t-1) together and runs softmax(t)
//   while the second product is in flight, and the two consumers take
//   turns to issue (named barriers 1 and 2), so one's softmax overlaps
//   the other's products.  The loop is peeled so that no wgmma sits in a
//   branch: ptxas serializes wgmma in divergent code.  P is carried as a
//   hi + lo pair of bf16 (hi = bf16(p), lo = bf16(p - hi), two wgmma per
//   16 keys): P in bf16 alone (2^-9 relative per probability) moved
//   outputs near 0 by more than the bar's 1e-4 at every checked shape
//   with more than one key a row; the pair
//   keeps P to about 2^-16, at 1.5x the tensor-core work.  Row sums l are
//   taken from the float32 p.  TMA fills rows past Sq / Skv with zeros;
//   keys >= Skv are masked to -inf, rows >= Sq are not stored.  Tiles use
//   the 128-byte swizzle (64-byte at D=32) that the wgmma descriptors
//   name; at D=128 a row is 256 B, so each tile is two TMA boxes of 64
//   columns.  Shared memory at D=128: Q 32 KB + 3 stages x (K 32 KB + V
//   32 KB) = 224 KB, one block per SM (the registers allow no more).
//   Registers of a consumer thread: S 64 and O D/2 float32, P 2 x 32
//   packed bf16; ptxas: 168 at entry, no spills.
// flash_attention in float32 (flash_attention_kernel): the CUDA cores, as
//   first written (float32 on the tensor cores would be TF32, which does
//   not meet the float32 bar): one block per (64-row query tile, b * Hq +
//   h), 256 threads, 4 threads per query row owning D/4 of its q and
//   accumulator; 32-key K/V tiles staged in shared memory; causal blocks
//   stop at their last row's position.
// decode_attention: one block per (b, KV head, split of the cache)
//   computes all G query heads of that KV head (up to 16 a block; more
//   heads take more blocks), so each K/V byte below cache_len is read
//   once from device memory, not G times.  split_plan
//   (kernels/decode_attention.py) cuts [0, cache_len) into splits of a
//   multiple of 64 keys, at least 256 each, about one block per SM: more
//   splits only add partials to merge.  Keys stream in 64-key tiles
//   through a ring of three stages by cp.async 16-byte copies (zero-filled
//   past the split), chunks XOR-swizzled by row (KeyTile).  With one
//   split the block writes the output; with more it writes float32 (m, l,
//   acc) partials and decode_merge_kernel combines the splits of each
//   (b, h) in a fixed order, so results are deterministic: a call is then
//   two launches.
//   bfloat16 (decode_attention_tc_kernel, 128 threads): the products on
//   the tensor cores (mma.sync m16n8k16, K and V through ldmatrix, V
//   transposed by ldmatrix.trans) with the block's heads as the 16 rows of
//   A, zero-padded.  2G flops a byte would fit the CUDA cores in
//   principle, but their bf16 conversions and per-head passes cost more
//   than the memory time from G = 4 up (a CUDA-core build fell well short
//   of the HBM rate under GQA); on the tensor cores the work is a few
//   percent of the memory time.  Each warp owns 16 keys of every tile and
//   its own online softmax (P as hi + lo bf16, as in K5); the four warps
//   meet once, at the end.  Shared memory at D=128: 3 x 32 KB, two blocks per SM.
//   float32 (decode_attention_kernel, 256 threads): on the CUDA cores, per
//   tile (a) each thread forms the scores of one key for up to 4 heads
//   from the float32 q rows in shared memory, (b) one warp per head takes
//   the tile max, rescales (m, l) and turns the scores into probabilities,
//   (c) each thread accumulates p * v for (head, 16-byte chunk of D, share
//   of the keys).
//
// fmaf() is written out where a product is accumulated on the CUDA
// cores: the library is built with -fmad=false (for onalgo_step.cu's
// exact rounding), which only stops the compiler from contracting a * b +
// c by itself.
//
// Plain C interface for ctypes: every entry point returns the CUDA error
// code of its launch (0 = success) and allocates nothing.  The tensor maps
// are encoded on the host for each call through the driver entry point
// that the runtime hands out (cudaGetDriverEntryPoint), so the library
// does not link libcuda.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernels' mask value
constexpr unsigned kFull = 0xffffffffu;

constexpr int kFlashBQ = 64;   // query rows per block (float32 kernel)
constexpr int kFlashTPR = 4;   // threads per query row
constexpr int kFlashThreads = kFlashBQ * kFlashTPR;
constexpr int kFlashBK = 32;   // keys per shared-memory tile

// 4 consecutive floats.
__device__ __forceinline__ void load4(const float* p, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// --------------------------------------------------------------------------
// K5 in float32: flash attention on the CUDA cores

template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int Sq, int Skv, int Hq, int Hkv, int causal,
                           float scale) {
  constexpr int kC = D / 4;                  // float4 chunks per row
  constexpr int kChunks = kC / kFlashTPR;    // chunks per thread
  __shared__ float4 ks[kFlashBK][kC];
  __shared__ float4 vs[kFlashBK][kC];

  const int tid = threadIdx.x;
  const int row = tid / kFlashTPR;
  const int lane = tid % kFlashTPR;
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFlashBQ;
  const int qpos = q0 + row;
  const bool live = qpos < Sq;

  float qr[kChunks * 4];
  const T* qrow = q + ((long long)b * Sq + (live ? qpos : 0)) * Hq * D +
                  (long long)h * D;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    load4(qrow + 4 * (lane + kFlashTPR * c), qr + 4 * c);

  float acc[kChunks * 4];
#pragma unroll
  for (int i = 0; i < kChunks * 4; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;

  const long long kv_stride = (long long)Hkv * D;  // from key j to j + 1
  const T* kbase = k + (long long)b * Skv * kv_stride + (long long)hk * D;
  const T* vbase = v + (long long)b * Skv * kv_stride + (long long)hk * D;
  const int kv_end = causal ? min(Skv, q0 + kFlashBQ) : Skv;

  for (int k0 = 0; k0 < kv_end; k0 += kFlashBK) {
    __syncthreads();  // the previous tile is consumed
    for (int slot = tid; slot < kFlashBK * kC; slot += kFlashThreads) {
      const int j = slot / kC, c = slot % kC;
      float fk[4] = {0.f, 0.f, 0.f, 0.f}, fv[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + j < Skv) {
        load4(kbase + (k0 + j) * kv_stride + 4 * c, fk);
        load4(vbase + (k0 + j) * kv_stride + 4 * c, fv);
      }
      ks[j][c] = make_float4(fk[0], fk[1], fk[2], fk[3]);
      vs[j][c] = make_float4(fv[0], fv[1], fv[2], fv[3]);
    }
    __syncthreads();

    float s[kFlashBK];
    float mt = m;
#pragma unroll
    for (int j = 0; j < kFlashBK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 kk = ks[j][lane + kFlashTPR * c];
        part = fmaf(qr[4 * c], kk.x, part);
        part = fmaf(qr[4 * c + 1], kk.y, part);
        part = fmaf(qr[4 * c + 2], kk.z, part);
        part = fmaf(qr[4 * c + 3], kk.w, part);
      }
      part += __shfl_xor_sync(kFull, part, 1);
      part += __shfl_xor_sync(kFull, part, 2);
      const int kpos = k0 + j;
      float sj = part * scale;
      if (causal && kpos > qpos) sj = kNegInf;
      if (kpos >= Skv) sj = -INFINITY;  // past the end: not a key at all
      s[j] = sj;
      mt = fmaxf(mt, sj);
    }
    const float corr = expf(m - mt);
    l *= corr;
#pragma unroll
    for (int i = 0; i < kChunks * 4; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < kFlashBK; ++j) {
      const float p = expf(s[j] - mt);
      l += p;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 vv = vs[j][lane + kFlashTPR * c];
        acc[4 * c] = fmaf(p, vv.x, acc[4 * c]);
        acc[4 * c + 1] = fmaf(p, vv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(p, vv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(p, vv.w, acc[4 * c + 3]);
      }
    }
    m = mt;
  }

  if (!live) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* orow = out + ((long long)b * Sq + qpos) * Hq * D + (long long)h * D;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      store(orow + 4 * (lane + kFlashTPR * c) + e, acc[4 * c + e] * inv);
}

// --------------------------------------------------------------------------
// K5 in bfloat16: flash attention on the tensor cores (wgmma, TMA)

constexpr int kTcBM = 128;      // query rows per block (two consumers of 64)
constexpr int kTcBN = 128;      // keys per K/V tile
constexpr int kTcStages = 3;    // K/V tiles in the ring
constexpr int kTcConsumers = 2;  // consumer warpgroups
constexpr int kTcThreads = 128 * (kTcConsumers + 1);

template <int D>
struct TcTile {
  static_assert(D == 32 || D == 64 || D == 128, "head size not built");
  static constexpr int kSW = D >= 64 ? 128 : 64;  // swizzle span (bytes)
  static constexpr int kBoxCols = kSW / 2;        // bf16 columns per box
  static constexpr int kBoxes = D / kBoxCols;     // TMA boxes per tile
  static constexpr uint32_t kSwizzle = kSW == 128 ? 1 : 2;  // descriptor
  static constexpr int kQBytes = kTcBM * D * 2;
  static constexpr int kKVBytes = kTcBN * D * 2;  // one K or one V tile
  static constexpr int kBarBytes = 8 * (1 + 4 * kTcStages);
  // + 1024: the tiles start on a 1024-byte boundary (the swizzle atom)
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kTcStages * kKVBytes + kBarBytes;
};

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              __nv_bfloat16* __restrict__ out, int Sq,
                              int Skv, int Hq, int Hkv, int causal,
                              float scale_log2) {
  using F = TcTile<D>;
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + F::kQBytes;  // stage s: K, then V
  const uint32_t bars = kv_s + 2 * kTcStages * F::kKVBytes;
  const uint32_t full_q = bars;
  // per stage: K landed, V landed, K consumed, V consumed
  auto bar = [&](int kind, int s) {
    return bars + 8 * (1 + kind * kTcStages + s);
  };
  auto k_tile = [&](int s) { return kv_s + 2 * s * F::kKVBytes; };
  auto v_tile = [&](int s) { return k_tile(s) + F::kKVBytes; };
  enum { kFullK, kFullV, kEmptyK, kEmptyV };

  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcBM;
  const int kv_end = causal ? min(Skv, q0 + kTcBM) : Skv;
  const int n_tiles = (kv_end + kTcBN - 1) / kTcBN;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(bar(kFullK, s), 1);
      mbar_init(bar(kFullV, s), 1);
      mbar_init(bar(kEmptyK, s), 4 * kTcConsumers);  // one arrival a warp
      mbar_init(bar(kEmptyV, s), 4 * kTcConsumers);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kTcConsumers) {
    // ---- producer: one thread issues every TMA load ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 128 * kTcConsumers) {
      mbar_expect_tx(full_q, F::kQBytes);
      for (int x = 0; x < F::kBoxes; ++x)
        tma_load_4d(q_s + x * kTcBM * F::kSW, &tq, full_q, x * F::kBoxCols,
                    h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kTcStages;
        const uint32_t par = ((t / kTcStages) - 1) & 1;
        if (t >= kTcStages) mbar_wait(bar(kEmptyK, s), par);
        mbar_expect_tx(bar(kFullK, s), F::kKVBytes);
        for (int x = 0; x < F::kBoxes; ++x)
          tma_load_4d(k_tile(s) + x * kTcBN * F::kSW, &tk, bar(kFullK, s),
                      x * F::kBoxCols, hk, t * kTcBN, b);
        if (t >= kTcStages) mbar_wait(bar(kEmptyV, s), par);
        mbar_expect_tx(bar(kFullV, s), F::kKVBytes);
        for (int x = 0; x < F::kBoxes; ++x)
          tma_load_4d(v_tile(s) + x * kTcBN * F::kSW, &tv, bar(kFullV, s),
                      x * F::kBoxCols, hk, t * kTcBN, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    // Accumulator fragment of m64nN: register 4j + 2i + c holds row
    // 16 warp + lane/4 + 8i, column 8j + 2 (lane % 4) + c.
    const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;
    const int col0 = 2 * (lane % 4);
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float sc[kTcBN / 2];
    // P(t) as the register A operand of m64nDk16, 16 keys per step, as a
    // hi + lo pair of bf16: the score fragment's registers 8kk .. 8kk+7
    // are exactly A's four packed pairs (rows lane/4 and +8, columns
    // 2 (lane%4) and +8).
    uint32_t p_hi[kTcBN / 16][4], p_lo[kTcBN / 16][4];

    // K-major operands: 16 columns (32 bytes) per k step inside a swizzled
    // row, the next box after kSW bytes; 8-row groups kSW * 8 apart.
    auto desc_kmajor = [&](uint32_t tile, int rows, int kk) {
      const int byte = kk * 32;
      return make_desc(tile + (byte / F::kSW) * rows * F::kSW +
                           byte % F::kSW,
                       16, 8 * F::kSW, F::kSwizzle);
    };
    const uint32_t q_rows = q_s + 64 * wg * F::kSW;

    auto issue_s = [&](int t) {  // S(t) = Q K(t)^T
      const int s = t % kTcStages;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_m64n128(sc, desc_kmajor(q_rows, kTcBM, kk),
                         desc_kmajor(k_tile(s), kTcBN, kk), kk > 0);
    };
    auto issue_pv = [&](int t) {  // O += P(t) V(t)
      // V: N-major (D contiguous); 16 keys per k step are 16 swizzled
      // rows; D's blocks of kBoxCols are one box (kTcBN * kSW bytes) apart.
      const int s = t % kTcStages;
#pragma unroll
      for (int kk = 0; kk < kTcBN / 16; ++kk) {
        const uint64_t dv = make_desc(v_tile(s) + kk * 16 * F::kSW,
                                      kTcBN * F::kSW, 8 * F::kSW,
                                      F::kSwizzle);
        wgmma_rs<D>(o, p_hi[kk], dv);
        wgmma_rs<D>(o, p_lo[kk], dv);
      }
    };
    auto release = [&](int kind, int t) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar(kind, t % kTcStages));
    };
    auto fence_o = [&]() {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) fence_operand(o[i]);
#pragma unroll
      for (int kk = 0; kk < kTcBN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          fence_operand(p_hi[kk][r]);
          fence_operand(p_lo[kk][r]);
        }
    };
    // softmax of tile t on S (in place: S becomes P in float32), returns
    // through corr the factor O must be rescaled by
    auto softmax = [&](int t, float (&corr)[2]) {
#pragma unroll
      for (int i = 0; i < kTcBN / 2; ++i) fence_operand(sc[i]);
      // the tile's row max on the raw scores (the scale is positive),
      // then p = 2^(s * scale_log2 - m): one FFMA and one ex2 a score
      const bool edge = t == n_tiles - 1;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kTcBN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float x = sc[4 * j + 2 * i + c];
            if (edge) {
              const int key = t * kTcBN + 8 * j + col0 + c;
              if (key >= Skv || (causal && key > row0 + 8 * i)) x = -INFINITY;
            }
            sc[4 * j + 2 * i + c] = x;
            mx[i] = fmaxf(mx[i], x);
          }
      float neg_m[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
        // finite: key 0 is seen by the first tile
        const float m_new = fmaxf(m[i], mx[i] * scale_log2);
        corr[i] = ex2_approx(m[i] - m_new);
        m[i] = m_new;
        l[i] *= corr[i];
        neg_m[i] = -m_new;
      }
#pragma unroll
      for (int j = 0; j < kTcBN / 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p =
              ex2_approx(fmaf(sc[4 * j + r], scale_log2, neg_m[r >> 1]));
          l[r >> 1] += p;
          sc[4 * j + r] = p;
        }
    };
    // O rescaled, then P(t) packed as the A operand (hi + lo)
    auto rescale_pack = [&](const float (&corr)[2]) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) o[4 * j + r] *= corr[r >> 1];
#pragma unroll
      for (int kk = 0; kk < kTcBN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], p_hi[kk][r],
                     p_lo[kk][r]);
    };

    // The two consumers take turns on the tensor cores (named barriers 1
    // and 2): while one issues S(t + 1) and O += P(t) V(t), the other runs
    // its softmax.  Consumer 0 goes first; consumer 1 passes no turn after
    // its last.  No wgmma sits in a branch (ptxas would serialize them).
    auto turn = [&]() { named_bar_sync(1 + wg, 256); };
    auto pass = [&](bool last) {
      if (wg == 0 || !last) named_bar_arrive(2 - wg, 256);
    };
    if (wg == 1) named_bar_arrive(1, 256);
    float corr[2];
    mbar_wait(full_q, 0);
    mbar_wait(bar(kFullK, 0), 0);
    turn();
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    pass(false);
    wgmma_wait<0>();
    release(kEmptyK, 0);
    softmax(0, corr);
    rescale_pack(corr);
    for (int t = 1; t < n_tiles; ++t) {
      mbar_wait(bar(kFullK, t % kTcStages), (t / kTcStages) & 1);
      mbar_wait(bar(kFullV, (t - 1) % kTcStages), ((t - 1) / kTcStages) & 1);
      turn();
      wgmma_fence();
      issue_s(t);
      wgmma_commit();
      issue_pv(t - 1);
      wgmma_commit();
      pass(false);
      wgmma_wait<1>();  // S(t) done, O += P(t-1) V(t-1) in flight
      release(kEmptyK, t);
      softmax(t, corr);
      wgmma_wait<0>();
      fence_o();
      release(kEmptyV, t - 1);
      rescale_pack(corr);
    }
    mbar_wait(bar(kFullV, (n_tiles - 1) % kTcStages),
              ((n_tiles - 1) / kTcStages) & 1);
    turn();
    wgmma_fence();
    issue_pv(n_tiles - 1);
    wgmma_commit();
    pass(true);
    wgmma_wait<0>();
    fence_o();
    release(kEmptyV, n_tiles - 1);

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(kFull, l[i], 1);
      l[i] += __shfl_xor_sync(kFull, l[i], 2);
      const int row = row0 + 8 * i;
      if (row >= Sq) continue;
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      __nv_bfloat16* orow = out + ((long long)b * Sq + row) * Hq * D +
                            (long long)h * D + col0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * i] * inv,
                                  o[4 * j + 2 * i + 1] * inv);
    }
  }
}

// --------------------------------------------------------------------------
// K6: flash-decode, split over the cache, one read of each KV head

constexpr int kDecThreads = 256;
constexpr int kDecStages = 3;   // tiles in the cp.async ring
constexpr int kDecMaxG = 16;    // query heads a block computes
constexpr int kDecTK = 64;      // keys per tile
constexpr int kMergeThreads = 128;

// A tile of kDecTK key rows in shared memory, RowBytes each, its 16-byte
// chunks XOR-swizzled by row so that the 8 rows that a quarter-warp (or an
// ldmatrix) reads at one chunk fall in distinct banks.
template <int RowBytes>
struct KeyTile {
  static constexpr int kNC = RowBytes / 16;  // chunks per row
  static constexpr int kRowsPerLine = RowBytes >= 128 ? 1 : 128 / RowBytes;
  static constexpr int kSwz = kNC < 8 ? kNC : 8;
  static constexpr int kBytes = kDecTK * RowBytes;
  static __device__ __forceinline__ int at(int r, int c) {
    return r * RowBytes + 16 * (c ^ ((r / kRowsPerLine) % kSwz));
  }
};

template <int D>
struct DecTile {  // float32
  using L = KeyTile<4 * D>;
  static constexpr int kVec = 4;  // floats per 16-byte chunk
  static constexpr int kNC = L::kNC;
  static constexpr int kTileBytes = L::kBytes;  // K or V
  static constexpr int kCopies = kDecTK * kNC / kDecThreads;
  static constexpr int kHeadLanes = kDecThreads / kDecTK;  // (a): head groups
  static constexpr int kHeadsPer = kDecMaxG / kHeadLanes;
  // (c): (head, chunk) accumulators a thread may own at kDecMaxG heads
  static constexpr int kSlots = (kDecMaxG * kNC + kDecThreads - 1) /
                                kDecThreads;
  static constexpr int kSmem = 4 * (kDecMaxG * D + kDecMaxG * kDecTK +
                                    3 * kDecMaxG) +
                               kDecStages * 2 * kTileBytes;
  static_assert(kCopies * kDecThreads == kDecTK * kNC, "tile copy split");
  static_assert(kDecThreads * kSlots * kVec * 4 <= kDecStages * 2 *
                    kTileBytes, "the final reduction reuses the ring");
  static __device__ __forceinline__ int at(int r, int c) {
    return L::at(r, c);
  }
  // cp.async of the tile of keys [k0, k0 + kDecTK) into kdst (K) and
  // kdst + kTileBytes (V); rows at or past k_end are zero-filled.
  static __device__ __forceinline__ void issue(uint32_t kdst,
                                               const float* kb,
                                               const float* vb, long long rs,
                                               int k0, int k_begin,
                                               int k_end, int tid) {
#pragma unroll
    for (int u = 0; u < kCopies; ++u) {
      const int idx = tid + kDecThreads * u;
      const int r = idx / kNC, c = idx % kNC;
      const bool ok = k0 + r < k_end;
      const long long off = (ok ? k0 + r : k_begin) * rs + c * kVec;
      sm90::cp_async16(kdst + at(r, c), kb + off, ok);
      sm90::cp_async16(kdst + kTileBytes + at(r, c), vb + off, ok);
    }
  }
};

template <int D>
__global__ void __launch_bounds__(kDecThreads, 1)
    decode_attention_kernel(const float* __restrict__ q,
                            const float* __restrict__ kc,
                            const float* __restrict__ vc,
                            float* __restrict__ out,
                            float* __restrict__ part_m,
                            float* __restrict__ part_l,
                            float* __restrict__ part_acc, int S, int Hq,
                            int Hkv, int n_valid, int split_len,
                            float scale) {
  using F = DecTile<D>;
  constexpr int kVec = F::kVec, kNC = F::kNC, TK = kDecTK;
  extern __shared__ float4 dsmem[];
  float* q_s = reinterpret_cast<float*>(dsmem);  // [kDecMaxG][D]
  float* p_s = q_s + kDecMaxG * D;               // [kDecMaxG][TK]
  float* m_s = p_s + kDecMaxG * TK;
  float* l_s = m_s + kDecMaxG;
  float* corr_s = l_s + kDecMaxG;
  char* ring = reinterpret_cast<char*>(corr_s + kDecMaxG);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = Hq / Hkv, chunks = (G + kDecMaxG - 1) / kDecMaxG;
  const int chunk = blockIdx.x % chunks, bk = blockIdx.x / chunks;
  const int b = bk / Hkv, hk = bk % Hkv;
  const int g0 = chunk * kDecMaxG, Gc = min(kDecMaxG, G - g0);
  const int h0 = hk * G + g0;
  const int split = blockIdx.y, splits = gridDim.y;
  const int k_begin = split * split_len;
  const int k_end = min(n_valid, k_begin + split_len);
  const int n_tiles = (k_end - k_begin + TK - 1) / TK;
  // (c): Gp >= Gc heads by kNC chunks, the keys shared by KP threads
  int Gp = 1;
  while (Gp < Gc) Gp *= 2;
  const int KP = max(1, kDecThreads / (Gp * kNC));

  for (int i = tid; i < Gc * D; i += kDecThreads)
    q_s[i] = q[((long long)b * Hq + h0) * D + i];
  if (tid < kDecMaxG) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  const long long rs = (long long)Hkv * D;  // from key j to j + 1
  const float* kb = kc + (long long)b * S * rs + (long long)hk * D;
  const float* vb = vc + (long long)b * S * rs + (long long)hk * D;
  const uint32_t ring_u32 = sm90::smem_u32(ring);
#pragma unroll
  for (int t = 0; t < kDecStages - 1; ++t) {
    if (t < n_tiles)
      F::issue(ring_u32 + t * 2 * F::kTileBytes, kb, vb, rs,
               k_begin + t * TK, k_begin, k_end, tid);
    sm90::cp_async_commit();
  }

  float acc[F::kSlots][kVec];
#pragma unroll
  for (int r = 0; r < F::kSlots; ++r)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[r][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    sm90::cp_async_wait<kDecStages - 2>();
    __syncthreads();  // tile t is in; every thread is done with t - 1
    const int tn = t + kDecStages - 1;
    if (tn < n_tiles)
      F::issue(ring_u32 + (tn % kDecStages) * 2 * F::kTileBytes, kb, vb, rs,
               k_begin + tn * TK, k_begin, k_end, tid);
    sm90::cp_async_commit();
    const char* ktile = ring + (t % kDecStages) * 2 * F::kTileBytes;
    const char* vtile = ktile + F::kTileBytes;
    const int valid = min(TK, k_end - (k_begin + t * TK));

    // (a) scores: key j of this tile for heads hl, hl + kHeadLanes, ...
    // (four partial sums a head, so the dependent chains are short)
    {
      const int j = tid % TK, hl = tid / TK;
      if (hl < Gc && j < valid) {
        float s[F::kHeadsPer][4] = {};
#pragma unroll 8
        for (int c = 0; c < kNC; ++c) {
          float kf[kVec];
          load4(reinterpret_cast<const float*>(ktile + F::at(j, c)), kf);
#pragma unroll
          for (int i = 0; i < F::kHeadsPer; ++i) {
            if (hl + F::kHeadLanes * i < Gc) {
              const float* qq = q_s + (hl + F::kHeadLanes * i) * D + c * kVec;
#pragma unroll
              for (int e = 0; e < kVec; ++e)
                s[i][e % 4] = fmaf(qq[e], kf[e], s[i][e % 4]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < F::kHeadsPer; ++i)
          if (hl + F::kHeadLanes * i < Gc)
            p_s[(hl + F::kHeadLanes * i) * TK + j] =
                ((s[i][0] + s[i][1]) + (s[i][2] + s[i][3])) * scale;
      }
    }
    __syncthreads();

    // (b) one warp per head: the tile max, (m, l) rescaled, probabilities
    for (int g = warp; g < Gc; g += kDecThreads / 32) {
      float* ps = p_s + g * TK;
      float x[TK / 32];
      float mt = -INFINITY;
#pragma unroll
      for (int w = 0; w < TK / 32; ++w) {
        x[w] = lane + 32 * w < valid ? ps[lane + 32 * w] : -INFINITY;
        mt = fmaxf(mt, x[w]);
      }
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(mt));
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < TK / 32; ++w) {
        if (lane + 32 * w < valid) {
          const float e = expf(x[w] - m_new);
          ps[lane + 32 * w] = e;
          sum += e;
        }
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);  // 0 on the first tile
        l_s[g] = fmaf(l_s[g], corr, sum);
        m_s[g] = m_new;
        corr_s[g] = corr;
      }
    }
    __syncthreads();

    // (c) acc += p * v: slot u = c + kNC (g + Gp kp)
#pragma unroll
    for (int r = 0; r < F::kSlots; ++r) {
      const int u = tid + kDecThreads * r;
      const int c = u % kNC, g = (u / kNC) % Gp, kp = u / (kNC * Gp);
      if (g < Gc && kp < KP) {
        const float corr = corr_s[g];
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[r][e] *= corr;
        const float* ps = p_s + g * TK;
#pragma unroll 4
        for (int j = kp; j < valid; j += KP) {
          float vf[kVec];
          load4(reinterpret_cast<const float*>(vtile + F::at(j, c)), vf);
          const float p = ps[j];
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
        }
      }
    }
  }

  // the KP shares of each (head, chunk) meet in the (now idle) ring
  sm90::cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int r = 0; r < F::kSlots; ++r)
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      red[(tid + kDecThreads * r) * kVec + e] = acc[r][e];
  __syncthreads();
  for (int i = tid; i < Gc * D; i += kDecThreads) {
    const int g = i / D, d = i % D;
    float a = 0.f;
    for (int kp = 0; kp < KP; ++kp)
      a += red[((kp * Gp + g) * kNC + d / kVec) * kVec + d % kVec];
    const long long bh = (long long)b * Hq + h0 + g;
    if (splits == 1) {
      out[bh * D + d] = a / fmaxf(l_s[g], 1e-30f);
    } else {
      part_acc[(bh * splits + split) * D + d] = a;
      if (d == 0) {
        part_m[bh * splits + split] = m_s[g];
        part_l[bh * splits + split] = l_s[g];
      }
    }
  }
}

// K6 in bfloat16: the same split and stream, the products on the tensor
// cores (mma.sync m16n8k16): the block's query heads are the 16 rows of
// A, padded with zeros.  Each warp owns 16 keys of every 64-key tile and
// its own online softmax over them; the warps meet once, at the end.

constexpr int kDecTcWarps = 4;
constexpr int kDecTcThreads = 32 * kDecTcWarps;

template <int D>
struct DecTcTile {
  using L = KeyTile<2 * D>;
  static constexpr int kNC = L::kNC;
  static constexpr int kTileBytes = L::kBytes;  // K or V
  static constexpr int kCopies = kDecTK * kNC / kDecTcThreads;
  static constexpr int kWarpFloats = kDecMaxG * D + 2 * kDecMaxG;  // o, m, l
  static constexpr int kSmem = kDecStages * 2 * kTileBytes;
  static_assert(16 * kDecTcWarps == kDecTK, "16 keys a warp");
  static_assert(kCopies * kDecTcThreads == kDecTK * kNC, "tile copy split");
  static_assert(4 * kDecTcWarps * kWarpFloats <= kSmem,
                "the warps' partials fit in the ring");
};

template <int D>
__global__ void __launch_bounds__(kDecTcThreads)
    decode_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ kc,
                               const __nv_bfloat16* __restrict__ vc,
                               __nv_bfloat16* __restrict__ out,
                               float* __restrict__ part_m,
                               float* __restrict__ part_l,
                               float* __restrict__ part_acc, int S, int Hq,
                               int Hkv, int n_valid, int split_len,
                               float scale_log2) {
  using F = DecTcTile<D>;
  using L = typename F::L;
  using namespace sm90;
  constexpr int kNC = F::kNC;
  extern __shared__ float4 dsmem[];
  char* ring = reinterpret_cast<char*>(dsmem);
  const uint32_t ring_u32 = smem_u32(ring);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = Hq / Hkv, chunks = (G + kDecMaxG - 1) / kDecMaxG;
  const int chunk = blockIdx.x % chunks, bk = blockIdx.x / chunks;
  const int b = bk / Hkv, hk = bk % Hkv;
  const int g0 = chunk * kDecMaxG, Gc = min(kDecMaxG, G - g0);
  const int h0 = hk * G + g0;
  const int split = blockIdx.y, splits = gridDim.y;
  const int k_begin = split * split_len;
  const int k_end = min(n_valid, k_begin + split_len);
  const int n_tiles = (k_end - k_begin + kDecTK - 1) / kDecTK;

  // Fragments (PTX m16n8k16): A holds rows lane/4 (+8), columns
  // 2 (lane%4) (+1, +8); C rows lane/4 (+8), columns 2 (lane%4) (+1).
  const int r0 = lane / 4, c0 = 2 * (lane % 4);
  uint32_t qa[D / 16][4];  // q of heads g0 + r as the A operand
  {
    const __nv_bfloat16* qb = q + ((long long)b * Hq + h0) * D;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int row = r0 + 8 * (x & 1), col = 16 * ks + c0 + 8 * (x >> 1);
        qa[ks][x] = row < Gc ? *reinterpret_cast<const uint32_t*>(
                                   qb + row * D + col)
                             : 0u;
      }
  }

  const long long rs = (long long)Hkv * D;  // from key j to j + 1
  const __nv_bfloat16* kb = kc + (long long)b * S * rs + (long long)hk * D;
  const __nv_bfloat16* vb = vc + (long long)b * S * rs + (long long)hk * D;
  auto issue = [&](int t) {
    const uint32_t kdst = ring_u32 + (t % kDecStages) * 2 * F::kTileBytes;
    const int k0 = k_begin + t * kDecTK;
#pragma unroll
    for (int u = 0; u < F::kCopies; ++u) {
      const int idx = tid + kDecTcThreads * u;
      const int r = idx / kNC, c = idx % kNC;
      const bool ok = k0 + r < k_end;
      const long long off = (ok ? k0 + r : k_begin) * rs + c * 8;
      cp_async16(kdst + L::at(r, c), kb + off, ok);
      cp_async16(kdst + F::kTileBytes + L::at(r, c), vb + off, ok);
    }
  };
#pragma unroll
  for (int t = 0; t < kDecStages - 1; ++t) {
    if (t < n_tiles) issue(t);
    cp_async_commit();
  }

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) o[n][x] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // ldmatrix: lane l addresses row l % 8 of matrix l / 8
  const int mi = lane / 8, mr = lane % 8;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kDecStages - 2>();
    __syncthreads();  // tile t is in; every warp is done with t - 1
    if (t + kDecStages - 1 < n_tiles) issue(t + kDecStages - 1);
    cp_async_commit();
    const uint32_t kt = ring_u32 + (t % kDecStages) * 2 * F::kTileBytes;
    const uint32_t vt = kt + F::kTileBytes;
    const int key0 = k_begin + t * kDecTK + 16 * warp;
    if (key0 >= k_end) continue;  // none of this warp's keys is valid

    // S = q K^T over this warp's 16 keys: two n8 tiles
    float sc[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t kf[4];  // (keys 0-7 | 8-15) x (columns 0-7 | 8-15)
      ldmatrix_x4(kf, kt + L::at(16 * warp + 8 * (mi >> 1) + mr,
                                 2 * ks + (mi & 1)));
      mma_bf16_16816(sc[0], qa[ks], kf[0], kf[1]);
      mma_bf16_16816(sc[1], qa[ks], kf[2], kf[3]);
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        float v = sc[n][x] * scale_log2;
        if (key0 + 8 * n + c0 + (x & 1) >= k_end) v = -INFINITY;
        sc[n][x] = v;
        mx[x >> 1] = fmaxf(mx[x >> 1], v);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);  // finite: key0 is valid
      corr[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) o[n][x] *= corr[x >> 1];
    // P as the A operand (C's two n8 tiles are A's two k8 halves), carried
    // as hi + lo bf16 like K5's
    uint32_t p_hi[4], p_lo[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int n = x >> 1, i = x & 1;
      const float p0 = exp2f(sc[n][2 * i] - m[i]);
      const float p1 = exp2f(sc[n][2 * i + 1] - m[i]);
      l[i] += p0 + p1;
      split_bf16(p0, p1, p_hi[x], p_lo[x]);
    }
    // O += P V: V's rows are keys (K), D contiguous (N): ldmatrix.trans
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t vf[4];  // (keys 0-7 | 8-15) x (columns 16dp.. | +8)
      ldmatrix_x4_trans(vf, vt + L::at(16 * warp + 8 * (mi & 1) + mr,
                                       2 * dp + (mi >> 1)));
      mma_bf16_16816(o[2 * dp], p_hi, vf[0], vf[1]);
      mma_bf16_16816(o[2 * dp + 1], p_hi, vf[2], vf[3]);
      mma_bf16_16816(o[2 * dp], p_lo, vf[0], vf[1]);
      mma_bf16_16816(o[2 * dp + 1], p_lo, vf[2], vf[3]);
    }
  }

  // the warps' (m, l, o) meet in the (now idle) ring
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);
  float* mine = red + warp * F::kWarpFloats;  // o[16][D], m[16], l[16]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
    if (lane % 4 == 0) {
      mine[kDecMaxG * D + r0 + 8 * i] = m[i];
      mine[kDecMaxG * D + kDecMaxG + r0 + 8 * i] = l[i];
    }
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      mine[(r0 + 8 * (x >> 1)) * D + 8 * n + c0 + (x & 1)] = o[n][x];
  __syncthreads();
  for (int i = tid; i < Gc * D; i += kDecTcThreads) {
    const int g = i / D, d = i % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDecTcWarps; ++w)
      M = fmaxf(M, red[w * F::kWarpFloats + kDecMaxG * D + g]);
    float Lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kDecTcWarps; ++w) {
      const float* pw = red + w * F::kWarpFloats;
      const float e = exp2f(pw[kDecMaxG * D + g] - M);  // 0 for an idle warp
      Lsum = fmaf(pw[kDecMaxG * D + kDecMaxG + g], e, Lsum);
      a = fmaf(pw[g * D + d], e, a);
    }
    const long long bh = (long long)b * Hq + h0 + g;
    if (splits == 1) {
      store(out + bh * D + d, a / fmaxf(Lsum, 1e-30f));
    } else {
      part_acc[(bh * splits + split) * D + d] = a;
      if (d == 0) {  // m back in natural units for the merge
        part_m[bh * splits + split] = M * 0.69314718055994531f;
        part_l[bh * splits + split] = Lsum;
      }
    }
  }
}

// The splits of one (b, h) combined in split order:
// out = sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30).
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
    decode_merge_kernel(const float* __restrict__ part_m,
                        const float* __restrict__ part_l,
                        const float* __restrict__ part_acc,
                        T* __restrict__ out, int splits, int D) {
  const long long bh = blockIdx.x;
  const float* pm = part_m + bh * splits;
  float M = -INFINITY;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, pm[s]);
  float L = 0.f;
  for (int s = 0; s < splits; ++s)
    L = fmaf(part_l[bh * splits + s], expf(pm[s] - M), L);
  L = fmaxf(L, 1e-30f);
  for (int d = threadIdx.x; d < D; d += kMergeThreads) {
    float a = 0.f;
    for (int s = 0; s < splits; ++s)
      a = fmaf(part_acc[(bh * splits + s) * D + d], expf(pm[s] - M), a);
    store(out + bh * D + d, a / L);
  }
}

// --------------------------------------------------------------------------
// launches

template <int D>
cudaError_t flash_launch(const void* q, const void* k, const void* v,
                         void* out, int B, int Sq, int Skv, int Hq, int Hkv,
                         int causal, float scale, cudaStream_t st) {
  const dim3 grid((Sq + kFlashBQ - 1) / kFlashBQ, B * Hq);
  flash_attention_kernel<float, D><<<grid, kFlashThreads, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Skv, Hq,
      Hkv, causal, scale);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled from the driver, through the runtime.
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

// A bf16 (B, S, H, D) tensor as a 4-D map over (D, H, S, B), boxes of
// `rows` positions of one head and TcTile<D>::kBoxCols columns.
template <int D>
bool encode_bshd(CUtensorMap* map, const void* ptr, int B, int S, int H,
                 int rows) {
  using F = TcTile<D>;
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)F::kBoxCols, 1, (cuuint32_t)rows,
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                F::kSW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                              : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t flash_tc_launch(const void* q, const void* k, const void* v,
                            void* out, int B, int Sq, int Skv, int Hq,
                            int Hkv, int causal, float scale,
                            cudaStream_t st) {
  using F = TcTile<D>;
  auto kernel = flash_attention_tc_kernel<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F::kSmem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tq, tk, tv;
  if (!encode_bshd<D>(&tq, q, B, Sq, Hq, kTcBM) ||
      !encode_bshd<D>(&tk, k, B, Skv, Hkv, kTcBN) ||
      !encode_bshd<D>(&tv, v, B, Skv, Hkv, kTcBN))
    return cudaErrorInvalidValue;
  const dim3 grid(B * Hq, (Sq + kTcBM - 1) / kTcBM);
  kernel<<<grid, kTcThreads, F::kSmem, st>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), Sq, Skv, Hq, Hkv,
      causal, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// After a split kernel: its launch error, else (with more than one split)
// the merge kernel's.
template <typename T>
cudaError_t merge_after(const float* part_m, const float* part_l,
                        const float* part_acc, void* out, int BH, int splits,
                        int D, cudaStream_t st) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  decode_merge_kernel<T><<<BH, kMergeThreads, 0, st>>>(
      part_m, part_l, part_acc, static_cast<T*>(out), splits, D);
  return cudaGetLastError();
}

template <int D>
cudaError_t decode_launch(const void* q, const void* kc, const void* vc,
                          void* out, float* part_m, float* part_l,
                          float* part_acc, int B, int S, int Hq, int Hkv,
                          int n_valid, int split_len, int splits,
                          float scale, cudaStream_t st) {
  using F = DecTile<D>;
  auto kernel = decode_attention_kernel<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F::kSmem);
  if (attr != cudaSuccess) return attr;
  const int G = Hq / Hkv;
  const dim3 grid(B * Hkv * ((G + kDecMaxG - 1) / kDecMaxG), splits);
  kernel<<<grid, kDecThreads, F::kSmem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(kc),
      static_cast<const float*>(vc), static_cast<float*>(out), part_m,
      part_l, part_acc, S, Hq, Hkv, n_valid, split_len, scale);
  return merge_after<float>(part_m, part_l, part_acc, out, B * Hq, splits,
                            D, st);
}

template <int D>
cudaError_t decode_tc_launch(const void* q, const void* kc, const void* vc,
                             void* out, float* part_m, float* part_l,
                             float* part_acc, int B, int S, int Hq, int Hkv,
                             int n_valid, int split_len, int splits,
                             float scale, cudaStream_t st) {
  using F = DecTcTile<D>;
  auto kernel = decode_attention_tc_kernel<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F::kSmem);
  if (attr != cudaSuccess) return attr;
  const int G = Hq / Hkv;
  const dim3 grid(B * Hkv * ((G + kDecMaxG - 1) / kDecMaxG), splits);
  kernel<<<grid, kDecTcThreads, F::kSmem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kc),
      static_cast<const __nv_bfloat16*>(vc),
      static_cast<__nv_bfloat16*>(out), part_m, part_l, part_acc, S, Hq,
      Hkv, n_valid, split_len, scale * 1.4426950408889634f);
  return merge_after<__nv_bfloat16>(part_m, part_l, part_acc, out, B * Hq,
                                    splits, D, st);
}

// dtype codes shared with the Python wrappers: 0 float32 (F32), 1
// bfloat16 (BF16).
#define ATTN_DISPATCH(F32, BF16, DTYPE, D, ...)                            \
  switch ((DTYPE) * 1000 + (D)) {                                         \
    case 32: return (int)F32<32>(__VA_ARGS__);                            \
    case 64: return (int)F32<64>(__VA_ARGS__);                            \
    case 128: return (int)F32<128>(__VA_ARGS__);                          \
    case 1032: return (int)BF16<32>(__VA_ARGS__);                         \
    case 1064: return (int)BF16<64>(__VA_ARGS__);                         \
    case 1128: return (int)BF16<128>(__VA_ARGS__);                        \
    default: return (int)cudaErrorInvalidValue;                           \
  }

}  // namespace

extern "C" {

const char* attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int Sq, int Skv, int Hq, int Hkv,
                           int D, int causal, float scale, int dtype,
                           void* stream) {
  ATTN_DISPATCH(flash_launch, flash_tc_launch, dtype, D, q, k, v, out, B,
                Sq, Skv, Hq, Hkv, causal, scale, (cudaStream_t)stream)
}

// part_m, part_l (B * Hq * splits) and part_acc (B * Hq * splits * D),
// float32, are read only when splits > 1.
int decode_attention_launch(const void* q, const void* kc, const void* vc,
                            void* out, void* part_m, void* part_l,
                            void* part_acc, int B, int S, int Hq, int Hkv,
                            int D, int n_valid, int split_len, int splits,
                            float scale, int dtype, void* stream) {
  ATTN_DISPATCH(decode_launch, decode_tc_launch, dtype, D, q, kc, vc, out,
                static_cast<float*>(part_m), static_cast<float*>(part_l),
                static_cast<float*>(part_acc), B, S, Hq, Hkv, n_valid,
                split_len, splits, scale, (cudaStream_t)stream)
}

}  // extern "C"
