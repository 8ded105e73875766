// Hand-written Hopper (sm_90a) attention kernels for the cloudlet LM.
//
// Replaces the Pallas TPU kernels
//   flash_attention_kernel   <- src/repro/kernels/flash_attention.py
//                               flash_attention_pallas (_flash_kernel)
//   decode_attention_kernel  <- src/repro/kernels/decode_attention.py
//                               decode_attention_pallas (_decode_kernel)
// and computes what their bodies compute: inputs loaded in their dtype
// (float32 or bfloat16) and converted to float32, scores (q . k) * D^-0.5
// in float32, masked scores set to -1e30, online softmax (m, l, acc) in
// float32, l floored at 1e-30, the output cast to q's dtype.  GQA is by
// index: query head h reads KV head h / (Hq / Hkv) of its batch row; K/V
// are never repeated.  Layouts are the model's: q and out (B, Sq, Hq, D),
// k and v (B, Skv, Hkv, D), all contiguous.
//
// What bounds them on the card.
//   flash_attention: operations.  4 B Hq Sq Skv D flops (about half when
//     causal) against q/k/v/out read and written once; at B=4, S=2048,
//     Hq=16, D=128 in bfloat16 that is 1.37e11 flops (0.139 ms at 989
//     TFLOP/s on the tensor cores) against 0.040 ms of bytes.
//   decode_attention: bytes.  One query row against cache_len keys: the
//     K and V rows below cache_len are read once, 4 flops per byte pair;
//     at B=16, cache_len=4096, Hkv=16, D=128 in bfloat16 that is 537 MB,
//     0.160 ms at 3.35 TB/s.
//
// Design (first version: simple and right, on the CUDA cores in float32):
//   flash_attention: one block per (query tile of 64 rows, b * Hq + h),
//     256 threads, 4 threads per query row, each owning D/4 of the row's
//     q and accumulator in registers (float4 chunks, interleaved so the 4
//     lanes of a row read neighbouring shared-memory words).  The TPU's
//     sequential KV grid axis becomes a loop over 32-key tiles staged in
//     shared memory as float32 (32 KB for K and V at D=128).  Per tile a
//     thread forms its 32 partial dots, two xor-shuffles finish them, the
//     tile max updates m once, and p * v accumulates.  Causal blocks stop
//     at their last row's position: later tiles are masked for every row
//     and contribute exactly 0 after the first tile (which always holds
//     key 0, so m is finite from then on).  Query tiles run from the last
//     (the heaviest under the causal mask) to the first.  The tensor cores
//     (mma / wgmma on bf16 tiles) are the next step.
//   decode_attention: one block per (b, query head), 256 threads.  A key
//     row is read by D*sizeof(T)/16 lanes, 16 bytes each, neighbouring
//     lanes on neighbouring d; the block's groups of lanes stride over the
//     keys below cache_len only (the masked tail contributes exactly 0),
//     four keys per group in flight, each group keeping its own (m, l,
//     acc); the groups merge through shared memory at the end.  At the
//     check shape, B * Hq = 256 blocks are all resident on the 132 SMs,
//     so there is no split over the cache.
//
// fmaf() is written out where a product is accumulated: the library is
// built with -fmad=false (for onalgo_step.cu's exact rounding), which only
// stops the compiler from contracting a * b + c by itself.
//
// Plain C interface for ctypes: every entry point returns the CUDA error
// code of its launch (0 = success) and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernels' mask value
constexpr unsigned kFull = 0xffffffffu;

constexpr int kFlashBQ = 64;   // query rows per block
constexpr int kFlashTPR = 4;   // threads per query row
constexpr int kFlashThreads = kFlashBQ * kFlashTPR;
constexpr int kFlashBK = 32;   // keys per shared-memory tile

constexpr int kDecodeThreads = 256;
constexpr int kDecodeUnroll = 4;  // keys in flight per group of lanes

// 4 consecutive elements -> float (8 bytes of bf16, 16 of float).
__device__ __forceinline__ void load4(const float* p, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* dst) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  dst[0] = bf16_lo(u.x);
  dst[1] = bf16_hi(u.x);
  dst[2] = bf16_lo(u.y);
  dst[3] = bf16_hi(u.y);
}

// 16 bytes -> float: 4 floats or 8 bf16.
template <typename T>
struct Vec16 {
  static constexpr int n = 16 / sizeof(T);
};

__device__ __forceinline__ void load16(const float* p, float* dst) {
  load4(p, dst);
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dst[2 * i] = bf16_lo(w[i]);
    dst[2 * i + 1] = bf16_hi(w[i]);
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// --------------------------------------------------------------------------
// K5: flash attention

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
// K6: flash-decode

template <typename T, int D>
__global__ void __launch_bounds__(kDecodeThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                            const T* __restrict__ vc, T* __restrict__ out,
                            int S, int Hq, int Hkv, int n_valid,
                            float scale) {
  constexpr int kVec = Vec16<T>::n;       // elements per 16-byte load
  constexpr int kTPR = D / kVec;          // lanes per key row
  constexpr int kGroups = kDecodeThreads / kTPR;
  static_assert(kTPR >= 1 && kTPR <= 32 && 32 % kTPR == 0,
                "a key row must map onto whole lanes of one warp");
  __shared__ float m_s[kGroups];
  __shared__ float l_s[kGroups];
  __shared__ float acc_s[kGroups][D];

  const int tid = threadIdx.x;
  const int g = tid / kTPR, lane = tid % kTPR;
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);

  float qr[kVec];
  load16(q + ((long long)b * Hq + h) * D + lane * kVec, qr);
  float acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
  float m = kNegInf, l = 0.f;

  const long long stride = (long long)Hkv * D;  // from key j to j + 1
  const long long base = (long long)b * S * stride + (long long)hk * D +
                         lane * kVec;
  // The loop bound is the same for every thread, so whole warps stay
  // together at the shuffles; keys at or past n_valid are predicated off.
  for (int j0 = 0; j0 < n_valid; j0 += kGroups * kDecodeUnroll) {
    float kr[kDecodeUnroll][kVec], vr[kDecodeUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kDecodeUnroll; ++u) {
      const int j = j0 + u * kGroups + g;
      if (j < n_valid) {
        load16(kc + base + j * stride, kr[u]);
        load16(vc + base + j * stride, vr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) kr[u][e] = vr[u][e] = 0.f;
      }
    }
    float s[kDecodeUnroll];
    float mt = m;
#pragma unroll
    for (int u = 0; u < kDecodeUnroll; ++u) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < kVec; ++e) part = fmaf(qr[e], kr[u][e], part);
#pragma unroll
      for (int o = kTPR / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(kFull, part, o);
      const int j = j0 + u * kGroups + g;
      s[u] = j < n_valid ? part * scale : -INFINITY;
      mt = fmaxf(mt, s[u]);
    }
    const float corr = expf(m - mt);
    l *= corr;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] *= corr;
#pragma unroll
    for (int u = 0; u < kDecodeUnroll; ++u) {
      const float p = expf(s[u] - mt);
      l += p;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = fmaf(p, vr[u][e], acc[e]);
    }
    m = mt;
  }

  if (lane == 0) {
    m_s[g] = m;
    l_s[g] = l;
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc_s[g][lane * kVec + e] = acc[e];
  __syncthreads();
  for (int d = tid; d < D; d += kDecodeThreads) {
    float M = kNegInf;
    for (int i = 0; i < kGroups; ++i) M = fmaxf(M, m_s[i]);
    float L = 0.f, a = 0.f;
    for (int i = 0; i < kGroups; ++i) {
      const float w = expf(m_s[i] - M);  // 0 for a group that saw no key
      L = fmaf(l_s[i], w, L);
      a = fmaf(acc_s[i][d], w, a);
    }
    store(out + ((long long)b * Hq + h) * D + d, a / fmaxf(L, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t flash_launch(const void* q, const void* k, const void* v,
                         void* out, int B, int Sq, int Skv, int Hq, int Hkv,
                         int causal, float scale, cudaStream_t st) {
  const dim3 grid((Sq + kFlashBQ - 1) / kFlashBQ, B * Hq);
  flash_attention_kernel<T, D><<<grid, kFlashThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, Hq, Hkv,
      causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t decode_launch(const void* q, const void* kc, const void* vc,
                          void* out, int B, int S, int Hq, int Hkv,
                          int n_valid, float scale, cudaStream_t st) {
  decode_attention_kernel<T, D><<<B * Hq, kDecodeThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<T*>(out), S, Hq, Hkv, n_valid,
      scale);
  return cudaGetLastError();
}

// dtype codes shared with the Python wrappers: 0 float32, 1 bfloat16.
#define ATTN_DISPATCH(LAUNCH, DTYPE, D, ...)                               \
  switch ((DTYPE) * 1000 + (D)) {                                         \
    case 32: return (int)LAUNCH<float, 32>(__VA_ARGS__);                  \
    case 64: return (int)LAUNCH<float, 64>(__VA_ARGS__);                  \
    case 128: return (int)LAUNCH<float, 128>(__VA_ARGS__);                \
    case 1032: return (int)LAUNCH<__nv_bfloat16, 32>(__VA_ARGS__);        \
    case 1064: return (int)LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__);        \
    case 1128: return (int)LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__);       \
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
  ATTN_DISPATCH(flash_launch, dtype, D, q, k, v, out, B, Sq, Skv, Hq, Hkv,
                causal, scale, (cudaStream_t)stream)
}

int decode_attention_launch(const void* q, const void* kc, const void* vc,
                            void* out, int B, int S, int Hq, int Hkv, int D,
                            int n_valid, float scale, int dtype,
                            void* stream) {
  ATTN_DISPATCH(decode_launch, dtype, D, q, kc, vc, out, B, S, Hq, Hkv,
                n_valid, scale, (cudaStream_t)stream)
}

}  // extern "C"
