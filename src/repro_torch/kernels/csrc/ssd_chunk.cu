// Hand-written Hopper (sm_90a) kernel for the Mamba2 / SSD chunk (K4).
//
// Replaces the Pallas TPU kernel
//   ssd_chunk_kernel  <- src/repro/kernels/ssd_chunk.py ssd_chunk_pallas
//                        (_ssd_kernel)
// and computes what its body computes, for one (batch * chunk, head) cell
// of Q <= 128 positions, all in float32:
//   xbar = x * dt,  cs = cumsum(dt * A),  decay = exp(cs[Q-1] - cs),
//   y_diag[i, :] = sum_{j <= i} (C_i . B_j) exp(cs[i] - cs[j]) xbar[j, :],
//   states[:, :] = sum_j xbar[j, :]^T (B_j decay[j]).
// Layouts are the model's: x and y (BC, Q, H, P), dt (BC, Q, H), A (H,),
// B and C (BC, Q, G, N) with G dividing H (G == H is the reference's
// head-expanded form; head h reads group h / (H / G)), states
// (BC, H, P, N); all contiguous.
//
// What bounds it on the card: operations.  Per cell the causal products
// need (N + P) Q (Q + 1) + 2 Q P N flops against x, dt, B, C read once and
// y, states written once; at mamba2-370m's long forward (BC = 4 x 16
// chunks of Q = 128, H = 32, P = 64, N = 128, G = 1) that is 10.8 GFLOP,
// 0.161 ms at 67 TFLOP/s in float32 (the TPU kernel's full Q x Q form is
// 17.2 GFLOP), against 211 MB, 0.063 ms at 3.35 TB/s (471 MB, 0.140 ms,
// with B and C head-expanded).  At the serving wave (BC = 16, Q = 16) the
// bytes bound: 21 MB of x, y and states against 0.16 GFLOP.
//
// Design (first version: simple and right, on the CUDA cores):
//   one block of 256 threads (8 warps) per (cell, head).  The cell's B, C
//   and xbar rows go to shared memory once (zero-padded to a multiple of
//   32 rows; B and C rows strided N + 4 floats so that eight lanes reading
//   eight rows with 16-byte loads hit distinct banks), and one thread
//   takes the cumsum in order.  At Q = 128, N = 128, P = 64 that is 182
//   KB, so one block runs per SM.  The scores are never stored whole: each
//   warp owns 4 rows of a 32-row tile, forms C_i . B_j for the keys
//   j <= its last row (lanes over j, float4 steps over N), applies the
//   mask and exp(cs[i] - cs[j]) from the cs vector (L is never stored),
//   writes its 4 rows to its own slice of a shared tile and multiplies
//   them into xbar (lanes over the head dim).  Warps touch only their own
//   tile rows, so the tile loop needs no block barrier.  The states loop
//   runs over all Q positions, each warp owning P / 8 rows of the (P, N)
//   state and each lane 4 of its columns.  The tensor cores (mma on tf32
//   or bf16 tiles) and several cells per block are the next steps.
//
// fmaf() is written out where a product is accumulated: the library is
// built with -fmad=false (the flags are shared with onalgo_step.cu), so
// the compiler does not contract a * b + c by itself.
//
// Plain C interface for ctypes: the entry point returns the CUDA error
// code of its launch (0 = success) and allocates nothing.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                 // score rows per warp per tile
constexpr int kTile = kWarps * kRows;    // 32 score rows per tile
constexpr int kMaxQ = 128;
constexpr int kCols = kMaxQ / 32;        // key groups per lane: lane + 32 c
constexpr int kMaxN = 128;
constexpr int kNC = kMaxN / 32;          // state columns per lane

__host__ __device__ inline int padded_rows(int Q) {
  return (Q + kTile - 1) / kTile * kTile;
}

// Floats of dynamic shared memory: B, C [QA][N + 4], xbar [QA][P], the
// score tile [kTile][QA + 4], dt and cs [QA].
__host__ __device__ inline int smem_floats(int Q, int P, int N) {
  const int QA = padded_rows(Q);
  return 2 * QA * (N + 4) + QA * P + kTile * (QA + 4) + 2 * QA;
}

template <int P>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A,
                     const float* __restrict__ Bm,
                     const float* __restrict__ Cm, float* __restrict__ y,
                     float* __restrict__ st, int Q, int H, int G, int N) {
  static_assert(P % 32 == 0 || P == 16, "head dim must be 16 or 32 k");
  constexpr int P4 = P / 4;
  constexpr int PC = (P + 31) / 32;   // head-dim columns per lane
  constexpr int RP = P / kWarps;      // state rows per warp
  extern __shared__ float4 smem4[];
  const int QA = padded_rows(Q);
  const int LN = N + 4, LN4 = LN / 4, N4 = N / 4;
  const int LM = QA + 4, LM4 = LM / 4;
  float* Bs = reinterpret_cast<float*>(smem4);  // [QA][LN]
  float* Cs = Bs + QA * LN;                       // [QA][LN]
  float* Xs = Cs + QA * LN;                       // [QA][P]: x * dt
  float* Ms = Xs + QA * P;                        // [kTile][LM]
  float* dts = Ms + kTile * LM;                   // [QA]
  float* cs = dts + QA;                           // [QA]

  const long long bc = blockIdx.x;
  const int hd = blockIdx.y;
  const int grp = hd / (H / G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int j = tid; j < QA; j += kThreads)
    dts[j] = j < Q ? dt[(bc * Q + j) * H + hd] : 0.f;
  __syncthreads();
  if (tid == 0) {  // cs = cumsum(dt * A) in position order
    const float a = A[hd];
    float s = 0.f;
    for (int j = 0; j < Q; ++j) {
      s += dts[j] * a;
      cs[j] = s;
    }
    for (int j = Q; j < QA; ++j) cs[j] = s;
  }
  for (int e = tid; e < QA * P4; e += kThreads) {
    const int j = e / P4, c = e % P4;
    float4 v = zero;
    if (j < Q) {
      v = *reinterpret_cast<const float4*>(x + ((bc * Q + j) * H + hd) * P +
                                           4 * c);
      const float d = dts[j];
      v.x *= d;
      v.y *= d;
      v.z *= d;
      v.w *= d;
    }
    reinterpret_cast<float4*>(Xs)[j * P4 + c] = v;
  }
  for (int e = tid; e < QA * N4; e += kThreads) {
    const int j = e / N4, c = e % N4;
    float4 vb = zero, vc = zero;
    if (j < Q) {
      const long long off = ((bc * Q + j) * G + grp) * N + 4 * c;
      vb = *reinterpret_cast<const float4*>(Bm + off);
      vc = *reinterpret_cast<const float4*>(Cm + off);
    }
    reinterpret_cast<float4*>(Bs + j * LN)[c] = vb;
    reinterpret_cast<float4*>(Cs + j * LN)[c] = vc;
  }
  __syncthreads();

  // ---- y_diag, 32 rows at a time; warp w owns rows ib .. ib + 3
  const float4* B4 = reinterpret_cast<const float4*>(Bs);
  const float4* C4 = reinterpret_cast<const float4*>(Cs);
  float* Mw = Ms + warp * kRows * LM;  // this warp's rows of the tile
  const float4* M4 = reinterpret_cast<const float4*>(Mw);
  for (int i0 = 0; i0 < Q; i0 += kTile) {
    const int ib = i0 + warp * kRows;
    if (ib >= Q) break;  // warp-uniform, and no block barrier follows
    const int ncol = (ib + kRows + 31) / 32;  // key groups with j <= ib + 3
    float acc[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
    for (int k = 0; k < N4; ++k) {
      float4 cr[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) cr[r] = C4[(ib + r) * LN4 + k];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (c < ncol) {
          const float4 bv = B4[(lane + 32 * c) * LN4 + k];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            acc[r][c] = fmaf(cr[r].x, bv.x, acc[r][c]);
            acc[r][c] = fmaf(cr[r].y, bv.y, acc[r][c]);
            acc[r][c] = fmaf(cr[r].z, bv.z, acc[r][c]);
            acc[r][c] = fmaf(cr[r].w, bv.w, acc[r][c]);
          }
        }
      }
    }
    // (C B^T o L) for these rows: L[i, j] = exp(cs[i] - cs[j]) for j <= i
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = ib + r;
      const float ci = cs[i];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (c < ncol) {
          const int j = lane + 32 * c;
          Mw[r * LM + j] =
              (i < Q && j <= i) ? acc[r][c] * expf(ci - cs[j]) : 0.f;
        }
      }
    }
    __syncwarp();
    float ya[kRows][PC];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < PC; ++c) ya[r][c] = 0.f;
    const int jn = min(ib + kRows, Q);  // keys j <= i of these rows
    for (int j4 = 0; j4 < (jn + 3) / 4; ++j4) {
      float4 m[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) m[r] = M4[r * LM4 + j4];
      const float* xr = Xs + 4 * j4 * P;
#pragma unroll
      for (int c = 0; c < PC; ++c) {
        const int pp = lane + 32 * c;
        if (pp < P) {
          const float x0 = xr[pp], x1 = xr[P + pp], x2 = xr[2 * P + pp],
                      x3 = xr[3 * P + pp];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            ya[r][c] = fmaf(m[r].x, x0, ya[r][c]);
            ya[r][c] = fmaf(m[r].y, x1, ya[r][c]);
            ya[r][c] = fmaf(m[r].z, x2, ya[r][c]);
            ya[r][c] = fmaf(m[r].w, x3, ya[r][c]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = ib + r;
      if (i >= Q) break;
#pragma unroll
      for (int c = 0; c < PC; ++c) {
        const int pp = lane + 32 * c;
        if (pp < P) y[((bc * Q + i) * H + hd) * P + pp] = ya[r][c];
      }
    }
    __syncwarp();  // the next tile rewrites this warp's rows
  }

  // ---- states = sum_j xbar[j]^T (B_j decay[j]); warp w owns rows
  //      w * RP .. w * RP + RP - 1 of the (P, N) state
  const float cs_last = cs[Q - 1];
  float sa[RP][kNC];
#pragma unroll
  for (int r = 0; r < RP; ++r)
#pragma unroll
    for (int c = 0; c < kNC; ++c) sa[r][c] = 0.f;
  for (int j = 0; j < Q; ++j) {
    const float d = expf(cs_last - cs[j]);
    float xv[RP];
    const float2* x2 = reinterpret_cast<const float2*>(Xs + j * P +
                                                       warp * RP);
#pragma unroll
    for (int r = 0; r < RP / 2; ++r) {
      const float2 v = x2[r];
      xv[2 * r] = v.x;
      xv[2 * r + 1] = v.y;
    }
    float bd[kNC];
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      const int nn = lane + 32 * c;
      bd[c] = nn < N ? Bs[j * LN + nn] * d : 0.f;
    }
#pragma unroll
    for (int r = 0; r < RP; ++r)
#pragma unroll
      for (int c = 0; c < kNC; ++c) sa[r][c] = fmaf(xv[r], bd[c], sa[r][c]);
  }
  float* sout = st + ((bc * H + hd) * P + warp * RP) * N;
#pragma unroll
  for (int r = 0; r < RP; ++r)
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      const int nn = lane + 32 * c;
      if (nn < N) sout[r * N + nn] = sa[r][c];
    }
}

template <int P>
cudaError_t ssd_launch(const float* x, const float* dt, const float* A,
                       const float* Bm, const float* Cm, float* y, float* st,
                       int BC, int Q, int H, int G, int N, cudaStream_t s) {
  const int smem = (int)sizeof(float) * smem_floats(Q, P, N);
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  ssd_chunk_kernel<P><<<dim3(BC, H), kThreads, smem, s>>>(
      x, dt, A, Bm, Cm, y, st, Q, H, G, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ssd_chunk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int ssd_chunk_launch(const void* x, const void* dt, const void* A,
                     const void* Bm, const void* Cm, void* y, void* st,
                     int BC, int Q, int H, int G, int P, int N,
                     void* stream) {
  if (Q < 1 || Q > kMaxQ || N < 4 || N > kMaxN || N % 4 || G < 1 || H % G)
    return (int)cudaErrorInvalidValue;
  const float *xf = static_cast<const float*>(x),
              *df = static_cast<const float*>(dt),
              *af = static_cast<const float*>(A),
              *bf = static_cast<const float*>(Bm),
              *cf = static_cast<const float*>(Cm);
  float *yf = static_cast<float*>(y), *sf = static_cast<float*>(st);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (P) {
    case 16: return (int)ssd_launch<16>(xf, df, af, bf, cf, yf, sf, BC, Q, H, G, N, s);
    case 32: return (int)ssd_launch<32>(xf, df, af, bf, cf, yf, sf, BC, Q, H, G, N, s);
    case 64: return (int)ssd_launch<64>(xf, df, af, bf, cf, yf, sf, BC, Q, H, G, N, s);
    case 128: return (int)ssd_launch<128>(xf, df, af, bf, cf, yf, sf, BC, Q, H, G, N, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
