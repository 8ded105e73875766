// Hand-written Hopper (sm_90a) kernels of the service lowering, one library:
// the workload draws (draws_kernel, here) and the value lowering
// (lower_values_kernel, at the end of the file, with its own note).
//
// The workload draws: the v1 counter-based uniforms and the processes built
// on them, one pass.
//
// No TPU kernel stands behind it: in the reference, XLA fuses this work
// inside the jitted lowering (src/repro/workload/service.py:63,
// src/repro/serve/compile.py:100, src/repro/workload/streaming.py:157).
// It is written by hand because no PyTorch call computes jax's threefry
// (torch.rand is Philox, another function).  Its plain version is the
// eager code of repro_torch/kernels/draws.py::draws_plain.
//
// One kernel, templated on two processes and two forms:
//   * the service process (STREAM_SERVICE, 4 channels): channel 0 drives
//     the ON/OFF arrival chain (resumed from on_in, or started from the
//     STREAM_ARRIVAL_INIT draw u < p_init), channel 1 the image id
//     min(floor(u * S), S - 1), channel 2 the channel change (u < p_change,
//     or global slot 0), channel 3 the rate drawn at a change and held
//     otherwise (resumed from held_in);
//   * the mobility walk (STREAM_TOPOLOGY, 2 channels): channel 0 the
//     handover (u < p_handover), channel 1 the cloudlet drawn at a
//     handover, the association held otherwise (resumed from held_in, or
//     n % K);
//   * the slab form writes rows [off, off + length) of the covering blocks
//     [b0, b0 + nb); the boundary form writes only the state ENTERING each
//     of blocks b0 .. b0 + nb - 1, (nb, n_cols) outputs.
//
// Addressing is the v1 contract: block b's key is fold_in(stream_key, b) =
// threefry2x32(stream_key, (b >> 32, b & 0xffffffff)), folded here from the
// stream key the host passes; element (r, c, n) of a block takes
// threefry2x32(block_key, (i >> 32, i & 0xffffffff)) of the 64-bit counter
// i = (r * C + c) * N + n with n the ABSOLUTE column, and the float32
// uniform ((x0 ^ x1) >> 9 | 0x3f800000) - 1.  So a column range [n0, n0 +
// n_cols) equals the same columns of the full-width draw, past 2^32 too.
//
// One thread per device column walks the slots in order, the chain state
// and the held value in registers: the recurrences are one pass, with no
// scan and no loop on the host.  Rows before `off` (the lead-in of an
// unaligned slab) skip the image draw; rows after the slab are not walked;
// the rate's and the cloudlet's uniform are drawn only at a change.
//
// Bound: about 80 integer instructions a threefry (20 rounds of add,
// rotate, xor and 5 key injections), three to four threefry a (slot,
// device) of the service and one to two of the walk, at the card's int32
// rate; 9 bytes a (slot, device) written by the service slab, 4 by the
// walk.  The integer pipe binds.
//
// Exactness: comparisons and the floor(u * L) product are single-rounded
// float32 as in the plain version; built with -fmad=false like every
// library of the port (nothing here could contract anyway).
//
// Plain C interface for ctypes: the entry point returns the CUDA error code
// of its launch (0 = success) and allocates nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowBlock = 64;  // slots a block key (the v1 contract)
constexpr int kThreads = 128;

__device__ __forceinline__ unsigned rotl(unsigned x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds (jax.random's threefry_2x32).
__device__ __forceinline__ uint2 threefry(unsigned k0, unsigned k1,
                                          unsigned x0, unsigned x1) {
  const unsigned ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (unsigned)(i + 1);
  }
  return make_uint2(x0, x1);
}

// jax.random.uniform's float32 of the bits at 64-bit counter i.
__device__ __forceinline__ float uniform_at(unsigned k0, unsigned k1,
                                            unsigned long long i) {
  const uint2 x = threefry(k0, k1, (unsigned)(i >> 32), (unsigned)i);
  return __uint_as_float(((x.x ^ x.y) >> 9) | 0x3F800000u) - 1.0f;
}

// floor(u * L) as int, clamped at L - 1 (float32 product, one rounding).
__device__ __forceinline__ int level_of(float u, int L) {
  const int idx = (int)floorf(__fmul_rn(u, (float)L));
  return idx < L - 1 ? idx : L - 1;
}

struct Draws {
  unsigned k0, k1;    // stream key
  unsigned ik0, ik1;  // service: STREAM_ARRIVAL_INIT's key (fresh start)
  long long N;        // full fleet width: the counters' row length
  long long n0;       // first column drawn
  int n_cols;
  long long b0;       // first covering block
  int nb;             // covering blocks
  int off, length;    // slab form: rows [off, off + length) are written
  const unsigned char* on_in;  // (n_cols,) chain state entering b0, or null
  const int* held_in;          // (n_cols,) held value entering b0, or null
  float p_a, p_b, p_c, p_d;    // service: p_on, p_stay, p_init, p_change;
                               // walk: p_handover
  int L1, L2;                  // service: S, R; walk: K
  unsigned char* on;           // slab: (length, n_cols)
  int* img;
  int* held;                   // rates / assoc
  unsigned char* on_entry;     // boundary: (nb, n_cols)
  int* held_entry;
};

template <bool kService, bool kBoundary>
__global__ void __launch_bounds__(kThreads) draws_kernel(Draws p) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= p.n_cols) return;
  constexpr int C = kService ? 4 : 2;
  const unsigned long long n = (unsigned long long)(p.n0 + c);
  const unsigned long long N = (unsigned long long)p.N;

  bool s = false;  // arrival chain state (service)
  int held;        // held rate (service) or cloudlet (walk)
  if (kService) {
    s = p.on_in != nullptr ? p.on_in[c] != 0
                           : uniform_at(p.ik0, p.ik1, n) < p.p_c;
    held = p.held_in != nullptr ? p.held_in[c] : 0;  // slot 0 redraws
  } else {
    held = p.held_in != nullptr ? p.held_in[c] : (int)(n % (unsigned)p.L1);
  }

  const long long rows =
      kBoundary ? (long long)(p.nb - 1) * kRowBlock : p.off + p.length;
  const long long ld = p.n_cols;
  for (int b = 0; (long long)b * kRowBlock < rows; ++b) {
    if (kBoundary) {
      if (kService) p.on_entry[b * ld + c] = s;
      p.held_entry[b * ld + c] = held;
    }
    const unsigned long long blk = (unsigned long long)(p.b0 + b);
    const uint2 key = threefry(p.k0, p.k1, (unsigned)(blk >> 32),
                               (unsigned)blk);
    const long long r_end = min((long long)kRowBlock,
                                rows - (long long)b * kRowBlock);
    for (int r = 0; r < r_end; ++r) {
      const long long t = (long long)b * kRowBlock + r;  // row of the window
      const unsigned long long i0 = (unsigned long long)(r * C) * N + n;
      const bool keep = !kBoundary && t >= p.off;
      const long long at = (t - p.off) * ld + c;
      const float u0 = uniform_at(key.x, key.y, i0);
      if (kService) {
        s = s ? (u0 < p.p_b) : (u0 < p.p_a);
        const float u2 = uniform_at(key.x, key.y, i0 + 2 * N);
        const bool slot0 = blk == 0 && r == 0;
        if (u2 < p.p_d || slot0)
          held = level_of(uniform_at(key.x, key.y, i0 + 3 * N), p.L2);
        if (keep) {
          const float u1 = uniform_at(key.x, key.y, i0 + N);
          p.on[at] = s;
          p.img[at] = level_of(u1, p.L1);
          p.held[at] = held;
        }
      } else {
        if (u0 < p.p_a)
          held = level_of(uniform_at(key.x, key.y, i0 + N), p.L1);
        if (keep) p.held[at] = held;
      }
    }
  }
  if (kBoundary) {
    const long long b = p.nb - 1;
    if (kService) p.on_entry[b * ld + c] = s;
    p.held_entry[b * ld + c] = held;
  }
}

}  // namespace

extern "C" {

const char* draws_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// service != 0: the service process, else the walk; boundary != 0: the
// boundary form (on_entry / held_entry), else the slab form (on / img /
// held).  Unused pointers may be null.
int draws_launch(int service, int boundary, unsigned k0, unsigned k1,
                 unsigned ik0, unsigned ik1, long long N, long long n0,
                 int n_cols, long long b0, int nb, int off, int length,
                 const unsigned char* on_in, const int* held_in, float p_a,
                 float p_b, float p_c, float p_d, int L1, int L2,
                 unsigned char* on, int* img, int* held,
                 unsigned char* on_entry, int* held_entry, void* stream) {
  if (n_cols < 1 || nb < 1 || N < 1 || n0 < 0 || n0 + n_cols > N ||
      b0 < 0 || L1 < 1 || (service && L2 < 1))
    return (int)cudaErrorInvalidValue;
  if (!boundary && (off < 0 || length < 1 ||
                    (long long)off + length > (long long)nb * kRowBlock))
    return (int)cudaErrorInvalidValue;
  Draws p{k0, k1, ik0, ik1, N, n0, n_cols, b0, nb, off, length,
          on_in, held_in, p_a, p_b, p_c, p_d, L1, L2,
          on, img, held, on_entry, held_entry};
  const dim3 grid((n_cols + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (service && boundary)
    draws_kernel<true, true><<<grid, kThreads, 0, s>>>(p);
  else if (service)
    draws_kernel<true, false><<<grid, kThreads, 0, s>>>(p);
  else if (boundary)
    draws_kernel<false, true><<<grid, kThreads, 0, s>>>(p);
  else
    draws_kernel<false, false><<<grid, kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// The value lowering (lower_values_kernel): the state index and the raw
// overlay values of every (slot, device) element, as gathers of per-rate
// and per-image records resolved once per compile.
//
// No TPU kernel stands behind it: in the reference, XLA fuses the gathers,
// the risk-adjusted gain and the quantization inside the jitted lowering
// (src/repro/serve/compile.py, src/repro/serve/admission.py's
// quantize_states_device).  Its plain version is the eager per-element
// code of repro_torch/kernels/lower_values.py::lower_values_plain.  Every
// value it computes depends on (rate, image) alone, so the records
// (ValueTables, built with the plain code's own ops on the (R,) and (S,)
// arrays) hold, bit for bit, what it computes per element; this kernel
// adds nothing but j's two integer parts.
//
// Bound: bytes.  An element reads on (1 B), img (4 B) and rates (4 B) and
// writes j and six float32 values (28 B): 37 B, 0.71 ms a slab of 64 x
// 10^6 at 3.35 TB/s.  The records stay in the 50 MB L2 (32 B an image,
// 512 KB at S = 16384), and an element's image record is one 32-byte
// sector.
//
// Design: a thread takes 4 consecutive elements a step: one 32-bit load of
// on and 128-bit loads of img and rates (streaming, evict-first), four
// image-record gathers on the read-only path (16 + 8 bytes of one sector
// each), the rate record from shared memory, and one 128-bit streaming
// store to each of the 7 outputs.  A grid-stride loop over the quads, the
// grid sized to the blocks the SMs hold at once; the last E % 4 elements
// go one a thread.  The launch refuses inputs that do not start on the
// boundaries of these loads (the wrapper makes the outputs, aligned, and
// rejects such views before the launch).  An image or rate index
// outside its table reads entry 0 and writes j = -1, which the rollout's
// range check reports; nothing reads out of bounds.

namespace values {

constexpr int kThreads = 256;
constexpr int kMaxRates = 48 * 1024 / 8;  // rate records in shared memory

struct Tables {
  const int2* rate;   // (R,): o's float32 bits, the rate part of j
  int R;
  const int4* image;  // (S, 2): {part, cycles, w, cl}, {cc, d, pad, pad}
  int S;
};

struct Out {
  int* j;
  float* o;
  float* h;
  float* w;
  float* cl;
  float* cc;
  float* d;
};

struct Value {
  int j;
  float o, h, w, cl, cc, d;
};

__device__ __forceinline__ Value lower_one(unsigned on, int img, int rate,
                                           const int2* srate,
                                           const Tables& t) {
  const bool img_ok = (unsigned)img < (unsigned)t.S;
  const bool rate_ok = (unsigned)rate < (unsigned)t.R;
  const int4* rec = t.image + 2 * (img_ok ? img : 0);
  const int4 a = __ldg(rec);
  const int2 b = __ldg(reinterpret_cast<const int2*>(rec + 1));
  const int2 r = srate[rate_ok ? rate : 0];
  Value v;
  v.j = (img_ok && rate_ok) ? (on ? r.y + a.x : 0) : -1;
  v.o = __int_as_float(r.x);
  v.h = __int_as_float(a.y);
  v.w = __int_as_float(a.z);
  v.cl = __int_as_float(a.w);
  v.cc = __int_as_float(b.x);
  v.d = __int_as_float(b.y);
  return v;
}

__global__ void __launch_bounds__(kThreads)
lower_values_kernel(const unsigned char* __restrict__ on,
                    const int* __restrict__ img,
                    const int* __restrict__ rates, Tables t, long long E,
                    Out out) {
  extern __shared__ int2 srate[];  // t.R records
  for (int k = threadIdx.x; k < t.R; k += blockDim.x) srate[k] = t.rate[k];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long Q = E >> 2;
  for (long long q = tid; q < Q; q += stride) {
    const unsigned on4 = __ldcs(reinterpret_cast<const unsigned*>(on) + q);
    const int4 i4 = __ldcs(reinterpret_cast<const int4*>(img) + q);
    const int4 r4 = __ldcs(reinterpret_cast<const int4*>(rates) + q);
    const Value v0 = lower_one(on4 & 0xffu, i4.x, r4.x, srate, t);
    const Value v1 = lower_one((on4 >> 8) & 0xffu, i4.y, r4.y, srate, t);
    const Value v2 = lower_one((on4 >> 16) & 0xffu, i4.z, r4.z, srate, t);
    const Value v3 = lower_one(on4 >> 24, i4.w, r4.w, srate, t);
    __stcs(reinterpret_cast<int4*>(out.j) + q,
           make_int4(v0.j, v1.j, v2.j, v3.j));
    __stcs(reinterpret_cast<float4*>(out.o) + q,
           make_float4(v0.o, v1.o, v2.o, v3.o));
    __stcs(reinterpret_cast<float4*>(out.h) + q,
           make_float4(v0.h, v1.h, v2.h, v3.h));
    __stcs(reinterpret_cast<float4*>(out.w) + q,
           make_float4(v0.w, v1.w, v2.w, v3.w));
    __stcs(reinterpret_cast<float4*>(out.cl) + q,
           make_float4(v0.cl, v1.cl, v2.cl, v3.cl));
    __stcs(reinterpret_cast<float4*>(out.cc) + q,
           make_float4(v0.cc, v1.cc, v2.cc, v3.cc));
    __stcs(reinterpret_cast<float4*>(out.d) + q,
           make_float4(v0.d, v1.d, v2.d, v3.d));
  }
  for (long long e = (Q << 2) + tid; e < E; e += stride) {
    const Value v = lower_one(on[e], img[e], rates[e], srate, t);
    out.j[e] = v.j;
    out.o[e] = v.o;
    out.h[e] = v.h;
    out.w[e] = v.w;
    out.cl[e] = v.cl;
    out.cc[e] = v.cc;
    out.d[e] = v.d;
  }
}

bool aligned(const void* p, uintptr_t to) {
  return ((uintptr_t)p & (to - 1)) == 0;
}

// Blocks of the kernel each SM holds at once with `smem` bytes of shared
// memory a block (asked again only where `smem` changes).
int resident_blocks(size_t smem) {
  static size_t asked = 0;
  static int n = 0;
  if (asked != smem) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, lower_values_kernel, kThreads, smem) != cudaSuccess)
      n = 1;
    asked = smem;
  }
  return n > 0 ? n : 1;
}

int launch(const unsigned char* on, const int* img, const int* rates,
           const int* rate_rec, int R, const int* image_rec, int S,
           long long E, const Out& out, cudaStream_t s) {
  if (R < 1 || R > kMaxRates || S < 1 || E < 0 || !aligned(image_rec, 32) ||
      !aligned(rate_rec, 8) || !aligned(on, 4) || !aligned(img, 16) ||
      !aligned(rates, 16))
    return (int)cudaErrorInvalidValue;
  if (E == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const Tables t{reinterpret_cast<const int2*>(rate_rec), R,
                 reinterpret_cast<const int4*>(image_rec), S};
  const size_t smem = (size_t)R * sizeof(int2);
  const long long cap = (long long)sms * resident_blocks(smem);
  long long grid = ((E >> 2) + kThreads - 1) / kThreads;
  if (grid > cap) grid = cap;
  if (grid < 1) grid = 1;
  lower_values_kernel<<<(unsigned)grid, kThreads, smem, s>>>(on, img, rates,
                                                             t, E, out);
  return (int)cudaGetLastError();
}

}  // namespace values

extern "C" {

// on (E,) bool bytes, img / rates (E,) int32; rate_rec (R, 2) and
// image_rec (S, 8) int32, image_rec 32-byte, on 4-byte and img / rates
// 16-byte aligned; outputs (E,), 16-byte aligned: j int32, then o, h, w,
// correct_local, correct_cloud, d_local float32.
int lower_values_launch(const unsigned char* on, const int* img,
                        const int* rates, const int* rate_rec, int R,
                        const int* image_rec, int S, long long E, int* j,
                        float* o, float* h, float* w, float* cl, float* cc,
                        float* d, void* stream) {
  return values::launch(on, img, rates, rate_rec, R, image_rec, S, E,
                        values::Out{j, o, h, w, cl, cc, d},
                        (cudaStream_t)stream);
}

}  // extern "C"
