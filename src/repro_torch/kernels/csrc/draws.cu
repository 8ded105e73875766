// Hand-written Hopper (sm_90a) kernel for the workload draws: the v1
// counter-based uniforms and the processes built on them, one pass.
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
