// Even-odd fat + naik (HISQ) staggered hopping term, 16-term form, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel qex_tpu/physics/stag_pallas_hisq.py
// `_hisq_kernel` in its 16-term mode (called by `dslash_pallas_hisq`,
// `d2ee_pallas_hisq` and `d2dd_pallas_hisq` on links built by
// `new_pallas_hisq`).  It computes what that kernel computes, not its
// block structure:
//
//     out(x) = sum_{t<16} L_t(x) psi(x + d_t)
//
// with every link pre-shifted and pre-adjointed at the output site and
// +-1/2 folded in.  Term t = kind*4 + mu: kind 0 is the fat forward hop
// (+1/2 fat_mu(x), distance 1), kind 1 the fat backward hop
// (-1/2 fat_mu(x-mu)^dag), kind 2 the naik forward hop (+1/2 long_mu(x),
// distance 3) and kind 3 the naik backward hop (-1/2 long_mu(x-3mu)^dag);
// `term_geom` holds each term's direction, sign and distance.
// Optionally the d2ee epilogue is fused: out = m2 * xfuse - sum_t ...
//
// The kernel is a template on the link element type.  With float links
// it is kernel B2, the true operator; with __nv_bfloat16 links it is
// kernel B2b, the inner operator of the sloppy CG (links from
// `new_pallas_hisq(..., links_dtype=bfloat16)`): each link element is
// widened to float (exactly), and the spinor, the sums and the output
// stay float, as the TPU kernel does (stag_pallas_hisq.py:236-237, :349).
//
// Layouts (all contiguous, V = Th*Z*Y*X half-lattice sites, site index
// (th, z, y, x) with x fastest):
//   links  float32 or bfloat16 (16, 2, 3, 3, Th, Z, Y*X)  split re/im,
//          as qex_tpu's l_e/l_o
//   psi    complex64 (3, Th, Z, Y*X)          interleaved re/im (float2)
//   xfuse  complex64 (3, Th, Z, Y*X) or null
//   out    complex64 (3, Th, Z, Y*X)
//
// Neighbours: x, y and z hops of distance d = 1 or 3 wrap modulo the
// extent (a single conditional wrap is wrong at distance 3 when an extent
// is 4 or less).  A t hop moves th by a sublattice-dependent amount: with
// s = (parity_out + x + y + z) & 1 a forward hop of distance d lands at
// th + (d-1)/2 + s and a backward hop at th - (d+1)/2 + s, both modulo Th
// (Th = 2 works: th + 2 == th).
//
// What bounds it on an H100: per output site it reads 16*72 B of links
// (16*36 B as bf16), one spinor of 24 B (each neighbour is some other
// thread's centre) and writes 24 B: 1,200 B/site for float links, 624 for
// bf16, against 1,152 flops/site, about 1 flop/B against the card's
// ~20 flop/B float32 ridge, so it is memory-bound.  A first design (one
// site a thread, every load a scalar __ldg, 78 registers, 256-thread
// blocks) reached 52-59% of the measured stream with bf16 links and
// 80-86% with f32.  Split into a links-only and a gathers-only kernel,
// its bf16 link stream alone took 60% of the hop and its sixteen gathers
// alone 23%: neither stream set the time, the loads a thread could keep
// in flight did.  This design:
//   - K = kSites = 4 consecutive sites along x per thread (the vector
//     path): each link load covers the four sites (8 B of bf16, 16 B of
//     float), so a register holds two bf16 link elements and a warp
//     instruction moves 256-512 B; the y and z gathers, the fused xfuse
//     read and the store move two sites (16 B) at a time; x and t gathers
//     stay per site (the sublattice, hence the t plane, alternates with
//     x);
//   - 64-thread blocks with at least six resident an SM: up to 170
//     registers a thread (ptxas takes 168) for the loads in flight, and
//     a grid of many small blocks that leaves no tail at 24^4;
//   - link loads bypass L1 (`L1::no_allocate`) with an L2 evict_first
//     policy: each link element is read once, and this keeps L1 and L2
//     for the spinor that the gathers re-read.
// Measured by graph replay on an H100 (PERF.md), the hop runs at 93-100%
// of the measured stream.  Shared-memory tiles with bulk copies were not
// built: they could save at most the last 7%.
// A grid that the vector path does not fit (X % K != 0, or operands not
// aligned to 16 B) runs the per-site kernel, the first design unchanged.
// The wrapper chooses the kernel and the grid
// (`stag_hisq.hisq16_geometry`).  Offsets into the link array are size_t
// (it holds 1.2 GB at 32^3x64).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

// sites a thread on the vector path, and its block size and the blocks
// an SM must hold: the register budget (65,536 / (64 * 6) = 170 a thread)
// that it needs to keep its loads in flight
constexpr int kSites = 4;
constexpr int kVectorThreads = 64;
constexpr int kVectorMinBlocks = 6;
// block size of the per-site path
constexpr int kSiteThreads = 256;

// Term t -> {mu, sign, distance}: psi is read at x + sign*distance*mu.
__device__ __forceinline__ int term_geom(int t, int f) {
  constexpr int g[16][3] = {{0, 1, 1},  {1, 1, 1},  {2, 1, 1},  {3, 1, 1},
                            {0, -1, 1}, {1, -1, 1}, {2, -1, 1}, {3, -1, 1},
                            {0, 1, 3},  {1, 1, 3},  {2, 1, 3},  {3, 1, 3},
                            {0, -1, 3}, {1, -1, 3}, {2, -1, 3}, {3, -1, 3}};
  return g[t][f];
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// kSites consecutive link elements at p (aligned to their size), widened
// to float, read past L1 with the L2 policy `pol`.
__device__ __forceinline__ void load_links(const float* p, uint64_t pol,
                                           float (&f)[kSites]) {
  static_assert(kSites == 4, "one 16-B load");
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.f32 "
      "{%0, %1, %2, %3}, [%4], %5;"
      : "=f"(f[0]), "=f"(f[1]), "=f"(f[2]), "=f"(f[3])
      : "l"(p), "l"(pol));
}

__device__ __forceinline__ void load_links(const __nv_bfloat16* p,
                                           uint64_t pol,
                                           float (&f)[kSites]) {
  static_assert(kSites == 4, "one 8-B load");
  unsigned w0, w1;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v2.b32 {%0, %1}, "
      "[%2], %3;" : "=r"(w0), "=r"(w1) : "l"(p), "l"(pol));
  f[0] = __uint_as_float(w0 << 16);
  f[1] = __uint_as_float(w0 & 0xffff0000u);
  f[2] = __uint_as_float(w1 << 16);
  f[3] = __uint_as_float(w1 & 0xffff0000u);
}

// (c + k) mod n for |k| <= 3 and n >= 1, without a negative result.
__device__ __forceinline__ int wrap(int c, int k, int n) {
  return (c + k + 4 * n) % n;
}

// The vector path: thread i of the grid takes the K = kSites sites
// site0 = K*i .. site0+K-1 of one x row (X % K == 0, operands aligned).
template <typename L>
__global__ void __launch_bounds__(kVectorThreads, kVectorMinBlocks)
hisq16_vector_kernel(const L* __restrict__ links,
                     const float2* __restrict__ psi,
                     const float2* __restrict__ xfuse,
                     float2* __restrict__ out, float m2, int X, int Y,
                     int Z, int Th, int parity_out) {
  constexpr int K = kSites;
  const int YX = X * Y;
  const int ZYX = Z * YX;
  const int V = Th * ZYX;
  const long long first =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * K;
  if (first >= V) return;
  const int site0 = static_cast<int>(first);
  const uint64_t pol = evict_first_policy();
  const size_t Vs = static_cast<size_t>(V);
  const int yx = site0 % YX;
  const int z = (site0 / YX) % Z;
  const int th = site0 / ZYX;
  const int x0 = yx % X;
  const int y = yx / X;
  const int s0 = (parity_out + x0 + y + z) & 1;

  const L* lp = links + site0;
  float acc_r[K][3], acc_i[K][3];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int a = 0; a < 3; ++a) acc_r[k][a] = acc_i[k][a] = 0.f;
  }
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const int mu = term_geom(t, 0);
    const int step = term_geom(t, 1) * term_geom(t, 2);
    float2 v[K][3];
    if (mu == 1 || mu == 2) {
      // y and z hops keep x: the K neighbours are consecutive, 16-B pairs
      const int shift = mu == 1 ? (wrap(y, step, Y) - y) * X
                                : (wrap(z, step, Z) - z) * YX;
#pragma unroll
      for (int b = 0; b < 3; ++b) {
#pragma unroll
        for (int k = 0; k < K; k += 2) {
          const float4 q = __ldg(reinterpret_cast<const float4*>(
              psi + b * Vs + site0 + shift + k));
          v[k][b] = make_float2(q.x, q.y);
          v[k + 1][b] = make_float2(q.z, q.w);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int site = site0 + k;
        int nb;
        if (mu == 0) {
          nb = site - x0 - k + wrap(x0 + k, step, X);
        } else {
          // the th move of a t hop, s + (d-1)/2 forward and s - (d+1)/2
          // backward, is s + (step-1)/2 (step - 1 is even), with the
          // sublattice s of this site
          const int s = s0 ^ (k & 1);
          nb = site + (wrap(th, s + (step - 1) / 2, Th) - th) * ZYX;
        }
#pragma unroll
        for (int b = 0; b < 3; ++b) v[k][b] = __ldg(psi + b * Vs + nb);
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        float lr[K], li[K];
        load_links(lp + (t * 18 + a * 3 + b) * Vs, pol, lr);
        load_links(lp + (t * 18 + 9 + a * 3 + b) * Vs, pol, li);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          acc_r[k][a] += lr[k] * v[k][b].x - li[k] * v[k][b].y;
          acc_i[k][a] += lr[k] * v[k][b].y + li[k] * v[k][b].x;
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float2 o[K];
#pragma unroll
    for (int k = 0; k < K; ++k) o[k] = make_float2(acc_r[k][a], acc_i[k][a]);
    if (xfuse != nullptr) {
#pragma unroll
      for (int k = 0; k < K; k += 2) {
        const float4 q = __ldg(
            reinterpret_cast<const float4*>(xfuse + a * Vs + site0 + k));
        o[k] = make_float2(m2 * q.x - o[k].x, m2 * q.y - o[k].y);
        o[k + 1] = make_float2(m2 * q.z - o[k + 1].x, m2 * q.w - o[k + 1].y);
      }
    }
#pragma unroll
    for (int k = 0; k < K; k += 2)
      *reinterpret_cast<float4*>(out + a * Vs + site0 + k) =
          make_float4(o[k].x, o[k].y, o[k + 1].x, o[k + 1].y);
  }
}

__device__ __forceinline__ float load_link(const float* p) {
  return __ldg(p);
}

__device__ __forceinline__ float load_link(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// The per-site path: one site a thread, the first design unchanged (its
// code, scalar __ldg loads and grid; the vector path's code at one site a
// thread ran 8-16% slower on lattices larger than L2).
template <typename L>
__global__ void __launch_bounds__(kSiteThreads)
hisq16_site_kernel(const L* __restrict__ links,
                   const float2* __restrict__ psi,
                   const float2* __restrict__ xfuse,
                   float2* __restrict__ out, float m2, int X, int Y, int Z,
                   int Th, int parity_out) {
  const int YX = X * Y;
  const int ZYX = Z * YX;
  const int V = Th * ZYX;
  const int site = blockIdx.x * blockDim.x + threadIdx.x;
  if (site >= V) return;
  const int yx = site % YX;
  const int z = (site / YX) % Z;
  const int th = site / ZYX;
  const int x = yx % X;
  const int y = yx / X;
  const int s = (parity_out + x + y + z) & 1;

  const size_t Vs = static_cast<size_t>(V);
  const L* lp = links + site;
  float acc_r[3] = {0.f, 0.f, 0.f};
  float acc_i[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const int mu = t & 3;
    const int kind = t >> 2;
    const bool fwd = (kind & 1) == 0;
    const int d = kind < 2 ? 1 : 3;
    int nb;
    if (mu == 0) {
      nb = site - x + wrap(x, fwd ? d : -d, X);
    } else if (mu == 1) {
      nb = site + (wrap(y, fwd ? d : -d, Y) - y) * X;
    } else if (mu == 2) {
      nb = site + (wrap(z, fwd ? d : -d, Z) - z) * YX;
    } else {
      const int k = fwd ? (d - 1) / 2 + s : s - (d + 1) / 2;
      nb = site + (wrap(th, k, Th) - th) * ZYX;
    }
    float2 v[3];
#pragma unroll
    for (int b = 0; b < 3; ++b) v[b] = __ldg(psi + b * Vs + nb);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const float lr = load_link(lp + (t * 18 + a * 3 + b) * Vs);
        const float li = load_link(lp + (t * 18 + 9 + a * 3 + b) * Vs);
        acc_r[a] += lr * v[b].x - li * v[b].y;
        acc_i[a] += lr * v[b].y + li * v[b].x;
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float2 o;
    if (xfuse != nullptr) {
      const float2 xv = __ldg(xfuse + a * Vs + site);
      o.x = m2 * xv.x - acc_r[a];
      o.y = m2 * xv.y - acc_i[a];
    } else {
      o.x = acc_r[a];
      o.y = acc_i[a];
    }
    out[a * Vs + site] = o;
  }
}

// Launch the vector or the per-site path on the wrapper's grid; refuses
// operands that the vector path would read out of line.
template <typename L>
int launch(const L* links, const void* psi, const void* xfuse, void* out,
           float m2, int X, int Y, int Z, int Th, int parity_out,
           int blocks, int threads, int vector, void* stream) {
  const long long V = static_cast<long long>(Th) * Z * Y * X;
  if (V <= 0 || V > INT_MAX) return cudaErrorInvalidValue;  // int sites
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* p = static_cast<const float2*>(psi);
  const float2* f = static_cast<const float2*>(xfuse);
  float2* o = static_cast<float2*>(out);
  if (vector) {
    const uintptr_t lmask = kSites * sizeof(L) - 1;
    if (X % kSites != 0 || reinterpret_cast<uintptr_t>(links) & lmask
        || reinterpret_cast<uintptr_t>(psi) & 15
        || reinterpret_cast<uintptr_t>(out) & 15
        || reinterpret_cast<uintptr_t>(xfuse) & 15)
      return cudaErrorMisalignedAddress;
    hisq16_vector_kernel<L><<<blocks, threads, 0, s>>>(
        links, p, f, o, m2, X, Y, Z, Th, parity_out);
  } else {
    hisq16_site_kernel<L><<<blocks, threads, 0, s>>>(
        links, p, f, o, m2, X, Y, Z, Th, parity_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound from Python with ctypes.  Each launches on
// `stream` (PyTorch's current stream) on the grid of
// stag_hisq.hisq16_geometry (blocks, threads, vector path or not), does
// not synchronise, and returns cudaGetLastError() of the launch (0 on
// success), or cudaErrorMisalignedAddress for operands that the vector
// path cannot take.

// Kernel B2: float32 links.
extern "C" int qex_hisq16_dslash(const float* links, const void* psi,
                                 const void* xfuse, void* out, float m2,
                                 int X, int Y, int Z, int Th,
                                 int parity_out, int blocks, int threads,
                                 int vector, void* stream) {
  return launch(links, psi, xfuse, out, m2, X, Y, Z, Th, parity_out, blocks,
                threads, vector, stream);
}

// Kernel B2b: the same hop on bfloat16 links.
extern "C" int qex_hisq16_dslash_bf16(const void* links, const void* psi,
                                      const void* xfuse, void* out,
                                      float m2, int X, int Y, int Z, int Th,
                                      int parity_out, int blocks,
                                      int threads, int vector,
                                      void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(links), psi, xfuse, out,
                m2, X, Y, Z, Th, parity_out, blocks, threads, vector,
                stream);
}
