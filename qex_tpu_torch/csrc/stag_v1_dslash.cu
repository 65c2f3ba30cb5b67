// Even-odd staggered hopping term on unshifted links (v1), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel qex_tpu/physics/stag_pallas.py `_dslash_kernel`
// (called by `dslash_pallas`, `d2ee_pallas` and `dslash_pallas_c` on
// links built by `new_pallas`).  It computes what that kernel computes,
// not its (th, z-block) grid:
//
//     out(x) = 1/2 sum_mu [ A_mu(x) psi(x+mu) - B_mu(x-mu)^dag psi(x-mu) ]
//
// with A the links of the output parity read at the output site and B
// the links of the source parity read at the source site x-mu.  The TPU
// kernel rolls the products B^dag psi for x and y, takes the z-1 plane's
// B_z for z, and picks B_t[th] or B_t[th-1] by the sublattice for t;
// each of those reads B_mu at the same site as psi(x-mu), which is what
// this kernel does directly.
//
// The kernel is a template on the link element type: float links are the
// true operator (kernel B4); __nv_bfloat16 links (kernel B4b, from
// `new_pallas(..., links_dtype=bfloat16)`) are widened to float exactly
// before use, and the spinor, the sums and the output stay float, as the
// TPU kernel does (`.astype(jnp.float32)` on each link plane).
//
// Layouts (all contiguous, V = Th*Z*Y*X half-lattice sites, site index
// (th, z, y, x) with x fastest):
//   a, b   float32 or bfloat16 (2, 4, 3, 3, Th, Z, Y*X)  split re/im, as
//          qex_tpu's PallasStagEO.g_e / g_o
//   psi    float32 (2, 3, Th, Z, Y*X)                   split re/im
//   out    float32 (2, 3, Th, Z, Y*X)
//
// Neighbours as the 8-term kernel (csrc/stag8_dslash.cu): x hops wrap
// inside each row of Y*X (x+1 at x = X-1 is x = 0 of the same row, not a
// roll of Y*X); y hops move by X in Y*X; z hops move one Z plane; a t hop
// moves th by 0 or 1 by the output site's sublattice s = (parity_out + x
// + y + z) % 2: forward takes th+1 where s == 1, backward th-1 where
// s == 0.
//
// What bounds it on an H100: per output site 4*72 B of A links, 4*72 B
// of B links (each B link is read by exactly one output site, so each is
// read once), 24 B of spinor and 24 B of output: 624 B/site with float
// links, 336 B with bf16 links, for 594 flops -- memory-bound (about
// 1 flop/B against the card's ~20 flop/B fp32 ridge).  A first design
// (one site a thread, scalar __ldg loads) streamed the f32 links at
// 89-92% of the measured stream but the bf16 links at 71-72% (49% of the
// bound at 24^4).  Split into a links-only kernel and one that reads B at
// the output site instead of x-mu: the bf16 links alone took 58-75% of
// the hop and reading B at the output site saved 20-25%, so the scalar
// 2-byte loads and the gathered B links both cost.  This design:
//   - K = kSites = 2 consecutive sites along x per thread (the vector
//     path): the A links, and the B links of the y and z hops (whose x-mu
//     sites keep x and so are consecutive), load both sites at once (one
//     32-bit bf16 pair, or a float2); the y and z spinor gathers and the
//     store are pairs too; the x and t hops (the x-1 site of the first
//     site is in the previous pair, and the t plane alternates with x)
//     load per site;
//   - the A links, and with bf16 links also the B links, are read past
//     L1 (`L1::no_allocate`) with an L2 evict_first policy; float B links
//     keep the default policy, which measured faster at 32^4 (the t-hop
//     B links of one 32-B sector are read by two warps, one per
//     sublattice);
//   - 64-thread blocks, so that 24^4's grid spreads evenly over the SMs.
// Measured by graph replay on an H100 (PERF.md), B4b runs at 74-79% of
// its bound and B4 at 79-81% (24^4 and 32^4).
// The per-site kernel, the first design unchanged, runs where the vector
// path does not fit (X odd, or operands not aligned to 16 B) and where a
// hop's operands fit in L2: there it keeps the links in L2 from one call
// to the next, which the evict-first link stream gives up.  The wrapper
// chooses the kernel and the grid (`stag_pallas.v1_geometry`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

// sites a thread and block size of the vector path, and the block size
// of the per-site path
constexpr int kSites = 2;
constexpr int kVectorThreads = 64;
constexpr int kSiteThreads = 256;

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// K consecutive link elements at p (aligned to K elements), widened to
// float: with HINT past L1 with the L2 policy `pol`, else through the
// read-only path.
template <bool HINT, int K>
__device__ __forceinline__ void load_links(const float* p, uint64_t pol,
                                           float (&f)[K]) {
  static_assert(K == 1 || K == 2, "1 or 2 sites");
  if constexpr (!HINT && K == 1) {
    f[0] = __ldg(p);
  } else if constexpr (!HINT) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    f[0] = v.x;
    f[1] = v.y;
  } else if constexpr (K == 1) {
    asm("ld.global.nc.L1::no_allocate.L2::cache_hint.f32 %0, [%1], %2;"
        : "=f"(f[0]) : "l"(p), "l"(pol));
  } else {
    asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v2.f32 {%0, %1}, "
        "[%2], %3;" : "=f"(f[0]), "=f"(f[1]) : "l"(p), "l"(pol));
  }
}

template <bool HINT, int K>
__device__ __forceinline__ void load_links(const __nv_bfloat16* p,
                                           uint64_t pol, float (&f)[K]) {
  static_assert(K == 1 || K == 2, "1 or 2 sites");
  unsigned w;
  if constexpr (!HINT && K == 1) {
    w = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else if constexpr (!HINT) {
    w = __ldg(reinterpret_cast<const unsigned*>(p));
  } else if constexpr (K == 1) {
    unsigned short h;
    asm("ld.global.nc.L1::no_allocate.L2::cache_hint.b16 %0, [%1], %2;"
        : "=h"(h) : "l"(p), "l"(pol));
    w = h;
  } else {
    asm("ld.global.nc.L1::no_allocate.L2::cache_hint.b32 %0, [%1], %2;"
        : "=r"(w) : "l"(p), "l"(pol));
  }
  f[0] = __uint_as_float(w << 16);
  if constexpr (K == 2) f[1] = __uint_as_float(w & 0xffff0000u);
}

// Two consecutive floats at p (aligned to 8 B) through the read-only path.
__device__ __forceinline__ void load_pair(const float* p, float (&f)[2]) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(p));
  f[0] = v.x;
  f[1] = v.y;
}

// The vector path: thread i of the grid takes the K = kSites sites
// site0 = K*i .. site0+K-1 of one x row (X % K == 0, operands aligned).
template <typename L>
__global__ void __launch_bounds__(kVectorThreads)
stag_v1_vector_kernel(const L* __restrict__ a, const L* __restrict__ b,
                      const float* __restrict__ psi,
                      float* __restrict__ out, int X, int Y, int Z, int Th,
                      int parity_out) {
  constexpr int K = kSites;
  static_assert(K == 2, "pairs of sites");
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
  // The A links are read once each, in order: past L1, evict first.  The
  // B links of a t hop are gathered from th or th-1 by the sublattice, so
  // the two halves of a sector go to two warps; float B links keep the
  // default policy, which measured faster at 32^4.
  constexpr bool kHintB = std::is_same<L, __nv_bfloat16>::value;
  const int row = site0 - x0;               // (th, z, y, 0)
  const int tz = th * ZYX + z * YX;         // (th, z, 0, 0)

  // neighbour of site k in direction j (0-3: x+mu, 4-7: x-mu)
  auto nbr = [&](int j, int k) {
    const int x = x0 + k;
    const int s = s0 ^ (k & 1);
    switch (j) {
      case 0: return row + (x + 1 == X ? 0 : x + 1);
      case 1: return tz + (y + 1 == Y ? 0 : y + 1) * X + x;
      case 2: return th * ZYX + (z + 1 == Z ? 0 : z + 1) * YX + yx + k;
      case 3: return (s ? (th + 1 == Th ? 0 : th + 1) : th) * ZYX + z * YX
                     + yx + k;
      case 4: return row + (x == 0 ? X - 1 : x - 1);
      case 5: return tz + (y == 0 ? Y - 1 : y - 1) * X + x;
      case 6: return th * ZYX + (z == 0 ? Z - 1 : z - 1) * YX + yx + k;
      default: return (s ? th : (th == 0 ? Th - 1 : th - 1)) * ZYX
                      + z * YX + yx + k;
    }
  };

  float acc_r[K][3], acc_i[K][3];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int r = 0; r < 3; ++r) acc_r[k][r] = acc_i[k][r] = 0.f;
  }
#pragma unroll
  for (int mu = 0; mu < 4; ++mu) {
#pragma unroll
    for (int dir = 0; dir < 2; ++dir) {
      const int j = mu + 4 * dir;
      // y and z hops keep x: the K neighbours (and, backward, the K
      // B-link sites) are consecutive
      const bool pair = mu == 1 || mu == 2;
      int nb[K];
#pragma unroll
      for (int k = 0; k < K; ++k) nb[k] = nbr(j, k);
      float vr[K][3], vi[K][3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if (pair) {
          float fr[K], fi[K];
          load_pair(psi + c * Vs + nb[0], fr);
          load_pair(psi + (3 + c) * Vs + nb[0], fi);
#pragma unroll
          for (int k = 0; k < K; ++k) {
            vr[k][c] = fr[k];
            vi[k][c] = fi[k];
          }
        } else {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            vr[k][c] = __ldg(psi + c * Vs + nb[k]);
            vi[k][c] = __ldg(psi + (3 + c) * Vs + nb[k]);
          }
        }
      }
      // forward: A_mu(x) psi(x+mu), A element [ri][mu][r][c] at the site;
      // backward: B_mu(y)^dag psi(y) at y = x-mu, (B^dag)[r][c] =
      // conj(B[c][r])
      const L* base = dir == 0 ? a : b;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int e = dir == 0 ? r * 3 + c : c * 3 + r;
          const L* pr = base + (mu * 9 + e) * Vs;
          const L* pi = base + ((4 + mu) * 9 + e) * Vs;
          float lr[K], li[K];
          if (dir == 0) {
            load_links<true, K>(pr + site0, pol, lr);
            load_links<true, K>(pi + site0, pol, li);
          } else if (pair) {
            load_links<kHintB, K>(pr + nb[0], pol, lr);
            load_links<kHintB, K>(pi + nb[0], pol, li);
          } else {
#pragma unroll
            for (int k = 0; k < K; ++k) {
              float f[1];
              load_links<kHintB, 1>(pr + nb[k], pol, f);
              lr[k] = f[0];
              load_links<kHintB, 1>(pi + nb[k], pol, f);
              li[k] = f[0];
            }
          }
#pragma unroll
          for (int k = 0; k < K; ++k) {
            if (dir == 0) {
              acc_r[k][r] += lr[k] * vr[k][c] - li[k] * vi[k][c];
              acc_i[k][r] += lr[k] * vi[k][c] + li[k] * vr[k][c];
            } else {
              acc_r[k][r] -= lr[k] * vr[k][c] + li[k] * vi[k][c];
              acc_i[k][r] -= lr[k] * vi[k][c] - li[k] * vr[k][c];
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    *reinterpret_cast<float2*>(out + r * Vs + site0) =
        make_float2(0.5f * acc_r[0][r], 0.5f * acc_r[1][r]);
    *reinterpret_cast<float2*>(out + (3 + r) * Vs + site0) =
        make_float2(0.5f * acc_i[0][r], 0.5f * acc_i[1][r]);
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
// thread ran 2-8% slower on lattices larger than L2).
template <typename L>
__global__ void __launch_bounds__(kSiteThreads)
stag_v1_site_kernel(const L* __restrict__ a, const L* __restrict__ b,
                    const float* __restrict__ psi, float* __restrict__ out,
                    int X, int Y, int Z, int Th, int parity_out) {
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

  const int row = site - x;                 // (th, z, y, 0)
  const int tz = th * ZYX + z * YX;         // (th, z, 0, 0)
  int nb[8];
  nb[0] = row + (x + 1 == X ? 0 : x + 1);
  nb[1] = tz + (y + 1 == Y ? 0 : y + 1) * X + x;
  nb[2] = th * ZYX + (z + 1 == Z ? 0 : z + 1) * YX + yx;
  nb[3] = (s ? (th + 1 == Th ? 0 : th + 1) : th) * ZYX + z * YX + yx;
  nb[4] = row + (x == 0 ? X - 1 : x - 1);
  nb[5] = tz + (y == 0 ? Y - 1 : y - 1) * X + x;
  nb[6] = th * ZYX + (z == 0 ? Z - 1 : z - 1) * YX + yx;
  nb[7] = (s ? th : (th == 0 ? Th - 1 : th - 1)) * ZYX + z * YX + yx;

  const size_t Vs = static_cast<size_t>(V);
  float acc_r[3] = {0.f, 0.f, 0.f};
  float acc_i[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int mu = 0; mu < 4; ++mu) {
    // forward: A_mu(x) psi(x+mu); A element [ri][mu][a][c] at the site
    float vr[3], vi[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      vr[c] = __ldg(psi + c * Vs + nb[mu]);
      vi[c] = __ldg(psi + (3 + c) * Vs + nb[mu]);
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float lr = load_link(a + (mu * 9 + r * 3 + c) * Vs + site);
        const float li =
            load_link(a + ((4 + mu) * 9 + r * 3 + c) * Vs + site);
        acc_r[r] += lr * vr[c] - li * vi[c];
        acc_i[r] += lr * vi[c] + li * vr[c];
      }
    }
    // backward: B_mu(y)^dag psi(y) at y = x-mu; (B^dag)[r][c] =
    // conj(B[c][r])
    const int ys = nb[4 + mu];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      vr[c] = __ldg(psi + c * Vs + ys);
      vi[c] = __ldg(psi + (3 + c) * Vs + ys);
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float lr = load_link(b + (mu * 9 + c * 3 + r) * Vs + ys);
        const float li = load_link(b + ((4 + mu) * 9 + c * 3 + r) * Vs + ys);
        acc_r[r] -= lr * vr[c] + li * vi[c];
        acc_i[r] -= lr * vi[c] - li * vr[c];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    out[r * Vs + site] = 0.5f * acc_r[r];
    out[(3 + r) * Vs + site] = 0.5f * acc_i[r];
  }
}

// Launch the vector or the per-site path on the wrapper's grid; refuses
// operands that the vector path would read out of line.
template <typename L>
int launch(const L* a, const L* b, const void* psi, void* out, int X, int Y,
           int Z, int Th, int parity_out, int blocks, int threads,
           int vector, void* stream) {
  const long long V = static_cast<long long>(Th) * Z * Y * X;
  if (V <= 0 || V > INT_MAX) return cudaErrorInvalidValue;  // int sites
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(psi);
  float* o = static_cast<float*>(out);
  if (vector) {
    const uintptr_t lmask = kSites * sizeof(L) - 1;
    if (X % kSites != 0 || reinterpret_cast<uintptr_t>(a) & lmask
        || reinterpret_cast<uintptr_t>(b) & lmask
        || reinterpret_cast<uintptr_t>(psi) & 15
        || reinterpret_cast<uintptr_t>(out) & 15)
      return cudaErrorMisalignedAddress;
    stag_v1_vector_kernel<L><<<blocks, threads, 0, s>>>(
        a, b, p, o, X, Y, Z, Th, parity_out);
  } else {
    stag_v1_site_kernel<L><<<blocks, threads, 0, s>>>(a, b, p, o, X, Y, Z,
                                                      Th, parity_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound from Python with ctypes.  Each launches on
// `stream` (PyTorch's current stream) on the grid of
// stag_pallas.v1_geometry (blocks, threads, vector path or not), does not
// synchronise, and returns cudaGetLastError() of the launch (0 on
// success), or cudaErrorMisalignedAddress for operands that the vector
// path cannot take.
// Kernel B4: float32 links.
extern "C" int qex_stag_v1_dslash(const void* a, const void* b,
                                  const void* psi, void* out, int X, int Y,
                                  int Z, int Th, int parity_out, int blocks,
                                  int threads, int vector, void* stream) {
  return launch(static_cast<const float*>(a), static_cast<const float*>(b),
                psi, out, X, Y, Z, Th, parity_out, blocks, threads, vector,
                stream);
}

// Kernel B4b: the same hop on bfloat16 links.
extern "C" int qex_stag_v1_dslash_bf16(const void* a, const void* b,
                                       const void* psi, void* out, int X,
                                       int Y, int Z, int Th, int parity_out,
                                       int blocks, int threads, int vector,
                                       void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(a),
                static_cast<const __nv_bfloat16*>(b), psi, out, X, Y, Z, Th,
                parity_out, blocks, threads, vector, stream);
}
