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
// distance 3) and kind 3 the naik backward hop (-1/2 long_mu(x-3mu)^dag).
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
// extent (a single conditional wrap, as the 8-term kernel uses, is wrong
// at distance 3 when an extent is 4 or less).  A t hop moves th by a
// sublattice-dependent amount: with s = (parity_out + x + y + z) & 1 a
// forward hop of distance d lands at th + (d-1)/2 + s and a backward hop
// at th - (d+1)/2 + s, both modulo Th (Th = 2 works: th + 2 == th).
//
// What bounds it on an H100: per output site it reads 16*72 B of links
// (16*36 B as bf16), one spinor of 24 B (each neighbour is some other
// thread's centre) and writes 24 B: 1,200 B/site for float links, 624 for
// bf16, against 1,152 flops/site, about 1 flop/B against the card's
// ~20 flop/B float32 ridge, so it is memory-bound.  The design answers
// that as the 8-term kernel does: one thread per output site, x fastest,
// so every link-plane load, spinor load and store of a warp covers
// consecutive addresses; the links (96% of the bytes) are streamed
// exactly once; the sixteen neighbour gathers re-read spinors that other
// threads of the block or of nearby blocks just read, so they come mostly
// from L1/L2; the fused d2ee epilogue saves a pass over the output.
// Offsets into the link array are size_t (it holds 1.2 GB at 32^3x64).
// Shared-memory tiling, TMA and vector loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_link(const float* p) {
  return __ldg(p);
}

__device__ __forceinline__ float load_link(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// (c + k) mod n for |k| <= 3 and n >= 1, without a negative result.
__device__ __forceinline__ int wrap(int c, int k, int n) {
  return (c + k + 4 * n) % n;
}

template <typename L>
__global__ void __launch_bounds__(kThreads)
hisq16_dslash_kernel(const L* __restrict__ links,
                     const float2* __restrict__ psi,
                     const float2* __restrict__ xfuse,
                     float2* __restrict__ out, float m2, int X, int Y,
                     int Z, int Th, int parity_out) {
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

template <typename L>
int launch(const L* links, const void* psi, const void* xfuse, void* out,
           float m2, int X, int Y, int Z, int Th, int parity_out,
           void* stream) {
  const long long V = static_cast<long long>(Th) * Z * Y * X;
  if (V <= 0 || V > INT_MAX) return cudaErrorInvalidValue;  // int sites
  const unsigned blocks =
      static_cast<unsigned>((V + kThreads - 1) / kThreads);
  hisq16_dslash_kernel<L><<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      links, static_cast<const float2*>(psi),
      static_cast<const float2*>(xfuse), static_cast<float2*>(out), m2, X,
      Y, Z, Th, parity_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound from Python with ctypes.  Each launches on
// `stream` (PyTorch's current stream), does not synchronise, and
// returns cudaGetLastError() of the launch (0 on success).

// Kernel B2: float32 links.
extern "C" int qex_hisq16_dslash(const float* links, const void* psi,
                                 const void* xfuse, void* out, float m2,
                                 int X, int Y, int Z, int Th,
                                 int parity_out, void* stream) {
  return launch(links, psi, xfuse, out, m2, X, Y, Z, Th, parity_out,
                stream);
}

// Kernel B2b: the same hop on bfloat16 links.
extern "C" int qex_hisq16_dslash_bf16(const void* links, const void* psi,
                                      const void* xfuse, void* out,
                                      float m2, int X, int Y, int Z, int Th,
                                      int parity_out, void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(links), psi, xfuse, out,
                m2, X, Y, Z, Th, parity_out, stream);
}
