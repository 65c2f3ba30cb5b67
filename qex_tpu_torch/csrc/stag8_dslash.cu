// Even-odd staggered hopping term, 8-term form, for Hopper (sm_90a).
//
// Replaces the TPU kernel qex_tpu/physics/stag_pallas_hisq.py
// `_hisq_kernel` in its 8-term mode (called by `dslash_pallas_hisq`,
// `d2ee_pallas_hisq` and `d2dd_pallas_hisq` on links built by
// `new_pallas_stag8`).  It computes what that kernel computes, not its
// block structure:
//
//     out(x) = sum_{t<8} L_t(x) psi(x + d_t)
//
// with the links pre-shifted and pre-adjointed at the output site and
// +-1/2 folded in (t < 4: +1/2 U_mu(x), forward hop in mu = t;
// t >= 4: -1/2 U_mu(x-mu)^dag, backward hop in mu = t-4).  Optionally
// the d2ee epilogue is fused: out = m2 * xfuse - sum_t L_t psi.
//
// The kernel is a template on the link element type.  With float links
// it is the true operator; with __nv_bfloat16 links (kernel B1b, the
// inner operator of the sloppy CG, links from `new_pallas_stag8(...,
// links_dtype=bfloat16)`) each link element is widened to float
// (exactly) before use, and the spinor, the sums and the output stay
// float, as the TPU kernel does (stag_pallas_hisq.py:236-237, :349).
//
// Layouts (all contiguous, V = Th*Z*Y*X half-lattice sites, site index
// (th, z, y, x) with x fastest):
//   links  float32 or bfloat16 (8, 2, 3, 3, Th, Z, Y*X)   split re/im,
//          as qex_tpu's l_e/l_o
//   psi    complex64 (3, Th, Z, Y*X)          interleaved re/im (float2)
//   xfuse  complex64 (3, Th, Z, Y*X) or null
//   out    complex64 (3, Th, Z, Y*X)
//
// Neighbours: x hops wrap inside each row of Y*X; y hops move by X in
// Y*X (periodic in y); z hops move one Z plane.  A t hop moves th by 0
// or 1 depending on the output site's sublattice s = (parity_out + x +
// y + z) % 2: forward takes th+1 where s == 1 and th otherwise;
// backward takes th where s == 1 and th-1 otherwise.
//
// What bounds it on an H100: per output site it moves 8*72 B of links,
// 8*24 B of gathered spinor and 24 B of output (792 B, f32) for 594
// flops, 0.75 flop/B against the card's ~20 flop/B fp32 ridge, so it is
// memory-bound (with bf16 links: 8*36 B of links, 336 B/site counting
// each spinor once, against 624 B/site for float links).  The design
// answers that with one thread per output
// site, x fastest, so every link-plane load, spinor load and store of a
// warp covers consecutive addresses; the links (73% of the bytes) are
// streamed exactly once; the eight neighbour spinor gathers re-read
// spinors other threads of the block and of nearby blocks just read, so
// most of the 192 B comes from L1/L2 rather than HBM; the fused d2ee
// epilogue saves one extra read-and-write pass over the output.  Shared
// memory tiling, TMA and wider (vectorised) link loads are later work.

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

template <typename L>
__global__ void __launch_bounds__(kThreads)
stag8_dslash_kernel(const L* __restrict__ links,
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
  const L* lp = links + site;
  float acc_r[3] = {0.f, 0.f, 0.f};
  float acc_i[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    float2 v[3];
#pragma unroll
    for (int b = 0; b < 3; ++b) v[b] = __ldg(psi + b * Vs + nb[t]);
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
  stag8_dslash_kernel<L><<<blocks, kThreads, 0,
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
extern "C" int qex_stag8_dslash(const float* links, const void* psi,
                                const void* xfuse, void* out, float m2,
                                int X, int Y, int Z, int Th,
                                int parity_out, void* stream) {
  return launch(links, psi, xfuse, out, m2, X, Y, Z, Th, parity_out,
                stream);
}

// Kernel B1b: the same hop on bfloat16 links.
extern "C" int qex_stag8_dslash_bf16(const void* links, const void* psi,
                                     const void* xfuse, void* out, float m2,
                                     int X, int Y, int Z, int Th,
                                     int parity_out, void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(links), psi, xfuse, out,
                m2, X, Y, Z, Th, parity_out, stream);
}
