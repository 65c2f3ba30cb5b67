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
// 1 flop/B against the card's ~20 flop/B fp32 ridge).  The design: one
// thread per output site, x fastest, so each link-plane and spinor-plane
// load of a warp covers consecutive addresses (the B gathers at x-mu are
// shifted by one row, plane or th-slice, still consecutive, apart from
// the x wrap column); the eight neighbour spinors come mostly from L1/L2.
// Shared-memory staging with cp.async/TMA is later work.

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
stag_v1_kernel(const L* __restrict__ a, const L* __restrict__ b,
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

template <typename L>
int launch(const L* a, const L* b, const void* psi, void* out, int X, int Y,
           int Z, int Th, int parity_out, void* stream) {
  const long long V = static_cast<long long>(Th) * Z * Y * X;
  if (V <= 0 || V > INT_MAX) return cudaErrorInvalidValue;  // int sites
  const unsigned blocks =
      static_cast<unsigned>((V + kThreads - 1) / kThreads);
  stag_v1_kernel<L><<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      a, b, static_cast<const float*>(psi), static_cast<float*>(out), X, Y,
      Z, Th, parity_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound from Python with ctypes.  Each launches on
// `stream` (PyTorch's current stream), does not synchronise, and
// returns cudaGetLastError() of the launch (0 on success).
// Kernel B4: float32 links.
extern "C" int qex_stag_v1_dslash(const void* a, const void* b,
                                  const void* psi, void* out, int X, int Y,
                                  int Z, int Th, int parity_out,
                                  void* stream) {
  return launch(static_cast<const float*>(a), static_cast<const float*>(b),
                psi, out, X, Y, Z, Th, parity_out, stream);
}

// Kernel B4b: the same hop on bfloat16 links.
extern "C" int qex_stag_v1_dslash_bf16(const void* a, const void* b,
                                       const void* psi, void* out, int X,
                                       int Y, int Z, int Th, int parity_out,
                                       void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(a),
                static_cast<const __nv_bfloat16*>(b), psi, out, X, Y, Z, Th,
                parity_out, stream);
}
