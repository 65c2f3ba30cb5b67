// Even-odd Wilson hopping term, eight spin-projected hops, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel qex_tpu/physics/wilson_pallas.py
// `_wilson_kernel` (called by `hop_pallas_w`, `m_ee_pallas` and
// `m_ee_dag_pallas` on links built by `new_pallas_wilson`).  It computes
// what that kernel computes, not its block structure:
//
//     out(x) = sum_{t<8} recon_t( L_t(x) proj_t( psi(x + d_t) ) )
//
// with the links pre-shifted and pre-adjointed at the output site and
// 1/2 folded in (t < 4: 1/2 U_mu(x), forward hop in mu = t; t >= 4:
// 1/2 U_mu(x-mu)^dag, backward hop in mu = t-4).  In the chiral basis
// gamma_mu = [[0, s], [s^dag, 0]] with one entry c_r = s[r][p(r)] =
// i^k(r) per row, so with e = -1 (forward) or +1 (backward):
//
//     h_s = psi_s + e c_s psi_{2+p(s)}                    (s = 0, 1)
//     r_s = L_t h_s                        (two 3x3 complex matvecs)
//     out_s += r_s,   out_{2+p(s)} += e conj(c_s) r_s.
//
// p and k are the compile-time tables of sigma_perm / sigma_ipow below
// (the TPU kernel's `_sigma_struct`, extracted from the gamma matrices;
// tests/test_torch_wilson.py reads the two tables back from this file
// and holds them against `_sigma_struct`).  Every multiply by i^k is a
// re/im swap with signs.  Optionally the Schur-complement epilogue is
// fused: out = ca * xfuse + cb * sum (ca = a, cb = -1/a for m_ee).
//
// The kernel is a template on the link element type.  With float links
// it is the true operator (kernel B3); with __nv_bfloat16 links (kernel
// B3b, the inner operator of the sloppy solve, links from
// `new_pallas_wilson(..., links_dtype=bfloat16)`) each link element is
// widened to float (exactly) before use, and the spinor, the sums and
// the output stay float, as the TPU kernel does.
//
// Layouts (all contiguous, V = Th*Z*Y*X half-lattice sites, site index
// (th, z, y, x) with x fastest):
//   links  float32 or bfloat16 (8, 2, 3, 3, Th, Z, Y*X)   split re/im
//   psi    complex64 (4, 3, Th, Z, Y*X)          interleaved re/im (float2)
//   xfuse  complex64 (4, 3, Th, Z, Y*X) or null
//   out    complex64 (4, 3, Th, Z, Y*X)
//
// Neighbours as in stag8_dslash.cu: x hops wrap inside each row of Y*X,
// y hops move by X in Y*X, z hops move one Z plane, and a t hop moves th
// by 0 or 1 by the output site's sublattice s = (parity_out + x + y + z)
// % 2: forward takes th+1 where s == 1 and th otherwise; backward takes
// th where s == 1 and th-1 otherwise.
//
// What bounds it on an H100: per output site it must move 8*72 B of
// links, 96 B of spinor and 96 B of output (768 B, f32 links; 480 B with
// bf16 links) for 1344 flops, 1.75 flop/B against the card's ~20 flop/B
// fp32 ridge, so it is memory-bound.  The design answers that with one
// thread per output site, x fastest, so each link-plane, spinor and
// output access of a warp covers consecutive addresses; the links (75%
// of the bytes) are streamed exactly once; the eight neighbour gathers
// of 96 B re-read spinors that other threads of the block and of nearby
// blocks just read, so most come from L1/L2 rather than device memory;
// the fused epilogue saves a read-and-write pass over the output.  The
// spin projection halves the matvecs (two per term, not four).  Shared
// memory tiling, TMA and vectorised link loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kThreads = 256;

// p(r) and k(r) with s[r][p(r)] = i^k(r) for gamma_mu, mu = x, y, z, t.
__host__ __device__ constexpr int sigma_perm(int mu, int r) {
  constexpr int t[4][2] = {{1, 0}, {1, 0}, {0, 1}, {0, 1}};
  return t[mu][r];
}

__host__ __device__ constexpr int sigma_ipow(int mu, int r) {
  constexpr int t[4][2] = {{1, 1}, {2, 0}, {1, 3}, {0, 0}};
  return t[mu][r];
}

// i^K * v on (re, im)
template <int K>
__device__ __forceinline__ float2 ipow_mul(float2 v) {
  if constexpr (K == 0) {
    return v;
  } else if constexpr (K == 1) {
    return make_float2(-v.y, v.x);
  } else if constexpr (K == 2) {
    return make_float2(-v.x, -v.y);
  } else {
    return make_float2(v.y, -v.x);
  }
}

__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float load_link(const float* p) {
  return __ldg(p);
}

__device__ __forceinline__ float load_link(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// One term: project the neighbour spinor at `nb`, apply L_T, reconstruct.
template <int T, typename L>
__device__ __forceinline__ void hop_term(const L* __restrict__ lp,
                                         const float2* __restrict__ psi,
                                         int nb, size_t Vs,
                                         float2 (&acc)[4][3]) {
  constexpr int mu = T % 4;
  constexpr int e2 = T < 4 ? 2 : 0;            // e = i^e2: -1 fwd, +1 bwd
  constexpr int p0 = sigma_perm(mu, 0);
  constexpr int p1 = sigma_perm(mu, 1);
  constexpr int kp0 = (sigma_ipow(mu, 0) + e2) % 4;       // e c_0
  constexpr int kp1 = (sigma_ipow(mu, 1) + e2) % 4;       // e c_1
  constexpr int kr0 = (4 - sigma_ipow(mu, 0) + e2) % 4;   // e conj(c_0)
  constexpr int kr1 = (4 - sigma_ipow(mu, 1) + e2) % 4;   // e conj(c_1)
  float2 h0[3], h1[3];
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    const float2 u0 = __ldg(psi + (0 * 3 + b) * Vs + nb);
    const float2 u1 = __ldg(psi + (1 * 3 + b) * Vs + nb);
    const float2 l0 = __ldg(psi + ((2 + p0) * 3 + b) * Vs + nb);
    const float2 l1 = __ldg(psi + ((2 + p1) * 3 + b) * Vs + nb);
    h0[b] = add(u0, ipow_mul<kp0>(l0));
    h1[b] = add(u1, ipow_mul<kp1>(l1));
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float2 r0 = make_float2(0.f, 0.f);
    float2 r1 = make_float2(0.f, 0.f);
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const float lr = load_link(lp + (T * 18 + a * 3 + b) * Vs);
      const float li = load_link(lp + (T * 18 + 9 + a * 3 + b) * Vs);
      r0.x += lr * h0[b].x - li * h0[b].y;
      r0.y += lr * h0[b].y + li * h0[b].x;
      r1.x += lr * h1[b].x - li * h1[b].y;
      r1.y += lr * h1[b].y + li * h1[b].x;
    }
    acc[0][a] = add(acc[0][a], r0);
    acc[1][a] = add(acc[1][a], r1);
    acc[2 + p0][a] = add(acc[2 + p0][a], ipow_mul<kr0>(r0));
    acc[2 + p1][a] = add(acc[2 + p1][a], ipow_mul<kr1>(r1));
  }
}

template <typename L>
__global__ void __launch_bounds__(kThreads)
wilson8_hop_kernel(const L* __restrict__ links,
                   const float2* __restrict__ psi,
                   const float2* __restrict__ xfuse,
                   float2* __restrict__ out, float ca, float cb, int X,
                   int Y, int Z, int Th, int parity_out) {
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
  const int zyx = z * YX + yx;
  const size_t Vs = static_cast<size_t>(V);
  const L* lp = links + site;
  float2 acc[4][3];
#pragma unroll
  for (int sp = 0; sp < 4; ++sp) {
#pragma unroll
    for (int a = 0; a < 3; ++a) acc[sp][a] = make_float2(0.f, 0.f);
  }
  hop_term<0>(lp, psi, row + (x + 1 == X ? 0 : x + 1), Vs, acc);
  hop_term<1>(lp, psi, tz + (y + 1 == Y ? 0 : y + 1) * X + x, Vs, acc);
  hop_term<2>(lp, psi, th * ZYX + (z + 1 == Z ? 0 : z + 1) * YX + yx, Vs,
              acc);
  hop_term<3>(lp, psi, (s ? (th + 1 == Th ? 0 : th + 1) : th) * ZYX + zyx,
              Vs, acc);
  hop_term<4>(lp, psi, row + (x == 0 ? X - 1 : x - 1), Vs, acc);
  hop_term<5>(lp, psi, tz + (y == 0 ? Y - 1 : y - 1) * X + x, Vs, acc);
  hop_term<6>(lp, psi, th * ZYX + (z == 0 ? Z - 1 : z - 1) * YX + yx, Vs,
              acc);
  hop_term<7>(lp, psi, (s ? th : (th == 0 ? Th - 1 : th - 1)) * ZYX + zyx,
              Vs, acc);
#pragma unroll
  for (int sp = 0; sp < 4; ++sp) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const size_t off = (sp * 3 + a) * Vs + site;
      float2 o = acc[sp][a];
      if (xfuse != nullptr) {
        const float2 xv = __ldg(xfuse + off);
        o = make_float2(ca * xv.x + cb * o.x, ca * xv.y + cb * o.y);
      }
      out[off] = o;
    }
  }
}

template <typename L>
int launch(const L* links, const void* psi, const void* xfuse, void* out,
           float ca, float cb, int X, int Y, int Z, int Th, int parity_out,
           void* stream) {
  const long long V = static_cast<long long>(Th) * Z * Y * X;
  if (V <= 0 || V > INT_MAX) return cudaErrorInvalidValue;  // int sites
  const unsigned blocks =
      static_cast<unsigned>((V + kThreads - 1) / kThreads);
  wilson8_hop_kernel<L><<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      links, static_cast<const float2*>(psi),
      static_cast<const float2*>(xfuse), static_cast<float2*>(out), ca, cb,
      X, Y, Z, Th, parity_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound from Python with ctypes.  Each launches on
// `stream` (PyTorch's current stream), does not synchronise, and
// returns cudaGetLastError() of the launch (0 on success).
extern "C" int qex_wilson8_hop(const float* links, const void* psi,
                               const void* xfuse, void* out, float ca,
                               float cb, int X, int Y, int Z, int Th,
                               int parity_out, void* stream) {
  return launch(links, psi, xfuse, out, ca, cb, X, Y, Z, Th, parity_out,
                stream);
}

// Kernel B3b: the same hop on bfloat16 links.
extern "C" int qex_wilson8_hop_bf16(const void* links, const void* psi,
                                    const void* xfuse, void* out, float ca,
                                    float cb, int X, int Y, int Z, int Th,
                                    int parity_out, void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(links), psi, xfuse, out,
                ca, cb, X, Y, Z, Th, parity_out, stream);
}
