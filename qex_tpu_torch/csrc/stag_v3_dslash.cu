// Even-odd staggered hopping term on pre-shifted term-major links (v3),
// its v4 entry point and the split-mode experiment, for Hopper (sm_90a).
//
// Replaces three TPU kernels that share one body:
//   B6  qex_tpu/physics/stag_pallas3.py `_dslash3_kernel` (called by
//       `dslash_pallas3`, `d2ee_pallas3`, `d2dd_pallas3`,
//       `dslash_pallas3_c`), float32 and bfloat16 links (B6b);
//   B7  qex_tpu/physics/stag_pallas4.py `_dslash4_kernel` (called by
//       `dslash_pallas4` and its d2ee/d2dd/_c wrappers) on the same
//       links, with its `compute_only` switch, float32 and bfloat16
//       links (B7b);
//   B8  exp_pallas3.py `make_kernel` in its five modes (called by `run`),
//       float32 links.
// v4 differs from v3 on the TPU only in how its vector work is grouped
// into Mosaic operations; one CUDA thread per site has no such grouping,
// so B7 computes v3's arithmetic in an instance of its own (its own
// symbol, entry point and launch count).
//
// The links are built once at setup (`new_pallas3`): per output parity
// and output site, L_mu = +1/2 U_mu(x) (forward, term mu) and
// L_{4+mu} = -1/2 U_mu(x-mu)^dag (backward, term 4+mu).  The modes:
//
//   kV3, kV4         out = sum_k L_k psi(x + d_k)
//   kComputeOnly     out = sum_k L_0 psi(x + d_k)        (B7 compute_only:
//                    term 0's link block in every term, as the TPU kernel
//                    streams term 0's block for every term)
//   kDma             out = 1/2 sum_k sign_k L_k[.][0]    (column 0 of each
//                    link; no spinor)
//   kMatvec          out = 1/2 sum_k sign_k L_0 psi(x)   (zero up to
//                    rounding: the four forward and four backward terms
//                    cancel; it times eight matvecs)
//   kShifts          out = 1/2 sum_k sign_k psi(x + d_k) (no links)
//   kCompute         out = 1/2 sum_k sign_k L_0 psi(x + d_k)
//   kFull            out = 1/2 sum_k sign_k L_k psi(x + d_k)
// with sign_k = +1 for k < 4 and -1 for k >= 4 (the B8 modes carry their
// own 1/2 and signs, as make_kernel does on links that already hold
// them: on v3's links `full` is 1/2 (F - B), not v3's F + B).  In the
// TPU experiment `matvec` and `compute` read link scratch that no copy
// wrote; here they read L_0, resident in registers, as compute_only does.
//
// Layouts (all contiguous, V = Th*Z*Y*X half-lattice sites, site index
// (th, z, y, x) with x fastest, ZYX = Z*Y*X):
//   links  float32 or bfloat16 (8, Th, 2, 3, 3, Z, Y*X)  term-major, th
//          outside re/im: element [k][th][ri][r][c][z][yx]
//   psi    float32 (2, 3, Th, Z, Y*X)                    split re/im
//   out    float32 (2, 3, Th, Z, Y*X)
// Neighbours x + d_k as csrc/stag8_dslash.cu (d_k = +mu for k < 4, -mu
// for k >= 4, the t hop by the output site's sublattice).
//
// What bounds it on an H100 (each input once, the output once): kV3/kV4
// 624 B/site with float links (576 B links, 24 B in, 24 B out), 336 B
// with bf16 links; kComputeOnly, kMatvec and kCompute 120 B (one link
// block); kDma 600 B (it reads the whole link block of every term, as
// the TPU copies did, and uses column 0); kShifts 48 B.  All are
// memory-bound (594 flops/site at most).  The design: one thread per
// output site, x fastest, so each term's link plane is one coalesced
// read of consecutive sites; the neighbour spinors come mostly from
// L1/L2.  The TPU kernel's double-buffered link DMA has its Hopper
// analogue in cp.async/TMA staging, which is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kThreads = 256;

enum Mode {
  kV3 = 0,
  kV4 = 1,
  kComputeOnly = 2,
  kDma = 3,
  kMatvec = 4,
  kShifts = 5,
  kCompute = 6,
  kFull = 7,
};

__device__ __forceinline__ float load_link(const float* p) {
  return __ldg(p);
}

__device__ __forceinline__ float load_link(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// A load that neither the compiler nor ptxas may drop although its
// value is unused (kDma reads whole link blocks and keeps column 0): a
// PTX volatile load into a scoped register.
__device__ __forceinline__ void touch(const float* p) {
  asm volatile("{ .reg .f32 t; ld.volatile.global.f32 t, [%0]; }"
               :: "l"(p));
}

// Hides a value from the optimiser, so that kMatvec's eight identical
// matvecs are each computed.
__device__ __forceinline__ float opaque(float v) {
  asm volatile("" : "+f"(v));
  return v;
}

template <typename L, int M>
__global__ void __launch_bounds__(kThreads)
stag_v3_kernel(const L* __restrict__ links, const float* __restrict__ psi,
               float* __restrict__ out, int X, int Y, int Z, int Th,
               int parity_out) {
  constexpr bool kSplit = M >= kDma;                 // the B8 modes
  constexpr bool kLink0 =
      M == kComputeOnly || M == kMatvec || M == kCompute;
  const int YX = X * Y;
  const int ZYX = Z * YX;
  const int V = Th * ZYX;
  const int site = blockIdx.x * blockDim.x + threadIdx.x;
  if (site >= V) return;
  const int yx = site % YX;
  const int zyx = site % ZYX;
  const int z = zyx / YX;
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
  const size_t ZYXs = static_cast<size_t>(ZYX);
  float acc_r[3] = {0.f, 0.f, 0.f};
  float acc_i[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    // term k's link block at this th: [ri][r][c] planes of ZYX sites
    const L* lp = links +
                  (static_cast<size_t>(kLink0 ? 0 : k) * Th + th) * 18 *
                      ZYXs +
                  zyx;
    float tr[3], ti[3];
    if constexpr (M == kDma) {
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        tr[r] = load_link(lp + (r * 3) * ZYXs);
        ti[r] = load_link(lp + (9 + r * 3) * ZYXs);
#pragma unroll
        for (int c = 1; c < 3; ++c) {
          touch(lp + (r * 3 + c) * ZYXs);
          touch(lp + (9 + r * 3 + c) * ZYXs);
        }
      }
    } else {
      const int src = M == kMatvec ? site : nb[k];
      float vr[3], vi[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        vr[c] = __ldg(psi + c * Vs + src);
        vi[c] = __ldg(psi + (3 + c) * Vs + src);
        if constexpr (M == kMatvec) {
          vr[c] = opaque(vr[c]);
          vi[c] = opaque(vi[c]);
        }
      }
      if constexpr (M == kShifts) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          tr[c] = vr[c];
          ti[c] = vi[c];
        }
      } else {
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          float sr = 0.f, si = 0.f;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float lr = load_link(lp + (r * 3 + c) * ZYXs);
            const float li = load_link(lp + (9 + r * 3 + c) * ZYXs);
            sr += lr * vr[c] - li * vi[c];
            si += lr * vi[c] + li * vr[c];
          }
          tr[r] = sr;
          ti[r] = si;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      if (kSplit && k >= 4) {
        acc_r[r] -= tr[r];
        acc_i[r] -= ti[r];
      } else {
        acc_r[r] += tr[r];
        acc_i[r] += ti[r];
      }
    }
  }
  const float scale = kSplit ? 0.5f : 1.f;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    out[r * Vs + site] = scale * acc_r[r];
    out[(3 + r) * Vs + site] = scale * acc_i[r];
  }
}

template <typename L, int M>
int launch(const void* links, const void* psi, void* out, int X, int Y,
           int Z, int Th, int parity_out, void* stream) {
  const long long V = static_cast<long long>(Th) * Z * Y * X;
  if (V <= 0 || V > INT_MAX) return cudaErrorInvalidValue;  // int sites
  const unsigned blocks =
      static_cast<unsigned>((V + kThreads - 1) / kThreads);
  stag_v3_kernel<L, M><<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const L*>(links), static_cast<const float*>(psi),
      static_cast<float*>(out), X, Y, Z, Th, parity_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound from Python with ctypes.  Each launches on
// `stream` (PyTorch's current stream), does not synchronise, and
// returns cudaGetLastError() of the launch (0 on success).

// Kernel B6: v3 on float32 links.
extern "C" int qex_stag_v3_dslash(const void* links, const void* psi,
                                  void* out, int X, int Y, int Z, int Th,
                                  int parity_out, void* stream) {
  return launch<float, kV3>(links, psi, out, X, Y, Z, Th, parity_out,
                            stream);
}

// Kernel B6b: v3 on bfloat16 links.
extern "C" int qex_stag_v3_dslash_bf16(const void* links, const void* psi,
                                       void* out, int X, int Y, int Z,
                                       int Th, int parity_out,
                                       void* stream) {
  return launch<__nv_bfloat16, kV3>(links, psi, out, X, Y, Z, Th,
                                    parity_out, stream);
}

// Kernel B7: v4 on float32 links; compute_only != 0 takes term 0's link
// block for every term.
extern "C" int qex_stag_v4_dslash(const void* links, const void* psi,
                                  void* out, int X, int Y, int Z, int Th,
                                  int parity_out, int compute_only,
                                  void* stream) {
  if (compute_only)
    return launch<float, kComputeOnly>(links, psi, out, X, Y, Z, Th,
                                       parity_out, stream);
  return launch<float, kV4>(links, psi, out, X, Y, Z, Th, parity_out,
                            stream);
}

// Kernel B7b: v4 on bfloat16 links.
extern "C" int qex_stag_v4_dslash_bf16(const void* links, const void* psi,
                                       void* out, int X, int Y, int Z,
                                       int Th, int parity_out,
                                       int compute_only, void* stream) {
  if (compute_only)
    return launch<__nv_bfloat16, kComputeOnly>(links, psi, out, X, Y, Z,
                                               Th, parity_out, stream);
  return launch<__nv_bfloat16, kV4>(links, psi, out, X, Y, Z, Th,
                                    parity_out, stream);
}

// Kernel B8: the split-mode experiment on float32 links; mode 0..4 =
// dma, matvec, shifts, compute, full (the order of exp_pallas3's MODES).
extern "C" int qex_stag_v3_split(const void* links, const void* psi,
                                 void* out, int X, int Y, int Z, int Th,
                                 int parity_out, int mode, void* stream) {
  switch (mode) {
    case 0:
      return launch<float, kDma>(links, psi, out, X, Y, Z, Th, parity_out,
                                 stream);
    case 1:
      return launch<float, kMatvec>(links, psi, out, X, Y, Z, Th,
                                    parity_out, stream);
    case 2:
      return launch<float, kShifts>(links, psi, out, X, Y, Z, Th,
                                    parity_out, stream);
    case 3:
      return launch<float, kCompute>(links, psi, out, X, Y, Z, Th,
                                     parity_out, stream);
    case 4:
      return launch<float, kFull>(links, psi, out, X, Y, Z, Th, parity_out,
                                  stream);
    default:
      return cudaErrorInvalidValue;
  }
}
