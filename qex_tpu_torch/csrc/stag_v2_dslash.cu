// Even-odd staggered hopping term in the grid-major layout (v2), for
// Hopper (sm_90a).
//
// Replaces the TPU kernel qex_tpu/physics/stag_pallas2.py `_kernel`
// (called by `dslash_pallas2` and `d2ee_pallas2` on links built by
// `new_pallas2`).  The operator is v1's (csrc/stag_v1_dslash.cu):
//
//     out(x) = 1/2 sum_mu [ A_mu(x) psi(x+mu) - B_mu(x-mu)^dag psi(x-mu) ]
//
// with A the output-parity links at the output site and B the
// source-parity links at the source site x-mu.  Only the layout differs:
// the (th, z) plane leads, so each plane's links and spinor are one
// contiguous block:
//
//   a, b   float32 (Th, Z, 2, 4, 3, 3, Y*X)   [th][z][ri][mu][r][c][yx]
//   psi    float32 (Th, Z, 2, 3, Y*X)         [th][z][ri][c][yx]
//   out    float32 (Th, Z, 2, 3, Y*X)
//
// Neighbours as csrc/stag8_dslash.cu: x hops wrap inside each row of Y*X,
// y hops move by X in Y*X, z hops move one plane, and a t hop moves th
// by 0 or 1 by the output site's sublattice s = (parity_out + x + y + z)
// % 2 (forward th+1 where s == 1, backward th-1 where s == 0).
//
// What bounds it on an H100: 624 B/site (576 B of links, 24 B of spinor,
// 24 B of output, each once) for 594 flops, so memory.  The design: one
// block of threads per (th, z) plane and Y*X chunk (grid (ceil(YX/256),
// Z, Th)), one thread per output site, so each of the 72 link planes of
// the block, and each spinor plane, is read coalesced; float32 links
// only, as the TPU kernel.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
stag_v2_kernel(const float* __restrict__ a, const float* __restrict__ b,
               const float* __restrict__ psi, float* __restrict__ out, int X,
               int Y, int Z, int Th, int parity_out) {
  const int YX = X * Y;
  const int yx = blockIdx.x * blockDim.x + threadIdx.x;
  if (yx >= YX) return;
  const int z = blockIdx.y;
  const int th = blockIdx.z;
  const int x = yx % X;
  const int y = yx / X;
  const int s = (parity_out + x + y + z) & 1;

  // neighbours as (th', z') plane and yx' within it
  const int row = yx - x;
  const int zp = z + 1 == Z ? 0 : z + 1;
  const int zm = z == 0 ? Z - 1 : z - 1;
  const int tp = s ? (th + 1 == Th ? 0 : th + 1) : th;
  const int tm = s ? th : (th == 0 ? Th - 1 : th - 1);
  int nplane[8], nyx[8];
  nplane[0] = nplane[1] = nplane[4] = nplane[5] = th * Z + z;
  nyx[0] = row + (x + 1 == X ? 0 : x + 1);
  nyx[1] = (y + 1 == Y ? 0 : y + 1) * X + x;
  nyx[4] = row + (x == 0 ? X - 1 : x - 1);
  nyx[5] = (y == 0 ? Y - 1 : y - 1) * X + x;
  nplane[2] = th * Z + zp;
  nplane[6] = th * Z + zm;
  nplane[3] = tp * Z + z;
  nplane[7] = tm * Z + z;
  nyx[2] = nyx[3] = nyx[6] = nyx[7] = yx;

  const size_t YXs = static_cast<size_t>(YX);
  const float* ap = a + static_cast<size_t>(th * Z + z) * 72 * YXs + yx;
  float acc_r[3] = {0.f, 0.f, 0.f};
  float acc_i[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int mu = 0; mu < 4; ++mu) {
    // forward: A_mu(x) psi(x+mu)
    const float* pp = psi + static_cast<size_t>(nplane[mu]) * 6 * YXs +
                      nyx[mu];
    float vr[3], vi[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      vr[c] = __ldg(pp + c * YXs);
      vi[c] = __ldg(pp + (3 + c) * YXs);
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float lr = __ldg(ap + (mu * 9 + r * 3 + c) * YXs);
        const float li = __ldg(ap + ((4 + mu) * 9 + r * 3 + c) * YXs);
        acc_r[r] += lr * vr[c] - li * vi[c];
        acc_i[r] += lr * vi[c] + li * vr[c];
      }
    }
    // backward: B_mu(y)^dag psi(y) at y = x-mu
    const size_t yplane = static_cast<size_t>(nplane[4 + mu]);
    const float* qp = psi + yplane * 6 * YXs + nyx[4 + mu];
    const float* bp = b + yplane * 72 * YXs + nyx[4 + mu];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      vr[c] = __ldg(qp + c * YXs);
      vi[c] = __ldg(qp + (3 + c) * YXs);
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float lr = __ldg(bp + (mu * 9 + c * 3 + r) * YXs);
        const float li = __ldg(bp + ((4 + mu) * 9 + c * 3 + r) * YXs);
        acc_r[r] -= lr * vr[c] + li * vi[c];
        acc_i[r] -= lr * vi[c] - li * vr[c];
      }
    }
  }
  float* op = out + static_cast<size_t>(th * Z + z) * 6 * YXs + yx;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    op[r * YXs] = 0.5f * acc_r[r];
    op[(3 + r) * YXs] = 0.5f * acc_i[r];
  }
}

}  // namespace

// Kernel B5.  Plain C entry point, bound from Python with ctypes:
// launches on `stream` (PyTorch's current stream), does not synchronise,
// and returns cudaGetLastError() of the launch (0 on success).
extern "C" int qex_stag_v2_dslash(const void* a, const void* b,
                                  const void* psi, void* out, int X, int Y,
                                  int Z, int Th, int parity_out,
                                  void* stream) {
  const long long V = static_cast<long long>(Th) * Z * Y * X;
  if (V <= 0 || V > INT_MAX || Z > 65535 || Th > 65535)
    return cudaErrorInvalidValue;
  const int YX = X * Y;
  const dim3 grid((YX + kThreads - 1) / kThreads, Z, Th);
  stag_v2_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(psi), static_cast<float*>(out), X, Y, Z, Th,
      parity_out);
  return static_cast<int>(cudaGetLastError());
}
