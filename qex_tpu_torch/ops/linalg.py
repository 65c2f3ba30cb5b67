"""Site-local dense linear algebra on lattice fields (port of
``qex_tpu.ops.linalg``: products, traces, global sums, ``expm``, the
closed-form ``det``/``inv``, ``rsqrt_phm`` and the polar projections
``project_u``/``project_su``).

All operations act on the *leading* site-tensor axes of a field: a
matrix field has shape ``(n, m, *lattice_dims)`` and a vector field
``(n, *lattice_dims)``.  Products are written as broadcast multiplies
summed over the contracted leading axis -- elementwise over the sites,
never a batched ``torch.linalg`` call over sites.

The global sums take an optional accumulation ``dtype``: the HMC
Hamiltonian accumulates in float64 (``torch.float64``) while the solver
keeps the working precision, as the JAX solver does.
"""

from __future__ import annotations

import torch


def adj(m: torch.Tensor) -> torch.Tensor:
    """Hermitian conjugate of a matrix field (leading two axes)."""
    return m.transpose(0, 1).conj()


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matrix-matrix product of two matrix fields: (a @ b) per site."""
    return (a[:, :, None] * b[None, :, :]).sum(1)


def mul_an(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """adj(a) @ b per site."""
    return (a.conj()[:, :, None] * b[:, None, :]).sum(0)


def mul_na(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ adj(b) per site."""
    return (a[:, None, :] * b.conj()[None, :, :]).sum(2)


def mul_aa(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """adj(a) @ adj(b) per site."""
    return mul(adj(a), adj(b))


def mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Matrix-vector product per site: (m @ v)."""
    return (m * v[None]).sum(1)


def mv_an(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """adj(m) @ v per site."""
    return (m.conj() * v[:, None]).sum(0)


def trace(m: torch.Tensor) -> torch.Tensor:
    """Per-site trace (complex scalar field)."""
    return torch.diagonal(m, dim1=0, dim2=1).sum(-1)


def re_trace(m: torch.Tensor) -> torch.Tensor:
    return trace(m).real


def eye_like(m: torch.Tensor) -> torch.Tensor:
    """Identity matrix field broadcastable against matrix field ``m``."""
    n = m.shape[0]
    ident = torch.eye(n, dtype=m.dtype, device=m.device)
    return ident.reshape((n, n) + (1,) * (m.dim() - 2))


def norm2(x: torch.Tensor, dtype: torch.dtype | None = None
          ) -> torch.Tensor:
    """Global squared 2-norm: sum |x|^2 over all axes (real scalar),
    accumulated in ``dtype`` (default: x's real dtype)."""
    if x.is_complex():
        xr, xi = x.real, x.imag
        return torch.sum(xr * xr, dtype=dtype) + torch.sum(xi * xi,
                                                            dtype=dtype)
    return torch.sum(x * x, dtype=dtype)


def dot(x: torch.Tensor, y: torch.Tensor, dtype: torch.dtype | None = None
        ) -> torch.Tensor:
    """Global inner product <x, y> = sum conj(x) y (complex scalar),
    accumulated in the complex ``dtype`` (default: the product's)."""
    return torch.sum(x.conj() * y, dtype=dtype)


def redot(x: torch.Tensor, y: torch.Tensor,
          dtype: torch.dtype | None = None) -> torch.Tensor:
    """Real part of the global inner product, accumulated in ``dtype``
    (real tensors, such as split re/im vectors, take sum x y)."""
    if not (x.is_complex() or y.is_complex()):
        return torch.sum(x * y, dtype=dtype)
    return torch.sum(x.real * y.real + x.imag * y.imag, dtype=dtype)


def expm(m: torch.Tensor, order: int = 12, squarings: int = 4
         ) -> torch.Tensor:
    """Per-site matrix exponential via Taylor + scaling-and-squaring
    (fixed order and squaring count, as ``qex_tpu.ops.linalg.expm``)."""
    x = m * (0.5 ** squarings)
    r = eye_like(m) + x
    term = x
    fac = 1.0
    for k in range(2, order + 1):
        term = mul(term, x)
        fac = fac / k
        r = r + term * fac
    for _ in range(squarings):
        r = mul(r, r)
    return r


# --- closed forms for small n -------------------------------------------------

def det(m: torch.Tensor) -> torch.Tensor:
    """Per-site determinant: closed form for n <= 3, elementwise over the
    sites; larger n go through ``torch.linalg.det`` on site-major
    matrices."""
    n = m.shape[0]
    if n == 1:
        return m[0, 0]
    if n == 2:
        return m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    if n == 3:
        return (
            m[0, 0] * (m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1])
            - m[0, 1] * (m[1, 0] * m[2, 2] - m[1, 2] * m[2, 0])
            + m[0, 2] * (m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0])
        )
    return torch.linalg.det(torch.movedim(m, (0, 1), (-2, -1)))


def inv(m: torch.Tensor) -> torch.Tensor:
    """Per-site inverse: adjugate over determinant for n <= 3, else
    ``torch.linalg.inv`` on site-major matrices."""
    n = m.shape[0]
    if n > 3:
        mi = torch.linalg.inv(torch.movedim(m, (0, 1), (-2, -1)))
        return torch.movedim(mi, (-2, -1), (0, 1))
    d = det(m)
    if n == 1:
        return (1.0 / d)[None, None]
    if n == 2:
        rows = [[m[1, 1], -m[0, 1]], [-m[1, 0], m[0, 0]]]
    else:
        def cof(i, j):
            i1, i2 = [a for a in range(3) if a != i]
            j1, j2 = [a for a in range(3) if a != j]
            return m[i1, j1] * m[i2, j2] - m[i1, j2] * m[i2, j1]
        # adjugate = transpose of the cofactor matrix, checkerboard signs
        rows = [[((-1) ** (i + j)) * cof(j, i) for j in range(3)]
                for i in range(3)]
    return torch.stack([torch.stack(r) for r in rows]) / d


# --- hermitian inverse square root and unitary projection -------------------

def rsqrt_phm(h: torch.Tensor, iters: int = 14, eps: float = 1e-30
              ) -> torch.Tensor:
    """Inverse square root of a positive-definite hermitian matrix field
    by coupled Newton-Schulz, after scaling by the per-site trace so that
    ||I - H/s|| < 1 (QEX ``rsqrtPHM``)."""
    n = h.shape[0]
    ident = eye_like(h)
    s = trace(h).real / n + eps
    a = h / s
    y, z = a, ident
    for _ in range(iters):
        t = 0.5 * (3.0 * ident - mul(z, y))
        y = mul(y, t)
        z = mul(t, z)
    return z / torch.sqrt(s)


def _project_u_ns(x: torch.Tensor, iters: int = 14) -> torch.Tensor:
    """Polar projection through Newton-Schulz, differentiable by autograd
    through the iterations (any n)."""
    return mul(x, rsqrt_phm(mul_an(x, x), iters=iters))


def _eigvals_herm3(h: torch.Tensor):
    """Closed-form eigenvalues of a 3x3 hermitian matrix field
    (trigonometric Cardano), three real fields.  At a degenerate site
    (h proportional to I, e.g. a cold start) p is held at sqrt(tiny) and
    the arccos argument clipped to [-1, 1], as in the JAX reference."""
    q = trace(h).real / 3.0
    hd = h - q.to(h.dtype) * eye_like(h)
    p2 = trace(mul(hd, hd)).real
    tiny = torch.tensor(1e-30, dtype=p2.dtype, device=p2.device)
    p = torch.sqrt(torch.maximum(p2 / 6.0, tiny))
    b = hd / p.to(h.dtype)
    r = torch.clamp(det(b).real / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    two_pi_3 = 2.0943951023931953
    return tuple(q + 2.0 * p * torch.cos(phi - two_pi_3 * k)
                 for k in range(3))


def _sylvester_herm3(r: torch.Tensor, m: torch.Tensor, s123
                     ) -> torch.Tensor:
    """Solve R N + N R = M for a 3x3 hermitian positive field R with
    eigenvalues ``s123``, without eigenvectors: T(A) = RA + AR is
    annihilated by the monic degree-6 polynomial with roots
    {s_i + s_j, i <= j}, so T^{-1} M is a degree-5 polynomial in T
    applied to M (degeneracy-safe, elementwise)."""
    s1, s2, s3 = s123
    roots = (2.0 * s1, 2.0 * s2, 2.0 * s3, s1 + s2, s1 + s3, s2 + s3)
    coeffs = [torch.ones_like(s1)]        # highest degree first
    for rt in roots:
        nxt = [coeffs[0]]
        for k in range(1, len(coeffs)):
            nxt.append(coeffs[k] - rt * coeffs[k - 1])
        nxt.append(-rt * coeffs[-1])
        coeffs = nxt
    a = [coeffs[6 - k].to(m.dtype) for k in range(7)]
    tm = m
    acc = a[1] * m
    for k in range(2, 7):
        tm = mul(r, tm) + mul(tm, r)
        acc = acc + a[k] * tm
    return -acc / a[0]


class _ProjectU3(torch.autograd.Function):
    """Polar projection of a 3x3 field with the closed-form backward of
    the JAX ``_project_u3_bwd``.  The forward runs without recording and
    keeps only (x, s = (x^dag x)^{-1/2}), never the Newton-Schulz
    iterates.

    torch's gradient of a real loss is the conjugate of JAX's, so the
    backward is conj(jax_bwd(conj(g))):

        M = S g^dag P,   R N + N R = M  (R = H^{1/2}, P = X S),
        G_X = g S^dag - X N^dag - X N.
    """

    @staticmethod
    def forward(ctx, x, iters):
        with torch.no_grad():
            s = rsqrt_phm(mul_an(x, x), iters=iters)
            out = mul(x, s)
        ctx.save_for_backward(x, s)
        return out

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        h = mul_an(x, x)
        r = mul(h, s)
        p = mul(x, s)
        m = mul(s, mul_an(g, p))
        l1, l2, l3 = _eigvals_herm3(h)
        sq = tuple(torch.sqrt(torch.clamp(lam, min=1e-30))
                   for lam in (l1, l2, l3))
        nn = _sylvester_herm3(r, m, sq)
        return mul_na(g, s) - mul_na(x, nn) - mul(x, nn), None


def project_u(x: torch.Tensor, iters: int = 14) -> torch.Tensor:
    """Polar projection U = X (X^dag X)^{-1/2} onto U(n) (QEX
    ``projectU``).  For n = 3 the backward is the closed-form polar VJP
    (memory O(1) in the iteration count); other n differentiate through
    the Newton-Schulz iterations."""
    if x.shape[0] == 3 and x.shape[1] == 3:
        return _ProjectU3.apply(x, iters)
    return _project_u_ns(x, iters)


def project_su(x: torch.Tensor, iters: int = 14) -> torch.Tensor:
    """Projection onto SU(n): polar projection, then the determinant's
    phase removed (QEX ``projectSU``)."""
    n = x.shape[0]
    u = project_u(x, iters=iters)
    phase = torch.angle(det(u))
    return u * torch.exp(-1j * phase / n).to(u.dtype)
