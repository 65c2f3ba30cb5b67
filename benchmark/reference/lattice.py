"""Plain PyTorch reference of the lattice arithmetic the benchmark's
cells drive: SU(3) site algebra, shifts, staggered phases, the
staggered and fat + naik hopping terms on the full lattice, nHYP and
HISQ smearing, the Wilson gauge action and conjugate gradient.

It is written from the published definitions (QEX's conventions, which
the benchmark's configurations name) and imports nothing of the program
under test.  Fields keep the program's documented interface layout:
links (4, 3, 3, X, Y, Z, T), colour vectors (3, X, Y, Z, T); direction
mu runs along lattice axis mu.  Even-site vectors are full-lattice
vectors that vanish on odd sites, so no even-odd packing is needed
inside; :func:`unpack_even` and :func:`pack_even` read and write the
program's packed even half.

Every function takes a :class:`Precision`.  ``complex128`` is the
reference proper; ``bfloat16`` is the control (:data:`CONTROL`):
complex64 arithmetic whose every stored result is rounded to bfloat16
components, as a bfloat16 implementation would store it.
"""

from __future__ import annotations

import math

import torch

CONTROL = "bfloat16"    # the precision below the configurations' complex64

HYP_PAIRS = [(mu, nu) for mu in range(4) for nu in range(4) if nu != mu]
HYP_INDEX = {pair: i for i, pair in enumerate(HYP_PAIRS)}


class Precision:
    """Working precision: ``complex128``, ``complex64`` or ``bfloat16``
    (see module)."""

    def __init__(self, name: str = "complex128"):
        if name not in ("complex128", "complex64", "bfloat16"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.bf16 = name == "bfloat16"
        self.dtype = (torch.complex128 if name == "complex128"
                      else torch.complex64)
        self.rdtype = self.dtype.to_real()

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """Round a stored result to this precision."""
        if not self.bf16:
            return x
        if x.is_complex():
            return torch.complex(x.real.to(torch.bfloat16).to(torch.float32),
                                 x.imag.to(torch.bfloat16).to(torch.float32))
        return x.to(torch.bfloat16).to(x.dtype)

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return self.q(x.to(self.dtype))


# --- site algebra on (3, 3, *dims) matrices and (3, *dims) vectors ----------

def adj(a):
    return a.transpose(0, 1).conj()


def mul(a, b, pr: Precision):
    return pr.q((a[:, :, None] * b[None]).sum(1))


def mul_an(a, b, pr: Precision):
    """adj(a) b"""
    return pr.q((a.conj()[:, :, None] * b[:, None, :]).sum(0))


def mul_na(a, b, pr: Precision):
    """a adj(b)"""
    return pr.q((a[:, None, :] * b.conj()[None, :, :]).sum(2))


def mv(m, v, pr: Precision):
    return pr.q((m * v[None]).sum(1))


def mv_adj(m, v, pr: Precision):
    return pr.q((m.conj() * v[:, None]).sum(0))


def trace(a):
    return a[0, 0] + a[1, 1] + a[2, 2]


def eye(a):
    e = torch.eye(3, dtype=a.dtype, device=a.device)
    return e.reshape((3, 3) + (1,) * (a.dim() - 2))


def det3(a):
    return (a[0, 0] * (a[1, 1] * a[2, 2] - a[1, 2] * a[2, 1])
            - a[0, 1] * (a[1, 0] * a[2, 2] - a[1, 2] * a[2, 0])
            + a[0, 2] * (a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0]))


def tah(a):
    """Traceless anti-hermitian part (a - a^dag)/2 - tr(.)/3."""
    d = 0.5 * (a - adj(a))
    return d - (trace(d) / 3.0) * eye(a)


def norm2(x, acc=torch.float64) -> torch.Tensor:
    """sum |x|^2, accumulated in ``acc``."""
    return (x.real.to(acc) ** 2).sum() + (x.imag.to(acc) ** 2).sum()


def redot(x, y, acc=torch.float64) -> torch.Tensor:
    """Re sum conj(x) y, accumulated in ``acc``."""
    return (x.real.to(acc) * y.real.to(acc)
            + x.imag.to(acc) * y.imag.to(acc)).sum()


# --- geometry ----------------------------------------------------------------

def shift(f, mu: int, k: int):
    """result[x] = f[x + k mu_hat], periodic; lattice axes are the last
    four."""
    return torch.roll(f, -k, dims=f.dim() - 4 + mu)


def coords(dims, device):
    """Four broadcastable coordinate fields over ``dims``."""
    out = []
    for mu, n in enumerate(dims):
        shape = [1, 1, 1, 1]
        shape[mu] = n
        out.append(torch.arange(n, device=device).reshape(shape))
    return out


def even_mask(dims, device) -> torch.Tensor:
    x = coords(dims, device)
    return ((x[0] + x[1] + x[2] + x[3]) % 2) == 0


def phase_signs(dims, bc: str, device) -> torch.Tensor:
    """eta_mu(x) times the boundary sign, shape (4, *dims): eta_0 = 1,
    eta_mu = (-1)^(x_0 + ... + x_{mu-1}); an 'a' in ``bc`` flips the
    links of that direction on its last slice."""
    x = coords(dims, device)
    out = []
    acc = torch.zeros((1, 1, 1, 1), dtype=torch.int64, device=device)
    for mu in range(4):
        s = (1 - 2 * (acc % 2)).expand(dims)
        if bc[mu] == "a":
            s = torch.where(x[mu] == dims[mu] - 1, -s, s)
        elif bc[mu] != "p":
            raise ValueError(f"bad boundary condition {bc!r}")
        out.append(s)
        acc = acc + x[mu]
    return torch.stack(out)


def phased(u, bc: str, pr: Precision):
    signs = phase_signs(u.shape[3:], bc, u.device).to(pr.rdtype)
    return u * signs[:, None, None]


def unpack_even(packed, dims) -> torch.Tensor:
    """The program's packed even half (..., X, Y, Z, T/2) as a full
    vector zero on odd sites: full[..., x, y, z, 2 th + s] = packed with
    s = (x + y + z) mod 2."""
    x = coords(dims, packed.device)
    s = (((x[0] + x[1] + x[2]) % 2) == 1)[..., 0:1]
    zero = torch.zeros_like(packed)
    pair = torch.stack([torch.where(s, zero, packed),
                        torch.where(s, packed, zero)], dim=-1)
    return pair.reshape(packed.shape[:-1] + (dims[3],))


def pack_even(full, dims) -> torch.Tensor:
    x = coords(dims, full.device)
    s = (((x[0] + x[1] + x[2]) % 2) == 1)[..., 0:1]
    pair = full.reshape(full.shape[:-1] + (dims[3] // 2, 2))
    return torch.where(s, pair[..., 1], pair[..., 0])


# --- staggered operators -----------------------------------------------------

def dslash(fat, x, pr: Precision, long=None):
    """1/2 sum_mu [fat_mu(x) chi(x+mu) - fat_mu(x-mu)^dag chi(x-mu)]
    (+ the same at distance 3 through ``long``) on phased links."""
    out = None
    for mu in range(4):
        t = (mv(fat[mu], shift(x, mu, 1), pr)
             - shift(mv_adj(fat[mu], x, pr), mu, -1))
        if long is not None:
            t = t + (mv(long[mu], shift(x, mu, 3), pr)
                     - shift(mv_adj(long[mu], x, pr), mu, -3))
        out = t if out is None else out + t
    return pr.q(0.5 * out)


def normal_op(fat, x_e, m2: float, pr: Precision, long=None):
    """A x = (m^2 - D D) x on an even-site vector (D maps even to odd
    and back, so the result stays on even sites)."""
    return pr.q(m2 * x_e - dslash(fat, dslash(fat, x_e, pr, long), pr, long))


def cg(apply, b, r2req: float, maxits: int, pr: Precision):
    """Conjugate gradient from zero; stops when |r|^2 <= r2req |b|^2.
    Returns (x, iterations)."""
    b2 = float(norm2(b))
    x = torch.zeros_like(b)
    r = b
    p = r
    rr = norm2(r)
    k = 0
    while float(rr) > r2req * b2 and k < maxits:
        ap = apply(p)
        pap = redot(p, ap)
        if not float(pap) > 0.0:          # breakdown (rounded operands)
            break
        alpha = (rr / pap).to(pr.rdtype)
        x = pr.q(x + alpha * p)
        r = pr.q(r - alpha * ap)
        rr_new = norm2(r)
        p = pr.q(r + (rr_new / rr).to(pr.rdtype) * p)
        rr = rr_new
        k += 1
    return x, k


def true_r2(apply, x, b) -> float:
    """|b - A x|^2 / |b|^2 in float64."""
    return float(norm2(b - apply(x)) / norm2(b))


# --- smearing ----------------------------------------------------------------

def sym_staple(side, mid, nu: int, mu: int, pr: Precision):
    """side(x) mid(x+nu) side(x+mu)^dag
    + side(x-nu)^dag mid(x-nu) side(x-nu+mu) for a direction-mu ``mid``
    and direction-nu ``side``."""
    side_mu = shift(side, mu, 1)
    up = mul_na(mul(side, shift(mid, nu, 1), pr), side_mu, pr)
    down = mul(mul_an(side, mid, pr), side_mu, pr)
    return pr.q(up + shift(down, nu, -1))


def project_u(x, pr: Precision):
    """Polar projection X (X^dag X)^{-1/2} onto U(3), with the inverse
    square root in closed form (Hasenfratz, Hoffmann and Schaefer,
    hep-lat/0702028): the eigenvalues g_i of Q = X^dag X by Cardano's
    formula, then Q^{-1/2} = f0 + f1 Q + f2 Q^2."""
    q = mul_an(x, x, pr)
    q2 = mul(q, q, pr)
    c0 = trace(q).real / 3.0
    qd = q - c0 * eye(q)
    p2 = trace(mul(qd, qd, pr)).real / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    # |r| < 1 strictly: arccos has an infinite slope at +-1, which a
    # rounded r can reach
    edge = 1.0 - (1e-6 if pr.rdtype == torch.float32 else 1e-14)
    r = torch.clamp(det3(qd / p).real / 2.0, -edge, edge)
    phi = torch.arccos(r) / 3.0
    sq = [torch.sqrt(torch.clamp(c0 + 2.0 * p * torch.cos(
        phi - 2.0 * math.pi * k / 3.0), min=1e-30)) for k in range(3)]
    u = sq[0] + sq[1] + sq[2]
    v = sq[0] * sq[1] + sq[0] * sq[2] + sq[1] * sq[2]
    w = sq[0] * sq[1] * sq[2]
    den = w * (u * v - w)
    f0 = (u * v * v - w * (u * u + v)) / den
    f1 = (-w - u * u * u + 2.0 * u * v) / den
    f2 = u / den
    rs = f0 * eye(q) + f1 * q + f2 * q2
    return mul(x, pr.q(rs), pr)


def nhyp(u, alphas, pr: Precision):
    """Three-level nHYP smearing (QEX hypsmear conventions, alpha1 the
    innermost level):

      L1[mu][nu] = P((1-a1) U_mu + a1/2 SS_nu(U_nu, U_mu))
      L2[mu][nu] = P((1-a2) U_mu + a2/4 sum_a SS_a(L1[a][b], L1[mu][b]))
      V_mu       = P((1-a3) U_mu + a3/6 sum_nu SS_nu(L2[nu][mu], L2[mu][nu]))

    with a, b the two directions other than mu, nu, and P the polar
    projection."""
    a1, a2, a3 = alphas
    l1 = [project_u(pr.q((1.0 - a1) * u[mu] + 0.5 * a1 * sym_staple(
        u[nu], u[mu], nu, mu, pr)), pr) for mu, nu in HYP_PAIRS]
    l2 = []
    for mu, nu in HYP_PAIRS:
        comp = [d for d in range(4) if d not in (mu, nu)]
        acc = (1.0 - a2) * u[mu]
        for a in comp:
            b = comp[1] if a == comp[0] else comp[0]
            acc = acc + 0.25 * a2 * sym_staple(
                l1[HYP_INDEX[(a, b)]], l1[HYP_INDEX[(mu, b)]], a, mu, pr)
        l2.append(project_u(pr.q(acc), pr))
    out = []
    for mu in range(4):
        acc = (1.0 - a3) * u[mu]
        for nu in range(4):
            if nu != mu:
                acc = acc + (a3 / 6.0) * sym_staple(
                    l2[HYP_INDEX[(nu, mu)]], l2[HYP_INDEX[(mu, nu)]], nu,
                    mu, pr)
        out.append(project_u(pr.q(acc), pr))
    return torch.stack(out)


def fat7_coefs(f7lf: float, naik: float) -> dict:
    """QEX setHisqFat7: one-link, 3-, 5-, 7-staple and Lepage weights."""
    return {"one": (1.0 + 3.0 * f7lf + naik) / 8.0, "three": -1.0 / 16.0,
            "five": 1.0 / 64.0, "seven": -1.0 / 384.0,
            "lepage": -f7lf / 16.0}


def fat_link(u, c: dict, d: int, pr: Precision):
    """Fat7 + Lepage link of direction d: (one - 6 lepage) U_d plus the
    3-, 5- and 7-staples and the same-direction Lepage path."""
    fl = (c["one"] - 6.0 * c["lepage"]) * u[d]
    for nu in range(4):
        if nu == d:
            continue
        s3 = sym_staple(u[nu], u[d], nu, d, pr)
        fl = fl + c["three"] * s3
        if c["lepage"] != 0.0:
            fl = fl + c["lepage"] * sym_staple(u[nu], s3, nu, d, pr)
        for rho in range(4):
            if rho in (d, nu):
                continue
            s5 = sym_staple(u[rho], s3, rho, d, pr)
            fl = fl + c["five"] * s5
            for sig in range(4):
                if sig in (d, nu, rho):
                    continue
                fl = fl + c["seven"] * sym_staple(u[sig], s5, sig, d, pr)
    return pr.q(fl)


def hisq_links(g, pr: Precision, c: dict):
    """HISQ links of phased links g: fat7 (``c["first"]``), the U(3)
    projection, then fat7 (``c["second"]``) for the fat links and
    ``c["naik"]`` W(x) W(x+d) W(x+2d) of the projected field W for the
    long links."""
    first = fat7_coefs(**c["first"])
    second = fat7_coefs(**c["second"])
    w = torch.stack([project_u(fat_link(g, first, d, pr), pr)
                     for d in range(4)])
    fat = torch.stack([fat_link(w, second, d, pr) for d in range(4)])
    long = torch.stack([pr.q(c["naik"] * mul(w[d], mul(
        shift(w[d], d, 1), shift(w[d], d, 2), pr), pr)) for d in range(4)])
    return fat, long


# --- gauge action ------------------------------------------------------------

def wilson_action(u, beta: float, pr: Precision,
                  acc=torch.float64) -> torch.Tensor:
    """S = -(beta/3) sum_x sum_{mu>nu} Re tr U_mu(x) U_nu(x+mu)
    U_mu(x+nu)^dag U_nu(x)^dag, accumulated in ``acc``."""
    s = torch.zeros((), dtype=acc, device=u.device)
    for mu in range(1, 4):
        for nu in range(mu):
            a = mul(u[mu], shift(u[nu], mu, 1), pr)
            b = mul(u[nu], shift(u[mu], nu, 1), pr)
            s = s + redot(a, b, acc)
    return -(beta / 3.0) * s


def expm(z, order: int = 16):
    """exp(z) per site by its Taylor series after scaling by 2^-s, s
    the least with |z| 2^-s <= 1/2 (Frobenius norm, over all sites),
    and s squarings."""
    nrm = float(torch.sqrt((z.real ** 2 + z.imag ** 2).sum((0, 1)).max()))
    s = max(0, math.ceil(math.log2(max(nrm, 1e-300) / 0.5)))
    x = z * (0.5 ** s)
    pr = Precision("complex128" if z.dtype == torch.complex128
                   else "complex64")
    out = eye(x) + x
    term = x
    for k in range(2, order + 1):
        term = mul(term, x, pr) / k
        out = out + term
    for _ in range(s):
        out = mul(out, out, pr)
    return out


def expm_mul(z, u, pr: Precision):
    """exp(z) u per site, the exponential taken in z's type and stored
    in ``pr``."""
    return mul(pr.q(expm(z).to(u.dtype)), u, pr)


def staple_sum(u, mu: int, pr: Precision):
    """Sum over nu != mu of the symmetric staples of U_mu."""
    out = None
    for nu in range(4):
        if nu != mu:
            s = sym_staple(u[nu], u[mu], nu, mu, pr)
            out = s if out is None else out + s
    return out
