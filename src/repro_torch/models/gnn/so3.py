"""SO(3) machinery for the equivariant GNNs: real spherical harmonics,
Wigner rotations of real-SH coefficient vectors and Gaunt (real-CG)
tensors (reference: ``repro.models.gnn.so3``, whose design notes hold
here).

``real_sph_harm`` takes ``xp=np`` for the host-side constants
(``_projection_basis``, ``gaunt_tensor``), which are the reference's
numpy arithmetic step for step and so equal it bit for bit; ``xp=torch``
(the default) evaluates on tensors. The projection basis caches numpy
arrays only; each call moves them to the rotation's device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def n_coeffs(l_max: int) -> int:
    return (l_max + 1) ** 2


def l_slices(l_max: int) -> list[slice]:
    """Coefficient slices per degree: l -> slice(l², (l+1)²)."""
    return [slice(l * l, (l + 1) * (l + 1)) for l in range(l_max + 1)]


def _unit(xyz, xp):
    if xp is np:
        return xyz / np.clip(np.linalg.norm(xyz, axis=-1, keepdims=True), 1e-12, None)
    return xyz / torch.clamp_min(torch.linalg.norm(xyz, dim=-1, keepdim=True), 1e-12)


def real_sph_harm(l_max: int, xyz, *, normalized_input: bool = False, xp=torch):
    """Y_lm at unit directions. xyz (..., 3) -> (..., (l_max+1)²).

    Ordering: (l, m) with m = −l..l, i.e. [Y00, Y1−1, Y10, Y11, Y2−2, …],
    orthonormal (∫ Y² dΩ = 1). The azimuthal factors are polynomials in
    x, y (``cs``, ``sn``); the associated Legendre recursion needs z alone.
    """
    if not normalized_input:
        xyz = _unit(xyz, xp)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    cs = [xp.ones_like(x)]
    sn = [xp.zeros_like(x)]
    for m in range(1, l_max + 1):
        cs.append(x * cs[-1] - y * sn[-1])
        sn.append(x * sn[-1] + y * cs[-2])
    out = []
    p_prev: dict = {}
    p_curr: dict = {}
    for l in range(l_max + 1):
        p_new: dict = {}
        for m in range(l + 1):
            if l == m:
                p_new[m] = xp.ones_like(z) if l == 0 else (2 * m - 1) * p_curr[m - 1]
            elif l == m + 1:
                p_new[m] = (2 * m + 1) * z * p_curr[m]
            else:
                p_new[m] = ((2 * l - 1) * z * p_curr[m] - (l + m - 1) * p_prev[m]) / (l - m)
        p_prev, p_curr = p_curr, p_new
        for m in range(-l, l + 1):
            am = abs(m)
            k = np.sqrt((2 * l + 1) / (4 * np.pi) * _factorial_ratio(l - am, l + am))
            c = k if m == 0 else np.sqrt(2.0) * k
            if xp is not np:  # a Python float times a float32 tensor, as jnp takes the scalar
                c = float(c)
            if m == 0:
                out.append(c * p_curr[0])
            else:
                out.append(c * p_curr[am] * (cs[am] if m > 0 else sn[am]))
    return np.stack(out, axis=-1) if xp is np else torch.stack(out, dim=-1)


def _factorial_ratio(a: int, b: int) -> float:
    """a! / b! computed stably for small ints."""
    out = 1.0
    if a >= b:
        for i in range(b + 1, a + 1):
            out *= i
        return out
    for i in range(a + 1, b + 1):
        out /= i
    return out


# ---------------------------------------------------------------------------
# Rotations of real-SH coefficients (projection method)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _projection_basis(l_max: int, n_pts: int = 0):
    """Fixed generic points X and per-l pinv(Y_l(X)) (host-side numpy)."""
    dim = n_coeffs(l_max)
    n_pts = n_pts or max(2 * dim, 32)
    rng = np.random.default_rng(12345)
    pts = rng.normal(size=(n_pts, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    y = real_sph_harm(l_max, pts, xp=np)  # (P, dim)
    pinvs = [np.linalg.pinv(y[:, sl]).astype(np.float32) for sl in l_slices(l_max)]  # (2l+1, P) each
    return pts.astype(np.float32), pinvs


def wigner_d_from_rot(l_max: int, rot: torch.Tensor) -> list[torch.Tensor]:
    """Rotation matrices D^l for real-SH coefficient vectors.

    rot: (..., 3, 3). Returns a list over l of (..., 2l+1, 2l+1): if c are
    the coefficients of f, D c are those of x ↦ f(Rᵀ x). D^l = (pinv(A)·B)ᵀ
    with A = Y_l(X), B = Y_l(R X) at the fixed points X.
    """
    pts_np, pinvs = _projection_basis(l_max)
    pts = torch.from_numpy(pts_np).to(rot.device)
    rpts = torch.einsum("...ij,pj->...pi", rot, pts)
    yr = real_sph_harm(l_max, rpts)  # (..., P, dim)
    return [torch.einsum("mp,...pn->...nm", torch.from_numpy(pinv).to(rot.device), yr[..., sl])
            for sl, pinv in zip(l_slices(l_max), pinvs)]


def rotate_coeffs(l_max: int, coeffs: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Apply D(R) blockwise. coeffs (..., dim, C) or (..., dim)."""
    ds = wigner_d_from_rot(l_max, rot)
    vec = coeffs.dim() == rot.dim() - 1  # no channel axis
    parts = []
    for sl, d in zip(l_slices(l_max), ds):
        if vec:
            parts.append(torch.einsum("...nm,...m->...n", d, coeffs[..., sl]))
        else:
            parts.append(torch.einsum("...nm,...mc->...nc", d, coeffs[..., sl, :]))
    return torch.cat(parts, dim=-1 if vec else -2)


def edge_rotation(edge_vec: torch.Tensor) -> torch.Tensor:
    """Rotation matrix mapping the edge direction onto +z (..., 3, 3).

    Rows are an orthonormal basis (u, v, n̂) with n̂ the edge direction, so
    R n̂ = e_z. Near the poles (|n̂_z| > 0.99) the helper axis is e_x, not
    e_z, which would be parallel to n̂.
    """
    n = _unit(edge_vec, torch)
    ez = torch.tensor([0.0, 0.0, 1.0], device=edge_vec.device)
    ex = torch.tensor([1.0, 0.0, 0.0], device=edge_vec.device)
    near_pole = torch.abs(n[..., 2:3]) > 0.99
    helper = torch.where(near_pole, ex, ez)
    u = _unit(torch.linalg.cross(helper, n, dim=-1), torch)
    v = torch.linalg.cross(n, u, dim=-1)
    return torch.stack([u, v, n], dim=-2)


# ---------------------------------------------------------------------------
# Gaunt tensors (real-SH triple products): NequIP's contraction weights
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def gaunt_tensor(l1: int, l2: int, l3: int) -> np.ndarray:
    """G[m1, m2, m3] = ∫ Y_{l1m1} Y_{l2m2} Y_{l3m3} dΩ (host-side, exact):
    Gauss–Legendre in cosθ × uniform in φ, exact for band-limited
    integrands of degree ≤ l1+l2+l3."""
    deg = l1 + l2 + l3
    n_theta = deg + 2
    n_phi = 2 * deg + 3
    nodes, weights = np.polynomial.legendre.leggauss(n_theta)
    phi = np.arange(n_phi) * 2 * np.pi / n_phi
    ct, ph = np.meshgrid(nodes, phi, indexing="ij")
    st = np.sqrt(1 - ct**2)
    pts = np.stack([st * np.cos(ph), st * np.sin(ph), ct], axis=-1)
    w = np.broadcast_to(weights[:, None], ct.shape) * (2 * np.pi / n_phi)
    lmax = max(l1, l2, l3)
    y = real_sph_harm(lmax, pts.reshape(-1, 3), xp=np)
    y = y.reshape(n_theta, n_phi, -1)
    sl = l_slices(lmax)
    y1, y2, y3 = y[..., sl[l1]], y[..., sl[l2]], y[..., sl[l3]]
    g = np.einsum("tpa,tpb,tpc,tp->abc", y1, y2, y3, w)
    g[np.abs(g) < 1e-10] = 0.0
    return g
