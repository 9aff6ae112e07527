"""Batched closest-point geometry (port of lsc_dr_planner_tpu/ops/geometry.py).

Branch-free, fixed-shape, batched over arbitrary leading axes. The
point-to-convex-hull query is the exact Carathéodory enumeration of the
JAX package: every vertex, edge and triangle of the K-point hull is a
candidate, plus C(K,4) origin-inside-tetrahedron tests. For K=6 that is
41 candidates and 15 tetrahedra, all materialised (a fused kernel is a
later item).
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

_EPS = 1e-12


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def closest_point_on_segment(p, a, b):
    """Closest point to p on segment [a, b]; all [..., D]."""
    ab = b - a
    denom = _dot(ab, ab)[..., None]
    t = _dot(p - a, ab)[..., None] / torch.clamp(denom, min=_EPS)
    t = torch.where(denom <= _EPS, 0.0, torch.clamp(t, 0.0, 1.0))
    return a + t * ab


def closest_between_segments(p1, p2, q1, q2):
    """Closest points between segments [p1,p2] and [q1,q2]; all [..., D].
    Returns (point_on_P, point_on_Q, dist)."""
    d1 = p2 - p1
    d2 = q2 - q1
    r = p1 - q1
    a = _dot(d1, d1)
    e = _dot(d2, d2)
    f = _dot(d2, r)
    c = _dot(d1, r)
    b = _dot(d1, d2)
    denom = a * e - b * b

    s_gen = torch.clamp((b * f - c * e) / torch.clamp(denom, min=_EPS), 0.0, 1.0)
    # parallel (denom ~ 0): s = 0
    s = torch.where(denom > _EPS * torch.clamp(a * e, min=1.0), s_gen, 0.0)
    s = torch.where(a <= _EPS, 0.0, s)

    t = (b * s + f) / torch.clamp(e, min=_EPS)
    t_clamped = torch.clamp(t, 0.0, 1.0)
    s2 = torch.clamp((b * t_clamped - c) / torch.clamp(a, min=_EPS), 0.0, 1.0)
    s = torch.where(a <= _EPS, 0.0, torch.where(t == t_clamped, s, s2))
    t = torch.where(e <= _EPS, 0.0, t_clamped)

    cp = p1 + s[..., None] * d1
    cq = q1 + t[..., None] * d2
    dist = torch.linalg.vector_norm(cq - cp, dim=-1)
    return cp, cq, dist


@functools.lru_cache(maxsize=None)
def _simplex_indices(K: int, device: torch.device):
    """Vertex indices of every edge, triangle and tetrahedron of K points,
    as [4 index tensors per simplex size] on `device` (made once)."""
    out = []
    for size in (2, 3, 4):
        idx = np.array(list(itertools.combinations(range(K), size)),
                       dtype=np.int64).reshape(-1, size)
        out.append([torch.as_tensor(idx[:, j].copy(), device=device)
                    for j in range(size)])
    return out


def _closest_on_triangle_to_origin(a, b, c):
    """Closest point to the origin on triangle (a, b, c); [..., 3] each.
    Voronoi-region query resolved with nested selects."""
    ab = b - a
    ac = c - a
    ap = -a
    d1 = _dot(ab, ap)
    d2 = _dot(ac, ap)
    bp = -b
    d3 = _dot(ab, bp)
    d4 = _dot(ac, bp)
    cp = -c
    d5 = _dot(ab, cp)
    d6 = _dot(ac, cp)

    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4

    v_ab = torch.clamp(d1 / torch.clamp(d1 - d3, min=_EPS), 0.0, 1.0)
    p_ab = a + v_ab[..., None] * ab
    w_ac = torch.clamp(d2 / torch.clamp(d2 - d6, min=_EPS), 0.0, 1.0)
    p_ac = a + w_ac[..., None] * ac
    w_bc = torch.clamp(
        (d4 - d3) / torch.clamp((d4 - d3) + (d5 - d6), min=_EPS), 0.0, 1.0)
    p_bc = b + w_bc[..., None] * (c - b)
    denom = torch.clamp(va + vb + vc, min=_EPS)
    v_in = vb / denom
    w_in = vc / denom
    p_in = a + v_in[..., None] * ab + w_in[..., None] * ac

    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)

    out = p_in
    out = torch.where(on_bc[..., None], p_bc, out)
    out = torch.where(on_ac[..., None], p_ac, out)
    out = torch.where(on_ab[..., None], p_ab, out)
    out = torch.where(in_c[..., None], c, out)
    out = torch.where(in_b[..., None], b, out)
    out = torch.where(in_a[..., None], a, out)
    return out


def _origin_in_tetra(a, b, c, d):
    """True where the origin is inside tetrahedron (a, b, c, d); [..., 3]."""

    def signed_vol(p0, p1, p2, p3):
        return _dot(p1 - p0, torch.linalg.cross(p2 - p0, p3 - p0, dim=-1))

    o = torch.zeros_like(a)
    v0 = signed_vol(a, b, c, d)
    v1 = signed_vol(o, b, c, d)
    v2 = signed_vol(a, o, c, d)
    v3 = signed_vol(a, b, o, d)
    v4 = signed_vol(a, b, c, o)
    eps = 1e-10
    nondegen = torch.abs(v0) > eps
    same_pos = (v1 >= -eps) & (v2 >= -eps) & (v3 >= -eps) & (v4 >= -eps)
    same_neg = (v1 <= eps) & (v2 <= eps) & (v3 <= eps) & (v4 <= eps)
    return nondegen & torch.where(v0 > 0, same_pos, same_neg)


def closest_point_origin_to_hull(points):
    """Exact closest point to the origin in conv(points).

    points: [..., K, 3] → (closest_point [..., 3], dist [...]). Odd under
    points → −points, so a reciprocal pair gets mirrored normals.
    """
    pairs, triples, quads = _simplex_indices(points.shape[-2], points.device)

    def pick(idx):
        return points.index_select(-2, idx)

    cand = [points]
    if len(pairs[0]):
        a, b = pick(pairs[0]), pick(pairs[1])
        cand.append(closest_point_on_segment(torch.zeros_like(a), a, b))
    if len(triples[0]):
        cand.append(_closest_on_triangle_to_origin(*map(pick, triples)))
    cand = torch.cat(cand, dim=-2)
    d2 = _dot(cand, cand)
    idx = torch.argmin(d2, dim=-1)  # first minimum among ties, as jnp.argmin
    best = torch.gather(
        cand, -2, idx[..., None, None].expand(*idx.shape, 1, cand.shape[-1])
    )[..., 0, :]
    dist = torch.sqrt(torch.gather(d2, -1, idx[..., None])[..., 0])

    if len(quads[0]):
        inside = torch.any(_origin_in_tetra(*map(pick, quads)), dim=-1)
        dist = torch.where(inside, 0.0, dist)
        best = torch.where(inside[..., None], 0.0, best)
    return best, dist
