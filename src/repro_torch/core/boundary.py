"""Gaussian-vs-rectangle intersection tests (mirror of ``repro.core.boundary``).

Three methods, all conservative supersets of the true 3-sigma ellipse
coverage and all monotone under rectangle containment (tile ⊂ group ⇒
test(tile) ⇒ test(group)) — the property that makes tile grouping lossless:

  * ``aabb``    — square box from the circumscribed 3σ radius (original 3D-GS)
  * ``obb``     — oriented bounding box of the 3σ ellipse via SAT (GSCore)
  * ``ellipse`` — exact ellipse/rect intersection: closed-form minimum of the
                  conic quadratic form over the rectangle

plus ``ellipse_opacity``, the opacity-aware support bound. All tests
broadcast over leading batch dims; a rect is (x0, y0, x1, y1) in pixels.
Every expression keeps the JAX package's operation order, so the same
float32 inputs give the same bits.
"""
from __future__ import annotations

import torch

from repro_torch.core.projection import QMAX_3SIGMA, SIGMA_CUT

BOUNDARY_METHODS = ("aabb", "obb", "ellipse", "ellipse_opacity")


def opacity_qmax(alpha):
    """min(9, 2 ln(255 alpha)): where alpha * exp(-q/2) drops below 1/255."""
    return torch.clamp(
        2.0 * torch.log(torch.clamp(255.0 * alpha, min=1.0 + 1e-6)),
        max=QMAX_3SIGMA,
    )


def aabb_test(mean2d, radius, rect):
    """Square AABB from circumscribed radius (3D-GS default)."""
    x0, y0, x1, y1 = rect
    mx, my = mean2d[..., 0], mean2d[..., 1]
    return (
        (mx + radius >= x0)
        & (mx - radius <= x1)
        & (my + radius >= y0)
        & (my - radius <= y1)
    )


def obb_test(mean2d, eigvec, eigval, rect):
    """Separating-axis test between the ellipse's OBB and an axis rect."""
    x0, y0, x1, y1 = rect
    ux, uy = eigvec[..., 0], eigvec[..., 1]
    vx, vy = -uy, ux
    e1 = SIGMA_CUT * torch.sqrt(torch.clamp(eigval[..., 0], min=0.0))
    e2 = SIGMA_CUT * torch.sqrt(torch.clamp(eigval[..., 1], min=0.0))

    cx = 0.5 * (x0 + x1)
    cy = 0.5 * (y0 + y1)
    hx = 0.5 * (x1 - x0)
    hy = 0.5 * (y1 - y0)
    dx = mean2d[..., 0] - cx
    dy = mean2d[..., 1] - cy

    sep_x = torch.abs(dx) > hx + torch.abs(ux) * e1 + torch.abs(vx) * e2
    sep_y = torch.abs(dy) > hy + torch.abs(uy) * e1 + torch.abs(vy) * e2
    sep_u = torch.abs(dx * ux + dy * uy) > e1 + hx * torch.abs(ux) + hy * torch.abs(uy)
    sep_v = torch.abs(dx * vx + dy * vy) > e2 + hx * torch.abs(vx) + hy * torch.abs(vy)
    return ~(sep_x | sep_y | sep_u | sep_v)


def ellipse_min_q(mean2d, conic, rect):
    """Exact min over the rect of q(p) = (p-mu)^T Conic (p-mu): 0 if mu is
    inside, else the least of the four edge minima (each a clamped 1D
    quadratic minimum)."""
    x0, y0, x1, y1 = rect
    A = conic[..., 0]
    B = conic[..., 1]
    C = conic[..., 2]
    mx, my = mean2d[..., 0], mean2d[..., 1]

    def q_at(px, py):
        ddx = px - mx
        ddy = py - my
        return A * ddx * ddx + 2.0 * B * ddx * ddy + C * ddy * ddy

    C_safe = torch.where(torch.abs(C) > 1e-12, C, torch.full_like(C, 1e-12))
    A_safe = torch.where(torch.abs(A) > 1e-12, A, torch.full_like(A, 1e-12))

    def clip(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)

    def edge_v(xe):
        ys = my - (B / C_safe) * (xe - mx)
        return q_at(xe, clip(ys, y0, y1))

    def edge_h(ye):
        xs = mx - (B / A_safe) * (ye - my)
        return q_at(clip(xs, x0, x1), ye)

    edge_min = torch.minimum(
        torch.minimum(edge_v(x0), edge_v(x1)),
        torch.minimum(edge_h(y0), edge_h(y1)),
    )
    inside = (mx >= x0) & (mx <= x1) & (my >= y0) & (my <= y1)
    return torch.where(inside, torch.zeros_like(edge_min), edge_min)


def ellipse_test(mean2d, conic, rect):
    return ellipse_min_q(mean2d, conic, rect) <= QMAX_3SIGMA


def boundary_test(method: str, proj, rect):
    """Dispatch on method name. ``proj`` is a Projected or any object with
    mean2d/radius/eigvec/eigval/conic/alpha broadcastable against rect."""
    if method == "aabb":
        return aabb_test(proj.mean2d, proj.radius, rect)
    if method == "obb":
        return obb_test(proj.mean2d, proj.eigvec, proj.eigval, rect)
    if method == "ellipse":
        return ellipse_test(proj.mean2d, proj.conic, rect)
    if method == "ellipse_opacity":
        qmax = opacity_qmax(proj.alpha)
        return ellipse_min_q(proj.mean2d, proj.conic, rect) <= qmax
    raise ValueError(f"unknown boundary method: {method!r}")
