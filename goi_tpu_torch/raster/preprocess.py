"""Per-Gaussian rasterization preprocess (frustum cull, EWA projection).

Counterpart of goi_tpu/raster/preprocess.py, the vectorized form of
preprocessCUDA (ref:cuda_rasterizer/forward.cu:154-256). Every Gaussian
of the (capacity-padded) scene is computed; a validity mask replaces the
CUDA early returns.

Two paths that share no logic, chosen by `preprocess` from what its
inputs show:
- `preprocess_cuda`: the hand-written kernel csrc/preprocess.cu, one
  launch that reads each Gaussian once and writes every field but the
  semantics, for CUDA tensors when no gradient has to flow through the
  geometry (grad mode off, or none of the geometry, colour, covariance
  or camera tensors requires grad);
- `preprocess_plain`: the composition of (N,) PyTorch operations, as the
  JAX version evaluates the same expressions in the same order. It is
  the kernel's plain version (CPU tensors) and the differentiable path
  that geometry training needs (autograd, as JAX autodiff there,
  PARITY.md N5).
On the card the two agree bit for bit in every field. While a profiler
is active, the counters `preprocess.fused` and `preprocess.plain` add
up the Gaussians each path takes on CUDA tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from goi_tpu_torch.core.camera import _TENSOR_FIELDS as CAMERA_TENSORS
from goi_tpu_torch.core.camera import Camera, ndc2pix
from goi_tpu_torch.core.scene import GaussianScene
from goi_tpu_torch.core.sh import C0, C1, C2, C3
from goi_tpu_torch.raster import _nvcc
from goi_tpu_torch.utils.profiling import count

TILE = 16     # ref:cuda_rasterizer/config.h:16-17 BLOCK_X/BLOCK_Y
NEAR_Z = 0.2  # frustum near cull (ref:cuda_rasterizer/auxiliary.h:154)

# 16^k for the cell_sel nibble packing; powers of two, so j * 16^k is
# exact in float32 on every device
_POW16 = [16.0 ** k for k in range(6)]


@dataclasses.dataclass
class Splats:
    """Per-Gaussian screen-space quantities (capacity N rows)."""

    mean2d: torch.Tensor         # (N, 2) pixel coords
    depth: torch.Tensor          # (N,) view-space z
    conic: torch.Tensor          # (N, 3) inverse 2D cov (a, b, c)
    opacity: torch.Tensor        # (N,) activated opacity
    color: torch.Tensor          # (N, 3) RGB from SH (or precomputed)
    semantics: torch.Tensor      # (N, S)
    radius: torch.Tensor         # (N,) int32 pixel radius (0 = culled)
    rect_min: torch.Tensor       # (N, 2) int32 tile coords (x, y)
    rect_max: torch.Tensor       # (N, 2) int32 tile coords, exclusive
    tiles_touched: torch.Tensor  # (N,) int32 exact kept-cell count for
    #                              rects up to 3x3, else the rect area
    valid: torch.Tensor          # (N,) bool
    # (N, 2) f32 packed cell-select tables: for rects with both dims <= 3
    # the flat 3x3 index of the l-th passing cell is the l-th nibble
    # (ranks 0-5 in col 0, 6-8 in col 1); -1 in col 0 marks the
    # rect-area fallback with the in-stream cull (binning._decode_cell)
    cell_sel: torch.Tensor


def cell_min_q(lx, ux, ly, uy, ca, cb, cc):
    """Exact min of the conic quadratic Q(d) = ca dx^2 + 2 cb dx dy +
    cc dy^2 over the box [lx, ux] x [ly, uy]: 0 if the origin is inside,
    else the min over the four edges (each a convex 1-D quadratic whose
    clamped stationary point is its minimum). Shared by the preprocess
    cell counts and the binning cull, which must agree exactly."""
    inside = (lx <= 0) & (ux >= 0) & (ly <= 0) & (uy >= 0)
    ca_s = torch.clamp(ca, min=1e-20)
    cc_s = torch.clamp(cc, min=1e-20)

    def q_at(dx, dy):
        return ca * dx * dx + 2.0 * cb * dx * dy + cc * dy * dy

    dy_l = torch.minimum(torch.maximum(-cb * lx / cc_s, ly), uy)
    dy_u = torch.minimum(torch.maximum(-cb * ux / cc_s, ly), uy)
    dx_l = torch.minimum(torch.maximum(-cb * ly / ca_s, lx), ux)
    dx_u = torch.minimum(torch.maximum(-cb * uy / ca_s, lx), ux)
    min_q = torch.minimum(
        torch.minimum(q_at(lx, dy_l), q_at(ux, dy_u)),
        torch.minimum(q_at(dx_l, ly), q_at(dx_u, uy)))
    return torch.where(inside, torch.zeros_like(min_q), min_q)


def _cov3d_scalar(scaling, rotation, modifier: float = 1.0):
    """Packed world covariance (c0..c5) = R diag((s*modifier)^2) R^T from
    raw (log-scale, unnormalized quaternion) params, all (N,) ops
    (ref:cuda_rasterizer/forward.cu:118-152)."""
    s0 = torch.exp(scaling[:, 0]) * modifier
    s1 = torch.exp(scaling[:, 1]) * modifier
    s2 = torch.exp(scaling[:, 2]) * modifier
    qr, qi, qj, qk = (rotation[:, 0], rotation[:, 1], rotation[:, 2],
                      rotation[:, 3])
    n2 = qr * qr + qi * qi + qj * qj + qk * qk
    inv_n = 1.0 / torch.sqrt(torch.clamp(n2, min=1e-24))
    r, i, j, k = qr * inv_n, qi * inv_n, qj * inv_n, qk * inv_n
    r00 = 1 - 2 * (j * j + k * k)
    r01 = 2 * (i * j - r * k)
    r02 = 2 * (i * k + r * j)
    r10 = 2 * (i * j + r * k)
    r11 = 1 - 2 * (i * i + k * k)
    r12 = 2 * (j * k - r * i)
    r20 = 2 * (i * k - r * j)
    r21 = 2 * (j * k + r * i)
    r22 = 1 - 2 * (i * i + j * j)
    v0, v1, v2 = s0 * s0, s1 * s1, s2 * s2
    c0 = r00 * r00 * v0 + r01 * r01 * v1 + r02 * r02 * v2   # xx
    c1 = r00 * r10 * v0 + r01 * r11 * v1 + r02 * r12 * v2   # xy
    c2 = r00 * r20 * v0 + r01 * r21 * v1 + r02 * r22 * v2   # xz
    c3 = r10 * r10 * v0 + r11 * r11 * v1 + r12 * r12 * v2   # yy
    c4 = r10 * r20 * v0 + r11 * r21 * v1 + r12 * r22 * v2   # yz
    c5 = r20 * r20 * v0 + r21 * r21 * v1 + r22 * r22 * v2   # zz
    return c0, c1, c2, c3, c4, c5


def _cov2d_scalar(x, y, z, cov, cam: Camera, in_front):
    """EWA projection to screen space over (N,) components
    (ref:cuda_rasterizer/forward.cu:73-113): clamp the view-space point
    to 1.3*tan_fov, J W Sigma W^T J^T, +0.3 low-pass on the diagonal.
    Rows culled by the near plane get view z = 1 before any division, so
    nothing non-finite reaches the outputs or a later backward."""
    c0, c1, c2, c3, c4, c5 = cov
    W = cam.world_view
    w00, w01, w02 = W[0, 0], W[0, 1], W[0, 2]
    w10, w11, w12 = W[1, 0], W[1, 1], W[1, 2]
    w20, w21, w22 = W[2, 0], W[2, 1], W[2, 2]
    b0, b1, b2 = W[0, 3], W[1, 3], W[2, 3]
    t0 = w00 * x + w01 * y + w02 * z + b0
    t1 = w10 * x + w11 * y + w12 * z + b1
    t2 = w20 * x + w21 * y + w22 * z + b2

    limx = 1.3 * cam.tan_fovx
    limy = 1.3 * cam.tan_fovy
    tz = torch.where(in_front, t2, torch.ones_like(t2))
    tx = torch.clamp(t0 / tz, -limx, limx) * tz
    ty = torch.clamp(t1 / tz, -limy, limy) * tz

    fx, fy = cam.focal_x, cam.focal_y
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2

    m00 = j00 * w00 + j02 * w20
    m01 = j00 * w01 + j02 * w21
    m02 = j00 * w02 + j02 * w22
    m10 = j11 * w10 + j12 * w20
    m11 = j11 * w11 + j12 * w21
    m12 = j11 * w12 + j12 * w22

    s00 = m00 * c0 + m01 * c1 + m02 * c2
    s01 = m00 * c1 + m01 * c3 + m02 * c4
    s02 = m00 * c2 + m01 * c4 + m02 * c5
    s10 = m10 * c0 + m11 * c1 + m12 * c2
    s11 = m10 * c1 + m11 * c3 + m12 * c4
    s12 = m10 * c2 + m11 * c4 + m12 * c5
    cov_xx = s00 * m00 + s01 * m01 + s02 * m02 + 0.3
    cov_xy = s00 * m10 + s01 * m11 + s02 * m12
    cov_yy = s10 * m10 + s11 * m11 + s12 * m12 + 0.3
    return cov_xx, cov_xy, cov_yy


def _sh_color_scalar(deg: int, features, dx, dy, dz):
    """SH -> RGB over (N,) components (ref:cuda_rasterizer/forward.cu:
    20-71): basis polynomials in the view direction, a per-channel
    multiply-add chain over the (B, 3, N) coefficients, +0.5, clamp."""
    f = features.permute(1, 2, 0)          # (B, 3, N)
    basis = [torch.full_like(dx, C0)]
    if deg > 0:
        basis += [-C1 * dy, C1 * dz, -C1 * dx]
        if deg > 1:
            xx, yy, zz = dx * dx, dy * dy, dz * dz
            basis += [
                C2[0] * dx * dy,
                C2[1] * dy * dz,
                C2[2] * (2.0 * zz - xx - yy),
                C2[3] * dx * dz,
                C2[4] * (xx - yy),
            ]
            if deg > 2:
                basis += [
                    C3[0] * dy * (3.0 * xx - yy),
                    C3[1] * dx * dy * dz,
                    C3[2] * dy * (4.0 * zz - xx - yy),
                    C3[3] * dz * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                    C3[4] * dx * (4.0 * zz - xx - yy),
                    C3[5] * dz * (xx - yy),
                    C3[6] * dx * (xx - 3.0 * yy),
                ]
    chans = []
    for c in range(3):
        acc = basis[0] * f[0, c]
        for k in range(1, len(basis)):
            acc = acc + basis[k] * f[k, c]
        chans.append(torch.clamp(acc + 0.5, min=0.0))
    return chans


def _tile_floor(v, grid: int):
    """clip(int32(floor(v)), 0, grid), clamped in float first so values
    past int32's range saturate as XLA's conversion does."""
    return torch.clamp(torch.floor(v), 0, grid).to(torch.int32)


def preprocess_plain(scene: GaussianScene, cam: Camera, *,
                     scaling_modifier: float = 1.0,
                     override_color: Optional[torch.Tensor] = None,
                     cov3d_precomp: Optional[torch.Tensor] = None,
                     semantic_masks: Optional[torch.Tensor] = None
                     ) -> Splats:
    """The composition: every field over (N,) columns, differentiable."""
    grid_x = (cam.width + TILE - 1) // TILE
    grid_y = (cam.height + TILE - 1) // TILE

    xyz = scene.xyz
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]

    P = cam.full_proj
    pc0 = P[0, 0] * x + P[0, 1] * y + P[0, 2] * z + P[0, 3]
    pc1 = P[1, 0] * x + P[1, 1] * y + P[1, 2] * z + P[1, 3]
    pc3 = P[3, 0] * x + P[3, 1] * y + P[3, 2] * z + P[3, 3]
    V = cam.world_view
    p_view_z = V[2, 0] * x + V[2, 1] * y + V[2, 2] * z + V[2, 3]

    in_front = p_view_z > NEAR_Z  # ref:auxiliary.h:154
    # safe-where the perspective division (culled rows: w ~ 0)
    p_w = 1.0 / torch.where(in_front, pc3 + 1e-7, torch.ones_like(pc3))

    if cov3d_precomp is None:
        cov = _cov3d_scalar(scene.scaling, scene.rotation, scaling_modifier)
    else:
        cov = tuple(cov3d_precomp[:, i] for i in range(6))
    cov_xx, cov_xy, cov_yy = _cov2d_scalar(x, y, z, cov, cam, in_front)

    det = cov_xx * cov_yy - cov_xy * cov_xy
    det_ok = det != 0.0
    det_inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conic_a = cov_yy * det_inv
    conic_b = -cov_xy * det_inv
    conic_c = cov_xx * det_inv

    mid = 0.5 * (cov_xx + cov_yy)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lam_max = mid + disc
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam_max, min=0.0)))
    radius = radius_f.to(torch.int32)

    opacity = torch.sigmoid(scene.opacity[:, 0])
    # opacity-aware binning radius: a pixel blends only where
    # alpha = opa exp(-q/2) >= 1/255, i.e. q <= 2 ln(255 opa); min(9, .)
    # keeps the reference's 3-sigma cap; (1 + 1e-6) absorbs rounding
    # between this bound and the blend's own power evaluation
    q_cut = 2.0 * torch.log(torch.clamp(opacity, min=1e-12) * 255.0)
    r_bin = torch.ceil(torch.sqrt(
        torch.clamp(torch.clamp(q_cut, min=0.0) * (1.0 + 1e-6), max=9.0)
        * torch.clamp(lam_max, min=0.0)))

    px = ndc2pix(pc0 * p_w, cam.width)
    py = ndc2pix(pc1 * p_w, cam.height)

    inv_t = 1.0 / TILE
    rmin_x = _tile_floor((px - r_bin) * inv_t, grid_x)
    rmin_y = _tile_floor((py - r_bin) * inv_t, grid_y)
    rmax_x = _tile_floor((px + r_bin + TILE - 1) * inv_t, grid_x)
    rmax_y = _tile_floor((py + r_bin + TILE - 1) * inv_t, grid_y)
    area = (rmax_x - rmin_x) * (rmax_y - rmin_y)

    # validity and radius keep the reference's 3-sigma rect semantics
    # (ref:forward.cu:191-195)
    a3_x = (_tile_floor((px + radius_f + TILE - 1) * inv_t, grid_x)
            - _tile_floor((px - radius_f) * inv_t, grid_x))
    a3_y = (_tile_floor((py + radius_f + TILE - 1) * inv_t, grid_y)
            - _tile_floor((py - radius_f) * inv_t, grid_y))

    valid = scene.valid & in_front & det_ok & (a3_x * a3_y > 0)
    zero_i = torch.zeros_like(radius)
    radius = torch.where(valid, radius, zero_i)
    tiles = torch.where(valid, area, zero_i)

    # exact per-cell overlap counts for rects up to 3x3 (Splats.cell_sel)
    w_r = rmax_x - rmin_x
    h_r = rmax_y - rmin_y
    pd = (conic_a > 0.0) & (conic_c > 0.0) \
        & (conic_a * conic_c - conic_b * conic_b > 0.0)
    small = (w_r <= 3) & (h_r <= 3) & pd
    qc = torch.clamp(q_cut, min=0.0) * (1.0 + 1e-6)
    pow16 = torch.tensor(_POW16, dtype=torch.float32, device=xyz.device)
    cnt = torch.zeros_like(area)
    sel_lo = torch.zeros_like(px)
    sel_hi = torch.zeros_like(px)
    for j in range(9):
        dxc, dyc = j % 3, j // 3
        tx = rmin_x + dxc
        ty = rmin_y + dyc
        lx = (tx * TILE).to(torch.float32) - px
        ly = (ty * TILE).to(torch.float32) - py
        ok_j = (dxc < w_r) & (dyc < h_r) & (
            cell_min_q(lx, lx + (TILE - 1), ly, ly + (TILE - 1),
                       conic_a, conic_b, conic_c) <= qc)
        # cell index j as the cnt-th nibble
        nib = j * pow16[torch.clamp(cnt, max=5).long()]
        nib_hi = j * pow16[torch.clamp(cnt - 6, min=0).long()]
        sel_lo = sel_lo + torch.where(ok_j & (cnt < 6), nib,
                                      torch.zeros_like(nib))
        sel_hi = sel_hi + torch.where(ok_j & (cnt >= 6), nib_hi,
                                      torch.zeros_like(nib_hi))
        cnt = cnt + ok_j.to(cnt.dtype)
    tiles = torch.where(small, torch.where(valid, cnt, zero_i), tiles)
    cell_sel = torch.where(small[:, None],
                           torch.stack([sel_lo, sel_hi], dim=-1),
                           torch.full_like(sel_lo, -1.0)[:, None])

    if override_color is not None:
        color = override_color
    else:
        cc = cam.camera_center
        dx, dy, dz = x - cc[0], y - cc[1], z - cc[2]
        inv_n = 1.0 / torch.clamp(
            torch.sqrt(dx * dx + dy * dy + dz * dz), min=1e-12)
        dx, dy, dz = dx * inv_n, dy * inv_n, dz * inv_n
        r, g, b = _sh_color_scalar(scene.active_sh_degree,
                                   scene.get_features(), dx, dy, dz)
        color = torch.stack([r, g, b], dim=-1)

    return Splats(
        mean2d=torch.stack([px, py], dim=-1),
        depth=p_view_z,
        conic=torch.stack([conic_a, conic_b, conic_c], dim=-1),
        opacity=opacity,
        color=color,
        semantics=scene.get_semantics(semantic_masks),
        radius=radius,
        rect_min=torch.stack([rmin_x, rmin_y], -1),
        rect_max=torch.stack([rmax_x, rmax_y], -1),
        tiles_touched=tiles,
        valid=valid,
        cell_sel=cell_sel,
    )


_SIGNATURES = {"goi_preprocess": (
    [ctypes.c_void_p] * 25
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
       ctypes.c_int, ctypes.c_float, ctypes.POINTER(ctypes.c_float),
       ctypes.c_void_p])}
# the SH constants in the kernel's order: C0, C1, C2[0..4], C3[0..6]
_SH = (C0, C1, *C2, *C3)
MAX_REST = 15    # the kernel's widest features_rest: SH degree 3


def _kernel_tensors(scene: GaussianScene, cam: Camera, override_color,
                    cov3d_precomp) -> dict:
    """The tensors the kernel reads, by name, each with its shape, in the
    order of csrc/preprocess.cu's goi_preprocess."""
    n = scene.xyz.shape[0]
    rest = scene.features_rest
    rest_rows = rest.shape[1] if rest.dim() == 3 else -1
    return {"xyz": (scene.xyz, (n, 3)),
            "scaling": (scene.scaling, (n, 3)),
            "rotation": (scene.rotation, (n, 4)),
            "opacity": (scene.opacity, (n, 1)),
            "features_dc": (scene.features_dc, (n, 1, 3)),
            "features_rest": (rest, (n, rest_rows, 3)),
            "valid": (scene.valid, (n,)),
            "cov3d_precomp": (cov3d_precomp, (n, 6)),
            "override_color": (override_color, (n, 3)),
            "world_view": (cam.world_view, (4, 4)),
            "full_proj": (cam.full_proj, (4, 4)),
            "camera_center": (cam.camera_center, (3,)),
            "tan_fovx": (cam.tan_fovx, ()),
            "tan_fovy": (cam.tan_fovy, ())}


def _check_kernel_inputs(tensors: dict, scene: GaussianScene,
                         cam: Camera, use_sh: bool) -> None:
    """Raise on what the kernel does not take: a dtype, shape, layout or
    device other than its own, an SH degree past its rows, a frame of no
    pixels."""
    for name, (t, shape) in tensors.items():
        if t is None:
            continue
        want = torch.bool if name == "valid" else torch.float32
        if t.dtype != want:
            raise TypeError(f"preprocess kernel: {name} must be {want}, "
                            f"got {t.dtype}")
        if tuple(t.shape) != shape or min(shape, default=0) < 0:
            raise ValueError(f"preprocess kernel: {name} of shape {shape} "
                             f"expected, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"preprocess kernel: {name} must be "
                             f"contiguous")
    rest_rows = scene.features_rest.shape[1]
    deg = scene.active_sh_degree
    if not 0 <= deg <= 3 or rest_rows > MAX_REST or (
            use_sh and (deg + 1) ** 2 - 1 > rest_rows):
        raise ValueError(f"preprocess kernel: SH degree 0-3 within "
                         f"features_rest's rows (at most {MAX_REST}) "
                         f"expected, got degree {deg} and {rest_rows} rows")
    if cam.width <= 0 or cam.height <= 0:
        raise ValueError(f"preprocess kernel: a frame of pixels expected, "
                         f"got {cam.width}x{cam.height}")
    dev = scene.xyz.device
    for name, (t, _) in tensors.items():
        if t is not None and (not _nvcc.is_cuda(t) or t.device != dev):
            raise ValueError(f"preprocess kernel: {name} must be on the "
                             f"CUDA device of xyz ({dev}), got {t.device}")


def preprocess_cuda(scene: GaussianScene, cam: Camera, *,
                    scaling_modifier: float = 1.0,
                    override_color: Optional[torch.Tensor] = None,
                    cov3d_precomp: Optional[torch.Tensor] = None,
                    semantic_masks: Optional[torch.Tensor] = None
                    ) -> Splats:
    """preprocess_plain's Splats from one launch of csrc/preprocess.cu,
    bit for bit on the card; the semantics in PyTorch. Forward only: the
    outputs carry no gradient to the geometry. Camera constants are read
    from the camera's device tensors (no host synchronise)."""
    tensors = _kernel_tensors(scene, cam, override_color, cov3d_precomp)
    _check_kernel_inputs(tensors, scene, cam, override_color is None)
    lib = _nvcc.library("preprocess", _SIGNATURES)
    n = scene.xyz.shape[0]
    dev = scene.xyz.device

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = Splats(
        mean2d=empty(n, 2), depth=empty(n), conic=empty(n, 3),
        opacity=empty(n), color=empty(n, 3),
        semantics=scene.get_semantics(semantic_masks),
        radius=empty(n, dtype=torch.int32),
        rect_min=empty(n, 2, dtype=torch.int32),
        rect_max=empty(n, 2, dtype=torch.int32),
        tiles_touched=empty(n, dtype=torch.int32),
        valid=empty(n, dtype=torch.bool), cell_sel=empty(n, 2))
    # the C entry takes the inputs in _kernel_tensors' order, then the
    # outputs in Splats' order
    _nvcc.check(lib.goi_preprocess(
        *(t.data_ptr() if t is not None else None
          for t, _ in tensors.values()),
        *(getattr(out, f.name).data_ptr() for f in dataclasses.fields(out)
          if f.name != "semantics"),
        n, cam.width, cam.height, scene.active_sh_degree,
        scene.features_rest.shape[1], scaling_modifier,
        (ctypes.c_float * len(_SH))(*_SH), _nvcc.stream()), "preprocess")
    preprocess_cuda.launches += 1
    return out


preprocess_cuda.launches = 0


def _geometry_needs_grad(scene: GaussianScene, cam: Camera, override_color,
                         cov3d_precomp) -> bool:
    """Whether a gradient may flow through the kernel's inputs: grad
    mode on and one of them requires grad (the semantics do not count:
    they stay outside the kernel)."""
    if not torch.is_grad_enabled():
        return False
    return any(t is not None and t.requires_grad for t, _ in
               _kernel_tensors(scene, cam, override_color,
                               cov3d_precomp).values())


def _dense(scene: GaussianScene, cam: Camera):
    """The scene and camera with contiguous tensors, the kernel's layout
    (a tensor that already is one is kept, not copied)."""
    scene = scene.replace(**{f: getattr(scene, f).contiguous() for f in (
        "xyz", "scaling", "rotation", "opacity", "features_dc",
        "features_rest", "valid")})
    return scene, dataclasses.replace(cam, **{
        f: getattr(cam, f).contiguous() for f in CAMERA_TENSORS})


def preprocess(scene: GaussianScene, cam: Camera, *,
               scaling_modifier: float = 1.0,
               override_color: Optional[torch.Tensor] = None,
               cov3d_precomp: Optional[torch.Tensor] = None,
               semantic_masks: Optional[torch.Tensor] = None) -> Splats:
    """Splats of `scene` seen by `cam`: the kernel for CUDA tensors when
    no gradient has to flow through the geometry, else the composition
    (module docstring)."""
    kw = dict(scaling_modifier=scaling_modifier,
              override_color=override_color, cov3d_precomp=cov3d_precomp,
              semantic_masks=semantic_masks)
    if not _nvcc.is_cuda(scene.xyz):
        return preprocess_plain(scene, cam, **kw)
    n = scene.xyz.shape[0]
    if _geometry_needs_grad(scene, cam, override_color, cov3d_precomp):
        count("preprocess.plain", n)
        return preprocess_plain(scene, cam, **kw)
    count("preprocess.fused", n)
    scene, cam = _dense(scene, cam)
    if override_color is not None:
        kw["override_color"] = override_color.contiguous()
    if cov3d_precomp is not None:
        kw["cov3d_precomp"] = cov3d_precomp.contiguous()
    return preprocess_cuda(scene, cam, **kw)
