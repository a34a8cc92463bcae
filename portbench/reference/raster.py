"""Plain 3D Gaussian splatting with semantics, in blocks of tiles.

The forward of GOI's rasterizer (3DGS's diff-gaussian-rasterization
with a semantic channel: preprocessCUDA, the tile lists and renderCUDA)
written from its equations in plain PyTorch; it imports nothing of the
program. Per pixel, over the Gaussians whose 3-sigma tile rectangle
covers the pixel's 16x16 tile, in (view depth, index) order:

  power = -0.5 (a dx^2 + c dy^2) - b dx dy        skip if power > 0
  alpha = min(0.99, opacity exp(power))           skip if alpha < 1/255
  stop before the Gaussian at which T (1 - alpha) < 1e-4
  w = alpha T;  T <- T (1 - alpha)
  colour = sum w c + T bg;  semantics = sum w s

The transmittance is an inclusive cumulative product over each pixel's
list (its rounding differs from a sequential product by a few ulp).
`semantic_grad` is the exact gradient of the semantic map with respect
to the Gaussians' semantic features, the only Gaussian attribute that
distillation trains: d(map)/d(s_g) is w(pixel, g).
"""

from __future__ import annotations

import torch

TILE = 16
PIX = TILE * TILE
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_MIN = 1e-4
NEAR = 0.2
BLOCK_PAIRS = 1 << 26          # (pixel, Gaussian) slots a block holds

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def _sh_color(deg, sh, d):
    """RGB of the SH coefficients sh (N, B, 3) in unit directions d."""
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    out = SH_C0 * sh[:, 0]
    if deg > 0:
        out = out - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] \
            - SH_C1 * x * sh[:, 3]
    if deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        out = (out + SH_C2[0] * x * y * sh[:, 4] + SH_C2[1] * y * z * sh[:, 5]
               + SH_C2[2] * (2 * zz - xx - yy) * sh[:, 6]
               + SH_C2[3] * x * z * sh[:, 7] + SH_C2[4] * (xx - yy) * sh[:, 8])
    if deg > 2:
        out = (out + SH_C3[0] * y * (3 * xx - yy) * sh[:, 9]
               + SH_C3[1] * x * y * z * sh[:, 10]
               + SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 11]
               + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
               + SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 13]
               + SH_C3[5] * z * (xx - yy) * sh[:, 14]
               + SH_C3[6] * x * (xx - 3 * yy) * sh[:, 15])
    return torch.clamp(out + 0.5, min=0.0)


def preprocess(scene: dict, view: dict, semantics=None) -> dict:
    """Screen-space splats of every Gaussian (3DGS preprocessCUDA):
    near cull at view z <= 0.2, EWA covariance with the 1.3 tan(fov)
    clamp and the 0.3 low-pass, conic, 3-sigma radius, tile rectangle,
    SH colour. `valid` is False for a culled Gaussian."""
    dev = scene["xyz"].device
    f32 = dict(dtype=torch.float32, device=dev)
    V = torch.as_tensor(view["world_view"], **f32)
    P = torch.as_tensor(view["full_proj"], **f32)
    w, h = view["width"], view["height"]
    gx, gy = (w + TILE - 1) // TILE, (h + TILE - 1) // TILE
    xyz = scene["xyz"]
    hom = torch.cat([xyz, torch.ones_like(xyz[:, :1])], 1)
    pv = hom @ V[:3].T                                   # view space
    pc = hom @ P.T
    front = pv[:, 2] > NEAR
    tz = torch.where(front, pv[:, 2], torch.ones_like(pv[:, 2]))
    pw = 1.0 / torch.where(front, pc[:, 3] + 1e-7, torch.ones_like(tz))
    px = ((pc[:, 0] * pw + 1.0) * w - 1.0) * 0.5
    py = ((pc[:, 1] * pw + 1.0) * h - 1.0) * 0.5

    s = torch.exp(scene["scaling"])
    q = scene["rotation"]
    q = q / torch.sqrt(torch.clamp((q * q).sum(1, keepdim=True), min=1e-24))
    r, i, j, k = q.unbind(1)
    R = torch.stack([
        torch.stack([1 - 2 * (j * j + k * k), 2 * (i * j - r * k),
                     2 * (i * k + r * j)], -1),
        torch.stack([2 * (i * j + r * k), 1 - 2 * (i * i + k * k),
                     2 * (j * k - r * i)], -1),
        torch.stack([2 * (i * k - r * j), 2 * (j * k + r * i),
                     1 - 2 * (i * i + j * j)], -1)], -2)       # (N, 3, 3)
    M = R * s[:, None, :]
    sigma = M @ M.transpose(1, 2)

    tanx = float(view["tan_fovx"])
    tany = float(view["tan_fovy"])
    fx, fy = w / (2 * tanx), h / (2 * tany)
    tx = torch.clamp(pv[:, 0] / tz, -1.3 * tanx, 1.3 * tanx) * tz
    ty = torch.clamp(pv[:, 1] / tz, -1.3 * tany, 1.3 * tany) * tz
    J = torch.zeros((xyz.shape[0], 2, 3), **f32)
    J[:, 0, 0] = fx / tz
    J[:, 0, 2] = -fx * tx / (tz * tz)
    J[:, 1, 1] = fy / tz
    J[:, 1, 2] = -fy * ty / (tz * tz)
    T = J @ V[:3, :3]
    cov = T @ sigma @ T.transpose(1, 2)
    ca = cov[:, 0, 0] + 0.3
    cb = cov[:, 0, 1]
    cc = cov[:, 1, 1] + 0.3
    det = ca * cc - cb * cb
    det_ok = det != 0
    inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    mid = 0.5 * (ca + cc)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam, min=0.0)))

    def tile(v, n):
        return torch.clamp(torch.floor(v / TILE), 0, n).to(torch.int64)

    rmin = torch.stack([tile(px - radius, gx), tile(py - radius, gy)], 1)
    rmax = torch.stack([tile(px + radius + TILE - 1, gx),
                        tile(py + radius + TILE - 1, gy)], 1)
    area = (rmax - rmin).prod(1)
    valid = front & det_ok & (area > 0) & (radius > 0)

    center = torch.as_tensor(view["center"], **f32)
    d = xyz - center
    d = d / torch.clamp(torch.linalg.norm(d, dim=1, keepdim=True), min=1e-12)
    sh = torch.cat([scene["features_dc"], scene["features_rest"]], 1)
    return {
        "mean2d": torch.stack([px, py], 1),
        "conic": torch.stack([cc * inv, -cb * inv, ca * inv], 1),
        "opacity": torch.sigmoid(scene["opacity"][:, 0]),
        "color": _sh_color(scene["sh_degree"], sh, d),
        "semantics": scene["semantics"] if semantics is None else semantics,
        "depth": pv[:, 2],
        "rmin": rmin, "rmax": rmax, "valid": valid,
        "grid": (gx, gy), "size": (w, h),
    }


def tile_lists(sp: dict) -> dict:
    """Each tile's Gaussians in (depth, index) order: `gid` of every
    (Gaussian, tile) instance sorted by tile then depth, and each tile's
    [start, end) in it."""
    gx, gy = sp["grid"]
    ids = torch.nonzero(sp["valid"])[:, 0]
    rmin, rmax = sp["rmin"][ids], sp["rmax"][ids]
    wdt = rmax[:, 0] - rmin[:, 0]
    cnt = wdt * (rmax[:, 1] - rmin[:, 1])
    gid = torch.repeat_interleave(ids, cnt)
    first = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
    local = torch.arange(gid.shape[0], device=gid.device) - first
    wi = torch.repeat_interleave(wdt, cnt)
    tx = torch.repeat_interleave(rmin[:, 0], cnt) + local % wi
    ty = torch.repeat_interleave(rmin[:, 1], cnt) + local // wi
    tile = ty * gx + tx
    # depth rank of each Gaussian (ties by index), then a stable sort by
    # tile keeps that order inside each tile
    depth = torch.where(sp["valid"], sp["depth"],
                        torch.full_like(sp["depth"], float("inf")))
    rank = torch.empty_like(depth, dtype=torch.int64)
    rank[torch.argsort(depth, stable=True)] = torch.arange(
        depth.shape[0], device=depth.device)
    order = torch.argsort(tile * depth.shape[0] + rank[gid], stable=True)
    gid, tile = gid[order], tile[order]
    counts = torch.bincount(tile, minlength=gx * gy)
    ends = torch.cumsum(counts, 0)
    return {"gid": gid, "start": ends - counts, "count": counts}


def _blocks(counts: torch.Tensor, budget: int):
    """Tiles in order of their list length, grouped so that a block's
    tiles x 256 x its longest list stays within `budget` slots."""
    order = torch.argsort(counts, stable=True)
    lens = counts[order].tolist()
    blocks, lo = [], 0
    while lo < len(lens):
        hi = lo + 1
        while hi < len(lens) and (hi - lo + 1) * PIX * max(lens[hi], 1) \
                <= budget:
            hi += 1
        blocks.append((order[lo:hi], max(lens[hi - 1], 1)))
        lo = hi
    return blocks


def _block_weights(sp, lists, tiles, k):
    """Blend weights (n, 256, k) of the block's tiles, the Gaussian of
    each slot (n, k) and the pixels' final transmittance (n, 256)."""
    dev = sp["mean2d"].device
    gx, _ = sp["grid"]
    w, h = sp["size"]
    slot = torch.arange(k, device=dev)
    start, count = lists["start"][tiles], lists["count"][tiles]
    has = slot[None] < count[:, None]
    pos = torch.clamp(start[:, None] + slot[None],
                      max=lists["gid"].shape[0] - 1)
    g = torch.where(has, lists["gid"][pos], torch.zeros_like(pos))
    lx = torch.arange(PIX, device=dev) % TILE
    ly = torch.arange(PIX, device=dev) // TILE
    pxl = (tiles % gx)[:, None] * TILE + lx[None]         # (n, 256)
    pyl = (tiles // gx)[:, None] * TILE + ly[None]
    inside = (pxl < w) & (pyl < h)
    m = sp["mean2d"][g]                                   # (n, k, 2)
    con = sp["conic"][g]
    dx = m[:, None, :, 0] - pxl[:, :, None].to(torch.float32)
    dy = m[:, None, :, 1] - pyl[:, :, None].to(torch.float32)
    power = -0.5 * (con[:, None, :, 0] * dx * dx
                    + con[:, None, :, 2] * dy * dy) \
        - con[:, None, :, 1] * dx * dy
    del dx, dy
    alpha = torch.clamp(sp["opacity"][g][:, None, :] * torch.exp(power),
                        max=ALPHA_MAX)
    ok = has[:, None, :] & inside[:, :, None] & (power <= 0) \
        & (alpha >= ALPHA_MIN)
    del power
    q = torch.where(ok, 1.0 - alpha, torch.ones_like(alpha))
    incl = torch.cumprod(q, dim=2)
    act = ok & (incl >= T_MIN)
    wts = torch.where(act, alpha * (incl / q), torch.zeros_like(alpha))
    t_final = torch.prod(torch.where(act, q, torch.ones_like(q)), dim=2)
    return wts, g, t_final


def _to_image(tiles, vals, sp, out):
    """Scatter (n, 256, C) tile pixels into the (C, H, W) image `out`."""
    gx, _ = sp["grid"]
    w, h = sp["size"]
    dev = vals.device
    lx = torch.arange(PIX, device=dev) % TILE
    ly = torch.arange(PIX, device=dev) // TILE
    px = ((tiles % gx)[:, None] * TILE + lx[None]).reshape(-1)
    py = ((tiles // gx)[:, None] * TILE + ly[None]).reshape(-1)
    keep = (px < w) & (py < h)
    flat = vals.reshape(-1, vals.shape[-1])[keep]
    out[:, py[keep], px[keep]] = flat.T


def render(sp: dict, lists: dict, *, bg=None, color: bool = True,
           block_pairs: int = BLOCK_PAIRS) -> dict:
    """The forward: semantics (S, H, W), with `color` also render
    (3, H, W) over `bg` and alpha (1, H, W)."""
    w, h = sp["size"]
    dev = sp["mean2d"].device
    s = sp["semantics"].shape[1]
    sem = torch.zeros((s, h, w), device=dev)
    rgb = torch.zeros((3, h, w), device=dev) if color else None
    alp = torch.zeros((1, h, w), device=dev) if color else None
    bg = torch.zeros(3, device=dev) if bg is None else \
        torch.as_tensor(bg, dtype=torch.float32, device=dev)
    for tiles, k in _blocks(lists["count"], block_pairs):
        wts, g, t_final = _block_weights(sp, lists, tiles, k)
        _to_image(tiles, torch.bmm(wts, sp["semantics"][g]), sp, sem)
        if color:
            c = torch.bmm(wts, sp["color"][g]) + t_final[..., None] * bg
            _to_image(tiles, c, sp, rgb)
            _to_image(tiles, (1.0 - t_final)[..., None], sp, alp)
        del wts
    out = {"semantics": sem}
    if color:
        out.update(render=rgb, alpha=alp)
    return out


def semantic_grad(sp: dict, lists: dict, grad_map: torch.Tensor, *,
                  block_pairs: int = BLOCK_PAIRS) -> torch.Tensor:
    """d loss / d semantics (N, S) of the Gaussians from d loss / d map
    (S, H, W): the sum over pixels of w(pixel, g) times the pixel's
    gradient, summed per Gaussian in float64."""
    gx, _ = sp["grid"]
    w, h = sp["size"]
    n, s = sp["semantics"].shape
    dev = grad_map.device
    out = torch.zeros((n, s), dtype=torch.float64, device=dev)
    pad = torch.zeros((s, sp["grid"][1] * TILE, gx * TILE), device=dev)
    pad[:, :h, :w] = grad_map
    # (tiles, 256, S) in the tile's row-major pixel order
    gt = pad.reshape(s, -1, TILE, gx, TILE).permute(1, 3, 2, 4, 0) \
        .reshape(-1, PIX, s)
    for tiles, k in _blocks(lists["count"], block_pairs):
        wts, g, _ = _block_weights(sp, lists, tiles, k)
        rows = torch.bmm(wts.transpose(1, 2), gt[tiles])     # (n, k, S)
        has = torch.arange(k, device=dev)[None] \
            < lists["count"][tiles][:, None]
        out.index_add_(0, g[has], rows[has].double())
        del wts, rows
    return out.float()


def blended_pairs(sp: dict, lists: dict,
                  block_pairs: int = BLOCK_PAIRS) -> tuple:
    """(pairs, Gaussians): the (pixel, Gaussian) pairs the blend
    composites in this view, and the Gaussians with at least one."""
    total = 0
    seen = torch.zeros(sp["mean2d"].shape[0], dtype=torch.bool,
                       device=sp["mean2d"].device)
    for tiles, k in _blocks(lists["count"], block_pairs):
        wts, g, _ = _block_weights(sp, lists, tiles, k)
        used = wts > 0
        total += int(used.sum())
        seen[g[used.any(dim=1)]] = True
        del wts, used
    return total, int(seen.sum())
