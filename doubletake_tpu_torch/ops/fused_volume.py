"""Fused plane-sweep feature volume: the CUDA kernel ``csrc/fused_volume.cu``
and its plain version.

``fused_feature_volume`` is the port of the Pallas TPU kernel
``doubletake_tpu/ops/pallas/fused_volume.py``. On a CUDA tensor it launches
the kernel, or raises; on a CPU tensor it runs ``feature_volume_plain``.

``feature_volume_plain`` is the JAX package's XLA path of ``FeatureVolume``
(``doubletake_tpu/models/cost_volume.py``:252-326): planes in chunks,
projection with the ``|z| > 1e-8`` guard, the bilinear warp as
``F.grid_sample``, the metadata channels in the checkpoint's order, the
matching MLP and the hint MLP. The port's ``FeatureVolume`` uses it as its
non-kernel path, so the kernel and the module share one oracle.

Both take the geometry already set up (``volume_geometry``): the projection
rows P = src_K @ src_T_cur, the current view's unit-depth rays, the source
camera centres and the pose-distance metadata.

The kernel takes the matching MLP's first layer split in two
(``volume_channel_order``): the rows of the channels every plane of a pixel
shares (current features, current ray, pose metadata), applied once per
pixel, and the per-plane rows in view-major order (each view's 16 warped
features, then its 7 scalars, two views to a 16-row step). The plane
channel's row is added as ``plane * w``. ``pack_volume_weights`` builds
that layout once, with each matrix split into bf16 hi + lo parts in the
order the tensor-core fragments read them; ``packed_volume_weights`` caches
it per weight tensor and rebuilds it when a weight changes.

The features' type picks the kernel's mode: float32 features take three
bf16 products per product (hi/lo), bf16 features (the bf16 compute dtype)
one product on the hi parts, as the TPU kernel computes. Both write float32
scores. The plain version follows the JAX XLA path's types at either
(``volume_metadata``).
"""

from __future__ import annotations

import ctypes
import math
import weakref

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from doubletake_tpu_torch.ops.build import load_kernel
from doubletake_tpu_torch.ops.grid_sample import grid_sample_2d
from doubletake_tpu_torch.utils import tracing
from doubletake_tpu_torch.utils.geometry import (
    normalize_vectors,
    pixel_grid_homogeneous,
    pose_distance,
)

CHANNELS = 16      # matching feature channels the kernel takes
HIDDEN = 128       # matching MLP width the kernel takes
HINT_HIDDEN = 12   # hint MLP width the kernel takes
MAX_VIEWS = 8      # most source views the kernel takes
GROUPS = 2         # warpgroups per block (one block per SM)
ROWS = 64          # pixels per warpgroup (wgmma's M), 16 a warp
# the fp32 vector of small weights, at these offsets (csrc/fused_volume.cu)
VEC_B1, VEC_WP, VEC_B2, VEC_W3, VEC_B3 = 0, 128, 256, 384, 512
VEC_LEN = 520
# channel of each column of a 16-channel K step: lane t of an MMA fragment
# holds columns 2t, 2t+1, 2t+8, 2t+9, here channels 4t..4t+3 (one 16-byte
# load of a feature row)
FRAGMENT_CHANNELS = [0, 1, 4, 5, 8, 9, 12, 13, 2, 3, 6, 7, 10, 11, 14, 15]
# the hint MLP, passed to the kernel by value: w1^T (3 x 12), b1, w2^T
# (12 x 12), b2, w3, b3 (the kernel's HintWeights)
HINT_LEN = 3 * 12 + 12 + 12 * 12 + 12 + 12 + 1


def mlp_in_channels(num_views: int, channels: int) -> int:
    """Metadata width: k*c + c + mask k + depth k + plane 1 + dot k +
    angle k + rays 3(1+k) + pose 3k (202 at k = 7, c = 16)."""
    return num_views * channels + channels + 10 * num_views + 4


def volume_geometry(src_K_bk44, src_cam_T_cur_cam_bk44, cur_cam_T_src_cam_bk44,
                    cur_invK_b44, h: int, w: int, dtype=torch.float32):
    """(P_bk34, rays_b3n, centers_bk3, pose_meta_b3k) for a matching grid h x w,
    all float32. ``dtype``, the features' type, is that of the pixel grid
    the rays start from, as in the JAX package (exact up to 256 columns)."""
    b, k = src_K_bk44.shape[:2]
    P_bk34 = torch.matmul(src_K_bk44, src_cam_T_cur_cam_bk44)[:, :, :3, :].contiguous()
    pix = pixel_grid_homogeneous(h, w, dtype, src_K_bk44.device).float()
    rays_b3n = torch.einsum("bij,jn->bin", cur_invK_b44[:, :3, :3], pix).contiguous()
    # the reference passes cur_cam_T_src_cam as the source poses
    pd, rm, tm = pose_distance(cur_cam_T_src_cam_bk44.reshape(b * k, 4, 4))
    pose_meta_b3k = torch.cat([pd.reshape(b, k), rm.reshape(b, k), tm.reshape(b, k)], -1)
    centers_bk3 = cur_cam_T_src_cam_bk44[:, :, :3, 3].contiguous()
    return P_bk34, rays_b3n, centers_bk3, pose_meta_b3k.contiguous()


def _mlp(layers, x):
    """The MLP on ``x``, each layer in the promoted type of its input and
    weights (flax's ``Dense``: bf16 weights on a float32 input compute in
    float32)."""
    for i, (wgt, bias) in enumerate(layers):
        dt = torch.promote_types(x.dtype, wgt.dtype)
        x = F.linear(x.to(dt), wgt.to(dt), bias.to(dt))
        if i < len(layers) - 1:
            x = F.leaky_relu(x, 0.01)
    return x


def warp_planes(src_feats_bkhwc, P_bk34, rays_b3n, planes_c):
    """The source views' features warped onto the current view at the
    planes ``planes_c`` (the JAX package's ``_warp_chunk``): warped
    features (B, k, Dc, N, C) in the features' type, the projected depths
    + 1e-8 (B, k, Dc, N) in float32, and the planes' points in the current
    camera (B, Dc, 3, N)."""
    b, k, h, w, c = src_feats_bkhwc.shape
    dc = planes_c.shape[0]
    pts = planes_c[None, :, None, None] * rays_b3n[:, None]            # (B, Dc, 3, N)
    cam = (torch.einsum("bkij,bdjn->bkdin", P_bk34[..., :3], pts)
           + P_bk34[..., 3][:, :, None, :, None])                      # (B, k, Dc, 3, N)
    z = cam[:, :, :, 2] + 1e-8
    scale = torch.where(cam[:, :, :, 2].abs() > 1e-8, 1.0 / z, torch.ones_like(z))
    gx = 2.0 * (cam[:, :, :, 0] * scale) / w - 1.0
    gy = 2.0 * (cam[:, :, :, 1] * scale) / h - 1.0
    grid = torch.stack([gx, gy], -1).reshape(b * k, dc * h, w, 2)
    warped = grid_sample_2d(src_feats_bkhwc.reshape(b * k, h, w, c), grid)
    return warped.reshape(b, k, dc, h * w, c), z, pts


def volume_metadata(cur_feats_bhwc, src_feats_bkhwc, P_bk34, rays_b3n, centers_bk3,
                    pose_meta_b3k, planes_c):
    """(B, Dc, N, nin) metadata vectors of the planes ``planes_c``, in the
    checkpoint's channel order (``models/cost_volume.py`` module doc).

    In the features' type, as the JAX package's XLA path computes it: the
    sampling grid, the warp, the dot, the plane depth, the angles, the rays,
    the pose metadata and the source centres are rounded to it; the
    projected depths stay float32, so the vector is float32 (bf16 values
    but for the depths) when the features are bf16."""
    b, h, w, c = cur_feats_bhwc.shape
    k = src_feats_bkhwc.shape[1]
    n = h * w
    dc = planes_c.shape[0]
    dtype = cur_feats_bhwc.dtype
    cur_n = cur_feats_bhwc.reshape(b, n, c)
    warped, z, pts = warp_planes(src_feats_bkhwc, P_bk34, rays_b3n, planes_c)
    mask = (z > 0).to(dtype)                                            # (B, k, Dc, N)
    dot = (warped.float() * cur_n[:, None, None].float()).sum(-1).to(dtype) * mask

    centers = centers_bk3.to(dtype).float()
    cur_rays = normalize_vectors(pts, 2)                                # (B, Dc, 3, N)
    src_rays = normalize_vectors(pts[:, None] - centers[:, :, None, :, None], 3)
    angle = (cur_rays[:, None] * src_rays).sum(3).to(dtype)            # (B, k, Dc, N)

    def per_view(x):  # (B, k, Dc, N) -> (B, Dc, N, k)
        return x.permute(0, 2, 3, 1)

    rays_all = torch.cat([cur_rays[:, None], src_rays], 1)              # (B, 1+k, Dc, 3, N)
    return torch.cat([
        warped.permute(0, 2, 3, 1, 4).reshape(b, dc, n, k * c),
        cur_n[:, None].expand(b, dc, n, c),
        per_view(mask),
        per_view(z),
        planes_c[None, :, None, None].expand(b, dc, n, 1).to(dtype),
        per_view(dot),
        per_view(angle),
        rays_all.permute(0, 2, 4, 1, 3).reshape(b, dc, n, (1 + k) * 3).to(dtype),
        pose_meta_b3k[:, None, None].expand(b, dc, n, 3 * k).to(dtype),
    ], -1)


def feature_volume_plain(cur_feats_bhwc, src_feats_bkhwc, P_bk34, rays_b3n, centers_bk3,
                         pose_meta_b3k, planes_d, mlp, hint_mlp=None, hint_bhw3=None,
                         plane_chunk: int = 16):
    """(B, D, h, w) scores. ``mlp``/``hint_mlp``: [(weight, bias)] per Linear,
    torch layout; ``hint_bhw3``: [depth, valid 0/1, weight], the depth finite
    where valid (elsewhere it is never used). float32 for float32 and bf16
    features (``volume_metadata``).

    Under autograd each chunk of planes is checkpointed: its metadata and
    MLP activations (~10 GB a chunk at b=16) are recomputed in the backward
    instead of kept, as XLA rematerialises them in the JAX train step."""
    b, h, w, _ = cur_feats_bhwc.shape
    dtype = cur_feats_bhwc.dtype
    n = h * w
    if hint_mlp is not None:
        hd, hv, hw = hint_bhw3.reshape(b, n, 3).unbind(-1)
        hvalid = hv > 0.5

    def chunk(planes_c):
        x = volume_metadata(cur_feats_bhwc, src_feats_bkhwc, P_bk34, rays_b3n, centers_bk3,
                            pose_meta_b3k, planes_c)
        score = _mlp(mlp, x)[..., 0]                                        # (B, Dc, N)
        if hint_mlp is not None:
            score = hint_mlp_plain(hint_mlp, score, hd, hvalid, hw, planes_c, dtype)
        return score

    chunks = []
    for s in range(0, planes_d.shape[0], plane_chunk):
        planes_c = planes_d[s:s + plane_chunk]
        if torch.is_grad_enabled():
            chunks.append(checkpoint(chunk, planes_c, use_reentrant=False))
        else:
            chunks.append(chunk(planes_c))
    return torch.cat(chunks, 1).reshape(b, -1, h, w)


def hint_mlp_plain(hint_mlp, score_bdn, hd_bn, hvalid_bn, hw_bn, planes_c,
                   dtype=torch.float32):
    """The hint MLP on [score, |hint - plane| or -1, weight or 0], the last
    two rounded to ``dtype`` (the features' type) as in the JAX package."""
    b, dc, n = score_bdn.shape
    diff = torch.where(hvalid_bn[:, None],
                       (hd_bn[:, None] - planes_c[None, :, None]).abs().to(dtype).float(),
                       torch.full((), -1.0, dtype=torch.float32, device=hd_bn.device))
    wts = torch.where(hvalid_bn, hw_bn, torch.zeros_like(hw_bn)).to(dtype).float()
    wts = wts[:, None].expand(b, dc, n)
    return _mlp(hint_mlp, torch.stack([score_bdn, diff, wts], -1))[..., 0]


# ------------------------------------------------------------ kernel layout


def volume_channel_order(k: int, c: int = CHANNELS):
    """The kernel's split of the metadata channels, as lists of metadata
    channel indices (-1: a zero row of padding).

    Returns (invariant_rows, plane_rows, plane_channel):
      * invariant_rows: the channels all planes of a pixel share — current
        features (c, in ``FRAGMENT_CHANNELS`` order), current ray (3), pose
        metadata (3k) — padded to a multiple of 16;
      * plane_rows: per view its c warped features (``FRAGMENT_CHANNELS``
        order), then per view
        [mask, depth, dot, angle, ray x, ray y, ray z, 0] (8 rows, two views
        to a 16-row step), padded to a multiple of 16;
      * plane_channel: the plane depth's channel (its row enters as
        ``plane * w``).
    """
    if c != CHANNELS:
        raise ValueError(f"the kernel's channel order is for {CHANNELS} channels, got {c}")
    cur_off = k * c
    mask_off = cur_off + c
    depth_off = mask_off + k
    plane_off = depth_off + k
    dot_off = plane_off + 1
    angle_off = dot_off + k
    rays_off = angle_off + k
    pose_off = rays_off + 3 * (k + 1)
    plane_rows = [v * c + i for v in range(k) for i in FRAGMENT_CHANNELS]
    for v in range(k):
        ray = rays_off + 3 + 3 * v
        plane_rows += [mask_off + v, depth_off + v, dot_off + v, angle_off + v,
                       ray, ray + 1, ray + 2, -1]
    plane_rows += [-1] * (-len(plane_rows) % 16)
    inv_rows = ([cur_off + i for i in FRAGMENT_CHANNELS]
                + [rays_off, rays_off + 1, rays_off + 2]
                + [pose_off + j for j in range(3 * k)])
    inv_rows += [-1] * (-len(inv_rows) % 16)
    return inv_rows, plane_rows, plane_off


def _select_rows(w_t, rows):
    """Rows of ``w_t`` (nin, out) picked by ``rows``, zeros where -1."""
    idx = torch.tensor(rows, device=w_t.device)
    out = w_t[idx.clamp(min=0)]
    return torch.where((idx >= 0)[:, None], out, torch.zeros_like(out))


def split_bf16(x):
    """(hi, lo) bf16 parts of float32 ``x``: hi = bf16(x), lo = bf16(x - hi)."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def wgmma_tiles(mat):
    """(K, 128) float32 -> (K/16, 2, 16, 2, 8, 8) bf16: per 16-row K step the
    hi then the lo part as ``wgmma`` reads B without swizzle, K-major:
    [column group of 8][K half][column][8 consecutive K] (8 x 8 core
    matrices of 128 bytes; K halves 128 bytes apart, column groups 256)."""
    kr, nc = mat.shape
    parts = torch.stack(split_bf16(mat))                    # (2, K, N)
    tiles = parts.reshape(2, kr // 16, 2, 8, nc // 8, 8)    # hl, s, kh, kk, ng, nr
    return tiles.permute(1, 0, 4, 2, 5, 3).contiguous()


def mma_fragments(mat):
    """(K, N) float32 -> (K/16, N/8, 32, 8) bf16, the B operand of
    ``mma.m16n8k16`` as lane ``4g + t`` holds it for each 16 x 8 tile: rows
    2t, 2t+1, 2t+8, 2t+9 of column g, hi parts then lo parts."""
    kr, nc = mat.shape
    hi, lo = split_bf16(mat)
    lane = torch.arange(32, device=mat.device)
    g, t = lane // 4, lane % 4
    rows = (torch.arange(kr // 16, device=mat.device)[:, None, None, None] * 16
            + torch.stack([2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9], -1)[None, None])
    cols = torch.arange(nc // 8, device=mat.device)[None, :, None, None] * 8 + g[None, None, :, None]
    return torch.cat([hi[rows, cols], lo[rows, cols]], -1).contiguous()


def pack_volume_weights(mlp, hint_mlp, k: int, c: int = CHANNELS):
    """The kernel's weights, from the torch-layout [(weight, bias)] lists.

    Returns a dict of float32 row matrices (``w1_inv`` (KI, 128),
    ``w1_plane`` (KP, 128), ``w2`` (128, 128) as in x out), their bf16 hi/lo
    parts as the kernel reads them (``w1_inv_frag``: ``mma_fragments``;
    ``w1_plane_tiles``, ``w2_tiles``: ``wgmma_tiles``),
    ``vec``, the small weights at the ``VEC_*`` offsets, and ``hint``, the
    hint MLP's ``HINT_LEN`` weights in host memory (None without one).
    """
    (w1, b1), (w2, b2), (w3, b3) = [(wt.detach().float(), bs.detach().float())
                                    for wt, bs in mlp]
    inv_rows, plane_rows, plane_ch = volume_channel_order(k, c)
    w1_t = w1.t()
    packed = {
        "w1_inv": _select_rows(w1_t, inv_rows),
        "w1_plane": _select_rows(w1_t, plane_rows),
        "w2": w2.t().contiguous(),
    }
    packed["w1_inv_frag"] = mma_fragments(packed["w1_inv"])
    packed["w1_plane_tiles"] = wgmma_tiles(packed["w1_plane"])
    packed["w2_tiles"] = wgmma_tiles(packed["w2"])
    vec = torch.zeros(VEC_LEN, dtype=torch.float32, device=w1.device)
    vec[VEC_B1:VEC_B1 + HIDDEN] = b1
    vec[VEC_WP:VEC_WP + HIDDEN] = w1_t[plane_ch]
    vec[VEC_B2:VEC_B2 + HIDDEN] = b2
    vec[VEC_W3:VEC_W3 + HIDDEN] = w3.reshape(-1)
    vec[VEC_B3] = b3.reshape(())
    packed["vec"] = vec
    packed["hint"] = None
    if hint_mlp is not None:
        (h1, hb1), (h2, hb2), (h3, hb3) = [(wt.detach().float(), bs.detach().float())
                                           for wt, bs in hint_mlp]
        packed["hint"] = torch.cat([h1.t().reshape(-1), hb1, h2.t().reshape(-1), hb2,
                                    h3.reshape(-1), hb3.reshape(1)]).cpu().contiguous()
    return packed


_packs: dict = {}   # id of the MLP's first weight tensor -> (key, packed)


def _weight_key(tensors):
    return tuple((t.data_ptr(), t._version, t.device, t.dtype, tuple(t.shape)) for t in tensors)


def packed_volume_weights(mlp, hint_mlp, k: int, c: int = CHANNELS):
    """``pack_volume_weights``, cached on the matching MLP's first weight
    tensor (one entry per module) and rebuilt when any weight's storage,
    version counter (an in-place update), device or shape changes."""
    tensors = [x for pair in list(mlp) + list(hint_mlp or []) for x in pair]
    key = (k, c, hint_mlp is not None, _weight_key(tensors))
    owner = mlp[0][0]
    hit = _packs.get(id(owner))
    if hit is not None and hit[0] == key:
        return hit[1]
    with torch.no_grad():
        packed = pack_volume_weights(mlp, hint_mlp, k, c)
    if hit is None:   # forget the pack with the tensor
        weakref.finalize(owner, _packs.pop, id(owner), None)
    _packs[id(owner)] = (key, packed)
    return packed


def plane_schedule(b: int, n: int, d: int, sms: int):
    """(planes a warpgroup walks, blocks) for the persistent grid: one block
    of ``GROUPS`` warpgroups per SM, work items of 64 pixels x a run of
    planes, the run chosen so the items fill the warpgroups in the fewest
    rounds (computing a pixel's shared channels costs about a quarter of a
    plane)."""
    groups = b * math.ceil(n / ROWS)
    slots = sms * GROUPS
    best = None
    for runs in range(1, d + 1):
        run = math.ceil(d / runs)
        items = groups * math.ceil(d / run)
        cost = math.ceil(items / slots) * (run + 0.25)
        if best is None or cost < best[0]:
            best = (cost, run, items)
    _, run, items = best
    return run, min(sms, math.ceil(items / GROUPS))


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else ctypes.c_void_p(0)


@tracing.spanned("ops.fused_volume")
def fused_feature_volume(cur_feats_bhwc, src_feats_bkhwc, P_bk34, rays_b3n, centers_bk3,
                         pose_meta_b3k, planes_d, mlp, hint_mlp=None, hint_bhw3=None,
                         plane_chunk: int = 16):
    """(B, D, h, w) float32 scores through the kernel (CUDA) or the plain
    version (CPU).

    Same arguments as ``feature_volume_plain``. A hint may be given with
    non-finite depths: they are zeroed first, on both paths. With a hint
    MLP and no hint, the hint is all invalid. The features' type picks the
    kernel's mode: float32 features take the float32 mode (three bf16
    products per product), bf16 features the bf16 mode (one); any other
    type raises. Everything else is float32.
    """
    b, h, w, c = cur_feats_bhwc.shape
    k = src_feats_bkhwc.shape[1]
    if hint_mlp is not None:
        if hint_bhw3 is None:
            hint_bhw3 = cur_feats_bhwc.new_zeros((b, h, w, 3), dtype=torch.float32)
        hint_bhw3 = torch.nan_to_num(hint_bhw3.float(), nan=0.0, posinf=0.0, neginf=0.0)
    else:
        hint_bhw3 = None
    args = (cur_feats_bhwc, src_feats_bkhwc, P_bk34, rays_b3n, centers_bk3,
            pose_meta_b3k, planes_d, mlp, hint_mlp, hint_bhw3)
    if not cur_feats_bhwc.is_cuda:
        return feature_volume_plain(*args, plane_chunk=plane_chunk)

    d = planes_d.shape[0]
    nin = mlp_in_channels(k, c)
    (w1, _), (w2, _), (w3, _) = mlp
    if c != CHANNELS or not 1 <= k <= MAX_VIEWS:
        raise ValueError(f"fused volume kernel takes {CHANNELS} channels and 1..{MAX_VIEWS} "
                         f"source views, got c={c}, k={k}")
    if (w1.shape != (HIDDEN, nin) or w2.shape != (HIDDEN, HIDDEN) or w3.shape != (1, HIDDEN)):
        raise ValueError(f"fused volume kernel takes an MLP [{nin}, {HIDDEN}, {HIDDEN}, 1]")
    if hint_mlp is not None:
        (h1, _), (h2, _), (h3, _) = hint_mlp
        hh = HINT_HIDDEN
        if h1.shape != (hh, 3) or h2.shape != (hh, hh) or h3.shape != (1, hh):
            raise ValueError(f"fused volume kernel takes a hint MLP [3, {hh}, {hh}, 1]")
    expect = {
        "cur_feats": (cur_feats_bhwc, (b, h, w, c)),
        "src_feats": (src_feats_bkhwc, (b, k, h, w, c)),
        "P": (P_bk34, (b, k, 3, 4)),
        "rays": (rays_b3n, (b, 3, h * w)),
        "centers": (centers_bk3, (b, k, 3)),
        "pose_meta": (pose_meta_b3k, (b, 3 * k)),
        "planes": (planes_d, (d,)),
        "hint": (hint_bhw3, (b, h, w, 3)),
    }
    dev = cur_feats_bhwc.device
    feat_dtype = cur_feats_bhwc.dtype
    if feat_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_feature_volume: features must be float32 or bfloat16, "
                         f"got {feat_dtype}")
    for name, (t, shape) in expect.items():
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_feature_volume: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        dtype = feat_dtype if name in ("cur_feats", "src_feats") else torch.float32
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"fused_feature_volume: {name} must be contiguous {dtype} on {dev}")
    packed = packed_volume_weights(mlp, hint_mlp, k, c)
    if packed["vec"].device != dev:
        raise ValueError(f"fused_feature_volume: the MLP weights must be on {dev}")

    run, blocks = plane_schedule(b, h * w, d, torch.cuda.get_device_properties(dev)
                                 .multi_processor_count)
    out = torch.empty((b, d, h, w), dtype=torch.float32, device=dev)
    lib = load_kernel("fused_volume")
    fn = lib.fused_volume_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(_ptr(cur_feats_bhwc), _ptr(src_feats_bkhwc), _ptr(rays_b3n), _ptr(P_bk34),
             _ptr(centers_bk3), _ptr(pose_meta_b3k), _ptr(planes_d), _ptr(hint_bhw3),
             _ptr(packed["w1_inv_frag"]), _ptr(packed["w1_plane_tiles"]),
             _ptr(packed["w2_tiles"]), _ptr(packed["vec"]), _ptr(packed["hint"]), _ptr(out),
             b, k, h, w, d, run, blocks, int(hint_mlp is not None),
             int(feat_dtype == torch.bfloat16), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"fused volume kernel launch failed: cudaError {err}")
    tracing.count("ops.fused_volume.launches")
    return out
