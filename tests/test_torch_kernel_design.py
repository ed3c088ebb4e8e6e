"""The designs of the port's two CUDA kernels, checked on the CPU.

K1 (``csrc/fused_volume.cu``) reorders the matching MLP's first layer
(``volume_channel_order``), applies the channels a pixel's planes share once,
and takes every product as three bf16 products of hi/lo parts. A plain torch
emulation of that algebra, built from ``pack_volume_weights``, is held to
``feature_volume_plain`` and to the JAX package's XLA ``FeatureVolume``
within 1e-4 on O(1) scores: the split products keep ~16 bits (relative
error ~2e-5 per product) and the summation order differs.

K2 (``csrc/integrate.cu``) skips boxes of voxels by a corner test; its plain
torch form (``block_cull_plain``) must never skip a voxel that
``integrate_plain`` updates.

The emulation lives here: the main path never runs it.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from doubletake_tpu.models import cost_volume as jcv

from doubletake_tpu_torch.checkpoints.convert import variables_to_state_dict
from doubletake_tpu_torch.models import cost_volume as tcv
from doubletake_tpu_torch.ops import fused_volume as fv
from doubletake_tpu_torch.ops.integrate import BOX, block_cull_plain, integrate_plain

B, C, H, W, D = 1, 16, 8, 12, 8
TOL = 1e-4


@pytest.fixture(autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------------- K1 packing


def volume_inputs(k, seed):
    rng = np.random.RandomState(seed)

    def pose():
        ang = rng.randn(3) * 0.1
        cx, cy, cz = np.cos(ang)
        sx, sy, sz = np.sin(ang)
        Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = Rz @ Ry @ Rx
        T[:3, 3] = rng.randn(3) * 0.1
        return T

    Km = np.eye(4, dtype=np.float32)
    Km[0, 0] = Km[1, 1] = 10.0
    Km[0, 2], Km[1, 2] = W / 2, H / 2
    src_T_cur = np.stack([pose() for _ in range(k)])[None]
    depth = ((rng.rand(B, H, W, 1) + 0.3) * 2).astype(np.float32)
    mask = rng.rand(B, H, W, 1) > 0.4
    hint = {"depth_hint_bhw1": np.where(mask, depth, np.nan).astype(np.float32),
            "hint_mask_bhw1": mask,
            "sampled_weights_bhw1": rng.rand(B, H, W, 1).astype(np.float32)}
    args = (rng.randn(B, H, W, C).astype(np.float32),
            rng.randn(B, k, H, W, C).astype(np.float32),
            src_T_cur, np.linalg.inv(src_T_cur).astype(np.float32),
            np.broadcast_to(Km, (B, k, 4, 4)).copy(), np.linalg.inv(Km)[None].astype(np.float32))
    return args, hint


def numpy_variables(shapes, seed):
    """Values for ``model.init``'s tree from numpy: lecun-normal kernels,
    small biases."""
    rng = np.random.RandomState(seed)

    def fill(path, s):
        if path[-1].key == "kernel":
            return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (rng.randn(*s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def split_mm(a, b):
    """a @ b as the kernel takes it: lo*hi + hi*lo + hi*hi of bf16 parts,
    summed in float32."""
    ah, al = (p.float() for p in fv.split_bf16(a))
    bh, bl = (p.float() for p in fv.split_bf16(b))
    return al @ bh + ah @ bl + ah @ bh


def emulate_kernel(cur, src, P, rays, centers, pose, planes, mlp, hint_mlp, hint_bhw3):
    """K1's algebra in plain torch, from ``pack_volume_weights``: u = b1 +
    W1[shared] x once per pixel, + plane * w_plane, + the view-major
    per-plane rows, each product split; layer 2 split; then the hint MLP."""
    b, h, w, c = cur.shape
    k = src.shape[1]
    pk = fv.pack_volume_weights(mlp, hint_mlp, k, c)
    vec = pk["vec"]
    inv_rows, plane_rows, _ = fv.volume_channel_order(k, c)
    x = fv.volume_metadata(cur, src, P, rays, centers, pose, planes)     # (B, D, N, nin)

    def pick(rows):
        idx = torch.tensor(rows)
        return torch.where(idx >= 0, x[..., idx.clamp(min=0)], torch.zeros(()))

    hid = fv.HIDDEN
    u = vec[fv.VEC_B1:fv.VEC_B1 + hid] + split_mm(pick(inv_rows)[:, :1], pk["w1_inv"])
    pre = (u + planes[None, :, None, None] * vec[fv.VEC_WP:fv.VEC_WP + hid]
           + split_mm(pick(plane_rows), pk["w1_plane"]))
    h2 = F.leaky_relu(split_mm(F.leaky_relu(pre, 0.01), pk["w2"])
                      + vec[fv.VEC_B2:fv.VEC_B2 + hid], 0.01)
    score = h2 @ vec[fv.VEC_W3:fv.VEC_W3 + hid] + vec[fv.VEC_B3]         # (B, D, N)
    if hint_mlp is not None:
        hd, hv, hw = torch.nan_to_num(hint_bhw3, nan=0.0).reshape(b, -1, 3).unbind(-1)
        score = fv.hint_mlp_plain(hint_mlp, score, hd, hv > 0.5, hw, planes)
    return score.reshape(b, -1, h, w)


@pytest.mark.parametrize("k", [1, 2, 7, 8])
def test_channel_order_covers_the_metadata(k):
    inv_rows, plane_rows, plane_ch = fv.volume_channel_order(k, C)
    rows = [r for r in inv_rows + plane_rows if r >= 0] + [plane_ch]
    assert sorted(rows) == list(range(fv.mlp_in_channels(k, C)))
    assert len(inv_rows) % 16 == 0 and len(plane_rows) == 16 * (k + (k + 1) // 2)
    assert len([r for r in plane_rows if r >= 0]) == 23 * k


def test_mma_fragments_layout():
    mat = torch.randn(32, 128, generator=torch.Generator().manual_seed(0))
    frag = fv.mma_fragments(mat)
    assert frag.shape == (2, 16, 32, 8) and frag.dtype == torch.bfloat16
    hi, lo = fv.split_bf16(mat)
    # lane 4g + t of tile (s, j): rows 16s + {2t, 2t+1, 2t+8, 2t+9}, column 8j + g
    for s, j, g, tq in [(0, 0, 0, 0), (1, 5, 3, 2), (1, 15, 7, 3)]:
        rows = [16 * s + r for r in (2 * tq, 2 * tq + 1, 2 * tq + 8, 2 * tq + 9)]
        got = frag[s, j, 4 * g + tq]
        assert torch.equal(got[:4], hi[rows, 8 * j + g])
        assert torch.equal(got[4:], lo[rows, 8 * j + g])
    rel = ((hi.float() + lo.float() - mat).abs() / mat.abs()).max()
    assert rel < 2.0 ** -15


def test_wgmma_tiles_layout():
    mat = torch.randn(32, 128, generator=torch.Generator().manual_seed(1))
    tiles = fv.wgmma_tiles(mat)
    assert tiles.shape == (2, 2, 16, 2, 8, 8) and tiles.is_contiguous()
    parts = fv.split_bf16(mat)
    # [step, hi/lo, column group, K half, column, K]: byte offsets 128 per
    # K half and 256 per column group inside a 4 KB tile
    for s, hl, ng, kh, nr, kk in [(0, 0, 0, 0, 0, 0), (1, 1, 5, 1, 3, 7), (1, 0, 15, 0, 7, 2)]:
        assert tiles[s, hl, ng, kh, nr, kk] == parts[hl][16 * s + 8 * kh + kk, 8 * ng + nr]
    flat = tiles.reshape(2, 2, -1)
    assert flat.shape[-1] * 2 == 4096
    assert flat[1, 1, (5 * 256 + 1 * 128 + 3 * 16 + 7 * 2) // 2] == parts[1][16 + 8 + 7, 43]


@pytest.mark.parametrize("hint_on", [False, True])
@pytest.mark.parametrize("k", [1, 2, 7, 8])
def test_kernel_algebra_matches_plain_and_jax(k, hint_on):
    args, hint = volume_inputs(k, seed=10 + k)
    jargs = tuple(map(jnp.asarray, args))
    jm = (jcv.FeatureMeshHintVolume if hint_on else jcv.FeatureVolume)(num_depth_bins=D,
                                                                       plane_chunk=4)
    jhint = {key: jnp.asarray(v) for key, v in hint.items()} if hint_on else None
    init = lambda key: jm.init(key, *jargs, 0.25, 5.0, hint=jhint)   # noqa: E731
    v = numpy_variables(jax.eval_shape(init, jax.random.PRNGKey(0)), seed=k)
    jvol = np.asarray(jm.apply(v, *jargs, 0.25, 5.0, hint=jhint)[0])   # (B, H, W, D)

    pm = (tcv.FeatureMeshHintVolume if hint_on else tcv.FeatureVolume)(
        num_depth_bins=D, num_views=k, plane_chunk=4)
    sd = variables_to_state_dict({"params": {"cost_volume": v["params"]}})
    pm.load_state_dict({key[len("cost_volume."):]: w for key, w in sd.items()})
    cur, src, src_T_cur, cur_T_src, src_K, invK = map(t, args)
    geo = fv.volume_geometry(src_K, src_T_cur, cur_T_src, invK, H, W)
    planes = tcv.generate_depth_planes(0.25, 5.0, D)
    hint_bhw3 = None
    if hint_on:
        valid = t(hint["hint_mask_bhw1"])[..., 0]
        wts = torch.where(valid, t(hint["sampled_weights_bhw1"])[..., 0], torch.zeros(()))
        hint_bhw3 = torch.stack([t(hint["depth_hint_bhw1"])[..., 0], valid.float(), wts], -1)
    common = (cur, src, *geo, planes, pm._layers(pm.mlp), pm._layers(pm.hint_mlp), hint_bhw3)
    with torch.no_grad():
        emu = emulate_kernel(*common)
        plain = fv.feature_volume_plain(*common, plane_chunk=4)
    assert torch.isfinite(emu).all()
    assert float((emu - plain).abs().max()) <= TOL
    assert float(np.abs(emu.permute(0, 2, 3, 1).numpy() - jvol).max()) <= TOL
    assert float(plain.abs().max()) > 0.1     # O(1) scores: the bound is relative too


def test_packed_weights_are_cached_and_follow_weight_changes():
    pm = tcv.FeatureMeshHintVolume(num_depth_bins=D, num_views=2)
    mlp, hint_mlp = pm._layers(pm.mlp), pm._layers(pm.hint_mlp)
    first = fv.packed_volume_weights(mlp, hint_mlp, 2)
    assert fv.packed_volume_weights(pm._layers(pm.mlp), pm._layers(pm.hint_mlp), 2) is first

    with torch.no_grad():                       # an in-place update of one weight
        pm.mlp.linears()[1].weight[3, 5] += 1.0
    second = fv.packed_volume_weights(pm._layers(pm.mlp), pm._layers(pm.hint_mlp), 2)
    assert second is not first
    assert torch.equal(second["w2"], pm.mlp.linears()[1].weight.detach().t())
    assert not torch.equal(second["w2_tiles"], first["w2_tiles"])

    sd = {key: torch.randn_like(val) for key, val in pm.state_dict().items()}
    pm.load_state_dict(sd)                      # new weights copied in
    third = fv.packed_volume_weights(pm._layers(pm.mlp), pm._layers(pm.hint_mlp), 2)
    assert third is not second
    w1 = pm.mlp.linears()[0].weight
    assert torch.equal(third["vec"][fv.VEC_B1:fv.VEC_B1 + 128], pm.mlp.linears()[0].bias)
    _, plane_rows, _ = fv.volume_channel_order(2, C)
    assert torch.equal(third["w1_plane"][0], w1.detach().t()[plane_rows[0]])
    h1, h2, h3 = (lin.weight.detach() for lin in pm.hint_mlp.linears())
    hint = third["hint"]
    assert hint.device.type == "cpu" and hint.numel() == fv.HINT_LEN
    assert torch.equal(hint[:36], h1.t().reshape(-1))
    assert torch.equal(hint[48:192], h2.t().reshape(-1))
    assert float(hint[-1]) == float(pm.hint_mlp.linears()[2].bias.detach())


@pytest.mark.parametrize("b,n,d,sms", [(1, 96 * 128, 64, 132), (1, 96 * 128, 61, 132),
                                       (2, 25 * 37, 8, 132), (1, 96 * 128, 64, 114)])
def test_plane_schedule_covers_every_plane_once(b, n, d, sms):
    run, blocks = fv.plane_schedule(b, n, d, sms)
    assert 1 <= run <= d and 1 <= blocks <= sms
    groups = b * -(-n // fv.ROWS)
    items = groups * -(-d // run)
    # the kernel's item walk: each (pixel group, plane) exactly once
    seen = np.zeros((groups, d), int)
    for wg in range(blocks * fv.GROUPS):
        for item in range(wg, items, blocks * fv.GROUPS):
            d0 = (item // groups) * run
            seen[item % groups, d0:min(d, d0 + run)] += 1
    assert (seen == 1).all()
    if (b, n, d, sms) == (1, 96 * 128, 64, 132):
        assert run == 16    # 3 rounds of 16 planes on 264 warpgroups


# ------------------------------------------------------------- K2 culling

VOXEL = 0.04
ORIGIN = (-1.28, -1.28, 0.0)
DIMS = (64, 64, 64)
DH, DW = 48, 64


def look(pos, fwd):
    """cam_T_world of a camera at ``pos`` looking along ``fwd`` (z up)."""
    fwd = np.asarray(fwd, float) / np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    T = np.eye(4)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, np.cross(fwd, right), fwd, pos
    return np.linalg.inv(T).astype(np.float32)


POSES = {
    # camera inside the volume, looking along +x and a little down
    "inside": (look((0.1, -0.2, 1.3), (1.0, 0.3, -0.2)), 3.0, 1.2),
    # outside, looking in: boxes straddle all four image borders
    "outside_in": (look((-2.2, 0.1, 1.2), (1.0, -0.1, 0.05)), 5.0, 2.6),
    # outside, looking away: nothing in view
    "away": (look((-2.2, 0.1, 1.2), (-1.0, 0.0, 0.0)), 5.0, 2.0),
    # looking in with the depth range ending inside the volume, the depths
    # just short of it
    "near_max_depth": (look((-2.2, 0.1, 1.2), (1.0, 0.05, 0.0)), 2.5, 2.47),
}


@pytest.mark.parametrize("name", sorted(POSES))
def test_block_cull_keeps_every_updated_voxel(name):
    cTw, max_depth, depth_mean = POSES[name]
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 0.7 * DW
    K[0, 2], K[1, 2] = DW / 2, DH / 2
    P = t((K @ cTw)[:3])
    rng = np.random.RandomState(3)
    depth = t((depth_mean + rng.uniform(-0.03, 0.03, (DH, DW))).astype(np.float32))
    origin = torch.tensor(ORIGIN, dtype=torch.float32)
    values = torch.zeros(DIMS)
    weights = torch.zeros(DIMS)
    kw = dict(voxel_size=VOXEL, min_depth=0.1, max_depth=max_depth, truncation=0.12,
              trunc_check=-0.18, update_rate=2.5, max_weight=100.0)
    _, new_w = integrate_plain(values, weights, depth, P, origin, **kw)
    updated = new_w != weights

    culled = block_cull_plain(DIMS, (DH, DW), P, origin, voxel_size=VOXEL, max_depth=max_depth)
    assert culled.shape == tuple(-(-n // s) for n, s in zip(DIMS, BOX))
    per_voxel = culled
    for axis, step in enumerate(BOX):
        per_voxel = per_voxel.repeat_interleave(step, axis)
    per_voxel = per_voxel[:DIMS[0], :DIMS[1], :DIMS[2]]
    assert not (updated & per_voxel).any()

    n_up, n_cull = int(updated.sum()), int(culled.sum())
    if name == "away":
        assert n_up == 0
    else:
        # not vacuous: the frame updates voxels, and boxes are culled and kept
        assert n_up > 1000 and 0 < n_cull < culled.numel()


@pytest.mark.parametrize("name", sorted(POSES))
def test_plain_blocks_equal_whole_volume(name):
    """``integrate_plain`` over x-slabs and a y-z block, each at its
    ``first_voxel`` in the whole volume, is bit-equal to the whole volume's
    update (the plain version of a volume too large for its temporaries)."""
    cTw, max_depth, depth_mean = POSES[name]
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 0.7 * DW
    K[0, 2], K[1, 2] = DW / 2, DH / 2
    P = t((K @ cTw)[:3])
    rng = np.random.RandomState(4)
    depth = t((depth_mean + rng.uniform(-0.03, 0.03, (DH, DW))).astype(np.float32))
    origin = torch.tensor(ORIGIN, dtype=torch.float32)
    values = t(rng.uniform(-1.0, 1.0, DIMS).astype(np.float32))
    weights = t(rng.uniform(0.0, 0.5, DIMS).astype(np.float32))
    kw = dict(voxel_size=VOXEL, min_depth=0.1, max_depth=max_depth, truncation=0.12,
              trunc_check=-0.18, update_rate=2.5, max_weight=100.0)
    whole_v, whole_w = integrate_plain(values, weights, depth, P, origin, **kw)
    for x0 in range(0, DIMS[0], 24):
        x1 = min(x0 + 24, DIMS[0])
        v, w = integrate_plain(values[x0:x1], weights[x0:x1], depth, P, origin,
                               first_voxel=(x0, 0, 0), **kw)
        assert torch.equal(v, whole_v[x0:x1]) and torch.equal(w, whole_w[x0:x1])
    block = (slice(8, 40), slice(5, 50), slice(17, 64))
    v, w = integrate_plain(values[block], weights[block], depth, P, origin,
                           first_voxel=(8, 5, 17), **kw)
    assert torch.equal(v, whole_v[block]) and torch.equal(w, whole_w[block])
    if name != "away":
        assert int((whole_w != weights).sum()) > 1000
