"""The online step and the offline passes as CUDA graph replays
(``runners.graphs``, ``runners.incremental.make_step``,
``runners.offline_two_pass``) and the constants that let a graph capture
them (``utils.geometry.device_constant``).

On the CPU: the constants equal what the step built before, bit for bit,
and are built once; the eager step is the three stages called in turn; the
graphed step's own code (its keys, the volume's slot, the copies in and out
of the static buffers, the counters) runs with a stand-in for the CUDA
graph that replays the captured stage on the static inputs, and matches the
eager step bit for bit while its returned tensors outlive later frames. The
offline passes likewise, at batch 2, against the passes as they ran eagerly.

No JAX here: the card's test runs on the card with
``python -m pytest tests/test_torch_graphs.py -m card --noconftest``.
"""

from __future__ import annotations

import gc
import json
import weakref
from collections import Counter, OrderedDict

import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.profiler import ProfilerActivity, profile

from doubletake_tpu_torch.data.loader import DataLoader, collate
from doubletake_tpu_torch.datasets.synthetic import SyntheticDataset
from doubletake_tpu_torch.models.cost_volume import generate_depth_planes
from doubletake_tpu_torch.ops.resize import interpolate_nearest
from doubletake_tpu_torch.options import Options
from doubletake_tpu_torch.runners import common, graphs, incremental, offline_two_pass
from doubletake_tpu_torch.tools import tsdf as tsdf_mod
from doubletake_tpu_torch.utils import tracing
from doubletake_tpu_torch.utils.geometry import linspace01

TINY = dict(
    dataset="synthetic", image_width=64, image_height=32, image_encoder_name="tiny",
    matching_encoder_type="tiny", depth_decoder_name="skip",
    model_type="cv_hint_depth_model", feature_volume_type="mlp_mesh_hint_feature_volume",
    matching_num_depth_bins=8, plane_chunk=8, model_num_views=3, batch_size=1,
    raycast_samples=64, num_workers=0, fusion_resolution=0.04,
    extended_neg_truncation=True, fast_cost_volume=True,
)
# the flagship's model (configs/models/doubletake_model.yaml) at half its
# image size, for the card
FLAGSHIP = dict(
    dataset="synthetic", image_width=256, image_height=192, image_encoder_name="efficientnet",
    matching_encoder_type="resnet", depth_decoder_name="unet_pp",
    model_type="cv_hint_depth_model", feature_volume_type="mlp_mesh_hint_feature_volume",
    matching_num_depth_bins=64, plane_chunk=16, model_num_views=8, batch_size=1,
    raycast_samples=256, num_workers=0, fusion_resolution=0.02, fusion_max_depth=3.5,
    extended_neg_truncation=True, fast_cost_volume=True,
)


def counter(name):
    return tracing.counters().get(name, 0)


def options(settings, device):
    o = Options()
    for k, v in settings.items():
        setattr(o, k, v)
    o.device = device
    return o


@pytest.mark.parametrize("num", [2, 3, 64, 96, 256])
def test_linspace01_is_built_once_and_unchanged(num):
    """i * float32(1 / (num - 1)), the last step exactly 1: the host's
    float32 rounding, as the step built it every call before."""
    step = torch.tensor(1.0 / (num - 1), dtype=torch.float32)
    want = torch.arange(num, dtype=torch.float32) * step
    want[-1] = 1.0
    got = linspace01(num)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.numpy().view(np.uint32))
    assert got[-1].item() == 1.0
    assert linspace01(num) is got
    assert linspace01(num, torch.device("cpu")) is got


def test_depth_planes_are_built_once_and_unchanged():
    lo = torch.log(torch.tensor(0.25, dtype=torch.float32))
    span = torch.log(torch.tensor(5.0 / 0.25, dtype=torch.float32))
    step = torch.tensor(1.0 / 63, dtype=torch.float32)
    ramp = torch.arange(64, dtype=torch.float32) * step
    ramp[-1] = 1.0
    want = torch.exp(lo + span * ramp)
    got = generate_depth_planes(0.25, 5.0, 64)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.numpy().view(np.uint32))
    assert generate_depth_planes(0.25, 5.0, 64, "cpu") is got


@pytest.mark.parametrize("dims", [(304, 200, 152), (40, 24, 16)])
def test_raycast_box_constants_unchanged(dims):
    X, Y, Z = dims
    box = tsdf_mod._box(dims, "cpu")
    hi = tsdf_mod._box_hi(dims, "cpu")
    want_box = torch.tensor([X - 1, Y - 1, Z - 1], dtype=torch.float32)[:, None]
    want_hi = torch.tensor([X - 1, Y - 1, Z - 1], dtype=torch.float32) - 1e-4
    assert box.shape == (3, 1) and torch.equal(box, want_box)
    np.testing.assert_array_equal(hi.numpy().view(np.uint32), want_hi.numpy().view(np.uint32))
    assert tsdf_mod._box(dims, "cpu") is box and tsdf_mod._box_hi(dims, "cpu") is hi


@pytest.mark.parametrize("size,out", [(12, 32), (32, 12), (7, 7 * 3), (96, 192)])
def test_nearest_index_unchanged(size, out):
    x = torch.arange(size * 5, dtype=torch.float32).reshape(1, size, 5, 1)
    got = interpolate_nearest(x, (out, 5))
    ys = np.clip(np.floor(np.arange(out) * (size / out)).astype(np.int64), 0, size - 1)
    assert torch.equal(got, x[:, torch.as_tensor(ys)])


def session_inputs(ds, device):
    """(cur id, src ids, cur, src) of each frame of ``ds``, on ``device``."""
    batches = []
    for i in range(len(ds)):
        cur_np, src_np = collate([ds[i]])
        batches.append((cur_np["frame_id_string"][0], src_np["frame_id_string"][0],
                        *common.device_batch(cur_np, src_np, device)))
    return batches


def tiny_session_inputs():
    """The tiny model (3 views: a session's first two frames run the
    matching encoder over all views, the rest read cached features), its
    fusion config and a 12-frame synthetic scan."""
    opts = options(TINY, "cpu")
    model = common.init_or_load_params(opts, common.build_model(opts))
    ds = SyntheticDataset(split="test", image_height=32, image_width=64, tuple_size=3,
                          num_images_in_tuple=3, num_frames=14, pass_frame_id=True)
    cfg = common.make_fuser(opts, ds, "synth0", "cpu")[1]
    return opts, model, ds, cfg, session_inputs(ds, "cpu")


def run_session(step, tsdf, batches):
    """The runner's loop over one session: the source features from the
    frames before; returns each frame's (out, hint) as handed back."""
    cache: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    kept = []
    for fid, src_ids, cur, src in batches:
        src_feats = None
        if all(i in cache for i in src_ids):
            src_feats = torch.stack([cache[i] for i in src_ids])[None]
        out, hint, tsdf = step(tsdf, cur, src, src_feats=src_feats)
        cache[fid] = out["matching_feats_bhwc"][0]
        kept.append((out, hint))
    return kept, tsdf


def eager_step(model, cfg, opts, hint_hw):
    """The three stages called in turn, as the step ran before it graphed."""
    hint_step, forward_step, fuse_step = incremental.make_split_steps(
        model, cfg, *hint_hw, opts.raycast_samples, opts.fusion_max_depth, opts)

    def step(tsdf, cur, src, src_feats=None):
        hint = hint_step(tsdf, cur)
        out = forward_step(cur, src, hint, src_feats)
        fuse_step(tsdf, out, cur)
        return out, hint, tsdf

    return step


def same(a, b):
    """Equal bit for bit (NaNs included)."""
    a, b = (np.ascontiguousarray(t.detach().cpu().numpy()) for t in (a, b))
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a.view(np.uint8),
                                                                        b.view(np.uint8))


def assert_same(kept_a, kept_b):
    assert len(kept_a) == len(kept_b)
    for (out_a, hint_a), (out_b, hint_b) in zip(kept_a, kept_b):
        for key in ("depth_pred_s0_bhw1", "matching_feats_bhwc", "overall_mask_bhw"):
            assert same(out_a[key], out_b[key]), key
        assert sorted(hint_a) == sorted(hint_b)
        for key in hint_a:
            assert same(hint_a[key], hint_b[key]), key


def test_eager_step_on_the_cpu_is_the_three_stages():
    """On the CPU the step runs its stages eagerly and captures nothing:
    the same depths, hints and volume as the stages called in turn."""
    opts, model, ds, cfg, batches = tiny_session_inputs()
    before = counter("runner.graph_captures"), counter("runner.graph_replays")
    vol_a, _ = common.make_fuser(opts, ds, "synth0", "cpu")
    vol_b, _ = common.make_fuser(opts, ds, "synth0", "cpu")
    step = incremental.make_step(model, cfg, 8, 16, opts.raycast_samples,
                                 opts.fusion_max_depth, opts=opts)
    kept_a, vol_a = run_session(step, vol_a, batches)
    kept_b, vol_b = run_session(eager_step(model, cfg, opts, (8, 16)), vol_b, batches)
    assert_same(kept_a, kept_b)
    assert torch.equal(vol_a.values, vol_b.values) and torch.equal(vol_a.weights, vol_b.weights)
    assert any(bool(h["hint_mask_bhw1"].any()) for _, h in kept_a)
    assert (counter("runner.graph_captures"), counter("runner.graph_replays")) == before


class StandInGraph:
    """What a CUDA graph does, on the CPU. Its capture (``record``) runs the
    stage once, for the frame it is captured on, and the replay that
    follows at once does nothing more; each later replay runs the stage
    again on the static inputs and writes its results into the static
    outputs."""

    def __init__(self, fn, inputs):
        self.fn, self.inputs, self.fresh = fn, inputs, True
        self.outputs = fn(*inputs)

    @staticmethod
    def record(fn, inputs, pool):
        graph = StandInGraph(fn, inputs)
        return graph, graph.outputs

    def replay(self):
        if self.fresh:
            self.fresh = False
            return
        graphs.copy_into(self.outputs, self.fn(*self.inputs))


@pytest.fixture
def stand_in(monkeypatch):
    """The step's graph path on the CPU, with ``StandInGraph``."""
    made = {}

    def stages(model, device):
        if model not in made:
            monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
            made[model] = graphs.Stages(model)
        return made[model]

    monkeypatch.setattr(graphs, "stages", stages)
    monkeypatch.setattr(graphs, "_record", StandInGraph.record)
    return made


def graph_outputs(stages):
    """The tensors a model's captured graphs hold as outputs."""
    return [t for g in all_graphs(stages) for t in graphs.tensors(g.outputs)]


def all_graphs(stages):
    """A model's captured graphs."""
    return [g for d in (stages.running.graphs, stages.static.graphs, stages.on_weights)
            for g in d.values() if g is not None]


def test_graphed_step_hands_back_its_own_tensors(stand_in):
    """Two sessions through the graph path with a stand-in graph: each
    stage runs eagerly at its first use, is captured at its second and
    replayed after; the second session, on a fresh volume, captures
    nothing. Depths, hints and volumes equal the eager step's bit for bit,
    and every frame's returned tensors, all kept to the end, still hold
    their own frame's values: none is a view of a buffer that a later
    replay rewrites. The first session's volume, still alive, keeps its
    contents when the second session's volume takes the graphs' storage."""
    opts, model, ds, cfg, batches = tiny_session_inputs()
    step = incremental.make_step(model, cfg, 8, 16, opts.raycast_samples,
                                 opts.fusion_max_depth, opts=opts)
    eager = eager_step(model, cfg, opts, (8, 16))
    captures = counter("runner.graph_captures")
    replays = counter("runner.graph_replays")
    for session in range(2):
        vol_g, _ = common.make_fuser(opts, ds, "synth0", "cpu")
        vol_e, _ = common.make_fuser(opts, ds, "synth0", "cpu")
        own = vol_g.values.untyped_storage().data_ptr()
        kept_g, vol_g = run_session(step, vol_g, batches)
        kept_e, vol_e = run_session(eager, vol_e, batches)
        assert_same(kept_g, kept_e)
        assert torch.equal(vol_g.values, vol_e.values)
        assert torch.equal(vol_g.weights, vol_e.weights)
        for out, _ in kept_g:
            assert out["depth_pred_s0_bhw1"].untyped_storage().data_ptr() not in {
                t.untyped_storage().data_ptr() for t in graph_outputs(stand_in[model])}
        if session == 0:
            # hint, fuse and both forwards (without and with cached features)
            assert counter("runner.graph_captures") - captures == 4
            captures = counter("runner.graph_captures")
            first = (vol_g, vol_g.values.clone(), vol_g.weights.clone())
        else:
            assert counter("runner.graph_captures") == captures
            # moved onto the first volume's storage
            assert vol_g.values.untyped_storage().data_ptr() != own
            assert torch.equal(first[0].values, first[1])
            assert torch.equal(first[0].weights, first[2])
    # two sessions, 3 stages a frame, the first use of each of 4 keys eager
    assert counter("runner.graph_replays") - replays == 2 * 3 * len(batches) - 4


def test_graphs_follow_the_volume_shape_and_release_old_volumes(stand_in):
    """Sessions on volumes of three shapes (two, one and two sessions),
    through the graph path with a stand-in graph: each shape's raycast and
    fuse are captured once, the forward once for all; a new shape drops the
    old shape's graphs, so once its sessions' volumes are dropped no graph
    or stage keeps their storage; the last shape's replayed session fuses
    the eager step's volume bit for bit."""
    opts, model, ds, cfg, batches = tiny_session_inputs()
    batches = batches[:4]
    step = incremental.make_step(model, cfg, 8, 16, opts.raycast_samples,
                                 opts.fusion_max_depth, opts=opts)

    def volume(grow):   # synth0's room, ``grow`` blocks of voxels longer in x
        bounds = common.scene_bounds_for_fusion(ds, "synth0")
        bounds["xmax"] += grow * tsdf_mod.VOX_MOD * opts.fusion_resolution
        return tsdf_mod.TSDF.from_bounds(bounds, opts.fusion_resolution, device="cpu")

    shapes, captured, stored = [0, 0, 1, 2, 2], [], []
    for grow in shapes:
        before = counter("runner.graph_captures")
        vol = run_session(step, volume(grow), batches)[1]
        captured.append(counter("runner.graph_captures") - before)
        stored.append([StorageWeakRef(t.untyped_storage()) for t in (vol.values, vol.weights)])
        if grow != shapes[-1]:
            del vol
            gc.collect()
    # both forwards and the first shape's hint and fuse; then each new shape's
    assert captured == [4, 0, 2, 2, 0]
    assert len({volume(g).dims for g in set(shapes)}) == 3
    assert all(r.expired() for refs in stored[:3] for r in refs)
    assert not any(r.expired() for refs in stored[3:] for r in refs)
    assert stand_in[model].running.volume[0][0] == tuple(vol.values.shape)
    vol_e = run_session(eager_step(model, cfg, opts, (8, 16)), volume(shapes[-1]), batches)[1]
    assert torch.equal(vol.values, vol_e.values) and torch.equal(vol.weights, vol_e.weights)


def test_new_weights_drop_the_forward_graphs(stand_in):
    """A step reads the weights' key once, at its first graphed frame; a
    step made after the weights change captures the forward anew, and the
    forward's graphs of the old weights are dropped."""
    opts, model, ds, cfg, batches = tiny_session_inputs()
    batches = batches[:4]

    def session():
        step = incremental.make_step(model, cfg, 8, 16, opts.raycast_samples,
                                     opts.fusion_max_depth, opts=opts)
        before = counter("runner.graph_captures")
        run_session(step, common.make_fuser(opts, ds, "synth0", "cpu")[0], batches)
        return counter("runner.graph_captures") - before

    assert session() == 4
    assert session() == 0
    old = dict(stand_in[model].on_weights)
    with torch.no_grad():
        next(model.parameters()).add_(0.0)   # a new version of the same storage
    assert session() == 2
    assert len(stand_in[model].on_weights) == len(old) == 2
    assert not set(stand_in[model].on_weights.values()) & set(old.values())


class CountingGraph:
    """A captured graph whose replays only count."""

    replays = 0

    def replay(self):
        CountingGraph.replays += 1

    @staticmethod
    def record(fn, inputs, pool):
        return CountingGraph(), fn(*inputs)


def test_capture_takes_back_its_launches_and_replays_add_them(monkeypatch):
    """A capture counts no kernel launch (nothing runs then) and reads its
    arguments' storage, the caller's tensors moving to copies of their
    own; each replay copies new arguments in, adds the launches its stage
    issues, and hands back copies of the outputs."""
    monkeypatch.setattr(graphs, "_record", CountingGraph.record)

    def stage(x):
        tracing.count("test.kernel.launches", 2)
        return {"y": x * 2}

    launches = counter("test.kernel.launches")
    captures = counter("runner.graph_captures")
    x = torch.arange(4.0)
    storage = x.untyped_storage().data_ptr()
    g = graphs.capture(stage, (x,), None)
    assert counter("test.kernel.launches") == launches
    assert counter("runner.graph_captures") == captures + 1
    assert g.launches == {"test.kernel.launches": 2}
    assert g.inputs[0].untyped_storage().data_ptr() == storage
    assert x.untyped_storage().data_ptr() != storage and torch.equal(x, torch.arange(4.0))
    replays = CountingGraph.replays
    out = g(torch.full((4,), 5.0))
    assert torch.equal(g.inputs[0], torch.full((4,), 5.0))
    assert torch.equal(x, torch.arange(4.0))
    assert out["y"].untyped_storage().data_ptr() != g.outputs["y"].untyped_storage().data_ptr()
    g(x)
    assert counter("test.kernel.launches") == launches + 4
    assert CountingGraph.replays == replays + 2


def test_an_argument_held_twice_gets_two_static_inputs(monkeypatch):
    """A capture whose arguments hold one tensor in two places (as an
    empty hint holds its zeros) gives each place a static input of its
    own, so a later call with two different tensors there reads both."""
    monkeypatch.setattr(graphs, "_record", StandInGraph.record)
    zero = torch.zeros(4)
    g = graphs.capture(lambda h: {"y": h["a"] * 2 + h["b"]}, ({"a": zero, "b": zero},), None)
    a, b = graphs.tensors(g.inputs)
    assert a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr()
    g({"a": zero, "b": zero})
    out = g({"a": torch.full((4,), 1.0), "b": torch.full((4,), 5.0)})
    assert torch.equal(out["y"], torch.full((4,), 7.0))


def test_a_capture_keeps_no_caller_tensor_alive(monkeypatch):
    """A capture's static inputs share its arguments' storage but are not
    views of them: once the caller drops a tensor it passed (moved to a
    copy at the capture), nothing keeps that tensor or its copy alive."""
    monkeypatch.setattr(graphs, "_record", CountingGraph.record)
    x = torch.arange(4.0)
    storage = x.untyped_storage().data_ptr()
    g = graphs.capture(lambda t: {"y": t * 2}, (x,), None)
    moved = weakref.ref(x)
    del x
    gc.collect()
    assert moved() is None
    assert g.inputs[0]._base is None and g.inputs[0].untyped_storage().data_ptr() == storage


HINT_MAX_DEPTH = offline_two_pass.HINT_MAX_DEPTH


def offline_inputs(num_frames=14, settings=None, size=(32, 64)):
    """A model, its options at batch 2 and a synthetic scan of
    ``num_frames`` frames (the tiny model's 3-view tuples: 2 fewer)."""
    opts = options(dict(TINY, batch_size=2) if settings is None else settings, "cpu")
    model = common.init_or_load_params(opts, common.build_model(opts))
    views = opts.model_num_views
    ds = SyntheticDataset(split="test", image_height=size[0], image_width=size[1],
                          tuple_size=views, num_images_in_tuple=views, num_frames=num_frames)
    return opts, model, ds


def offline_batches(opts, ds, device="cpu"):
    """The scan's (cur, src) batches on ``device``, as the loader gives them."""
    loader = DataLoader(ds, batch_size=opts.batch_size, shuffle=False, num_workers=0)
    return [common.device_batch(cur_np, src_np, device) for cur_np, src_np in loader]


def eager_hint_volume(opts, model, ds, batches, device="cpu"):
    """Pass 1 as it ran before it graphed: the forward with an empty hint
    at the image's size, each depth fused in turn."""
    tsdf, cfg = common.make_hint_fuser(opts, ds, "synth0", device)
    with torch.no_grad():
        for cur, src in batches:
            b, h, w = cur["image_bhw3"].shape[:3]
            out = model(cur, src, hint=common.empty_hint(b, h, w, device), return_mask=True)
            for i in range(b):
                tsdf_mod.integrate_depth(tsdf, out["depth_pred_s0_bhw1"][i],
                                         cur["cam_T_world_b44"][i], cur["K_s0_b44"][i], cfg)
    return tsdf


def eager_pass2(model, static, batches, hint_hw, samples):
    """Pass 2's step as it ran before it graphed, over ``batches``."""
    kept = []
    with torch.no_grad():
        for cur, src in batches:
            hint = common.render_hint(static, cur, *hint_hw, samples, HINT_MAX_DEPTH)
            model_cur = {k: v for k, v in cur.items() if k != "hint_world_T_cam_b44"}
            kept.append((model(model_cur, src, hint=hint, return_mask=True), hint))
    return kept


def offline_session(opts, model, ds, batches, hint_hw, device="cpu"):
    """One scan through the runner's passes: (hint volume, each pass-2
    batch's (out, hint) as handed back, the static volume)."""
    vol = offline_two_pass.compute_hint_volume(opts, model, ds, "synth0", torch.device(device))
    step = offline_two_pass.make_pass2_step(model, *hint_hw, opts.raycast_samples,
                                            HINT_MAX_DEPTH)
    static = tsdf_mod.prepare_static(vol)
    return vol, [step(static, cur, src) for cur, src in batches], static


def counted(fn):
    """(fn(), the captures and the replays it made)."""
    before = counter("runner.graph_captures"), counter("runner.graph_replays")
    out = fn()
    return out, (counter("runner.graph_captures") - before[0],
                 counter("runner.graph_replays") - before[1])


def test_graphed_offline_passes_hand_back_their_own_tensors(stand_in):
    """Two sessions of pass 1 and pass 2 at batch 2 through the graph path
    with a stand-in graph. The forward is captured at pass 1's second
    batch and serves both passes; pass 2's raycast at its second batch;
    the second session captures nothing and replays each pass's forward
    and pass 2's raycast once a batch. Hint volumes, depths and hints
    equal the eager passes' bit for bit, and every batch's returned
    tensors, kept to the end, still hold their own batch's values."""
    opts, model, ds = offline_inputs()
    batches = offline_batches(opts, ds)
    n = len(batches)
    assert n == 6 and all(cur["image_bhw3"].shape[0] == 2 for cur, _ in batches)
    for session in range(2):
        (vol_g, kept_g, static_g), made = counted(
            lambda: offline_session(opts, model, ds, batches, (8, 16)))
        vol_e = eager_hint_volume(opts, model, ds, batches)
        assert same(vol_g.values, vol_e.values) and same(vol_g.weights, vol_e.weights)
        static_e = tsdf_mod.prepare_static(vol_e)
        assert same(static_g.values, static_e.values)
        kept_e = eager_pass2(model, static_e, batches, (8, 16), opts.raycast_samples)
        assert_same(kept_g, kept_e)
        assert any(bool(h["hint_mask_bhw1"].any()) for _, h in kept_g)
        held = {t.untyped_storage().data_ptr() for t in graph_outputs(stand_in[model])}
        for out, hint in kept_g:
            assert out["depth_pred_s0_bhw1"].untyped_storage().data_ptr() not in held
            assert hint["hint_mask_bhw1"].untyped_storage().data_ptr() not in held
        if session == 0:   # pass 1's first forward and pass 2's first raycast run eagerly
            assert made == (2, (n - 1) + n + (n - 1))
        else:
            assert made == (0, n + 2 * n)
    assert len(stand_in[model].on_weights) == 1 and len(stand_in[model].static.graphs) == 1


def test_smaller_last_batch_runs_eagerly_until_its_shape_comes_back(stand_in):
    """11 tuples at batch 2: pass 1's last batch of 1 runs eagerly; pass 2
    captures its forward, the shape's second use, and runs its raycast
    eagerly, a first use. Both passes equal the eager ones bit for bit."""
    opts, model, ds = offline_inputs(num_frames=13)
    batches = offline_batches(opts, ds)
    assert [cur["image_bhw3"].shape[0] for cur, _ in batches] == [2] * 5 + [1]
    vol_g, made = counted(lambda: offline_two_pass.compute_hint_volume(
        opts, model, ds, "synth0", torch.device("cpu")))
    assert made == (1, 4)
    vol_e = eager_hint_volume(opts, model, ds, batches)
    assert same(vol_g.values, vol_e.values) and same(vol_g.weights, vol_e.weights)
    step = offline_two_pass.make_pass2_step(model, 8, 16, opts.raycast_samples, HINT_MAX_DEPTH)
    static = tsdf_mod.prepare_static(vol_g)
    kept_g, made = counted(lambda: [step(static, cur, src) for cur, src in batches])
    # the raycast at batch 2 and the forward of 1; replays: 6 forwards, 4 raycasts
    assert made == (2, 10)
    assert_same(kept_g, eager_pass2(model, tsdf_mod.prepare_static(vol_e), batches, (8, 16),
                                    opts.raycast_samples))


def test_revisit_poses_get_their_own_raycast(stand_in):
    """A batch with ``hint_world_T_cam_b44`` (the revisit runner's poses in
    the volume's world frame) raycasts under a key of its own, eager at its
    first use and captured at its second, while the forward replays the
    graph it shares with the batches without; the hints are raycast at
    those poses, equal to the eager step's bit for bit."""
    opts, model, ds = offline_inputs()
    batches = offline_batches(opts, ds)
    vol, _, static = offline_session(opts, model, ds, batches, (8, 16))
    shift = torch.eye(4)
    shift[0, 3] = 0.1
    moved = [(dict(cur, hint_world_T_cam_b44=shift @ cur["world_T_cam_b44"]), src)
             for cur, src in batches[:3]]
    stages = stand_in[model]
    forwards, raycasts = set(stages.on_weights), len(stages.static.graphs)
    step = offline_two_pass.make_pass2_step(model, 8, 16, opts.raycast_samples, HINT_MAX_DEPTH)
    kept_g, made = counted(lambda: [step(static, cur, src) for cur, src in moved])
    assert made == (1, 3 + 2)
    assert set(stages.on_weights) == forwards and len(stages.static.graphs) == raycasts + 1
    kept_e = eager_pass2(model, tsdf_mod.prepare_static(vol), moved, (8, 16),
                         opts.raycast_samples)
    assert_same(kept_g, kept_e)
    plain = eager_pass2(model, tsdf_mod.prepare_static(vol), batches[:3], (8, 16),
                        opts.raycast_samples)
    assert not all(same(g[1]["depth_hint_bhw1"], p[1]["depth_hint_bhw1"])
                   for g, p in zip(kept_g, plain))


def test_pass2_raycasts_share_one_static_volume(stand_in):
    """Pass 2 over two sessions at batch 2, with a smaller last batch and
    revisit poses, through the graph path with a stand-in graph: the
    raycasts of all three keys read the model's one static-volume slot.
    The only volume-sized tensors that the graphs and slots hold are that
    slot's values and weights; the second session's volume, of the same
    shape but other values, is copied in and its own storage released; the
    hints equal the eager step's bit for bit. A volume of another shape
    then takes the slot, and the old shape's raycasts and storage go."""
    opts, model, ds = offline_inputs(num_frames=13)
    batches = offline_batches(opts, ds)
    assert [cur["image_bhw3"].shape[0] for cur, _ in batches] == [2] * 5 + [1]
    shift = torch.eye(4)
    shift[0, 3] = 0.1
    batches += [(dict(cur, hint_world_T_cam_b44=shift @ cur["world_T_cam_b44"]), src)
                for cur, src in batches[:2]]
    # two hint volumes of one shape: the scan's, and its first three batches'
    vols = [eager_hint_volume(opts, model, ds, batches[:6]),
            eager_hint_volume(opts, model, ds, batches[:3])]
    assert not same(vols[0].values, vols[1].values)
    step = offline_two_pass.make_pass2_step(model, 8, 16, opts.raycast_samples, HINT_MAX_DEPTH)

    def storage(t):
        return t.untyped_storage().data_ptr()

    slot_at = first = None
    for vol in vols:
        static = tsdf_mod.prepare_static(vol)
        first = first or weakref.ref(static.values)
        own = [StorageWeakRef(t.untyped_storage()) for t in (static.values, static.weights)]
        kept_g = [step(static, cur, src) for cur, src in batches]
        assert_same(kept_g, eager_pass2(model, tsdf_mod.prepare_static(vol), batches, (8, 16),
                                        opts.raycast_samples))
        assert any(bool(h["hint_mask_bhw1"].any()) for _, h in kept_g)
        slot = stand_in[model].static
        slot_at = slot_at or [storage(t) for t in slot.volume[1]]
        assert [storage(t) for t in slot.volume[1]] == slot_at
        assert [storage(static.values), storage(static.weights)] == slot_at
    gc.collect()
    assert all(r.expired() for r in own)
    assert first() is None   # the first session's tensors, not only their storage, are let go
    assert len(slot.graphs) == 3   # batch 2, batch 1, batch 2 at the revisit poses
    held = [t for g in all_graphs(stand_in[model])
            for t in graphs.tensors(g.inputs) + graphs.tensors(g.outputs)]
    held += graphs.tensors([s.volume[1] for s in (slot, stand_in[model].running) if s.volume])
    assert {storage(t) for t in held if t.numel() >= static.values.numel()} == set(slot_at)

    bounds = common.scene_bounds_for_fusion(ds, "synth0")
    bounds["xmax"] += tsdf_mod.VOX_MOD * 0.04
    other = tsdf_mod.prepare_static(tsdf_mod.TSDF.from_bounds(bounds, 0.04))
    old = [StorageWeakRef(t.untyped_storage()) for t in slot.volume[1]]
    kept_g = [step(other, cur, src) for cur, src in batches[:2]]
    assert_same(kept_g, eager_pass2(model, other, batches[:2], (8, 16), opts.raycast_samples))
    assert [storage(t) for t in slot.volume[1]] == [storage(other.values),
                                                    storage(other.weights)]
    assert len(slot.graphs) == 1
    del static, held
    gc.collect()
    assert all(r.expired() for r in old)


def test_offline_passes_on_the_cpu_and_in_training_run_eagerly():
    """On the CPU both passes run eagerly, capture and replay nothing, and
    equal the passes as they ran before; a model in training mode gets no
    graphs, whatever the device."""
    opts, model, ds = offline_inputs()
    batches = offline_batches(opts, ds)
    (vol, kept, _), made = counted(lambda: offline_session(opts, model, ds, batches, (8, 16)))
    assert made == (0, 0) and model not in graphs._stages
    vol_e = eager_hint_volume(opts, model, ds, batches)
    assert same(vol.values, vol_e.values) and same(vol.weights, vol_e.weights)
    assert_same(kept, eager_pass2(model, tsdf_mod.prepare_static(vol_e), batches, (8, 16),
                                  opts.raycast_samples))
    model.train()
    assert offline_two_pass.make_forward(model, torch.device("cuda"))[0] is None
    assert graphs.stages(model, torch.device("cuda")) is None and model not in graphs._stages


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs")
    return torch.device("cuda")


def traced_kernels(fn, path):
    """``fn()`` under the profiler; {name: launches} of the device kernels
    it ran, as the trace records them (one per kernel node a replay runs)."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    return Counter(e["name"] for e in events if e.get("cat") == "kernel")


def launched(kernels, name):
    return sum(n for k, n in kernels.items() if name in k)


@pytest.mark.card
def test_graphed_step_on_the_card(cuda, tmp_path):
    """On the card, the flagship model at half size: a 40-frame session and
    then a second on a fresh volume, the step's graphs against the stages
    called eagerly. Depths, hints and volumes are equal bit for bit; the
    second session captures nothing; K1 and K2 count one launch a frame,
    and in the second session, all replays, the device trace shows K1's and
    K2's kernels run once a frame too."""
    opts = options(FLAGSHIP, "cuda")
    common.resolve_device(opts)
    model = common.init_or_load_params(opts, common.build_model(opts)).eval()
    ds = SyntheticDataset(split="test", image_height=192, image_width=256,
                          num_frames=47, pass_frame_id=True)
    assert len(ds) == 40
    batches = session_inputs(ds, cuda)
    hint_hw = (48, 64)
    cfg = common.make_fuser(opts, ds, "synth0", cuda)[1]
    step = incremental.make_step(model, cfg, *hint_hw, opts.raycast_samples,
                                 opts.fusion_max_depth, opts=opts)
    eager = eager_step(model, cfg, opts, hint_hw)
    firsts = []
    for session in range(2):
        vol_g, _ = common.make_fuser(opts, ds, "synth0", cuda)
        vol_e, _ = common.make_fuser(opts, ds, "synth0", cuda)
        captures = counter("runner.graph_captures")
        k1, k2 = counter("ops.fused_volume.launches"), counter("ops.integrate.launches")
        if session == 0:
            kept_g, vol_g = run_session(step, vol_g, batches)
            torch.cuda.synchronize()
        else:
            ran = {}
            kernels = traced_kernels(
                lambda: ran.update(zip(("kept", "vol"), run_session(step, vol_g, batches))),
                tmp_path / "trace.json")
            kept_g, vol_g = ran["kept"], ran["vol"]
            assert launched(kernels, "fused_volume_kernel") == len(batches)
            assert launched(kernels, "integrate_kernel") == len(batches)
        assert counter("ops.fused_volume.launches") - k1 == len(batches)
        assert counter("ops.integrate.launches") - k2 == len(batches)
        kept_e, vol_e = run_session(eager, vol_e, batches)
        torch.cuda.synchronize()
        assert_same(kept_g, kept_e)
        assert torch.equal(vol_g.values, vol_e.values)
        assert torch.equal(vol_g.weights, vol_e.weights)
        assert any(bool(h["hint_mask_bhw1"].any()) for _, h in kept_g)
        if session == 0:
            assert counter("runner.graph_captures") > captures
            firsts = [vol_g, vol_g.values.clone(), vol_g.weights.clone()]
        else:
            assert counter("runner.graph_captures") == captures
            assert torch.equal(firsts[0].values, firsts[1])
            assert torch.equal(firsts[0].weights, firsts[2])


@pytest.mark.card
def test_graphed_offline_passes_on_the_card(cuda, tmp_path):
    """On the card, the flagship model at half size and batch 4: two
    sessions of both passes over a 40-tuple scan, graphed against the
    passes as they ran eagerly. Hint volumes, pass-2 depths and hints are
    equal bit for bit; the second session captures nothing; K1 counts one
    launch a batch in each pass, and in the second session, all replays,
    the device trace shows K1's kernel run once a batch in each pass too,
    and K2's once a frame (pass 1's fuses)."""
    opts, model, ds = offline_inputs(num_frames=47, settings=dict(FLAGSHIP, batch_size=4),
                                     size=(192, 256))
    opts.device = "cuda"
    common.resolve_device(opts)
    model = model.to(cuda).eval()
    batches = offline_batches(opts, ds, cuda)
    n = len(batches)
    assert n == 10 and len(ds) == 40
    hint_hw = (48, 64)
    for session in range(2):
        k1, k2 = counter("ops.fused_volume.launches"), counter("ops.integrate.launches")
        captures = counter("runner.graph_captures")
        if session == 0:
            vol_g, kept_g, _ = offline_session(opts, model, ds, batches, hint_hw, cuda)
            torch.cuda.synchronize()
        else:
            ran = {}
            kernels = traced_kernels(
                lambda: ran.update(zip(("vol", "kept", "static"), offline_session(
                    opts, model, ds, batches, hint_hw, cuda))), tmp_path / "trace.json")
            vol_g, kept_g = ran["vol"], ran["kept"]
            assert launched(kernels, "fused_volume_kernel") == 2 * n
            assert launched(kernels, "integrate_kernel") == len(ds)
        assert counter("ops.fused_volume.launches") - k1 == 2 * n
        assert counter("ops.integrate.launches") - k2 == len(ds)
        made = counter("runner.graph_captures") - captures
        assert made == (2 if session == 0 else 0)
        vol_e = eager_hint_volume(opts, model, ds, batches, cuda)
        kept_e = eager_pass2(model, tsdf_mod.prepare_static(vol_e), batches, hint_hw,
                             opts.raycast_samples)
        torch.cuda.synchronize()
        assert same(vol_g.values, vol_e.values) and same(vol_g.weights, vol_e.weights)
        assert_same(kept_g, kept_e)
        assert any(bool(h["hint_mask_bhw1"].any()) for _, h in kept_g)
