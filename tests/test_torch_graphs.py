"""The online step as CUDA graph replays (``runners.graphs``,
``runners.incremental.make_step``) and the constants that let a graph
capture it (``utils.geometry.device_constant``).

On the CPU: the constants equal what the step built before, bit for bit,
and are built once; the eager step is the three stages called in turn; the
graphed step's own code (its keys, the volume's slot, the copies in and out
of the static buffers, the counters) runs with a stand-in for the CUDA
graph that replays the captured stage on the static inputs, and matches the
eager step bit for bit while its returned tensors outlive later frames.

No JAX here: the card's test runs on the card with
``python -m pytest tests/test_torch_graphs.py -m card --noconftest``.
"""

from __future__ import annotations

import gc
import json
from collections import Counter, OrderedDict

import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.profiler import ProfilerActivity, profile

from doubletake_tpu_torch.data.loader import collate
from doubletake_tpu_torch.datasets.synthetic import SyntheticDataset
from doubletake_tpu_torch.models.cost_volume import generate_depth_planes
from doubletake_tpu_torch.ops.resize import interpolate_nearest
from doubletake_tpu_torch.options import Options
from doubletake_tpu_torch.runners import common, graphs, incremental
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
    return [t for g in [*stages.on_volume.values(), *stages.on_weights.values()]
            if g is not None for t in graphs.tensors(g.outputs)]


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
    assert stand_in[model].volume[0][0] == tuple(vol.values.shape)
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
