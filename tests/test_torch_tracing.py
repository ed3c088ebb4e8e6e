"""The port's tracing module (``utils/tracing.py``): spans are recorded only
while a profiler records on the calling thread, nest by parent and root,
land in the profiler's trace, and stop at the cap; the runners' steps,
pass 1, the loader and the model open the spans the benchmark's readers
and breakdown read; ``StageClock`` is still the runners' clock."""

import json
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from doubletake_tpu_torch.data.loader import DataLoader
from doubletake_tpu_torch.datasets.synthetic import SyntheticDataset
from doubletake_tpu_torch.options import Options
from doubletake_tpu_torch.runners import common, incremental, offline_two_pass
from doubletake_tpu_torch.utils import tracing

TINY = dict(
    dataset="synthetic", image_width=64, image_height=32, image_encoder_name="tiny",
    matching_encoder_type="tiny", depth_decoder_name="skip",
    model_type="cv_hint_depth_model", feature_volume_type="mlp_mesh_hint_feature_volume",
    matching_num_depth_bins=8, plane_chunk=8, model_num_views=2, batch_size=2,
    raycast_samples=64, num_workers=1, fusion_resolution=0.04,
    extended_neg_truncation=True, fast_cost_volume=True, device="cpu",
)
MODEL_SPANS = ("model.image_encoder", "model.matching_encoder", "model.cost_volume",
               "model.cv_encoder", "model.decoder")


@pytest.fixture(autouse=True)
def fresh_records():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    tracing.clear()
    yield
    tracing.clear()
    torch.set_num_threads(n)


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def tiny():
    opts = Options()
    for k, v in TINY.items():
        setattr(opts, k, v)
    model = common.init_or_load_params(opts, common.build_model(opts))
    ds = SyntheticDataset(split="test", image_height=32, image_width=64, tuple_size=2,
                          num_images_in_tuple=2, num_frames=3, pass_frame_id=True)
    assert len(ds) == 2
    return opts, model, ds


def closed(recs):
    assert all(r.end_ns >= r.start_ns > 0 for r in recs)
    return recs


def children(recs, i):
    return [r.name for r in recs if r.parent == i]


def test_span_off_makes_no_record_and_opens_no_range(monkeypatch):
    def no_range(name):
        raise AssertionError(f"a range {name!r} was opened with the profiler off")

    monkeypatch.setattr(tracing, "record_function", no_range)
    with tracing.span("runner.step"):
        with tracing.span("model.decoder"):
            pass
    assert tracing.records() == [] and tracing.dropped() == 0


def test_nested_spans_record_parents_roots_and_reach_the_trace(tmp_path):
    with cpu_profile() as prof:
        with tracing.span("runner.step"):
            with tracing.span("model.decoder"):
                torch.ones(3).sum()
            with tracing.span("ops.integrate"):
                pass
        with tracing.span("data.loader_wait"):
            pass
    recs = closed(tracing.records())
    assert [(r.name, r.parent, r.root) for r in recs] == [
        ("runner.step", -1, 0), ("model.decoder", 0, 0), ("ops.integrate", 0, 0),
        ("data.loader_wait", -1, 3)]
    step, decoder, integrate, _ = recs
    assert step.start_ns <= decoder.start_ns <= decoder.end_ns <= integrate.start_ns
    assert integrate.end_ns <= step.end_ns
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {r.name for r in recs} <= names


def test_spans_follow_the_calling_threads_profiler():
    with cpu_profile():
        worker = threading.Thread(target=lambda: tracing.span("data.loader_wait").__enter__())
        worker.start()
        worker.join(timeout=10)
        assert not worker.is_alive()
    assert tracing.records() == []


def test_record_cap_holds_and_counts_drops(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_RECORDS", 3)
    with cpu_profile():
        for _ in range(5):
            with tracing.span("runner.device_batch"):
                pass
    assert len(closed(tracing.records())) == 3 and tracing.dropped() == 2
    tracing.clear()
    assert tracing.records() == [] and tracing.dropped() == 0


def test_counters_count():
    before = tracing.counters().get("test.counted", 0)
    tracing.count("test.counted")
    tracing.count("test.counted", 4)
    assert tracing.counters()["test.counted"] == before + 5


def test_incremental_frame_spans():
    """One frame as the online loop runs it: the loader's wait, the copy to
    the device, then the step with the raycast, the model's five stages
    (K1's wrapper inside the cost volume) and the fuse (K2's wrapper
    inside)."""
    opts, model, ds = tiny()
    tsdf, cfg = common.make_fuser(opts, ds, "synth0", "cpu")
    step = incremental.make_step(model, cfg, 8, 16, 64, opts.fusion_max_depth, opts=opts)
    batches = iter(DataLoader(ds, batch_size=1, num_workers=1))
    try:
        with cpu_profile():
            cur_np, src_np = next(batches)
            cur, src = common.device_batch(cur_np, src_np, "cpu")
            step(tsdf, cur, src, clock=common.StageClock("cpu"))
    finally:
        batches.close()
    recs = closed(tracing.records())
    roots = [r.name for r in recs if r.parent == -1]
    assert roots == ["data.loader_wait", "runner.device_batch", "runner.step"]
    i = [r.name for r in recs].index("runner.step")
    assert children(recs, i) == ["tsdf.raycast", *MODEL_SPANS, "tsdf.integrate"]
    assert all(r.root == i for r in recs[i:])
    by_name = {r.name: k for k, r in enumerate(recs)}
    assert children(recs, by_name["model.cost_volume"]) == ["ops.fused_volume"]
    assert children(recs, by_name["tsdf.integrate"]) == ["ops.integrate"]


def test_pass1_batch_spans():
    """One batch of pass 1 on a two-tuple scan: the loader's waits outside,
    the batch's copy, forward and fuses under one root."""
    opts, model, ds = tiny()
    with cpu_profile():
        offline_two_pass.compute_hint_volume(opts, model, ds, "synth0", torch.device("cpu"))
    recs = closed(tracing.records())
    roots = [r.name for r in recs if r.parent == -1]
    assert roots == ["data.loader_wait", "runner.pass1_batch", "data.loader_wait"]
    i = [r.name for r in recs].index("runner.pass1_batch")
    assert children(recs, i) == ["runner.device_batch", *MODEL_SPANS, "tsdf.integrate",
                                 "tsdf.integrate"]
    inside = [r for r in recs if r.root == i]
    assert [r.name for r in inside].count("ops.integrate") == 2
    assert [r.name for r in inside].count("ops.fused_volume") == 1


def test_stage_clock_is_the_runners():
    assert common.StageClock is tracing.StageClock
