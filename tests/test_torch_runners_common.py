"""The port's shared runner pieces against the JAX package's, on the CPU:
the lazy (tolerant) weight load, the hint-volume fuser, and the options the
port refuses instead of ignoring.

Lazy load: a JAX npz of another initialisation with one layer's shape
changed is merged over the same starting weights by both packages; every
entry of the port's state dict must equal the bridge's conversion of the
JAX merge, bit for bit.
"""

import numpy as np
import pytest
import torch

import jax

from doubletake_tpu.checkpoints.io import lazy_load_params, load_params, save_params
from doubletake_tpu.data.loader import collate
from doubletake_tpu.datasets.synthetic import SyntheticDataset
from doubletake_tpu.options import Options as JaxOptions
from doubletake_tpu.runners import common as jcommon

from doubletake_tpu_torch.checkpoints.convert import (
    lazy_load_state_dict,
    load_weights,
    variables_to_state_dict,
)
from doubletake_tpu_torch.options import Options
from doubletake_tpu_torch.runners import common, incremental, no_hint, offline_two_pass, revisit

TINY = dict(
    dataset="synthetic", image_width=64, image_height=32, image_encoder_name="tiny",
    matching_encoder_type="tiny", depth_decoder_name="skip",
    model_type="cv_hint_depth_model", feature_volume_type="mlp_mesh_hint_feature_volume",
    matching_num_depth_bins=8, plane_chunk=8, model_num_views=2, batch_size=2,
    raycast_samples=64, num_workers=0, fusion_resolution=0.04,
    extended_neg_truncation=True, fast_cost_volume=True,
)


@pytest.fixture(autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def options(cls, **extra):
    o = cls()
    for k, v in {**TINY, **extra}.items():
        setattr(o, k, v)
    return o


def test_lazy_load_matches_jax(tmp_path):
    jopts = options(JaxOptions)
    ds = SyntheticDataset(split="test", image_height=32, image_width=64, tuple_size=2,
                          num_images_in_tuple=2, num_frames=4)
    cur, src = jcommon.device_batch(*collate([ds[0]]))
    jmodel = jcommon.build_model(jopts)
    init = jax.jit(jmodel.init)
    start = jax.device_get(init(jax.random.PRNGKey(0), cur, src))
    ckpt = jax.device_get(init(jax.random.PRNGKey(1), cur, src))
    kernel = ckpt["params"]["matching_model"]["conv1"]["kernel"]
    ckpt["params"]["matching_model"]["conv1"]["kernel"] = np.concatenate(
        [kernel, kernel[..., :1]], -1)                       # one more output channel
    path = str(tmp_path / "ckpt.npz")
    save_params(path, ckpt)
    expected = variables_to_state_dict(lazy_load_params(start, load_params(path)))

    model = common.build_model(options(Options, device="cpu"))
    model.load_state_dict(variables_to_state_dict(start))
    kept = lazy_load_state_dict(model, load_weights(path))
    assert kept == ["matching_model.conv1.weight"]
    got = model.state_dict()
    assert set(got) == set(expected)
    for name, value in expected.items():
        assert torch.equal(got[name], value), name
    assert not torch.equal(got["matching_model.conv0.weight"],
                           variables_to_state_dict(start)["matching_model.conv0.weight"])

    # through the option: the checkpoint's matching entries over the seeded
    # initialisation, which the mismatched layer keeps
    fresh = common.init_or_load_params(options(Options, device="cpu"),
                                       common.build_model(options(Options, device="cpu")))
    lazy = common.init_or_load_params(
        options(Options, device="cpu", lazy_load_weights_from_checkpoint=path),
        common.build_model(options(Options, device="cpu")))
    for name, value in lazy.state_dict().items():
        want = fresh.state_dict()[name] if name in kept else expected[name]
        assert torch.equal(value, want), name


def test_hint_fuser_matches_jax():
    ds = SyntheticDataset(split="test", image_height=32, image_width=64, num_frames=4)
    jtsdf, jcfg = jcommon.make_hint_fuser(options(JaxOptions), ds, "synth0")
    ptsdf, pcfg = common.make_hint_fuser(options(Options, device="cpu"), ds, "synth0", "cpu")
    assert ptsdf.dims == tuple(jtsdf.dims) and ptsdf.voxel_size == jtsdf.voxel_size == 0.04
    np.testing.assert_array_equal(ptsdf.origin.numpy(), np.asarray(jtsdf.origin))
    assert (pcfg.min_depth, pcfg.max_depth, pcfg.extended_neg_truncation) == \
        (jcfg.min_depth, jcfg.max_depth, jcfg.extended_neg_truncation) == (0.5, 3.0, True)


@pytest.mark.parametrize("runner", [incremental, no_hint, offline_two_pass, revisit],
                         ids=lambda m: m.__name__.split(".")[-1])
def test_depth_visualization_is_not_ported_yet(runner, tmp_path):
    o = options(Options, device="cpu", dump_depth_visualization=True,
                output_base_path=str(tmp_path))
    with pytest.raises(ValueError, match="dump_depth_visualization is not ported yet"):
        runner.run(o)


@pytest.mark.parametrize("runner", [incremental, no_hint, offline_two_pass, revisit],
                         ids=lambda m: m.__name__.split(".")[-1])
def test_raycast_mip_is_not_ported_yet(runner, tmp_path):
    o = options(Options, device="cpu", raycast_mip=True, output_base_path=str(tmp_path))
    with pytest.raises(ValueError, match="raycast_mip is not ported yet"):
        runner.run(o)
