"""The weights bridge: JAX variables -> the port's ``state_dict``.

The port's modules carry the reference PyTorch state_dict names (the
layout ``doubletake_tpu/checkpoints/convert.py``:8-13 reads), so a reference
Lightning ``.ckpt`` loads as it is, and the JAX package's converter maps the
port's own ``state_dict`` back onto JAX variables. This module goes the
other way: ``variables_to_state_dict`` turns JAX ``{"params",
"batch_stats"}`` trees (numpy leaves) into tensors under the port's names,
for every ported module — including the Tiny encoders and the skip decoder,
which have no reference checkpoint.

Transforms: conv HWIO -> OIHW, dense (in, out) -> (out, in), batch norm
scale/bias + running stats -> weight/bias/running_mean/running_var.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from doubletake_tpu_torch.models.layers import blurpool_filter


class _Writer:
    """Accumulates state_dict entries from JAX subtrees."""

    def __init__(self, variables: Dict):
        self.params = variables.get("params", {})
        self.stats = variables.get("batch_stats", {})
        self.sd: Dict[str, torch.Tensor] = {}

    @staticmethod
    def _node(tree, path):
        for p in path:
            tree = tree[p]
        return tree

    def _put(self, key, arr):
        self.sd[key] = torch.from_numpy(np.array(arr, np.float32, order="C"))

    def conv(self, path, key):
        node = self._node(self.params, path)
        self._put(f"{key}.weight", np.asarray(node["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in node:
            self._put(f"{key}.bias", node["bias"])

    def dense(self, path, key):
        node = self._node(self.params, path)
        self._put(f"{key}.weight", np.asarray(node["kernel"]).T)
        self._put(f"{key}.bias", node["bias"])

    def bn(self, path, key):
        node = self._node(self.params, path)
        stats = self._node(self.stats, path)
        self._put(f"{key}.weight", node["scale"])
        self._put(f"{key}.bias", node["bias"])
        self._put(f"{key}.running_mean", stats["mean"])
        self._put(f"{key}.running_var", stats["var"])
        self.sd[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    def basic_block(self, path, key):
        """Norm-free BasicBlock: conv1, conv2, optional downsample.0."""
        node = self._node(self.params, path)
        self.conv(path + ("conv1",), f"{key}.conv1")
        self.conv(path + ("conv2",), f"{key}.conv2")
        if "downsample" in node:
            self.conv(path + ("downsample",), f"{key}.downsample.0")


def _effnetv2(w: _Writer):
    p, e = ("encoder",), "encoder"
    w.conv(p + ("conv_stem",), f"{e}.conv_stem")
    w.bn(p + ("bn1",), f"{e}.bn1")
    for name, node in w.params["encoder"].items():
        if not name.startswith("blocks_"):
            continue
        _, si, bi = name.split("_")
        src, dst = p + (name,), f"{e}.blocks.{si}.{bi}"
        if "conv" in node:                                  # ConvBnAct
            w.conv(src + ("conv",), f"{dst}.conv")
            w.bn(src + ("bn1",), f"{dst}.bn1")
        elif "conv_exp" in node:                            # EdgeResidual
            w.conv(src + ("conv_exp",), f"{dst}.conv_exp")
            w.bn(src + ("bn1",), f"{dst}.bn1")
            w.conv(src + ("conv_pwl",), f"{dst}.conv_pwl")
            w.bn(src + ("bn2",), f"{dst}.bn2")
        else:                                               # InvertedResidual
            w.conv(src + ("conv_pw",), f"{dst}.conv_pw")
            w.bn(src + ("bn1",), f"{dst}.bn1")
            w.conv(src + ("conv_dw",), f"{dst}.conv_dw")
            w.bn(src + ("bn2",), f"{dst}.bn2")
            w.conv(src + ("se", "conv_reduce"), f"{dst}.se.conv_reduce")
            w.conv(src + ("se", "conv_expand"), f"{dst}.se.conv_expand")
            w.conv(src + ("conv_pwl",), f"{dst}.conv_pwl")
            w.bn(src + ("bn3",), f"{dst}.bn3")


def _bn_basic_block(w: _Writer, path, key):
    """BN BasicBlock; the resnet-d shortcut as ``downsample.{1,2}``."""
    node = w._node(w.params, path)
    for name in ("conv1", "conv2"):
        w.conv(path + (name,), f"{key}.{name}")
    for name in ("bn1", "bn2"):
        w.bn(path + (name,), f"{key}.{name}")
    if "downsample_conv" in node:
        w.conv(path + ("downsample_conv",), f"{key}.downsample.1")
        w.bn(path + ("downsample_bn",), f"{key}.downsample.2")


def _resnet18d(w: _Writer):
    p = ("encoder",)
    for src, dst in (("conv1_0", "conv1.0"), ("conv1_1", "conv1.3"), ("conv1_2", "conv1.6")):
        w.conv(p + (src,), f"encoder.{dst}")
    for src, dst in (("bn1_0", "conv1.1"), ("bn1_1", "conv1.4"), ("bn1", "bn1")):
        w.bn(p + (src,), f"encoder.{dst}")
    for li in range(1, 5):
        for bi in range(2):
            _bn_basic_block(w, p + (f"layer{li}_{bi}",), f"encoder.layer{li}.{bi}")


def _unet_matching_encoder(w: _Writer):
    p, m = ("matching_model", "encoder"), "matching_model.encoder"
    w.conv(p + ("conv_stem",), f"{m}.conv_stem")
    w.bn(p + ("bn1",), f"{m}.bn1")
    for name, node in w.params["matching_model"]["encoder"].items():
        if not name.startswith("blocks_"):
            continue
        _, si, bi = name.split("_")
        convs = ("conv_dw", "conv_pw") if "conv_pwl" not in node else (
            "conv_pw", "conv_dw", "conv_pwl")
        for ci, conv_name in enumerate(convs):
            w.conv(p + (name, conv_name), f"{m}.blocks.{si}.{bi}.{conv_name}")
            w.bn(p + (name, f"bn{ci + 1}"), f"{m}.blocks.{si}.{bi}.bn{ci + 1}")
    for i in range(5):
        for src, dst in (("inner", "inner_blocks"), ("layer", "layer_blocks")):
            w.conv(("matching_model", "decoder", f"{src}_{i}"),
                   f"matching_model.decoder.{dst}.{i}.0")
    w.conv(("matching_model", "outconv"), "matching_model.outconv.1")


def _tiny_encoder(w: _Writer):
    for name in w.params["encoder"]:
        if name.startswith("conv"):
            si = name[len("conv"):]
            w.conv(("encoder", name), f"encoder.conv{si}")
            w.bn(("encoder", f"bn{si}"), f"encoder.bn{si}")


def _resnet_matching_encoder(w: _Writer):
    p, m = ("matching_model",), "matching_model.net"
    w.conv(p + ("conv1",), f"{m}.0")
    w.bn(p + ("bn1",), f"{m}.1")
    w.sd[f"{m}.3.1.filt"] = blurpool_filter(64)
    for bi in range(2):
        _bn_basic_block(w, p + (f"layer1_{bi}",), f"{m}.4.{bi}")
    w.conv(p + ("head_conv1",), f"{m}.5")
    w.conv(p + ("head_conv2",), f"{m}.8")


def _tiny_matching_encoder(w: _Writer):
    for name in ("conv0", "conv1"):
        w.conv(("matching_model", name), f"matching_model.{name}")


def _cost_volume(w: _Writer):
    for mlp in ("mlp", "hint_mlp"):
        node = w.params["cost_volume"].get(mlp)
        if node is None:
            continue
        for li in range(len(node)):
            w.dense(("cost_volume", mlp, f"linear_{li}"), f"cost_volume.{mlp}.net.{2 * li}")


def _cv_encoder(w: _Writer):
    for name in w.params["cost_volume_net"]:
        src = ("cost_volume_net", name)
        if name.startswith("ds_conv_"):
            w.basic_block(src, f"cost_volume_net.convs.{name}")
        else:                                               # conv_{i}_{j}
            _, i, j = name.split("_")
            w.basic_block(src, f"cost_volume_net.convs.conv_{i}.{j}")


def _depth_decoder_pp(w: _Writer):
    d = "depth_decoder.convs"
    for name, node in w.params["depth_decoder"].items():
        src = ("depth_decoder", name)
        if name.startswith("in_conv_"):
            w.basic_block(src + ("block0",), f"{d}.{name}.0")
            w.basic_block(src + ("block1",), f"{d}.{name}.conv_0")
        elif name.startswith("output_") and name.endswith("_block"):
            w.basic_block(src, f"{d}.output_{name.split('_')[1]}.0")
        elif name.startswith("output_") and name.endswith("_conv"):
            w.conv(src, f"{d}.output_{name.split('_')[1]}.1")
        else:                                               # diag/right/up convs
            w.basic_block(src, f"{d}.{name}")


def _skip_decoder(w: _Writer):
    for name in w.params["depth_decoder"]:
        src = ("depth_decoder", name)
        if name.startswith("block"):                        # block{bi}_{pre,post}
            bi, kind = name[len("block"):].split("_")
            stage = "pre_concat_conv" if kind == "pre" else "post_concat_conv"
            for c in ("conv1", "conv2"):
                w.conv(src + (c,), f"depth_decoder.block{bi}.{stage}.{c}")
        else:                                               # out{bi}
            for ci, idx in ((1, 0), (2, 2), (3, 4)):
                w.conv(src + (f"conv{ci}",), f"depth_decoder.{name}.{idx}")


def variables_to_state_dict(variables: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats"}`` (numpy leaves) -> the port's state_dict.

    Covers every module of the JAX package; a subtree it does not recognise
    raises.
    """
    w = _Writer(variables)
    params = w.params
    enc = params.get("encoder")
    if enc is not None:
        if "conv_stem" in enc:
            _effnetv2(w)
        elif "conv1_0" in enc:
            _resnet18d(w)
        elif "conv0" in enc:
            _tiny_encoder(w)
        else:
            raise ValueError("image encoder not recognised")
    mm = params.get("matching_model")
    if mm is not None:
        if "head_conv1" in mm:
            _resnet_matching_encoder(w)
        elif "encoder" in mm:
            _unet_matching_encoder(w)
        elif "conv0" in mm:
            _tiny_matching_encoder(w)
        else:
            raise ValueError("matching encoder not recognised")
    if "cost_volume" in params:
        _cost_volume(w)
    if "cost_volume_net" in params:
        _cv_encoder(w)
    dec = params.get("depth_decoder")
    if dec is not None:
        if "in_conv_04" in dec:
            _depth_decoder_pp(w)
        elif "block1_pre" in dec:
            _skip_decoder(w)
        else:
            raise ValueError("depth decoder not recognised")
    return w.sd


def load_npz_variables(path: str) -> Dict:
    """The nested variables tree from an npz that the JAX package's
    ``checkpoints/io.py`` ``save_params`` wrote ("params/a/b/kernel" keys)."""
    data = np.load(path)
    out: Dict = {}
    for name in data.files:
        parts = name.split("/")
        node = out
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = data[name]
    return out


def lazy_load_state_dict(model: torch.nn.Module, state_dict: Dict[str, torch.Tensor]):
    """Copy the entries of ``state_dict`` whose names and shapes match the
    model's over the model's own, in place, and keep the rest (the JAX
    package's ``checkpoints/io.py`` ``lazy_load_params``). Returns the names
    that were kept."""
    own = model.state_dict()
    matching = {k: v for k, v in state_dict.items()
                if k in own and tuple(own[k].shape) == tuple(v.shape)}
    model.load_state_dict(matching, strict=False)
    return sorted(set(own) - set(matching))


_OLD_FPN_KEY = re.compile(r"^(matching_model\.decoder\.(?:inner|layer)_blocks\.\d+)\.(weight|bias)$")


def _fpn_key(key: str) -> str:
    """torchvision before 0.13 stored the FPN's convs without the ``.0`` of
    ``Conv2dNormActivation``: the port's (newer) name for such a key."""
    return _OLD_FPN_KEY.sub(r"\1.0.\2", key)


def load_weights(path: str) -> Dict[str, torch.Tensor]:
    """A state_dict from a reference ``.ckpt``/``.pth`` (loaded as it is) or
    a JAX-package npz (through ``variables_to_state_dict``)."""
    if path.endswith((".ckpt", ".pth")):
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        sd = ckpt.get("state_dict", ckpt)
        return {_fpn_key(k): v for k, v in sd.items() if isinstance(v, torch.Tensor)}
    return variables_to_state_dict(load_npz_variables(path))
