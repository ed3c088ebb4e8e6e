"""Full depth-estimation models (torch.nn; NHWC tensors and dict keys at the
interface, as in ``doubletake_tpu.models.depth_model``).

  * ``DepthModel``        — SimpleRecon (reference:
    src/doubletake/experiment_modules/sr_depth_model.py:38-435);
  * ``DepthModelCVHint``  — DoubleTake: the same skeleton with the
    mesh-hint volume and a hint dict input (reference:
    src/doubletake/experiment_modules/doubletake_model.py:265-425).

Inference and training, in float32 or bf16 (``compute_dtype``: images are
cast to it at entry, weights are cast by ``runners.common`` or the train
step, outputs are float32). Train mode is the module's (``model.train()``):
batch norm then normalises with the batch's statistics, and the feature
volume takes its plain path. The horizontal-flip augmentation is a Python
bool ``flip``: images are flipped for the encoders, the matching features
flipped back for the plane sweep, the volume flipped again to align with
the flipped image features, and the outputs flipped back
(sr_depth_model.py:275-435 ordering).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from doubletake_tpu_torch.models.backbones import get_image_encoder, get_matching_encoder
from doubletake_tpu_torch.models.cost_volume import get_volume_class
from doubletake_tpu_torch.models.decoders import CVEncoder, DepthDecoderPP, SkipDecoderRegression
from doubletake_tpu_torch.utils.tracing import span


class DepthModel(nn.Module):
    """SimpleRecon-style MVS depth model; fields mirror the Options names."""

    def __init__(self, image_encoder_name: str = "efficientnet",
                 depth_decoder_name: str = "unet_pp",
                 feature_volume_type: str = "mlp_feature_volume",
                 matching_encoder_type: str = "resnet", matching_scale: int = 1,
                 matching_num_depth_bins: int = 64, matching_feature_dims: int = 16,
                 model_num_views: int = 8, min_matching_depth: float = 0.25,
                 max_matching_depth: float = 5.0, plane_chunk: int = 16,
                 fast_cost_volume: bool = False, compute_dtype: str = "float32"):
        super().__init__()
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {compute_dtype!r} is not ported")
        self.compute_dtype = getattr(torch, compute_dtype)
        self.matching_scale = matching_scale
        self.min_matching_depth = min_matching_depth
        self.max_matching_depth = max_matching_depth
        self.encoder = get_image_encoder(image_encoder_name)
        self.matching_model = get_matching_encoder(matching_encoder_type, matching_feature_dims)
        self.cost_volume = get_volume_class(feature_volume_type)(
            num_depth_bins=matching_num_depth_bins, num_views=model_num_views - 1,
            matching_feature_dims=matching_feature_dims, plane_chunk=plane_chunk,
            fast_cost_volume=fast_cost_volume,
        )
        enc_ch = list(self.encoder.feature_channels)
        cv_outs = (64, 128, 256, 384)
        self.cost_volume_net = CVEncoder(matching_num_depth_bins, enc_ch[matching_scale:], cv_outs)
        dec_in = enc_ch[:matching_scale] + list(cv_outs)
        if depth_decoder_name == "unet_pp":
            self.depth_decoder = DepthDecoderPP(dec_in)
        elif depth_decoder_name == "skip":
            self.depth_decoder = SkipDecoderRegression(dec_in)
        else:
            raise ValueError(f"Unknown decoder {depth_decoder_name}")

    def encode_frame(self, image_bhw3):
        """Image-only encoders of a (batch of) frame(s): the image-prior
        pyramid and the matching features, both NHWC. Neither depends on
        poses, source views or the hint, so sequential runners may run them
        ahead and feed them back through ``forward(cur_feats=...,
        cur_matching_feats=...)``."""
        img = image_bhw3.to(self.compute_dtype)
        return tuple(self.encoder(img)), self.matching_model(img)

    def forward(self, cur_data: Dict[str, Any], src_data: Dict[str, Any],
                return_mask: bool = False, hint: Optional[Dict[str, Any]] = None,
                src_matching_feats=None, cur_feats=None, cur_matching_feats=None,
                flip: bool = False, stop_after: Optional[str] = None):
        """cur_data: "image_bhw3", "cam_T_world_b44", "world_T_cam_b44",
        f"invK_s{matching_scale}_b44". src_data: "image_bkhw3",
        "cam_T_world_bk44", "world_T_cam_bk44", f"K_s{matching_scale}_bk44".
        src_matching_feats: optional (B, k, H/4, W/4, C) features of the src
        views in src_data's order (the sequential runners' feature cache).
        cur_feats / cur_matching_feats: optional ``encode_frame`` outputs.
        Both feature inputs are for unflipped inference passes only.
        flip: the horizontal-flip augmentation (module doc).
        stop_after: a profiling diagnostic: "cost_volume" returns right
        after the volume, "cv_encoder" after the CVEncoder.
        """
        dtype = self.compute_dtype
        cur_image = cur_data.get("image_bhw3")
        src_image = src_data.get("image_bkhw3")
        if cur_image is None:
            assert cur_feats is not None and cur_matching_feats is not None, (
                "cur_data lacks image_bhw3: cur_feats and cur_matching_feats must be "
                "precomputed (encode_frame)")
        else:
            cur_image = cur_image.to(dtype)
        if src_image is None:
            assert src_matching_feats is not None, (
                "src_data lacks image_bkhw3: src_matching_feats must be precomputed")
        else:
            src_image = src_image.to(dtype)
        src_K = src_data[f"K_s{self.matching_scale}_bk44"]
        cur_invK = cur_data[f"invK_s{self.matching_scale}_b44"]
        src_cam_T_cur_cam = torch.einsum(
            "bkij,bjl->bkil", src_data["cam_T_world_bk44"], cur_data["world_T_cam_b44"])
        cur_cam_T_src_cam = torch.einsum(
            "bij,bkjl->bkil", cur_data["cam_T_world_b44"], src_data["world_T_cam_bk44"])

        def flipped(x, dim):
            return x.flip(dim) if flip else x

        if cur_image is not None:
            cur_image = flipped(cur_image, 2)
        if src_image is not None:
            src_image = flipped(src_image, 3)
        with span("model.image_encoder"):
            if cur_feats is not None:
                assert not flip, "cur_feats is an inference input; flipped passes encode images"
                cur_feats = tuple(f.to(dtype) for f in cur_feats)
            else:
                cur_feats = self.encoder(cur_image)
        b, k = src_data["world_T_cam_bk44"].shape[:2]
        with span("model.matching_encoder"):
            if src_matching_feats is None and cur_matching_feats is None:
                all_images = torch.cat([cur_image[:, None], src_image], 1)
                all_feats = self.matching_model(
                    all_images.reshape((b * (k + 1),) + all_images.shape[2:]))
                all_feats = all_feats.reshape((b, k + 1) + all_feats.shape[1:])
                matching_cur_feats, matching_src_feats = all_feats[:, 0], all_feats[:, 1:]
            else:
                assert not flip, ("src/cur matching feats are inference feature-cache inputs; "
                                  "flipped passes encode images")
                matching_cur_feats = (cur_matching_feats.to(dtype)
                                      if cur_matching_feats is not None
                                      else self.matching_model(cur_image))
                if src_matching_feats is not None:
                    matching_src_feats = src_matching_feats.to(dtype)
                else:
                    f = self.matching_model(src_image.reshape((b * k,) + src_image.shape[2:]))
                    matching_src_feats = f.reshape((b, k) + f.shape[1:])
            # the plane sweep needs the views as the cameras saw them
            matching_cur_feats = flipped(matching_cur_feats, 2)
            matching_src_feats = flipped(matching_src_feats, 3)

        with span("model.cost_volume"):
            cost_volume_bhwd, lowest_cost_bhw, _, overall_mask_bhw = self.cost_volume(
                matching_cur_feats, matching_src_feats, src_cam_T_cur_cam, cur_cam_T_src_cam,
                src_K, cur_invK, self.min_matching_depth, self.max_matching_depth,
                hint=hint, return_mask=return_mask,
            )
            cost_volume_bhwd = flipped(cost_volume_bhwd, 2)
        if stop_after == "cost_volume":
            return {"cost_volume_bhwd": cost_volume_bhwd,
                    "matching_feats_bhwc": matching_cur_feats}

        # the decoder stack runs NCHW: the volume's (B, H, W, D) view is the
        # kernel's (B, D, H, W) buffer, so this permute is free
        with span("model.cv_encoder"):
            cv_feats = self.cost_volume_net.forward_nchw(
                cost_volume_bhwd.permute(0, 3, 1, 2),
                [f.permute(0, 3, 1, 2) for f in cur_feats[self.matching_scale:]])
        if stop_after == "cv_encoder":
            return {"cv_feats": [f.permute(0, 2, 3, 1) for f in cv_feats],
                    "matching_feats_bhwc": matching_cur_feats}
        outputs = {}
        with span("model.decoder"):
            decoder_inputs = ([f.permute(0, 3, 1, 2) for f in cur_feats[:self.matching_scale]]
                              + cv_feats)
            for key, log_depth in self.depth_decoder.forward_nchw(decoder_inputs).items():
                log_depth = flipped(log_depth.permute(0, 2, 3, 1).float(), 2)
                outputs[key] = log_depth
                outputs[key.replace("log_", "")] = torch.exp(log_depth)
        outputs["lowest_cost_bhw"] = lowest_cost_bhw
        outputs["overall_mask_bhw"] = overall_mask_bhw
        # features of a mirrored image never enter the runners' feature cache
        if not flip:
            outputs["matching_feats_bhwc"] = matching_cur_feats
        return outputs


class DepthModelCVHint(DepthModel):
    """DoubleTake: DepthModel with the mesh-hint feature volume."""

    def __init__(self, **kwargs):
        kwargs.setdefault("feature_volume_type", "mlp_mesh_hint_feature_volume")
        super().__init__(**kwargs)

    def forward(self, cur_data, src_data, return_mask=False, hint=None,
                src_matching_feats=None, cur_feats=None, cur_matching_feats=None,
                flip=False, stop_after=None):
        if hint is None:
            # empty hint: invalid everywhere (the reference feeds all-invalid
            # hint tensors before a mesh exists). Without images it is built
            # at matching resolution, where the volume resizes it anyway.
            if "image_bhw3" in cur_data:
                b, h, w, _ = cur_data["image_bhw3"].shape
                dev = cur_data["image_bhw3"].device
            else:
                b, h, w = cur_matching_feats.shape[:3]
                dev = cur_matching_feats.device
            zero = torch.zeros((b, h, w, 1), dtype=torch.float32, device=dev)
            hint = {"depth_hint_bhw1": zero, "hint_mask_bhw1": zero.bool(),
                    "sampled_weights_bhw1": zero}
        return super().forward(cur_data, src_data, return_mask=return_mask, hint=hint,
                               src_matching_feats=src_matching_feats, cur_feats=cur_feats,
                               cur_matching_feats=cur_matching_feats, flip=flip,
                               stop_after=stop_after)


def get_model_class(model_type: str):
    """Model registry (reference utils/model_utils.py:10-17)."""
    return {"depth_model": DepthModel, "cv_hint_depth_model": DepthModelCVHint}[model_type]
