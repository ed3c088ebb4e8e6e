"""The port's dataset readers against the JAX package's, on tiny scans in
each dataset's native layout (the fixtures of tests/test_dataset_formats.py:
7Scenes, VDR, 3RScan with its rescan transform, zipped 3RScan, COLMAP, and
ScanNet). Every frame dict must be equal array by array.
"""

import io
import json
import os
import zipfile

import numpy as np
import pytest
from PIL import Image

from doubletake_tpu.datasets import registry as jregistry
from doubletake_tpu.options import Options as JaxOptions

from doubletake_tpu_torch.datasets import registry
from doubletake_tpu_torch.options import Options

H_IMG, W_IMG = 64, 96
K_3RSCAN = "877.5 0 479.75 0 0 877.5 269.75 0 0 0 1 0 0 0 0 1"
INFO_3RSCAN = ("m_colorWidth = 960\nm_colorHeight = 540\nm_depthWidth = 224\n"
               f"m_depthHeight = 172\nm_depthShift = 1000\nm_calibrationColorIntrinsic = {K_3RSCAN}\n")


def write_image(path, h, w, seed):
    rng = np.random.RandomState(seed)
    Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(path)


def write_depth_png16(path, h, w, seed):
    rng = np.random.RandomState(seed)
    arr = (rng.rand(h, w) * 3000 + 500).astype(np.uint16)
    arr[0, 0] = 0  # one invalid pixel
    Image.fromarray(arr).save(path)


def pose(i):
    T = np.eye(4)
    c, s = np.cos(0.1 * i), np.sin(0.1 * i)
    T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    T[:3, 3] = (0.2 * i, -0.1 * i, 0.05)
    return T


def seven_scenes(root):
    scan = "chess/seq-01"
    sd = os.path.join(root, scan)
    os.makedirs(sd)
    for i in range(2):
        write_image(os.path.join(sd, f"frame-{i:06d}.color.png"), 480, 640, i)
        write_depth_png16(os.path.join(sd, f"frame-{i:06d}.depth.proj.png"), 480, 640, i)
        np.savetxt(os.path.join(sd, f"frame-{i:06d}.pose.txt"), pose(i))
    return "7scenes", scan, ["0", "1"], {}


def vdr(root):
    scan = "cap1"
    sd = os.path.join(root, scan)
    os.makedirs(sd)
    meta = []
    for i in range(2):
        pose_gl = pose(i).astype(np.float32)
        meta.append({"pose4x4": pose_gl.T.reshape(-1).tolist(), "resolution": [1920, 1440],
                     "intrinsics": [1400.0, 1410.0, 960.0, 720.0, 0.0]})
        write_image(os.path.join(sd, f"frame_{i}.jpg"), 1440, 1920, i)
        rng = np.random.RandomState(i)
        (rng.rand(192, 256) * 3 + 0.5).astype(np.float32).tofile(os.path.join(sd, f"depth_{i}.bin"))
        (rng.rand(192, 256) * 3).astype(np.uint8).tofile(
            os.path.join(sd, f"depthConfidence_{i}.bin"))
    with open(os.path.join(sd, "capture.json"), "w") as f:
        json.dump(meta, f)
    return "vdr", scan, ["0", "1"], {}


def threer_scan(root):
    ref_scan, rescan = "abc-ref", "abc-re1"
    for k, scan in enumerate((ref_scan, rescan)):
        sd = os.path.join(root, scan, "sensor_data")
        os.makedirs(sd)
        with open(os.path.join(sd, "_info.txt"), "w") as f:
            f.write(INFO_3RSCAN)
        for i in range(2):
            write_image(os.path.join(sd, f"frame-{i:06d}.color.jpg"), 540, 960, 10 * k + i)
            rng = np.random.RandomState(10 * k + i)
            Image.fromarray((rng.rand(172, 224) * 3000 + 500).astype(np.uint16)).save(
                os.path.join(sd, f"frame-{i:06d}.depth.pgm"))
            np.savetxt(os.path.join(sd, f"frame-{i:06d}.pose.txt"), pose(i + k))
    transform = pose(3)
    with open(os.path.join(root, "3RScan.json"), "w") as f:
        json.dump([{"reference": ref_scan,
                    "scans": [{"reference": rescan,
                               "transform": transform.T.reshape(-1).tolist()}]}], f)
    return "3rscan", rescan, ["0", "1"], {}


def threer_scan_zipped(root):
    scan = "zip-scan"
    os.makedirs(os.path.join(root, scan))

    def encoded(arr, fmt):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format=fmt)
        return buf.getvalue()

    rng = np.random.RandomState(0)
    with zipfile.ZipFile(os.path.join(root, scan, "sequence.zip"), "w") as zf:
        zf.writestr("_info.txt", INFO_3RSCAN)
        for i in range(2):
            zf.writestr(f"frame-{i:06d}.color.jpg",
                        encoded((rng.rand(540, 960, 3) * 255).astype(np.uint8), "PNG"))
            zf.writestr(f"sensor_data/frame-{i:06d}.depth.pgm",
                        encoded((rng.rand(172, 224) * 3000 + 500).astype(np.uint16), "PPM"))
            zf.writestr(f"frame-{i:06d}.pose.txt",
                        "\n".join(" ".join(str(v) for v in row) for row in pose(i)))
    return "3rscan", scan, ["0", "1"], {}


def colmap(root):
    scan = "walk1"
    sp = os.path.join(root, scan, "sparse", "0")
    os.makedirs(sp)
    os.makedirs(os.path.join(root, scan, "images"))
    with open(os.path.join(sp, "cameras.txt"), "w") as f:
        f.write("# comment\n1 PINHOLE 1280 720 1000 1010 640 360\n")
    with open(os.path.join(sp, "images.txt"), "w") as f:
        f.write("# comment\n")
        f.write("1 0.9 0.1 0.3 0.2 0.5 -0.2 0.1 1 img0.jpg\n0 0\n")
        f.write("2 0.8 -0.2 0.1 0.4 0.1 0.3 -0.6 1 img1.jpg\n0 0\n")
    with open(os.path.join(root, scan, "scale.txt"), "w") as f:
        f.write("2.0\n")
    for i in range(2):
        write_image(os.path.join(root, scan, "images", f"img{i}.jpg"), 720, 1280, i)
    return "colmap", scan, ["img0", "img1"], {}


def scannet(root):
    scan = "scene0000_00"
    sd = os.path.join(root, "scans", scan, "sensor_data")
    os.makedirs(sd)
    os.makedirs(os.path.join(root, "scans", scan, "intrinsic"))
    with open(os.path.join(root, "scans", scan, f"{scan}.txt"), "w") as f:
        f.write("depthWidth = 640\ndepthHeight = 480\nnumColorFrames = 2\n")
    K = np.eye(4)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 580.0, 585.0, 320, 240
    np.savetxt(os.path.join(root, "scans", scan, "intrinsic", "intrinsic_depth.txt"), K)
    for i in range(2):
        write_image(os.path.join(sd, f"frame-{i:06d}.color.jpg"), 480, 640, i)
        write_depth_png16(os.path.join(sd, f"frame-{i:06d}.depth.png"), 480, 640, i)
        np.savetxt(os.path.join(sd, f"frame-{i:06d}.pose.txt"), pose(i))
    return "scannet", scan, ["0", "1"], {"split": "train"}


def readers(name, root, **kwargs):
    """(port reader, JAX reader) of dataset ``name`` over ``root``."""
    out = []
    for reg, cls in ((registry, Options), (jregistry, JaxOptions)):
        o = cls()
        o.dataset, o.dataset_path = name, root
        o.image_height, o.image_width = H_IMG, W_IMG
        o.mv_tuple_file_suffix = None
        for key, value in kwargs.items():
            setattr(o, key, value)
        out.append(reg.dataset_from_opts(o, split=kwargs.get("split", "test"),
                                         include_full_res_depth=True,
                                         include_full_depth_K=True, pass_frame_id=True))
    return out


@pytest.mark.parametrize("rotate", [False, True], ids=["upright", "rotated"])
@pytest.mark.parametrize("fixture", [seven_scenes, vdr, threer_scan, threer_scan_zipped,
                                     colmap, scannet], ids=lambda f: f.__name__)
def test_reader_matches_jax(fixture, rotate, tmp_path):
    name, scan, frame_ids, extra = fixture(str(tmp_path))
    port, ref = readers(name, str(tmp_path), rotate_images=rotate, **extra)
    assert type(port).__name__ == type(ref).__name__
    for frame_id in frame_ids:
        got = port.get_frame(scan, frame_id, load_depth=True)
        want = ref.get_frame(scan, frame_id, load_depth=True)
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            if isinstance(value, str):
                assert got[key] == value, key
            else:
                assert got[key].dtype == value.dtype, key
                np.testing.assert_array_equal(got[key], value, err_msg=key)
        assert np.isfinite(got["world_T_cam_b44"]).all()
    if name == "3rscan" and scan == "abc-re1":
        (pfirst, pT), (jfirst, jT) = port.revisit_source_scan(scan), ref.revisit_source_scan(scan)
        assert pfirst == jfirst == "abc-ref"
        np.testing.assert_array_equal(pT, jT)
        assert not np.allclose(pT, np.eye(4))


def test_registry_names():
    for name in ("scannet", "synthetic", "7scenes", "3rscan", "vdr", "colmap"):
        assert registry.get_dataset(name).__name__ == jregistry.get_dataset(name).__name__
    for name in ("arkit", "scanniverse"):
        with pytest.raises(NotImplementedError, match="not released"):
            registry.get_dataset(name)
    with pytest.raises(ValueError):
        registry.get_dataset("not_a_dataset")


def test_scan_list(tmp_path):
    o, jo = Options(), JaxOptions()
    o.dataset = jo.dataset = "synthetic"
    assert registry.get_scan_list(o) == jregistry.get_scan_list(jo) == ["synth0"]
    split = tmp_path / "scans.txt"
    split.write_text("scene0000_00\n\nscene0001_00\n")
    o.dataset = jo.dataset = "scannet"
    assert registry.get_scan_list(o, str(split)) == jregistry.get_scan_list(jo, str(split)) == [
        "scene0000_00", "scene0001_00"]
