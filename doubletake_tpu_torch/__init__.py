"""doubletake_tpu_torch: the PyTorch / CUDA port of doubletake_tpu.

The same multi-view-stereo depth estimator with geometry hints, written for
one NVIDIA Hopper GPU: plain PyTorch modules for the network, the TSDF and
the runners, and hand-written CUDA kernels (``csrc/``) for the fused
plane-sweep feature volume and the TSDF integrate. Public tensors keep the
JAX package's NHWC layout and dict keys, so the two packages can be held
against each other on the same inputs.
"""

__version__ = "0.1.0"
