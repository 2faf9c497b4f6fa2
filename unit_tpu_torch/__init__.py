"""unit_tpu_torch: the PyTorch/CUDA port of unit_tpu for NVIDIA Hopper.

A second package beside the JAX one, held against it module by module.  It
imports torch and never jax; ``unit_tpu.config`` (jax-free) is its config
surface.  Its hand-written kernels (``csrc/``) are built with nvcc for
sm_90a at first use.  This first slice is the serving path of the flagship
detector (``configs/VOC/VOC-RCNN-101-C4-split1.yaml``).
"""

__version__ = "0.1.0"
