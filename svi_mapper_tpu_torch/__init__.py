"""svi_mapper_tpu_torch — the PyTorch/CUDA port of ``svi_mapper_tpu``.

The sub-package layout, module names and function names mirror the JAX
package, so the counterpart of any module is found by path. This package
imports ``torch`` and numpy only; it never imports ``jax``, ``flax`` or
``svi_mapper_tpu``.

Ported so far (the stereo front-end, ``StereoTracker`` -> ``process_frame``):
  config                 calibration parser, ``TrackingParams``
  geometry/              se3, linalg, camera
  ops/                   image, descriptors, corners, hamming,
                         track_kernel, stereo_kernel (CUDA kernels + plain
                         versions), cuda_build (nvcc + ctypes loader)
  mapping/landmarks      the landmark table
  frontend/              epipolar, tracking, stereo, recovery
  solvers/               posit, landmark_opt
  models/                frame, tracker
  io/synthetic           the corridor renderer
  convert                numpy <-> port state
  csrc/                  CUDA C++ sources of the three kernels

Device rule: every entry point takes ``device=None``; ``None`` means
``cuda`` and raises when no CUDA device is present. Nothing falls back to
the CPU on its own; pass ``device="cpu"`` to ask for it.
"""

__version__ = "0.1.0"
