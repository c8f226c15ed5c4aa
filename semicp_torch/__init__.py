"""semicp_torch — semantic EM-ICP registration in PyTorch for NVIDIA Hopper.

The PyTorch port of the JAX package `semicp` (which stays the reference
and is checked against in the tests). Sub-packages and module names
follow `semicp` so that each module's counterpart is easy to find:

  geom/      SE(3) Lie group math, planar symmetric 3x3 algebra, 3x3 eigh
  cloud/     padded planar clouds, radius covariances, moments (kernels K1, K5)
  corr/      class-major Morton layout, per-class NN (kernels K2, K4)
  register/  E-step reduction (kernels K3, K6), GN/LM M-step, EM align,
             the robust and pipelined aligners, GICP and NDT baselines
  data/      KITTI, PCD and native scan loaders; synthetic scenes (numpy)
  eval/      ATE / RPE (numpy, float64)
  utils/     JSONL metrics, phase timers, device drain, SLAM checkpoints
  slam/      keyframes, the pose graph and its LM, loop closure, submaps,
             the scan prefetcher, the Schur-complement map BA
  dist/      the process-group mesh (NCCL, gloo), batched alignment of
             independent pairs, the ring NN and the distributed align
  cli/       run_pair, run_odometry, run_slam and run_batch (--device cuda|cpu)

The hand-written CUDA kernels live in csrc/ and are built by nvcc at
first use (kernels.py). On a CPU tensor every kernel wrapper takes its
plain PyTorch version. This package never imports jax or semicp.
"""

import torch as _torch

# Full f32 for every matmul and solve: TF32 keeps ~3 decimal digits,
# which breaks the expanded-form distance matmul of the radius estimate
# (|q|^2 + |t|^2 - 2 q.t at tens of metres) and the 6x6 GN solves, as
# bf16 truncation broke pose-graph descent in the JAX package.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from semicp_torch.config import Config, default_config  # noqa: F401, E402
from semicp_torch.cloud import Cloud, make_cloud, preprocess_cloud  # noqa: F401, E402
from semicp_torch.register import align, make_align_fn  # noqa: F401, E402
