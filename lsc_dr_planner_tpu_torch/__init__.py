"""lsc_dr_planner_tpu_torch — the PyTorch/CUDA port of lsc_dr_planner_tpu.

The fused fleet planning step (neighbour gather → prediction → CLSC →
SFC → goal LP → batched ADMM QP) in PyTorch, with the ADMM iteration
loop as a hand-written CUDA kernel for Hopper (`csrc/admm.cu`, bound by
`ops/qp_cuda.py`). Module names mirror the JAX package so each
counterpart is found at the same path.

The device is an explicit argument everywhere; the plain PyTorch paths
serve CPU tensors (tests) and are the oracles the kernel is checked
against. Nothing here imports jax or the JAX package.
"""

import torch

# The ADMM KKT algebra needs true float32 matmuls: TF32 (≈3 decimal
# digits) breaks convergence the same way the TPU's bf16 default did.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from lsc_dr_planner_tpu_torch.config import GoalMode, Param, PlannerMode  # noqa: E402

__all__ = ["Param", "PlannerMode", "GoalMode"]
