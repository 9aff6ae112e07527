"""The device of the port's entry points.

`build_fleet`, `MultiSyncSimulator`, `sim.run.run_one` and the CLI run on
the card ("cuda") unless the caller asks for the CPU ("cpu", the plain
torch paths). Nothing falls back from one to the other.
"""

from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device) -> torch.device:
    """`device` as a torch.device; "cuda" without a CUDA device raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested, but torch sees no CUDA device "
                           "(pass device='cpu' / --device cpu to run on the CPU)")
    return dev
