"""The device of the port's entry points.

`build_fleet`, `MultiSyncSimulator`, `sim.run.run_one` and the CLI run on
the card ("cuda") unless the caller asks for the CPU ("cpu", the plain
torch paths). Nothing falls back from one to the other.
"""

from __future__ import annotations

import subprocess

import torch

DEFAULT = "cuda"


def resolve(device) -> torch.device:
    """`device` as a torch.device; "cuda" without a CUDA device raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested, but torch sees no CUDA device "
                           "(pass device='cpu' / --device cpu to run on the CPU)")
    return dev


def describe(device) -> str:
    """What a measurement ran on: "cpu", or the card's name and power
    limit as `nvidia-smi --query-gpu=name,power.limit` gives them (a
    card set below its maximum power runs slower under load)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        return subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, check=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(index)}, power limit not read"
