"""State conversion between the JAX package and the port.

The planner has no weights: its state is the world and the fleet. These
functions take the fields of the JAX package's `GridWorld`,
`FleetArrays` and `StepInputs` as a mapping of name → array (anything
`np.asarray` accepts, so the JAX objects' own fields work unchanged)
and return the port's objects on a given device; `outputs_to_numpy`
goes the other way. Nothing here imports jax.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from lsc_dr_planner_tpu_torch.planner.pipeline import (
    FleetArrays, StepInputs, StepOutputs,
)
from lsc_dr_planner_tpu_torch.world.grid import GridWorld


def _tensor(x, device):
    return torch.as_tensor(np.array(x), device=device)


def grid_world_from_numpy(fields: Mapping[str, Any], device) -> GridWorld:
    return GridWorld(
        resolution=float(fields["resolution"]),
        world_min=np.asarray(fields["world_min"], dtype=np.float64),
        world_max=np.asarray(fields["world_max"], dtype=np.float64),
        origin_idx=np.asarray(fields["origin_idx"]),
        occ=_tensor(fields["occ"], device),
        blocked_cumsum=_tensor(fields["blocked_cumsum"], device).to(torch.int32),
        radius=float(fields["radius"]),
    )


def fleet_from_numpy(fields: Mapping[str, Any], device) -> FleetArrays:
    return FleetArrays(**{f.name: _tensor(fields[f.name], device)
                          for f in dataclasses.fields(FleetArrays)})


def inputs_from_numpy(fields: Mapping[str, Any], device) -> StepInputs:
    """StepInputs of the slice's configuration: no dynamic obstacles, the
    global map (the JAX fields dynobs_* and occ_known are not read)."""
    kw = {}
    for f in dataclasses.fields(StepInputs):
        v = fields.get(f.name)
        if f.name == "planner_seq":
            kw[f.name] = int(np.asarray(v))
        elif v is None:
            kw[f.name] = None
        else:
            kw[f.name] = _tensor(v, device)
    return StepInputs(**kw)


def outputs_to_numpy(out: StepOutputs) -> dict:
    return {f.name: (None if getattr(out, f.name) is None
                     else getattr(out, f.name).detach().cpu().numpy())
            for f in dataclasses.fields(StepOutputs)}
