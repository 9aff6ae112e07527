"""True mid-run checkpoint/resume for the synchronous simulator.

Port of lsc_dr_planner_tpu/sim/checkpoint.py, with the same `.npz`
format and version: arrays are stored natively; non-array state (MAPF
plan cache, planner-state name, metrics) rides in one pickled object
field. A resumed run continues bit-identically to an uninterrupted one.
In local-sensing mode the agents' known maps and their versions are
saved too (`map_known`, `map_version`) and restored onto the
simulator's device.

The pickled field names classes by module (`PlanningTimeStatistics`),
so a checkpoint written by the JAX package names
`lsc_dr_planner_tpu.utils.timing`; unpickling that as it is would import
the JAX package, and with it jax. `load_checkpoint` maps every
`lsc_dr_planner_tpu.*` module to its copy in this package, so it reads
checkpoints written by either package without importing jax.
"""

from __future__ import annotations

import io
import pickle

import numpy as np
import torch

_VERSION = 3

# mutable ndarray attributes copied verbatim
_ARRAY_FIELDS = (
    "pos", "vel", "acc", "start_point", "desired_goal", "current_goal",
    "next_waypoint", "prev_ctrl", "desired_ctrl", "has_prev",
    "sfc_lo", "sfc_hi", "sfc_initialized", "qp_y",
    "_pin_steps", "_pin_anchor", "vel_excess_ratio", "acc_excess_ratio",
    "_mcp_mode", "_dist_best", "_no_progress", "mapf_elapsed",
)

# plain scalar attributes
_SCALAR_FIELDS = (
    "planner_seq", "sim_time", "safety_ratio_agent", "safety_ratio_obs",
    "total_flight_time", "is_collided", "qp_failed",
    "_coarse_version",
)

_JAX_PACKAGE = "lsc_dr_planner_tpu"
_PORT_PACKAGE = "lsc_dr_planner_tpu_torch"


class _PortUnpickler(pickle.Unpickler):
    """Reads classes of the JAX package from their copies in the port."""

    def find_class(self, module, name):
        if module == _JAX_PACKAGE or module.startswith(_JAX_PACKAGE + "."):
            module = _PORT_PACKAGE + module[len(_JAX_PACKAGE):]
        return super().find_class(module, name)


def save_checkpoint(sim, path: str) -> None:
    """Capture the simulator's full mutable state."""
    arrays = {k: np.asarray(getattr(sim, k)) for k in _ARRAY_FIELDS}
    aux = {
        "version": _VERSION,
        "scalars": {k: getattr(sim, k) for k in _SCALAR_FIELDS},
        "planner_state": sim.planner_state.name,
        "group_plans": sim._group_plans,
        "events": sim.events,
        "obs_rng": sim._obs_rng,
        "planning_time": sim.planning_time,
        "traj_history": sim.traj_history,
        "sim_csv_rows": sim._sim_csv_rows,
        "mission_start_time": sim.mission_start_time,
    }
    if sim.local_maps:
        # the known maps live on the planner's device
        arrays["map_known"] = sim.map_manager.known.cpu().numpy()
        arrays["map_version"] = sim.map_manager._version
    np.savez_compressed(
        path, __aux__=np.frombuffer(pickle.dumps(aux), dtype=np.uint8),
        **arrays,
    )


def load_checkpoint(sim, path: str) -> None:
    """Restore state saved by either package's `save_checkpoint` into a
    simulator built with the same Param + Mission (static config is NOT
    checkpointed — reconstruct the simulator first, then restore)."""
    from lsc_dr_planner_tpu_torch.sim.simulator import PlannerState

    data = np.load(path, allow_pickle=False)
    aux = _PortUnpickler(io.BytesIO(data["__aux__"].tobytes())).load()
    if aux["version"] != _VERSION:
        raise ValueError(f"checkpoint version {aux['version']} unsupported")

    for k in _ARRAY_FIELDS:
        cur = getattr(sim, k)
        val = data[k]
        if isinstance(cur, np.ndarray) and cur.shape != val.shape:
            raise ValueError(
                f"checkpoint field {k}: shape {val.shape} != simulator "
                f"{cur.shape} — was the simulator built with the same "
                f"mission/param?"
            )
        setattr(sim, k, val.copy())
    for k, v in aux["scalars"].items():
        setattr(sim, k, v)
    sim.planner_state = PlannerState[aux["planner_state"]]
    sim._group_plans = aux["group_plans"]
    sim.events = aux["events"]
    sim._obs_rng = aux["obs_rng"]
    sim.planning_time = aux["planning_time"]
    sim.traj_history = aux["traj_history"]
    sim._sim_csv_rows = aux["sim_csv_rows"]
    sim.mission_start_time = aux["mission_start_time"]
    if sim.local_maps:
        mm = sim.map_manager
        known = torch.as_tensor(data["map_known"], device=mm.device)
        if known.shape != mm.known.shape:
            raise ValueError(f"checkpoint field map_known: shape {tuple(known.shape)} != "
                             f"simulator {tuple(mm.known.shape)}")
        mm.known = known
        mm._version = data["map_version"].copy()
        mm._union = None
        # force a coarse-grid rebuild from the restored maps
        sim._coarse_version = -1
