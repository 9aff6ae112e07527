"""The port's entry points run on the card unless the caller asks for the
CPU: `workload.build_fleet`, `MultiSyncSimulator`, `sim.run.run_one` and
the CLI default to "cuda", which raises without a CUDA device and never
falls back to the CPU. Without a card (as in the CPU test runs) each
default raises; with one, each runs on the card."""

import inspect

import numpy as np
import pytest
import torch

from lsc_dr_planner_tpu_torch import device, workload
from lsc_dr_planner_tpu_torch.config import Param
from lsc_dr_planner_tpu_torch.sim import run
from lsc_dr_planner_tpu_torch.sim.simulator import MultiSyncSimulator

torch.set_num_threads(1)


@pytest.mark.parametrize("fn", [workload.build_fleet, MultiSyncSimulator.__init__, run.run_one])
def test_default_device_is_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda" == device.DEFAULT


def test_resolve_keeps_the_cpu_and_refuses_a_missing_card():
    assert device.resolve("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert device.resolve("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            device.resolve("cuda")


def test_build_fleet_default_runs_on_the_card_or_raises():
    if torch.cuda.is_available():
        assert workload.build_fleet(8)[3].pos.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            workload.build_fleet(8)
    assert workload.build_fleet(8, device="cpu")[3].pos.device.type == "cpu"


def test_simulator_default_runs_on_the_card_or_raises(tmp_path):
    m = workload.forest_mission(3, 4)
    if torch.cuda.is_available():
        sim = MultiSyncSimulator(Param(multisim_save_result=False), m, log_dir=str(tmp_path))
        assert sim.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MultiSyncSimulator(Param(multisim_save_result=False), m, log_dir=str(tmp_path))


def _mission_files(tmp_path):
    m = workload.forest_mission(3, 4)
    mpath, wpath = str(tmp_path / "m.json"), str(tmp_path / "w.csv")
    m.save(mpath)
    np.savetxt(wpath, m.world_boxes, delimiter=",")
    return mpath, wpath


def test_cli_default_is_the_card(tmp_path):
    """The CLI without --device asks for the card; on a host without one it
    raises before flying anything."""
    mpath, wpath = _mission_files(tmp_path)
    argv = ["--mission", mpath, "--world", wpath, "--log-dir", str(tmp_path / "log"),
            "--max-iter", "2"]
    if torch.cuda.is_available():
        (r,) = run.main(argv)
        assert r["mission"] == "m.json"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run.main(argv)


def test_run_one_default_is_the_card(tmp_path):
    mpath, wpath = _mission_files(tmp_path)
    param = Param(multisim_save_result=False, multisim_max_planner_iteration=2)
    if torch.cuda.is_available():
        assert run.run_one(mpath, wpath, param, str(tmp_path / "log"), 0, False)["mission"]
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run.run_one(mpath, wpath, param, str(tmp_path / "log"), 0, False)
