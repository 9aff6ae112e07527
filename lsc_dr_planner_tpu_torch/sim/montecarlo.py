"""Monte-Carlo scenario batching: S scenarios planned in lockstep, one
batched planning step per iteration (port of
lsc_dr_planner_tpu/sim/montecarlo.py).

  * ONE set of preprocessed statics (rasterized world, coarse MAPF
    grids, fleet planner) is shared by every replica
    (`MultiSyncSimulator(share_static_from=...)`); a replica owns only
    its mutable per-scenario state (in local-sensing mode, its own known
    maps).
  * The planning step runs the scenarios as one fused fleet of S·A
    agents (`FleetPlanner._step_impl(..., scenarios=S)`): neighbour
    slots stay inside each scenario, and the QP of all S·A agents is one
    batch, so the compacted straggler rescue picks its agents across
    the scenarios, as the JAX package's flattened QP does. Scenarios run
    in chunks of 32, one after another (the JAX package's figure, so the
    results match it for every S).
  * The host MAPF/waypoint layer runs the scenarios through a thread
    pool (the native C++ solvers release the GIL during their ctypes
    calls); the workers build numpy inputs only, which the main thread
    stacks and copies to the device once.

With a process group (`group=`, parallel/mesh.py::init_group) the
scenarios split over its ranks, as the JAX package's `mesh=` splits them
over devices: every rank keeps every scenario's host state and runs the
deterministic host phase for all of them; the bucket is padded to a
multiple of the group's size, each rank plans its contiguous block of
scenarios, and an all-gather of the outputs the host applies gives
every rank every scenario's outputs. Each rank's batch is its own QP
batch: the loop's exit and the compacted rescue are per rank, so a
split run can differ from one device's within the loop's exit chunk,
and, with more than 64 agents a rank, in the agents the rescue takes.

Like the JAX package, a local-sensing scenario senses after every step
but never merges maps (only `MultiSyncSimulator.plan` merges).
"""

from __future__ import annotations

import copy
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from lsc_dr_planner_tpu_torch.config import Param
from lsc_dr_planner_tpu_torch.device import DEFAULT as DEFAULT_DEVICE
from lsc_dr_planner_tpu_torch.mission import Mission
from lsc_dr_planner_tpu_torch.ops import qp
from lsc_dr_planner_tpu_torch.planner.pipeline import FleetArrays, StepInputs
from lsc_dr_planner_tpu_torch.sim.simulator import (
    MultiSyncSimulator,
    _state_at_np,
    _to_host,
    host_output_tensors,
)

CHUNK = 32  # scenarios per batched step


class MonteCarloSimulator:
    """Runs S scenario replicas in lockstep with a scenario-batched
    planning step on `device` (the card by default; "cuda" without a
    CUDA device raises). All scenarios share one world and mission
    shape; goals are perturbed per scenario (`max_noise`, seeded)."""

    def __init__(self, param: Param, mission: Mission, n_scenarios: int,
                 max_noise: float = 0.25, log_dir: str = "log", seed: int = 0,
                 device=DEFAULT_DEVICE, host_workers: Optional[int] = None, group=None):
        self.S = n_scenarios
        # the process group the scenarios split over (None: this device alone)
        self.group = group
        self.world = dist.get_world_size(group) if group is not None else 1
        self.rank = dist.get_rank(group) if group is not None else 0
        base = MultiSyncSimulator(param, mission, log_dir=log_dir, seed=seed,
                                  save_result=False, device=device)
        self.sims: List[MultiSyncSimulator] = [base]
        for s in range(1, n_scenarios):
            m = copy.deepcopy(mission)
            if max_noise > 0:
                m.add_noise(max_noise, param.world_dimension, seed=seed + s)
            self.sims.append(MultiSyncSimulator(
                param, m, log_dir=log_dir, seed=seed + s, save_result=False,
                share_static_from=base,
            ))
        self.planner = base.planner
        self.fleet = base.fleet
        self.device = base.device
        self._tiled = {}  # scenarios → the fleet arrays tiled that many times
        self._pool = ThreadPoolExecutor(
            max_workers=host_workers or min(n_scenarios, (os.cpu_count() or 2) * 2))
        # last-step phase wall times (host MAPF / stack+transfer / device /
        # apply)
        self.phase_times = {}
        # last-step fleet-wide QP convergence over the active scenarios
        self.last_qp_convergence = 1.0
        # the card's peak allocated bytes in each chunk of the last step
        # (torch.cuda.max_memory_allocated; empty on the CPU)
        self.chunk_peak_bytes: List[int] = []

    # ------------------------------------------------------------------
    def _fleet(self, scenarios: int) -> FleetArrays:
        if scenarios not in self._tiled:
            f = self.fleet
            self._tiled[scenarios] = FleetArrays(**{
                k: v.repeat(scenarios, *([1] * (v.dim() - 1))) for k, v in vars(f).items()})
        return self._tiled[scenarios]

    def chunk_qp(self, dev: dict, c0: int, n: int):
        """Stages 1-5 of scenarios c0 .. c0+n-1 of a stacked batch
        (`prepare_step`) as one fused fleet: the `DeferredQP` whose QP
        covers all their agents."""
        A = self.sims[0].A
        inp = StepInputs(**{
            k: v if k == "planner_seq"
            else v[c0:c0 + n] if k.startswith("dynobs_") else v[c0 * A:(c0 + n) * A]
            for k, v in dev.items()})
        return self.planner._step_impl(self._fleet(n), inp, defer_qp=True, scenarios=n)

    def _stack(self, inputs: List[dict], occ: Optional[list]) -> dict:
        """B scenarios' host inputs stacked once and copied to the device:
        per-agent fields [B·A, ...] scenario-major, dynamic obstacles
        [B, OD, ...], the known maps (already on the device) concatenated."""
        B, A = len(inputs), self.sims[0].A
        seqs = {h["planner_seq"] for h in inputs}
        assert len(seqs) == 1, f"scenarios out of lockstep: planner_seq {seqs}"
        dev = {"planner_seq": seqs.pop()}
        for k in inputs[0].keys() - {"planner_seq"}:
            x = np.stack([h[k] for h in inputs])
            if not k.startswith("dynobs_"):
                x = x.reshape((B * A,) + x.shape[2:])
            dev[k] = torch.as_tensor(x, device=self.device)
        if occ is not None:
            dev["occ_known"] = torch.cat(occ)
        return dev

    def _batched_step(self, dev: dict, B: int) -> List[torch.Tensor]:
        """The planning step of B scenarios (`_stack`'s inputs) in chunks
        of CHUNK scenarios, one after another: per chunk, stages 1-5 as one
        fused fleet, one QP over all its agents, then the failsafe.
        Returns the outputs the host applies (`host_output_tensors`),
        scenario-major over the B·A agents, or with a group over every
        rank's B·A agents."""
        pl = self.planner
        cuda = self.device.type == "cuda"
        self.chunk_peak_bytes = []
        outs = []
        for c0 in range(0, B, CHUNK):
            if cuda:
                torch.cuda.reset_peak_memory_stats(self.device)
            d = self.chunk_qp(dev, c0, min(CHUNK, B - c0))
            out = qp.solve(pl.qp_cfg, d.qp_inp, feas_tol=pl.feas_tol)
            outs.append(host_output_tensors(pl.finish_step(out, d)))
            if cuda:
                self.chunk_peak_bytes.append(torch.cuda.max_memory_allocated(self.device))
        outs = [torch.cat(parts) for parts in zip(*outs)]
        if self.group is None:
            return outs
        from lsc_dr_planner_tpu_torch.parallel.mesh import all_gather_rows

        return [all_gather_rows(x, self.group) for x in outs]

    # ------------------------------------------------------------------
    def prepare_step(self, iteration: int):
        """The first half of `step`: dynamics, sensing and the host MAPF
        layer of the scenarios still flying, then their inputs padded,
        stacked and on the device. Returns (active simulators, `_stack`'s
        inputs, bucket size B), or None when every scenario has finished.

        The batch is padded to a power-of-two bucket with repeats of the
        last active input (past 32, to a multiple of 32), as in the JAX
        package: the compacted rescue picks across the whole batch, so
        the padding decides which agents it takes. With a group, B is
        then padded to a multiple of its size, and the inputs on the
        device are this rank's block of B / size scenarios."""
        p = self.sims[0].param
        active = [sim for sim in self.sims if not sim.is_finished()]
        if not active:
            return None
        t0 = time.perf_counter()
        # batched ideal dynamics, host-side float64 over all scenarios at
        # once: the same Bernstein evaluation as the single-sim do_step
        if iteration > 0:
            ctrl = np.stack([sim.desired_ctrl for sim in active])
            pos, vel, acc = _state_at_np(ctrl, p.multisim_time_step, p.dt)
            for s, sim in enumerate(active):
                sim.pos = pos[s].astype(np.float64)
                sim.vel = vel[s].astype(np.float64)
                sim.acc = acc[s].astype(np.float64)
                if p.world_dimension == 2:
                    sim.pos[:, 2] = p.world_z_2d
                sim.sim_time += p.multisim_time_step
                if sim.local_maps:
                    sim.sense()
        for sim in active:
            # the host copy of the known maps that a coarse-grid rebuild
            # reads, made here: the worker threads do no device work
            if sim.local_maps and sim.map_manager.version() != sim._coarse_version:
                sim.map_manager.union_occ()

        # host MAPF layer, threaded across scenarios
        def host_phase(sim):
            sim.decentralized_mapp()
            return sim._host_step_inputs()

        inputs = list(self._pool.map(host_phase, active))
        occ = [sim.map_manager.known for sim in active] if active[0].local_maps else None
        t1 = time.perf_counter()

        n_act = len(inputs)
        B = 1
        while B < n_act:
            B *= 2
        B = min(B, self.S)
        if B > CHUNK:
            B = -(-n_act // CHUNK) * CHUNK
        B = -(-B // self.world) * self.world
        inputs = inputs + [inputs[-1]] * (B - n_act)
        if occ is not None:
            occ = occ + [occ[-1]] * (B - n_act)
        mine = slice(self.rank * B // self.world, (self.rank + 1) * B // self.world)
        dev = self._stack(inputs[mine], occ[mine] if occ is not None else None)
        self.phase_times = {"n_active": n_act, "host": t1 - t0,
                            "stack": time.perf_counter() - t1}
        return active, dev, B

    def step(self, iteration: int) -> None:
        """One lockstep iteration over the scenarios still flying
        (finished replicas are dropped from the host phase and the device
        batch alike)."""
        prep = self.prepare_step(iteration)
        if prep is not None:
            self.plan_prepared(*prep)

    def plan_prepared(self, active: List[MultiSyncSimulator], dev: dict, B: int) -> None:
        """The second half of `step`: the batched planning step of
        `prepare_step`'s batch, its outputs applied and audited per
        scenario."""
        t2 = time.perf_counter()
        # one device→host copy of the outputs the host applies
        host = _to_host(self._batched_step(dev, B // self.world))
        t3 = time.perf_counter()
        A = active[0].A
        # fleet-wide QP convergence across the active scenarios (padded
        # lanes excluded)
        self.last_qp_convergence = float(np.mean(host[5][:len(active) * A]))
        for s, sim in enumerate(active):
            sim._apply_host_outputs(*(x[s * A:(s + 1) * A] for x in host))
            sim.save_simulation_result()
        self.phase_times.update(device=t3 - t2, apply=time.perf_counter() - t3)

    # ------------------------------------------------------------------
    def run(self, max_iterations: Optional[int] = None) -> List[dict]:
        max_iter = max_iterations or self.sims[0].param.multisim_max_planner_iteration
        for it in range(max_iter):
            if all(sim.is_finished() for sim in self.sims):
                break
            self.step(it)
        return [sim.summary() for sim in self.sims]
