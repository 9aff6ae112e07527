#!/usr/bin/env python3
"""The port's multi-device planning across the cards of one host.

    python3 multichip_check.py

Spawns one rank per card of the host (at least 2), joined in one NCCL
group (`parallel/mesh.py::init_group`; `run(..., device="cpu")` runs
the ranks under gloo on the CPU, as the tests do). Every rank builds
`workload.build_fleet(1024)` on its card; rank 0 evolves it 3 steps and
broadcasts the state, so every rank plans from one state. Then:

- the all-gather step (`mesh.make_sharded_step`) and the halo step
  (`halo.make_halo_step` on the spatially sorted fleet, with
  `required_hops` hops) on each rank's block, the outputs gathered to
  every rank. Each rank solves its own QP batch (mesh.py), so the
  sharded step is held, at the JAX tests' tolerance (rtol 1e-4 /
  atol 2e-4; the loop's exit chunk, residual and duals skipped), to the
  same work done without the group: each rank's block through
  `_step_impl` with the whole fleet's neighbour slots. Against the
  whole fleet's step on one card, every output that does not come out
  of the QP is held at 2e-4; the control points come out of another
  QP batch, whose float32 loop exits elsewhere (PERF.md, R1: moving
  every position by 1e-6 m moves them up to 0.2 m), so their gap is
  reported and the converged share held to > 0.9. The neighbour
  predictions are compared in the slots that hold an in-range agent;
- each rank's ADMM kernel launches in those steps (on the card: more
  than 0 on every rank);
- the step's wall time (the slowest rank, mean of 3 calls) unsharded,
  all-gather and halo;
- `scaling.measure_scaling` weak (1024/N agents a rank, 1, 2, 4, ... N
  ranks) and strong (1024 agents on each group).

Prints the cards' names and power limits, then one JSON object as its
last line, also written to chiprun_out/multichip.json. Exits non-zero
with fewer than 2 cards, and when a check fails.
"""

from __future__ import annotations

import types
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
AGENTS = 1024  # the main path's fleet, build_fleet(1024)


def _broadcast_state(inp, group):
    """Rank 0's StepInputs on every rank (bool tensors as uint8 on the
    wire; each field received into a copy of its own, since fresh inputs
    share storage between fields)."""
    out = {}
    for f in dataclasses.fields(inp):
        v = getattr(inp, f.name)
        if torch.is_tensor(v):
            wire = (v.to(torch.uint8) if v.dtype == torch.bool
                    else v.clone(memory_format=torch.contiguous_format))
            dist.broadcast(wire, 0, group=group)
            v = wire.bool() if v.dtype == torch.bool else wire
        elif f.name == "planner_seq":
            box = [v]
            dist.broadcast_object_list(box, 0, group=group)
            v = box[0]
        out[f.name] = v
    return type(inp)(**out)


def _sync(dev, group):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dist.barrier(group)


def _wall_ms(fn, reps, dev, group):
    """Mean wall ms of `fn` over `reps` calls, the slowest rank's."""
    _sync(dev, group)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(dev, group)
    dt = torch.tensor([(time.perf_counter() - t0) / reps * 1e3], dtype=torch.float64,
                      device=dev)
    dist.all_reduce(dt, op=dist.ReduceOp.MAX, group=group)
    return float(dt.item())


def _field(out, name, valid):
    """A field of StepOutputs; the neighbour predictions only in the
    `valid` [A, OA] slots (the others are masked in the step, and what
    they hold can differ: halo.py)."""
    x = getattr(out, name)
    return x[:, :valid.shape[1]][valid] if name == "obs_pred_ctrl" else x


def _check(ref, block, out, what, valid, show):
    """The sharded step's outputs `out` against the block step `block`
    (each rank's block through `_step_impl` alone, with the neighbour
    slots of the whole fleet: the same work) at the JAX tests' tolerance,
    and against the whole fleet's step `ref` (module docstring)."""
    names = [f.name for f in dataclasses.fields(out) if getattr(out, f.name) is not None]
    diffs = {key: {n: float((_field(out, n, valid).double() - _field(other, n, valid).double())
                            .abs().max().item()) for n in names}
             for key, other in (("block", block), ("fleet", ref))}
    for n in names:
        if n in ("qp_iterations", "qp_residual", "qp_y"):
            continue
        a, b = _field(out, n, valid), _field(block, n, valid)
        if a.dtype in (torch.bool, torch.int32, torch.int64):
            assert torch.equal(a, b), (what, "block", n)
        else:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=2e-4,
                                       msg=lambda m: f"{what} block {n}: {m}")
    for n in ("current_goal", "sfc_lo", "sfc_hi", "sfc_initialized", "obs_pred_ctrl",
              "initial_ctrl"):
        assert diffs["fleet"][n] <= 2e-4, (what, "fleet", n, diffs["fleet"][n])
    both = out.qp_converged & ref.qp_converged
    gap = torch.where(both, (out.desired_ctrl - ref.desired_ctrl).abs().flatten(1).amax(1), 0.0)
    res = {"max_diff_block": diffs["block"], "max_diff_fleet": diffs["fleet"],
           "converged": [int(ref.qp_converged.sum()), int(out.qp_converged.sum())],
           "ctrl_gap_fleet_p50_p99_max": [float(gap.quantile(q)) for q in (0.5, 0.99, 1.0)],
           "agents_gap_over_0.1m": int((gap > 0.1).sum().item())}
    if show:
        print(what, json.dumps(res), flush=True)
    assert out.qp_converged.float().mean().item() > 0.9, res
    return res


def _rank_main(rank: int, n: int, cfg, init: str):
    from lsc_dr_planner_tpu_torch import workload
    from lsc_dr_planner_tpu_torch.ops import qp_cuda
    from lsc_dr_planner_tpu_torch.parallel import halo, mesh, scaling
    from lsc_dr_planner_tpu_torch.planner.pipeline import NeighborData

    torch.set_num_threads(1)
    dev = mesh.rank_device(cfg.device, rank)
    group = mesh.init_group(dev, rank, n, init)
    try:
        res = {"ranks": n, "agents": cfg.agents, "backend": dist.get_backend(group)}
        p, planner, fleet, inp = workload.build_fleet(cfg.agents, device=dev)
        if rank == 0:
            step = workload.make_evolve_step(p, planner, fleet)
            for _ in range(cfg.warmup):  # a state with previous solutions
                inp, _ = step(inp)
        inp = _broadcast_state(inp, group)
        ref = planner._step_impl(fleet, inp)
        perm = torch.as_tensor(halo.spatial_permutation(inp.pos.cpu().numpy()), device=dev)
        fleet_p, inp_p = halo.permute_agents(fleet, inp, perm)
        ref_p = planner._step_impl(fleet_p, inp_p)
        hops = halo.required_hops(inp_p.pos.cpu().numpy(), n, p.communication_range)
        res["hops"] = hops
        ms = {"unsharded": _wall_ms(lambda: planner._step_impl(fleet, inp), cfg.reps,
                                    dev, group)}
        for name, fn, want, (f, i) in (
                ("allgather", mesh.make_sharded_step(planner, group), ref, (fleet, inp)),
                ("halo", halo.make_halo_step(planner, group, hops), ref_p, (fleet_p, inp_p))):
            valid = planner._neighbor_slots(i)[1]
            f_l, i_l = mesh.shard_step_inputs(f, i, rank, n)
            qp_cuda.reset_launches()
            out = mesh.gather_outputs(fn(f_l, i_l), group)
            _sync(dev, group)
            launches = torch.tensor([qp_cuda.launches], device=dev)
            every = [torch.zeros_like(launches) for _ in range(n)]
            dist.all_gather(every, launches, group=group)
            Al = cfg.agents // n
            nd = planner._gather_neighbors(f, i)
            block = mesh.gather_outputs(planner._step_impl(f_l, i_l, neighbors=NeighborData(
                **{k: v[rank * Al:(rank + 1) * Al] for k, v in vars(nd).items()})), group)
            res[name] = {"kernel_launches_per_rank": [int(x.item()) for x in every],
                         **_check(want, block, out, name, valid, rank == 0)}
            if dev.type == "cuda":
                assert min(res[name]["kernel_launches_per_rank"]) > 0, (name, res[name])
            ms[name] = _wall_ms(lambda: mesh.gather_outputs(fn(f_l, i_l), group), cfg.reps,
                                dev, group)
        res["step_ms"] = ms
        counts = tuple(d for d in (1, 2, 4, 8, 16) if d <= n)
        res["weak"] = scaling.measure_scaling(counts, A_per_device=cfg.agents // n,
                                              steps=cfg.reps, device=dev, group=group)
        res["strong"] = scaling.measure_scaling(counts, A_per_device=cfg.agents // n,
                                                steps=cfg.reps, fixed_total=True,
                                                device=dev, group=group)
        if rank == 0:
            Path(cfg.out).parent.mkdir(parents=True, exist_ok=True)
            Path(cfg.out).write_text(json.dumps(res))
        _sync(dev, group)
    finally:
        dist.destroy_process_group()


def run(ranks: int, agents: int, device: str, out: Path, warmup: int = 3,
        reps: int = 3) -> dict:
    """The check (module docstring) over `ranks` spawned ranks on
    `device` ("cuda": one card a rank; "cpu": gloo); the result, also
    written to `out`."""
    if agents % ranks:
        raise ValueError(f"{agents} agents must divide into {ranks} ranks")
    out.unlink(missing_ok=True)
    init = out.parent / "multichip_group"
    init.parent.mkdir(parents=True, exist_ok=True)
    init.unlink(missing_ok=True)
    cfg = types.SimpleNamespace(agents=agents, device=device, out=str(out),
                                warmup=warmup, reps=reps)
    t0 = time.perf_counter()
    torch.multiprocessing.spawn(_rank_main, args=(ranks, cfg, f"file://{init}"), nprocs=ranks)
    res = json.loads(out.read_text())
    res["wall_s"] = time.perf_counter() - t0
    return res


def main():
    ranks = torch.cuda.device_count()
    if ranks < 2:
        raise SystemExit(f"needs at least 2 CUDA devices, found {ranks}")
    from lsc_dr_planner_tpu_torch.ops import qp_cuda, sfc_cuda

    qp_cuda.build()  # once each, before the ranks load them
    sfc_cuda.build()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    res = run(ranks, AGENTS, "cuda", ROOT / "chiprun_out" / "multichip.json")
    res["kind"] = torch.cuda.get_device_name(0)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
