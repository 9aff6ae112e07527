"""The port's multi-device planning against the JAX package's unsharded
step (the mirrors of tests/test_parallel.py): the step's neighbour
override, the all-gather step at 2 and 4 ranks and its second
iteration, the halo step at 4 ranks, and `required_hops`.

The sharded steps run in spawned gloo ranks on the CPU
(`lsc_dr_planner_tpu_torch.parallel.testing.run_case`: a rank imports
the port alone); the parent builds the case with
`__graft_entry__._build` and compares.

Tolerances. The JAX tests' `_tree_allclose` (rtol 1e-4 / atol 2e-4,
skipping the ADMM's exit chunk, residual and duals) holds each sharded
run to the port's unsharded step on the same inputs, and holds every
output that does not come out of a QP to JAX's unsharded step. The
control points come out of the port's own ADMM loop, whose float32 exit
gates stop at other chunks than the JAX loop's (unsharded, at A=16:
24 against 40 iterations for some agents, control points up to 6.8e-4 m
apart), so against JAX they are held, where both converged, to
CTRL_TOL = 2e-3 m, about three times the largest gap these cases read
(CPU: 7.2e-4 m for the neighbour override, 2.9e-4 and 5.5e-4 m for the
all-gather step at 2 and 4 ranks, 4.8e-4 m for its second iteration,
4.6e-4 m for the halo step); the converged set must be the same."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from lsc_dr_planner_tpu.parallel import halo as halo_j
from lsc_dr_planner_tpu.planner.pipeline import NeighborData as NeighborDataJ
from lsc_dr_planner_tpu_torch import convert
from lsc_dr_planner_tpu_torch.config import Param
from lsc_dr_planner_tpu_torch.parallel import halo, testing
from lsc_dr_planner_tpu_torch.planner.pipeline import FleetPlanner, NeighborData

# One intra-op thread: the suite runs in several worker processes on a
# shared CPU, and torch's spinning thread pool would starve the JAX
# computations of the other workers (small tensors gain nothing from it).
torch.set_num_threads(1)

PARAM = dict(max_obstacles=4, qp_max_iter=25)  # __graft_entry__._build's Param
PLANNER = dict(max_dynobs=0, agent_radius=0.15)
WORLD_KEYS = ("resolution", "world_min", "world_max", "origin_idx", "occ",
              "blocked_cumsum", "cell_ranges", "n_boxes", "radius")


def _tree_allclose(a, b, rtol=1e-4, atol=2e-4, skip=()):
    """tests/test_parallel.py's comparison of StepOutputs (`a` JAX's, or a
    mapping of numpy arrays as `b` is), skipping also `skip`."""
    skip = {"qp_iterations", "qp_residual", "qp_y", *skip}
    a = a if isinstance(a, dict) else a._asdict()
    for name in a:
        if name in skip:
            continue
        la = np.asarray(a[name])
        lb = np.asarray(b[name])
        if la.dtype == bool or np.issubdtype(la.dtype, np.integer):
            np.testing.assert_array_equal(la, lb, err_msg=name)
        else:
            np.testing.assert_allclose(la, lb, rtol=rtol, atol=atol, err_msg=name)


QP_OUTPUTS = ("desired_ctrl",)
CTRL_TOL = 2e-3  # m; see the module docstring


def _step_parity(ref_j, out, downstream=()):
    """`out` against JAX's step: `_tree_allclose` on every output but the
    QP's and those in `downstream` (computed from an earlier step's QP);
    boxes and the converged set exactly; control points within CTRL_TOL
    where both converged."""
    _tree_allclose(ref_j, out, skip=set(QP_OUTPUTS) | set(downstream))
    for name in ("sfc_lo", "sfc_hi", "qp_converged"):
        np.testing.assert_array_equal(out[name], np.asarray(getattr(ref_j, name)), err_msg=name)
    conv = out["qp_converged"] & np.asarray(ref_j.qp_converged)
    dctrl = np.abs(out["desired_ctrl"] - np.asarray(ref_j.desired_ctrl))[conv]
    assert dctrl.max(initial=0.0) < CTRL_TOL, dctrl.max()


def _port(planner_j, fleet_j, inp_j):
    world = convert.grid_world_from_numpy(
        {k: getattr(planner_j.world, k) for k in WORLD_KEYS}, "cpu")
    planner = FleetPlanner(Param(**PARAM), world, inp_j.pos.shape[0], **PLANNER)
    return (planner, convert.fleet_from_numpy(fleet_j._asdict(), "cpu"),
            convert.inputs_from_numpy(inp_j._asdict(), "cpu"))


def _run_ranks(tmp_path, n, kind, planner_j, fleet_j, inp_j, **extra):
    """The case in spawned gloo ranks; rank 0's gathered outputs."""
    arrays = {f"world_{k}": np.asarray(getattr(planner_j.world, k)) for k in WORLD_KEYS}
    arrays.update({f"fleet_{k}": np.asarray(v) for k, v in fleet_j._asdict().items()})
    arrays.update({f"inp_{k}": np.asarray(v) for k, v in inp_j._asdict().items()
                   if v is not None})
    np.savez(tmp_path / "case.npz", **arrays)
    (tmp_path / "case.json").write_text(json.dumps(
        {"kind": kind, "param": PARAM, "planner": PLANNER, **extra}))
    torch.multiprocessing.spawn(testing.run_case, args=(n, str(tmp_path)), nprocs=n)
    return dict(np.load(tmp_path / "out.npz"))


def test_neighbor_override_matches_jax():
    """`_step_impl(fleet, inp, neighbors=nd)` in both packages on one
    hand-built NeighborData: each agent's slots hold a permutation of
    other agents (not the nearest), some marked invalid, so every field
    of the override reaches the step."""
    A = 8
    planner_j, fleet_j, inp_j = graft._build(n_agents=A)
    OA = planner_j.O_agents
    rng = np.random.default_rng(3)
    order = np.stack([rng.permutation([j for j in range(A) if j != i])[:OA]
                      for i in range(A)])
    valid = rng.random((A, OA)) < 0.7
    valid[:, 0] = True
    has_prev = rng.random(A) < 0.5
    prev = np.asarray(inp_j.prev_ctrl) + rng.normal(0, 0.02, inp_j.prev_ctrl.shape)
    inp_j = inp_j._replace(has_prev=jnp.asarray(has_prev),
                           prev_ctrl=jnp.asarray(prev, jnp.float32))
    nd = dict(prev_ctrl=np.asarray(inp_j.prev_ctrl)[order], has_prev=has_prev[order],
              pos=np.asarray(inp_j.pos)[order], vel=np.asarray(inp_j.vel)[order],
              radius=np.asarray(fleet_j.radius)[order],
              downwash=np.asarray(fleet_j.downwash)[order],
              goal=np.asarray(inp_j.current_goal)[order], valid=valid)
    ref = jax.jit(planner_j._step_impl)(
        fleet_j, inp_j, neighbors=NeighborDataJ(**{k: jnp.asarray(v) for k, v in nd.items()}))
    default = jax.jit(planner_j._step_impl)(fleet_j, inp_j)
    assert not np.allclose(np.asarray(ref.obs_pred_ctrl), np.asarray(default.obs_pred_ctrl))

    planner, fleet, inp = _port(planner_j, fleet_j, inp_j)
    nd_t = NeighborData(**{k: torch.as_tensor(v) for k, v in nd.items()})
    out = convert.outputs_to_numpy(planner._step_impl(fleet, inp, neighbors=nd_t))
    _step_parity(ref, out)
    # the override is the step's only source of neighbour data: the
    # default gather's slots, handed in, give the default step
    default_t = convert.outputs_to_numpy(planner._step_impl(fleet, inp))
    _tree_allclose(default_t, convert.outputs_to_numpy(planner._step_impl(
        fleet, inp, neighbors=planner._gather_neighbors(fleet, inp))), rtol=0, atol=0)
    with pytest.raises(ValueError, match="scenarios"):
        planner._step_impl(fleet, inp, scenarios=2, neighbors=nd_t)


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_sharded_step_matches_unsharded(tmp_path, n_ranks):
    A = 2 * n_ranks
    planner_j, fleet_j, inp_j = graft._build(n_agents=A)
    ref = jax.jit(planner_j._step_impl)(fleet_j, inp_j)
    out = _run_ranks(tmp_path, n_ranks, "allgather", planner_j, fleet_j, inp_j)
    _step_parity(ref, out)
    planner, fleet, inp = _port(planner_j, fleet_j, inp_j)
    _tree_allclose(convert.outputs_to_numpy(planner._step_impl(fleet, inp)), out)


def test_sharded_step_second_iteration(tmp_path):
    """Outputs fed back as inputs (the steady-state loop), 4 ranks."""
    A = 16
    planner_j, fleet_j, inp_j = graft._build(n_agents=A)
    step = jax.jit(planner_j._step_impl)

    def advance(i, o):
        return i._replace(prev_ctrl=o.desired_ctrl, has_prev=jnp.ones_like(i.has_prev),
                          current_goal=o.current_goal, sfc_lo=o.sfc_lo, sfc_hi=o.sfc_hi,
                          sfc_initialized=o.sfc_initialized,
                          planner_seq=i.planner_seq + 1)

    ref = step(fleet_j, advance(inp_j, step(fleet_j, inp_j)))
    out = _run_ranks(tmp_path, 4, "allgather", planner_j, fleet_j, inp_j, iterations=2)
    # the second step's neighbour predictions and initial trajectories
    # come from the first step's QP
    _step_parity(ref, out, downstream=("obs_pred_ctrl", "initial_ctrl", "current_goal"))
    planner, fleet, inp = _port(planner_j, fleet_j, inp_j)
    out_t = planner._step_impl(fleet, testing._advance(inp, planner._step_impl(fleet, inp)))
    # each rank's loop exits on its own agents, so the first step's control
    # points move by up to a chunk (8.3e-5 m here): `_tree_allclose`'s own
    # tolerance, not the 2e-5 of the JAX test, whose sharded loop exits
    # once for the fleet
    _tree_allclose(convert.outputs_to_numpy(out_t), out)


def test_halo_step_matches_unsharded(tmp_path):
    """The halo exchange on tests/test_parallel.py's irregular line
    (strictly distinct pairwise distances) equals the global-gather step."""
    from lsc_dr_planner_tpu.ops import trajectory

    d, A = 4, 16
    planner_j, fleet_j, inp_j = graft._build(n_agents=A)
    p = planner_j.param
    i = np.arange(A, dtype=np.float64)
    x = 0.4 * i + 0.012 * i * i
    x -= x.mean()
    pos = jnp.asarray(np.stack([x, 0.02 * np.sin(i), np.full(A, 0.6)], axis=1), jnp.float32)
    ctrl = trajectory.const_vel_ctrl(pos, jnp.zeros((A, 3), jnp.float32), p.M, p.n, p.dt)
    inp_j = inp_j._replace(pos=pos, prev_ctrl=ctrl, current_goal=pos, next_waypoint=pos,
                           desired_goal=pos + jnp.asarray([0.0, 1.0, 0.0], jnp.float32))
    hops = halo.required_hops(np.asarray(pos), d, p.communication_range)
    assert hops == halo_j.required_hops(np.asarray(pos), d, p.communication_range)
    assert hops <= 2
    ref = jax.jit(planner_j._step_impl)(fleet_j, inp_j)
    out = _run_ranks(tmp_path, d, "halo", planner_j, fleet_j, inp_j, hops=hops)
    _step_parity(ref, out)
    planner, fleet, inp = _port(planner_j, fleet_j, inp_j)
    _tree_allclose(convert.outputs_to_numpy(planner._step_impl(fleet, inp)), out)


@pytest.mark.parametrize("spacing_end, hops", [(30.0, 1), (7.5, 2)])
def test_halo_required_hops(spacing_end, hops):
    """required_hops grows as slabs narrow against the comm range (2 m
    spacing: slabs ~7.5 m; 0.5 m spacing: slabs ~1.9 m), as the JAX one."""
    pos = np.zeros((16, 3))
    pos[:, 0] = np.linspace(0.0, spacing_end, 16)
    assert halo.required_hops(pos, 4, 3.0) == hops == halo_j.required_hops(pos, 4, 3.0)
    with pytest.raises(ValueError, match="divide evenly"):
        halo.required_hops(pos[:15], 4, 3.0)


def test_shard_step_inputs_blocks():
    """Agent-leading fields (the known maps and duals included) split into
    contiguous blocks; dynamic obstacles and scalars are replicated; a
    fleet that does not divide raises."""
    from lsc_dr_planner_tpu_torch import workload
    from lsc_dr_planner_tpu_torch.parallel import mesh

    _, _, fleet, inp = workload.build_fleet(8, device="cpu")
    inp = dataclasses.replace(
        inp, occ_known=torch.zeros((8, 3, 3, 2), dtype=torch.bool),
        dynobs_pos=torch.ones((2, 3)), dynobs_valid=torch.ones(2, dtype=torch.bool))
    fleet_l, inp_l = mesh.shard_step_inputs(fleet, inp, 1, 4)
    assert torch.equal(inp_l.pos, inp.pos[2:4])
    assert torch.equal(inp_l.occ_known, inp.occ_known[2:4])
    assert torch.equal(inp_l.qp_y0, inp.qp_y0[2:4])
    assert torch.equal(fleet_l.max_vel, fleet.max_vel[2:4])
    assert inp_l.dynobs_pos is inp.dynobs_pos and inp_l.planner_seq == inp.planner_seq
    with pytest.raises(ValueError, match="divide evenly"):
        mesh.shard_step_inputs(fleet, inp, 0, 3)


def test_permute_agents_moves_the_sharded_leaves():
    """`halo.permute_agents` reorders exactly the leaves that
    `mesh.shard_step_inputs` splits (one predicate, `mesh.agent_leading`):
    the known maps and the duals move; dynamic obstacles stay, even when
    there are as many of them as agents, and so do the scalars."""
    from lsc_dr_planner_tpu_torch import workload
    from lsc_dr_planner_tpu_torch.parallel import mesh

    _, _, fleet, inp = workload.build_fleet(8, device="cpu")
    inp = dataclasses.replace(
        inp, occ_known=torch.rand((8, 3, 3, 2)) < 0.5, qp_y0=torch.rand(inp.qp_y0.shape),
        dynobs_pos=torch.rand((8, 3)), dynobs_valid=torch.ones(8, dtype=torch.bool))
    perm = torch.arange(7, -1, -1)
    fleet_p, inp_p = halo.permute_agents(fleet, inp, perm)
    for obj, obj_p in ((fleet, fleet_p), (inp, inp_p)):
        for f in dataclasses.fields(obj):
            v, v_p = getattr(obj, f.name), getattr(obj_p, f.name)
            if mesh.agent_leading(f.name, v):
                assert torch.equal(v_p, v[perm]), f.name
            else:
                assert v_p is v, f.name
    assert inp_p.dynobs_pos is inp.dynobs_pos and inp_p.planner_seq == inp.planner_seq
    assert torch.equal(inp_p.occ_known, inp.occ_known.flip(0))
    assert torch.equal(inp_p.qp_y0, inp.qp_y0.flip(0))
    _, inp_l = mesh.shard_step_inputs(fleet, inp, 1, 4)
    assert inp_l.dynobs_pos is inp.dynobs_pos


def test_select_neighbors_pads_dead_slots():
    """Fewer candidates than neighbour slots (a small block, one live
    neighbour): the selection pads with dead slots, which come out
    invalid, after the live in-range candidate; self and a dead candidate
    are never chosen."""
    from lsc_dr_planner_tpu_torch import workload
    from lsc_dr_planner_tpu_torch.parallel import mesh

    _, planner, fleet, inp = workload.build_fleet(8, device="cpu", max_obstacles=4)
    assert planner.O_agents == 4
    cand = mesh.pack_candidates(fleet, inp)[:3]  # agents 0, 1, 2
    ok = torch.tensor([True, True, False])
    nd = mesh.select_neighbors(planner, inp.pos[:1], torch.tensor([0]), cand,
                               torch.arange(3), ok)
    assert nd.valid.tolist() == [[True, False, False, False]]
    assert torch.equal(nd.pos[0, 0], inp.pos[1])
    assert torch.equal(nd.prev_ctrl[0, 0], inp.prev_ctrl[1])
