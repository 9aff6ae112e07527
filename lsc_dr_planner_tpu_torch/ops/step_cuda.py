"""Wrappers of the hand-written Hopper kernels of the step's neighbour,
prediction, goal and QP-input stages (`csrc/step_stages.cu`).

- `neighbor_slots_cuda`: each agent's OA nearest other agents of its
  scenario (planner/stages.py::neighbor_slots; the JAX package's
  lsc_dr_planner_tpu/planner/pipeline.py:226-252, `lax.top_k`), a block
  an agent;
- `step_front_cuda`: stages 1 and 2 with the neighbour gather
  (stages.step_front; pipeline.py:292-445 of the JAX package), a block
  an agent;
- `front_with_neighbors_cuda`: the two in one launch
  (stages.front_with_neighbors): each block selects its agent's
  neighbours, then predicts from them;
- `goal_qp_inputs_cuda`: stage 5 and the QP-input assembly of stage 6
  (stages.goal_qp_inputs; planner/goal.py:26-122 and pipeline.py:566-690
  of the JAX package), a block an agent.

The selection and the prediction have narrow builds (OA <= 32, O <= 64,
every source row staged in shared memory at once: the main path's) and
wide builds for every other shape (`selection_build`, `front_build`):
a block-wide radix select of the OA nearest over distance bits computed
once into shared memory, and a sort of them; the slot tables in dynamic
shared memory sized by O, every output a store stream, the shifted rows
read straight from global memory (a fleet too small to fill the card:
each agent's predictions over several blocks). Device memory is the
only limit on
OA < A and O in practice (the wide tables take ~62 B a slot and the
selection ~4 B a candidate of the 227 KB of shared memory: O up to
~3,500, A up to ~55,000).

None had a Pallas original. Each takes CUDA tensors only and raises on
anything else (stages.py gives them CUDA tensors and CPU tensors to the
plain bodies), queues one launch on the current stream and does not
synchronise. Each allocates its outputs with one `torch.empty` apiece,
and checks its inputs' devices, types and shapes once for each
configuration (kept in the planner's StageConfig.cache, by the fleet's
size and which optional inputs are given); an input that is not
contiguous is copied first (BVC's expanded margins). The source is
compiled at first use by `cuda_build` into `build/` and loaded with
ctypes. `neighbor_launches`, `front_launches`, `fused_launches` and
`goal_launches` count each entry's launches since `reset_launches()`,
`wide_launches` those of the three entries' wide builds among them.
"""

from __future__ import annotations

import ctypes

import torch

from lsc_dr_planner_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "step_stages.cu"
BLOCK_THREADS = 128  # every stage kernel: one agent a block of 4 warps

neighbor_launches = 0  # neighbor_slots kernel launches since the last reset
front_launches = 0  # step_front kernel launches (slots given) since the last reset
fused_launches = 0  # step_front kernel launches with its own selection since the last reset
goal_launches = 0  # goal_qp_inputs kernel launches since the last reset
# launches of the wide builds since the last reset, per entry
wide_launches = {"neighbor_slots": 0, "step_front": 0, "front_with_neighbors": 0}
_lib = None


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(cuda_build.compile_source(SOURCE, verbose)))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.neighbor_slots_launch.argtypes = [P, I, I, I, F, I, P, P, P]
    lib.neighbor_slots_launch.restype = I
    lib.step_front_smem_bytes.argtypes = [I] * 8
    lib.step_front_build.argtypes = [I] * 8
    lib.step_front_parts.argtypes = [I]
    lib.neighbor_slots_smem_bytes.argtypes = [I] * 2
    lib.neighbor_slots_build.argtypes = [I] * 2
    lib.step_stages_occupancy.argtypes = [I, I, I, I, P]
    for fn in (lib.step_front_smem_bytes, lib.step_stages_occupancy, lib.step_front_build,
               lib.step_front_parts, lib.neighbor_slots_smem_bytes, lib.neighbor_slots_build):
        fn.restype = I
    for fn in (lib.step_front_launch, lib.goal_qp_inputs_launch):
        fn.argtypes = [P, P, P, P]
        fn.restype = I
    _lib = lib
    return lib


def reset_launches():
    global neighbor_launches, front_launches, fused_launches, goal_launches
    neighbor_launches = front_launches = fused_launches = goal_launches = 0
    for k in wide_launches:
        wide_launches[k] = 0


def list_len(A: int, OA: int) -> int:
    """K, the keys each of the narrow neighbour selection's 128 threads
    keeps (the kernel's list_len): the least of 8, 16 and 32 that holds
    min(OA, its ceil(A/128) candidates)."""
    need = min(OA, -(-A // BLOCK_THREADS))
    return 8 if need <= 8 else 16 if need <= 16 else 32


def selection_build(A: int, OA: int) -> int:
    """The neighbour selection's build for OA of A agents (the kernel's
    neighbor_slots_build): its list K (list_len) for the narrow builds,
    0 for the wide build."""
    return build().neighbor_slots_build(A, OA)


def front_build(A: int, S: int, O: int, OA: int, M: int, n: int, mode: int,
                select: bool) -> int:
    """The prediction kernel's build for the shape (the kernel's
    step_front_build): its selection's list K (8 without one), 0 for the
    wide builds, -1 for a shape no build takes."""
    return build().step_front_build(A, S, O, OA, M, n, mode, int(select))


def occupancy(kernel: int, n: int, K: int, smem_bytes: int) -> int:
    """Blocks an SM of a stage kernel (0: the neighbour selection with
    lists of K, 1: the prediction with its slots given, 2: with its own
    selection, 3: the goal; n: the Bézier degree) at `smem_bytes` of
    dynamic shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    out = ctypes.c_int(0)
    rc = build().step_stages_occupancy(kernel, n, K, smem_bytes, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"step_stages_occupancy failed: CUDA error {rc}")
    return out.value


def _outputs(dev, specs):
    """{name: a new contiguous tensor} for specs [(name, shape, dtype)]:
    one torch.empty each, which the card's host issues faster than views
    carved out of one buffer (three tensor operations a view)."""
    return {name: torch.empty(shape, dtype=dtype, device=dev) for name, shape, dtype in specs}


def _check(name, t, dtype, shape, dev):
    if t.device != dev or t.dtype != dtype:
        raise ValueError(f"{name}: need {dtype} on {dev}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")


def _ptrs(tensors):
    """(the data pointers of `tensors` (None: a null pointer) as a C array,
    the tensors they point into): a tensor that is not contiguous is
    copied first, once however often it is listed (queued on the current
    stream, before the launch; 3-D's prev_ctrl, a permuted view, is both
    the sources and the agents' own), and the copy kept alive with the
    launch's arguments."""
    keep, copies = [], {}
    for t in tensors:
        if t is not None and not t.is_contiguous():
            if id(t) not in copies:
                copies[id(t)] = t.contiguous()
            t = copies[id(t)]
        keep.append(t)
    return (ctypes.c_void_p * len(keep))(*(None if t is None else t.data_ptr()
                                            for t in keep)), keep


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def neighbor_slots_cuda(cfg, sc, pos, scenarios: int):
    """Queue the neighbour selection (stages.neighbor_slots) of pos [S·A,
    3] (float32 on a CUDA device; S = `scenarios`) on the current stream:
    one launch (none where cfg.OA is 0, a fleet of one). cfg: the
    planner's stages.StageConfig; sc: its stage_scalars. Returns (order
    int64 [S·A, OA] into the flattened fleet, valid bool [S·A, OA])."""
    global neighbor_launches
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"the neighbour kernel needs CUDA tensors, got {dev}")
    SA, OA = pos.shape[0], cfg.OA
    key = ("neighbors", SA, scenarios, dev)
    if key not in cfg.cache:
        _check("pos", pos, torch.float32, (SA, 3), dev)
        if scenarios < 1 or SA % scenarios or not 0 <= OA < SA // scenarios:
            raise ValueError(f"neighbour kernel: S = {scenarios}, S·A = {SA}, OA = {OA}: need "
                             f"S | S·A and 0 <= OA < A")
        cfg.cache[key] = OA > 0 and selection_build(SA // scenarios, OA) == 0
    pos = pos.contiguous()
    out = _outputs(dev, (("order", (SA, OA), torch.int64), ("valid", (SA, OA), torch.bool)))
    if OA == 0:
        return out["order"], out["valid"]
    lib = build()
    rc = lib.neighbor_slots_launch(pos.data_ptr(), scenarios, SA // scenarios, OA, sc["range"],
                                   int(cfg.comm_range > 0), out["order"].data_ptr(),
                                   out["valid"].data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"neighbor_slots_launch failed: CUDA error {rc}")
    neighbor_launches += 1
    wide_launches["neighbor_slots"] += cfg.cache[key]
    return out["order"], out["valid"]


# the kernel's FrontPtrs, in order
_FRONT_INPUTS = ("order", "slot_valid", "src_prev", "src_has_prev", "src_pos", "src_vel",
                 "src_radius", "src_downwash", "src_goal", "prev", "has_prev", "pos", "vel",
                 "disturbed", "max_acc", "dyn_pos", "dyn_vel", "dyn_radius", "dyn_downwash",
                 "dyn_max_acc", "dyn_valid", "growth", "sub")
_FRONT_OUTPUTS = ("obs_pred", "obs_valid", "obs_is_agent", "obs_radius", "obs_downwash",
                  "obs_max_acc", "obs_pos_now", "obs_goal", "initial_ctrl", "obs_pred_sizes",
                  "order", "valid")


def step_front_cuda(cfg, sc, fleet, inp, order, valid, neighbors, scenarios: int) -> dict:
    """Queue stages 1 and 2 (stages.step_front) on the current stream: one
    launch. cfg: the planner's stages.StageConfig; sc: its
    stage_scalars; the agent slots through `order` [A, OA] and `valid`
    into the fleet's arrays, or from `neighbors` (a NeighborData [A, OA,
    ...], then order and valid are None). Returns {name: tensor} of
    stages.Front's fields."""
    global front_launches
    out, wide = _front(cfg, sc, fleet, inp, order, valid, neighbors, scenarios, False)
    front_launches += 1
    wide_launches["step_front"] += wide
    return out


def front_with_neighbors_cuda(cfg, sc, fleet, inp, scenarios: int) -> dict:
    """Queue the neighbour selection and stages 1 and 2
    (stages.front_with_neighbors) on the current stream: one launch, each
    block selecting its agent's slots among inp.pos [S·A, 3] first.
    Returns {name: tensor} of stages.Front's fields with `order` and
    `valid` ([S·A, OA], as neighbor_slots_cuda's)."""
    global fused_launches
    out, wide = _front(cfg, sc, fleet, inp, None, None, None, scenarios, True)
    fused_launches += 1
    wide_launches["front_with_neighbors"] += wide
    return out


def _front(cfg, sc, fleet, inp, order, valid, neighbors, scenarios: int, select: bool) -> tuple:
    """step_front_launch with the slots given (`order`, `valid` or
    `neighbors`) or, with `select`, its own selection: (outputs, whether
    a wide build took it)."""
    dev = inp.pos.device
    if dev.type != "cuda":
        raise ValueError(f"the prediction kernel needs CUDA tensors, got {dev}")
    A, S, O, OA, OD, M, N = inp.pos.shape[0], scenarios, cfg.O, cfg.OA, cfg.OD, cfg.M, cfg.n + 1
    f32, b = torch.float32, torch.bool
    nd = neighbors
    if nd is not None:
        src = dict(order=None, slot_valid=nd.valid, src_prev=nd.prev_ctrl,
                   src_has_prev=nd.has_prev, src_pos=nd.pos, src_vel=nd.vel,
                   src_radius=nd.radius, src_downwash=nd.downwash, src_goal=nd.goal)
        rows = A * OA
    else:
        src = dict(order=order, slot_valid=valid, src_prev=inp.prev_ctrl,
                   src_has_prev=inp.has_prev, src_pos=inp.pos, src_vel=inp.vel,
                   src_radius=fleet.radius, src_downwash=fleet.downwash,
                   src_goal=inp.current_goal)
        rows = A
    ins = dict(src, prev=inp.prev_ctrl, has_prev=inp.has_prev, pos=inp.pos, vel=inp.vel,
               disturbed=inp.is_disturbed, max_acc=fleet.max_acc, growth=cfg.growth, sub=cfg.sub,
               **({"dyn_" + k: getattr(inp, "dynobs_" + k) for k in (
                   "pos", "vel", "radius", "downwash", "max_acc", "valid")} if OD else {}))
    key = ("front", A, S, nd is None, select, dev)
    if key not in cfg.cache:
        lead = (A, OA) if nd is not None else (rows,)
        dyn = (S * OD,) if S > 1 else (OD,)
        shapes = dict(order=((A, OA), torch.int64), slot_valid=((A, OA), b),
                      src_prev=(lead + (M, N, 3), f32), src_has_prev=(lead, b),
                      src_pos=(lead + (3,), f32), src_vel=(lead + (3,), f32),
                      src_radius=(lead, f32), src_downwash=(lead, f32),
                      src_goal=(lead + (3,), f32), prev=((A, M, N, 3), f32), has_prev=((A,), b),
                      pos=((A, 3), f32), vel=((A, 3), f32), disturbed=((A,), b),
                      max_acc=((A, 3), f32), growth=((M, N), f32), sub=((N, N), f32),
                      dyn_pos=(dyn + (3,), f32), dyn_vel=(dyn + (3,), f32),
                      dyn_radius=(dyn, f32), dyn_downwash=(dyn, f32), dyn_max_acc=(dyn, f32),
                      dyn_valid=(dyn, b))
        for name, t in ins.items():
            if t is not None:
                shape, dtype = shapes[name]
                if name.startswith("dyn_") and S > 1:
                    t = t.reshape(-1, *t.shape[2:])
                _check(name, t, dtype, shape, dev)
        if O < 1 or S < 1 or A % S or cfg.n < 1:
            raise ValueError(f"prediction kernel: O = {O}, S = {S}, A = {A}")
        if select and not (0 <= OA and (OA == 0 or OA < A // S)):
            raise ValueError(f"neighbour selection: S = {S}, S·A = {A}, OA = {OA}: need "
                             f"0 <= OA < A")
        fb = front_build(A, S, O, OA, M, cfg.n, cfg.mode, select)
        if fb < 0:
            raise ValueError(f"prediction kernel: O = {O} slots, OA = {OA} of {A // S} agents: "
                             f"the slot tables and the selection pass shared memory")
        cfg.cache[key] = (fb == 0, (ctypes.c_int * 12)(A, S, O, OA, OD, M, cfg.n, cfg.mode,
                                              int(cfg.size_growth),
                                              int(cfg.velocity_guard is not None), int(select),
                                              int(cfg.comm_range > 0)),
                         (ctypes.c_float * 4)(sc["dt"], sc["reset"], sc["guard"], sc["range"]))
    wide, ints, flts = cfg.cache[key]
    spec = [("obs_pred", (A, O, M, N, 3), f32), ("obs_valid", (A, O), b),
            ("obs_is_agent", (A, O), b), ("obs_radius", (A, O), f32),
            ("obs_downwash", (A, O), f32), ("obs_max_acc", (A, O), f32),
            ("obs_pos_now", (A, O, 3), f32), ("obs_goal", (A, O, 3), f32),
            ("initial_ctrl", (A, M, N, 3), f32)]
    if cfg.sizes:
        spec.append(("obs_pred_sizes", (A, O, M, N), f32))
    if select:
        spec += [("order", (A, OA), torch.int64), ("valid", (A, OA), b)]
    out = _outputs(dev, spec)
    out.setdefault("obs_pred_sizes", None)
    ptrs, _keep = _ptrs([ins.get(k) for k in _FRONT_INPUTS]
                        + [out.get(k) for k in _FRONT_OUTPUTS])
    rc = build().step_front_launch(ptrs, ints, flts, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"step_front_launch failed: CUDA error {rc}")
    return out, wide


# the kernel's GoalPtrs, in order
_GOAL_INPUTS = ("pos", "vel", "current_goal", "desired_goal", "next_waypoint", "disturbed",
                "has_prev", "nominal_velocity", "radius", "normals", "anchors", "margins",
                "obs_valid", "sfc_lo", "sfc_hi", "world_lo", "world_hi", "y0_in")
_GOAL_OUTPUTS = ("new_goal", "terminal_mask", "lsc_rhs", "lsc_active", "lb", "ub",
                 "comm_halfrange", "y0")


def goal_qp_inputs_cuda(cfg, sc, fleet, inp, normals, anchors, margins, obs_valid, sfc_lo_w,
                        sfc_hi_w, planner_seq: int) -> dict:
    """Queue stage 5 and the QP-input assembly (stages.goal_qp_inputs) on
    the current stream: one launch. Returns {name: tensor} of
    stages.GoalQP's fields."""
    global goal_launches
    dev = inp.pos.device
    if dev.type != "cuda":
        raise ValueError(f"the goal kernel needs CUDA tensors, got {dev}")
    A, O, M, N, dim = inp.pos.shape[0], cfg.O, cfg.M, cfg.n + 1, cfg.dim
    f32, b = torch.float32, torch.bool
    y0_in = inp.qp_y0 if inp.qp_y0 is not None and cfg.warm_duals else None
    ins = dict(pos=inp.pos, vel=inp.vel, current_goal=inp.current_goal,
               desired_goal=inp.desired_goal, next_waypoint=inp.next_waypoint,
               disturbed=inp.is_disturbed, has_prev=inp.has_prev,
               nominal_velocity=fleet.nominal_velocity, radius=fleet.radius,
               normals=normals, anchors=anchors, margins=margins, obs_valid=obs_valid,
               sfc_lo=sfc_lo_w if cfg.use_sfc else None, sfc_hi=sfc_hi_w if cfg.use_sfc else None,
               world_lo=cfg.world_lo, world_hi=cfg.world_hi, y0_in=y0_in)
    R = 0 if y0_in is None else y0_in.shape[-1]
    key = ("goal", A, R, dev)
    if key not in cfg.cache:
        shapes = dict(pos=(A, 3), vel=(A, 3), current_goal=(A, 3), desired_goal=(A, 3),
                      next_waypoint=(A, 3), disturbed=(A,), has_prev=(A,),
                      nominal_velocity=(A,), radius=(A,), normals=(A, O, M, 3),
                      anchors=(A, O, M, N, 3), margins=(A, O, M, N), obs_valid=(A, O),
                      sfc_lo=(A, M, 3), sfc_hi=(A, M, 3), world_lo=(3,), world_hi=(3,),
                      y0_in=(A, R))
        for name, t in ins.items():
            if t is not None:
                _check(name, t, b if name in ("disturbed", "has_prev", "obs_valid") else f32,
                       shapes[name], dev)
        if dim not in (2, 3) or O < 1:
            raise ValueError(f"goal kernel: dim = {dim} (2 or 3), O = {O}")
        cfg.cache[key] = ((ctypes.c_int * 10)(A, O, M, N, dim, cfg.phi, R, cfg.goal,
                                              int(cfg.use_sfc), int(cfg.comm_range > 0)),
                         (ctypes.c_float * 7)(sc["dt"], sc["Mdt"], sc["tiny"], sc["qp_margin"],
                                              sc["comm_box"], sc["comm_half"], sc["dl_vel"]))
    ints, flts = cfg.cache[key]
    ints = (ctypes.c_int * 11)(*ints, int(planner_seq > cfg.deadlock_seq))
    spec = [("new_goal", (A, 3), f32), ("terminal_mask", (A, M), f32),
            ("lsc_rhs", (A, O, M, N), f32), ("lsc_active", (A, O, M, N), b),
            ("lb", (A, dim, M, N), f32), ("ub", (A, dim, M, N), f32),
            ("comm_halfrange", (A,), f32)]
    if R:
        spec.append(("y0", (A, R), f32))
    out = _outputs(dev, spec)
    out.setdefault("y0", None)
    ptrs, _keep = _ptrs([ins[k] for k in _GOAL_INPUTS] + [out[k] for k in _GOAL_OUTPUTS])
    rc = build().goal_qp_inputs_launch(ptrs, ints, flts, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"goal_qp_inputs_launch failed: CUDA error {rc}")
    goal_launches += 1
    return out
