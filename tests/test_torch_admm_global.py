"""The ADMM kernel's global build (`csrc/admm.cu`, `<256,0,global>`) on the CPU.

The kernel runs only on the card (its `cuda` tests are in
tests/test_torch_cuda.py, which imports no jax). The build runs the
cluster build's order of operations in one block and streams the
agent's rows and Kinv from global memory through a ring of tiles in
shared memory. Here:

- `qp_cuda.global_tile_plan`, the pure-Python tiles that admm.cu's
  global_plan mirrors: every row of every group in exactly one tile, in
  group order and in whole slots; Kinv's rows in tiles; every tile within
  a stage; the copies' heads and tails (`qp_cuda.copy_split`) leave
  16-B aligned copies for every agent, odd row counts among them; the
  block's bytes (`global_block_bytes`) within the H100's opt-in limit;
- the cluster build's CPU twin (tests/test_torch_admm_cluster.py
  `cluster_twin`) at 8g's 480 slots: one CTA holding all 8 groups (the
  global build's cut) gives the bits of eight, and the twin holds to the
  plain loop chunk by chunk.
"""

import dataclasses

import pytest
import torch

from lsc_dr_planner_tpu_torch.ops import qp, qp_cuda

# One intra-op thread: the suite runs in several worker processes on a
# shared CPU (see tests/test_torch_admm_cluster.py).
torch.set_num_threads(1)

H100_SMEM_OPTIN = 232448  # bytes a block may opt in to on the H100 (227 KB)
# (dim, O, M, N, K, R_stat): 8g's 480 and 432 slots at M = 28 (past the
# cluster build), its 160 (the cluster build at C = 8), 8f's shape, and
# shapes with an odd row count R (every other agent's rows then start 4 B
# past the last's 16-B boundary): 3-D at M = 110, 8f's horizon with one
# static row less, and 2-D at M = 10 with 15 slots
SHAPES = {
    "O480": (3, 480, 28, 6, 82, 2478),
    "O432": (3, 432, 28, 6, 82, 2478),
    "dk246_O160": (3, 160, 28, 6, 82, 2478),
    "8f": (3, 80, 12, 6, 34, 774),
    "M110": (3, 1, 110, 6, 328, 23265),
    "8f_odd": (3, 80, 12, 6, 34, 773),
    "2d_odd": (2, 15, 10, 5, 28, 411),
}
# blocks an SM the plan asks for
BLOCKS = {"M110": 1}


def _copies(plan, shape, agent):
    """Every copy of one agent's tiles: (region capacity in floats, offset
    of the source from a 16-B aligned base in floats, floats)."""
    dim, O, M, N, K, R_stat = shape
    MN, dk = M * N, dim * K
    R = O * MN + R_stat
    cl = qp_cuda._r4(plan["T"] * MN + 3)
    cs = qp_cuda._r4(plan["ST"] + 3)
    out = []
    for _, kind, lo, hi in plan["row_jobs"]:
        if kind == "lsc":
            out += [(cl, agent * R + lo * MN, (hi - lo) * MN)] * 5
            out.append((qp_cuda._r4(plan["T"] * M * dim + 3), (agent * O + lo) * M * dim,
                        (hi - lo) * M * dim))
        else:
            out += [(cs, agent * R + O * MN + lo, hi - lo)] * 6
    for k0 in range(0, dk, plan["KT"]):
        k1 = min(dk, k0 + plan["KT"])
        out.append((qp_cuda._r4(plan["KT"] * dk + 3), (agent * dk + k0) * dk, (k1 - k0) * dk))
    return out


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_global_tile_plan(name):
    """The tiles cover every LSC slot and static row of every group once,
    group by group (its LSC tiles in slot order, then its static tiles),
    LSC tiles in whole slots of their group; Kinv's rows once; every tile
    within a stage; each copy's head, 4-B floats and 16-B copies add up,
    and the 16-B copies are aligned at source and destination, for the
    first agents whatever R; the block's bytes are global_block_bytes and
    fit the H100's opt-in limit, two blocks an SM at 8g's shapes."""
    shape = SHAPES[name]
    dim, O, M, N, K, R_stat = shape
    MN, dk = M * N, dim * K
    plan = qp_cuda.global_tile_plan(*shape)
    G, GS = -(-O // qp_cuda.GROUPS), -(-R_stat // qp_cuda.GROUPS)
    assert (plan["G"], plan["GS"]) == (G, GS)
    slots, rows, order = [], [], []
    for j, kind, lo, hi in plan["row_jobs"]:
        assert lo < hi
        if kind == "lsc":
            assert j * G <= lo and hi <= min(O, (j + 1) * G) and hi - lo <= plan["T"]
            slots += range(lo, hi)
        else:
            assert j * GS <= lo and hi <= min(R_stat, (j + 1) * GS) and hi - lo <= plan["ST"]
            rows += range(lo, hi)
        order.append((j, kind == "static", lo))
    assert order == sorted(order)
    assert slots == list(range(O)) and rows == list(range(R_stat))
    stage = plan["stage"]
    assert stage % 4 == 0 and stage <= qp_cuda.GLOBAL_STAGE_CAP
    assert qp_cuda._lsc_tile_floats(dim, M, MN, plan["T"]) <= stage
    assert 6 * qp_cuda._r4(plan["ST"] + 3) <= stage and qp_cuda._r4(plan["KT"] * dk + 3) <= stage
    assert plan["n_kinv"] == -(-dk // plan["KT"])
    for agent in range(4):
        for cap, offset, n in _copies(plan, shape, agent):
            head, pre, body, tail = qp_cuda.copy_split(offset % 4, n)
            assert pre + 4 * body + tail == n and pre < 4 and tail < 4
            assert (offset + pre) % 4 == 0 and (head + pre) % 4 == 0, (offset, head, pre)
            assert head + n <= cap
    nbytes = plan["smem_bytes"]
    assert nbytes == qp_cuda.global_block_bytes(*shape) == 4 * (plan["resident"] + 3 * stage)
    assert nbytes <= H100_SMEM_OPTIN
    want = BLOCKS.get(name, 2)
    assert plan["blocks_per_sm"] == want
    assert qp_cuda.ctas_per_sm(nbytes, H100_SMEM_OPTIN) >= want
    assert plan["n_kinv"] + len(plan["row_jobs"]) >= qp_cuda.GLOBAL_STAGES


def test_copy_split_covers_every_head():
    """Each head 0-3 and length 0-9: the data starts `head` floats into
    the region, the 16-B copies start on a source boundary, every float is
    copied once."""
    for head in range(4):
        for n in range(10):
            h, pre, body, tail = qp_cuda.copy_split(head, n)
            assert h == head and pre + 4 * body + tail == n
            assert pre == min(n, (4 - head) % 4)
            assert body == 0 or (head + pre) % 4 == 0


# ---- the twin at 8g's 480 slots ------------------------------------------


@pytest.fixture(scope="module")
def qp_480():
    """Two agents of random QPs at 8g's 480-slot shape (3-D at M = 28,
    dim·K 246, R = 83,118), the port's plain preparation on the CPU."""
    from test_torch_cuda import _random_qp_inputs

    cfg = qp.QPConfig(dim=3, M=28, n=5, phi=3, n_obs=480, use_comm=True, stop_at_horizon=True,
                      dt=0.2, control_input_weight=0.01, terminal_weight=1.0, rho=1.0,
                      sigma=1e-6, alpha=1.6, max_iter=200, eps_abs=1e-3, rescue_iter=800)
    li = qp.prepare(cfg, _random_qp_inputs(cfg, 2, seed=4, device="cpu")).loop
    K = li.Pn.shape[-1]
    assert (cfg.dim, cfg.n_obs, cfg.M, cfg.N, K, li.z.shape[1] - 480 * 168) == SHAPES["O480"]
    return cfg, li, 5e-3


def test_twin_one_block_is_the_cluster_bits(qp_480):
    """One chunk of the twin with all 8 groups in one CTA (C = 1, the
    global build's cut) against 8 CTAs of one group each: the same bits."""
    from test_torch_admm_cluster import cluster_twin

    cfg, li, feas_tol = qp_480
    one = cluster_twin(cfg, li, qp.CHUNK, feas_tol, C=1)
    eight = cluster_twin(cfg, li, qp.CHUNK, feas_tol, C=8)
    assert all(torch.equal(a, b) for a, b in zip(one, eight))


def test_twin_matches_plain_loop_at_480_slots(qp_480):
    """Two chunks of the twin, each from the twin's state, held to the
    plain chunk from the same state by tests/test_torch_cuda.py's
    `_chunk_held` (per agent within the loop tolerance, or by the float64
    clause: float32 ADMM is ill-conditioned at dim·K 246); the two-chunk
    run is its chain of single chunks, bit for bit."""
    from test_torch_admm_cluster import cluster_twin
    from test_torch_cuda import _chunk_held

    cfg, li, feas_tol = qp_480
    got = cluster_twin(cfg, li, 2 * qp.CHUNK, feas_tol, C=1)
    state = li
    for _ in range(int(got[4]) // qp.CHUNK):
        k = cluster_twin(cfg, state, qp.CHUNK, feas_tol, C=1)
        _chunk_held(cfg, state, k, qp.admm_loop_plain(cfg, state, qp.CHUNK, feas_tol), feas_tol)
        state = dataclasses.replace(state, xi=k[0], z=k[1], y=k[2])
    for a, b in zip(got[:3], (state.xi, state.z, state.y)):
        assert torch.equal(a, b)
