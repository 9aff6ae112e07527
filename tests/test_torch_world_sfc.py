"""Parity of the port's grid world and SFC update with the JAX package:
integer results (blocked counts, lattice indices, corridor boxes) must be
bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsc_dr_planner_tpu.ops import sfc as jsfc
from lsc_dr_planner_tpu.world.grid import build_grid_world as jbuild
from lsc_dr_planner_tpu_torch import convert
from lsc_dr_planner_tpu_torch.ops import sfc as tsfc
from lsc_dr_planner_tpu_torch.world.grid import build_grid_world as tbuild

# One intra-op thread: the suite runs in several worker processes on a
# shared CPU, and torch's spinning thread pool would starve the JAX
# computations of the other workers (small tensors gain nothing from it).
torch.set_num_threads(1)


def _forest(seed=0, n=25):
    """The case generator of tests/test_world.py::test_update_sfc_fused_equivalence."""
    rng = np.random.default_rng(seed)
    boxes = []
    for _ in range(n):
        c = rng.uniform(-4, 4, 2)
        boxes.append([c[0], c[1], 0.5, 0.35, 0.35, 1.0])
    return rng, np.asarray(boxes)


def _worlds():
    rng, boxes = _forest()
    gj = jbuild(boxes, [-5, -5, 0], [5, 5, 1], 0.1, 0.15)
    gt = tbuild(boxes, [-5, -5, 0], [5, 5, 1], 0.1, 0.15, "cpu")
    return rng, gj, gt


def test_build_and_convert_agree():
    _, gj, gt = _worlds()
    np.testing.assert_array_equal(gt.blocked_cumsum.numpy(), np.asarray(gj.blocked_cumsum))
    np.testing.assert_array_equal(gt.occ.numpy(), np.asarray(gj.occ))
    gc = convert.grid_world_from_numpy(vars(gj), "cpu")
    assert torch.equal(gc.blocked_cumsum, gt.blocked_cumsum)
    assert gc.dims == gt.dims and gc.resolution == gt.resolution
    np.testing.assert_array_equal(gc.origin_idx, gt.origin_idx)


def test_box_blocked_count_exact():
    _, gj, gt = _worlds()
    rng = np.random.default_rng(5)
    dims = np.asarray(gt.dims)
    lo = rng.integers(-5, dims + 5, size=(4000, 3)).astype(np.int32)
    hi = (lo + rng.integers(0, 30, size=(4000, 3))).astype(np.int32)
    ct = gt.box_blocked_count(torch.tensor(lo), torch.tensor(hi))
    cj = gj.box_blocked_count(jnp.asarray(lo), jnp.asarray(hi))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert (ct.numpy() > 0).any() and (ct.numpy() == 0).any()


@pytest.mark.parametrize("fn", ["point_to_lattice_floor", "point_to_lattice_ceil",
                                "point_to_lattice_round"])
def test_lattice_conversions_exact(fn):
    _, gj, gt = _worlds()
    rng = np.random.default_rng(6)
    p = rng.uniform(-5, 5, (3000, 3)).astype(np.float32)
    p[:1000] = np.round(p[:1000] * 20) / 20  # exact halves of the lattice step
    np.testing.assert_array_equal(getattr(gt, fn)(torch.tensor(p)).numpy(),
                                  np.asarray(getattr(gj, fn)(jnp.asarray(p))))


def test_sfc_to_world_exact():
    _, gj, gt = _worlds()
    rng = np.random.default_rng(7)
    lo = rng.integers(-2, 40, (500, 3)).astype(np.int32)
    hi = lo + rng.integers(0, 70, (500, 3)).astype(np.int32)
    for a, b in zip(tsfc.sfc_to_world(gt, torch.tensor(lo), torch.tensor(hi), 0.15),
                    jsfc.sfc_to_world(gj, jnp.asarray(lo), jnp.asarray(hi), 0.15)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("radius_cells", [40, 0])
def test_update_sfc_fused_hull_exact(radius_cells):
    """The batched port (all trials as one fleet) against the JAX fused
    update, trial by trial, with and without the expansion clamp."""
    rng, gj, gt = _worlds()
    M = 10
    cases = []
    for _ in range(6):
        pos = np.append(rng.uniform(-4.5, 4.5, 2), 0.6).astype(np.float32)
        last_pt = (pos + np.append(rng.uniform(-0.5, 0.5, 2), 0)).astype(np.float32)
        cgoal = (pos + np.append(rng.uniform(-1.5, 1.5, 2), 0)).astype(np.float32)
        wpt = (pos + np.append(rng.uniform(-1.0, 1.0, 2), 0)).astype(np.float32)
        slo = np.tile(np.asarray(gj.point_to_lattice_floor(jnp.asarray(pos))) - 2, (M, 1))
        shi = np.tile(np.asarray(gj.point_to_lattice_ceil(jnp.asarray(pos))) + 2, (M, 1))
        for init_done in (False, True):
            cases.append((slo, shi, init_done, last_pt, cgoal, wpt, pos))
    cols = [np.stack(c) for c in zip(*cases)]
    t_lo, t_hi = tsfc.update_sfc_fused(gt, *map(torch.tensor, cols),
                                       max_radius_cells=radius_cells)
    for a, (slo, shi, init_done, last_pt, cgoal, wpt, pos) in enumerate(cases):
        ictrl = jnp.asarray(np.repeat(np.linspace(pos, cgoal, M)[:, None, :], 6, axis=1),
                            jnp.float32)
        j_lo, j_hi = jsfc.update_sfc_fused(
            gj, "hull", jnp.asarray(slo), jnp.asarray(shi), jnp.asarray(init_done),
            jnp.asarray(last_pt), jnp.asarray(cgoal), jnp.asarray(wpt),
            jnp.asarray(pos), ictrl, 0.15, max_radius_cells=radius_cells)
        np.testing.assert_array_equal(t_lo[a].numpy(), np.asarray(j_lo), err_msg=str(a))
        np.testing.assert_array_equal(t_hi[a].numpy(), np.asarray(j_hi), err_msg=str(a))
