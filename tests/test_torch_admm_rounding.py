"""admm_rounding.py's emulation of the ADMM loop kernel on the CPU: with
no float32 rounding it is the float64 plain loop, and its report runs."""

import json

import pytest
import torch

import admm_rounding
from lsc_dr_planner_tpu_torch.ops import qp, qp_check

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def batch():
    return admm_rounding.batch(4)


def test_emulation_without_rounding_is_the_float64_plain_loop(batch):
    cfg, li = batch
    got = admm_rounding.emulated_loop(cfg, li, 16, "", store32=False)
    want = qp.admm_loop_plain(cfg, qp_check.as_f64(li), 16, 0.0)
    for g, w in zip(got, want[:3]):
        torch.testing.assert_close(g, w, rtol=1e-9, atol=1e-9)


def test_report_has_a_line_a_variant(capsys):
    admm_rounding.main(["--A", "4", "--iters", "8", "--variants", "all,abix"])
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["variant"] for r in recs] == ["float32 plain loop", "all", "abix"]
    for r in recs:
        for t in "xzy":
            assert 0.0 <= r[t]["p90"] <= r[t]["max"] < float("inf"), r
