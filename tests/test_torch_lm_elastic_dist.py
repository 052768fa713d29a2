"""An LM arch's elastic restart (`launch.train --elastic`) on gloo CPU
ranks: `torch_dist_cases.py` case `lm_elastic` on 4 ranks, then case
`lm_resume` on 2.

qwen1.5-0.5b SMOKE at batch 2, trained from data 2 x model 2 for 6 steps
with a checkpoint every 2 and `--chaos kill@5xN`:

- `x2`, --seq 64: ranks 2-3 leave at step 5; the survivors remesh onto
  data 1 x model 2 (the sequence re-split over the new model axis), roll
  back to the step-4 checkpoint and finish.  Their steps 4-5 are equal
  on both survivors and within 1e-5 (relative) of a 2-rank data 1 x
  model 2 run resumed from a copy of the same checkpoint (the same
  program on the same mesh from the same state: only the checkpoint
  round trip of the 2 x 2 run's state lies between them);
- `x1`, --seq 48: rank 3 leaves; the 3 survivors remesh onto data 1 x
  model 3, 16 tokens a rank, and finish with equal, finite losses;
- `x1_bad`, --seq 64: model 3 does not divide 64, so the remesh raises
  a ValueError on every rank (the reference's placement of the batch
  over such an axis fails there too) rather than pick another mesh.
"""
import os
import shutil

import numpy as np
import pytest

import torch_dist_cases as cases

KILL, STEPS = cases.LM_ELASTIC_KILL, cases.LM_ELASTIC_STEPS
RESUME_RTOL = 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("lm_elastic"))
    ranks = cases.run("lm_elastic", (2, 2), d, timeout=600)
    sub = os.path.join(d, "resumed")
    shutil.copytree(os.path.join(d, "x2", f"step-{KILL - 1}"),
                    os.path.join(sub, "resume", f"step-{KILL - 1}"))
    resumed = cases.run("lm_resume", (1, 2), sub)
    return {"ranks": ranks, "resumed": resumed}


def test_lm_elastic_loses_two_ranks(runs):
    ranks = runs["ranks"]
    assert [int(r["x2.left_at"]) for r in ranks] == [-1, -1, KILL, KILL]
    for r in ranks[:2]:
        np.testing.assert_array_equal(r["x2.steps"], np.arange(STEPS))
        np.testing.assert_array_equal(r["x2.losses"], ranks[0]["x2.losses"])
    assert np.isfinite(ranks[0]["x2.losses"]).all()
    np.testing.assert_array_equal(ranks[2]["x2.steps"], np.arange(KILL))


def test_lm_elastic_matches_the_resumed_run(runs):
    got = dict(zip(runs["ranks"][0]["x2.steps"].tolist(),
                   runs["ranks"][0]["x2.losses"].tolist()))
    resumed = runs["resumed"]
    np.testing.assert_array_equal(resumed[0]["steps"],
                                  np.arange(KILL - 1, STEPS))
    np.testing.assert_array_equal(resumed[1]["losses"],
                                  resumed[0]["losses"])
    for step, want in zip(resumed[0]["steps"].tolist(),
                          resumed[0]["losses"].tolist()):
        np.testing.assert_allclose(got[step], want, rtol=RESUME_RTOL,
                                   err_msg=f"step {step}")


def test_lm_elastic_onto_three_ranks(runs):
    ranks = runs["ranks"]
    assert [int(r["x1.left_at"]) for r in ranks] == [-1, -1, -1, KILL]
    for r in ranks[:3]:
        np.testing.assert_array_equal(r["x1.steps"], np.arange(STEPS))
        np.testing.assert_array_equal(r["x1.losses"], ranks[0]["x1.losses"])
    assert np.isfinite(ranks[0]["x1.losses"]).all()


def test_lm_elastic_refuses_a_model_axis_that_does_not_divide_seq(runs):
    for r in runs["ranks"]:
        msg = str(r["x1_bad.error"])
        assert "data=1 model=3" in msg and "--seq 64" in msg, msg
        assert "x1_bad.losses" not in r
