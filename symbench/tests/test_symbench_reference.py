"""The plain reference agrees with the port at a tiny fp32 size on the CPU,
served tokens and fine-tuning steps alike, and the fp8 control does not."""
import pytest

import tiny
from bench import manifest

LOG = lambda m: None


@pytest.mark.parametrize("cfg,loop", [("granite-3-8b", "serve_open"),
                                      ("deepseek-moe-16b", "serve_backlog")])
def test_served_tokens_agree_and_the_control_does_not(cfg, loop):
    m = tiny.serve_mix(loop)
    m["check"] = {"served_tokens": 60, "max_requests": 6,
                  "watched_share": 0.8}
    _, res, nums = manifest.loop(m).run(tiny.arch(cfg), m, "tiny-" + loop,
                                        5, 1.5, False, "cpu", LOG,
                                        control=True)
    assert res["failed"] == 0
    assert nums["served_logit_gap"] < 1e-4
    assert nums["served_logit_err"] < 1e-4
    assert nums["control_logit_err"] > 100 * nums["served_logit_err"]


@pytest.mark.parametrize("cfg,mix,cell", [
    ("granite-3-8b", "ft-8jobs", "granite-ft-8jobs"),
    ("deepseek-moe-16b", "ft-4jobs", "deepseek-ft-4jobs")])
def test_fine_tuning_steps_agree(cfg, mix, cell):
    m = tiny.train_mix(mix)
    _, res, nums = manifest.loop(m).run(tiny.arch(cfg), m, cell, 5, 0.5,
                                        False, "cpu", LOG)
    assert res["failed"] == 0
    assert nums["loss_gap"] < 1e-5
    assert nums["first_grad_gap"] < 1e-4
    assert nums["change_gap"] < 1e-3


def test_fine_tuning_control_reads_above_the_program():
    from bench import check
    arch, mix = tiny.arch("granite-3-8b"), tiny.train_mix("ft-8jobs")
    train = manifest.loop(mix)
    base, jobs, eng = train.build(arch, mix, 9, "cpu")
    prog = train.first_steps(eng, jobs, 3)
    ref = train.reference(arch, base, jobs, mix, 3)
    low = train.reference(arch, base, jobs, mix, 3, fp8=True)
    sound, control = check.train_numbers(prog, ref), \
        check.train_numbers(low, ref)
    assert max(control.values()) > 10 * max(sound.values())
