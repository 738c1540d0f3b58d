"""On the card: the same tiny cells in bf16 through the port's CUDA kernels,
the program's readings far below the fp8 control's. Skips without a card
(the ``card`` fixture decides)."""
import pytest

import tiny
from bench import manifest

LOG = lambda m: None


@pytest.mark.chip
def test_served_tokens_on_the_card_read_below_the_control(card):
    from repro_torch.kernels import _build
    _build.build(["decode_attn", "sgmv"])
    m = tiny.serve_mix("serve_open")
    m["check"] = {"served_tokens": 60, "max_requests": 6,
                  "watched_share": 0.8}
    _, res, nums = manifest.loop(m).run(
        tiny.arch("granite-3-8b", "bfloat16"), m, "tiny-serve-open", 5, 2.0,
        False, card, LOG, control=True)
    assert res["failed"] == 0
    assert nums["control_logit_err"] > nums["served_logit_err"]


@pytest.mark.chip
def test_fine_tuning_on_the_card_agrees_with_the_reference(card):
    m = tiny.train_mix("ft-4jobs")
    _, res, nums = manifest.loop(m).run(
        tiny.arch("deepseek-moe-16b", "bfloat16"), m, "deepseek-ft-4jobs", 5,
        1.0, False, card, LOG)
    assert res["failed"] == 0
    assert nums["loss_gap"] < 1e-2
