"""PyTorch port vs the JAX reference: the seeded chaos sweep
(``repro_torch.faults.chaos``).

Each scenario checks its contracts port against port, bit for bit (the
faulted run against the port's clean run, the restored service against
the uninterrupted one). Against JAX's sweep on the same seed: the faults
injected, per kind, and what the engines did with them (faults counted,
clients quarantined, the checkpoint restored).

The fine-tuning scenario's bitwise contract rests on the compact train
step's bank-size invariance: a job's losses and state are bit for bit the
same alone and at every position of any bucket, beside padding and NaN
rows (``chaos.bank_rows_drift``). The CPU gives it, and the tier-1 case
pins that the CPU path does. The H100 does not (one BLAS product over the
bucket's rows: ROADMAP Queue 3, a stated departure), and only
``chip_smoke.py`` phase 12e, which runs the same check on the card, can
see a change there; a CPU case cannot fail for it.

In tier-1: the serving and symbiotic scenarios and the CPU invariance.
Under the ``chaos`` marker
(``pytest -m chaos tests/test_torch_chaos.py``): the whole sweep, whose
fine-tuning scenario's injected faults must equal JAX's and whose jobs
must not drift from the clean run at all. JAX's own fine-tuning errors
are not compared: on the CPU its faulted jobs do not stay bit for bit its
clean run's, a reference-side defect the port's CPU path does not share.
"""
import pytest

from repro.faults import chaos as jax_chaos
from repro_torch.config import AdapterConfig
from repro_torch.faults import chaos
from test_torch_model import one_thread  # noqa: F401 (autouse fixture)


def test_serving_scenario_matches_reference():
    got = chaos.serving_scenario(0, device="cpu")
    assert got["errors"] == []
    want = jax_chaos.serving_scenario(0)
    assert want["errors"] == []
    for key in ("injected", "total", "engine_faults", "quarantined_clients"):
        assert got[key] == want[key], key
    assert got["total"] == 9 and len(got["injected"]) == 4


def test_symbiotic_scenario_matches_reference(tmp_path):
    got = chaos.symbiotic_scenario(0, str(tmp_path / "port"), device="cpu")
    assert got["errors"] == []
    want = jax_chaos.symbiotic_scenario(0, str(tmp_path / "jax"))
    assert want["errors"] == []
    for key in ("injected", "total", "restored_seq"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("method", ["lora", "ia3"])
def test_compact_step_is_bank_size_invariant(method):
    """On the CPU a LoRA or IA3 job's bits do not depend on its bucket
    (what the fine-tuning scenario's bitwise contract needs). The card's
    departure is measured by phase 12e, not here."""
    acfg = chaos._lora() if method == "lora" else AdapterConfig(
        method="ia3", targets=("k", "v", "down"))
    assert chaos.bank_rows_drift(chaos._tiny_cfg(), acfg, 16,
                                 device="cpu") == {}


@pytest.mark.chaos
def test_chaos_sweep(tmp_path):
    report = chaos.run_sweep(seed=0, workdir=str(tmp_path), device="cpu")
    assert report["ok"], report["errors"]
    assert report["total_injected"] >= 30
    assert len(report["kinds"]) >= 4
    want = jax_chaos.finetune_scenario(0)
    got = report["scenarios"][0]
    assert got["scenario"] == "finetune"
    assert got["loss_drift"] == 0.0 and got["state_drift"] == 0.0
    assert got["injected"] == want["injected"]
