"""A whole run (past the look for a card) at a tiny size comes out correct,
and with the timed path broken underneath it comes out not correct: a token
altered where it is produced, decode state left unchanged, a train step
that returns its state unchanged, half of each batch left out of the
loss."""
import pytest
import torch

from drive import run_cell


def test_sound_runs_are_correct(monkeypatch):
    for cell in ("tiny-serve-open", "granite-ft-8jobs"):
        rc, out, err = run_cell(monkeypatch, cell)
        assert rc == 0 and out["correct"], err[-2000:]
        assert list(out)[-1] == "checks"
        assert set(out) >= {"correct", "attempted", "failed", "metrics",
                            "device"}
        assert "setup_s" in out["metrics"]
        assert err.strip().splitlines()[-1].startswith("check ")


def test_a_token_altered_where_produced(monkeypatch):
    from repro_torch.serving.engine import ServingEngine
    orig, count = ServingEngine._sample, [0]

    def altered(self, logits, req):
        out = orig(self, logits, req)
        count[0] += 1
        return (out + 1) % logits.shape[-1] if count[0] % 5 == 0 else out
    monkeypatch.setattr(ServingEngine, "_sample", altered)
    rc, out, err = run_cell(monkeypatch, "tiny-serve-open")
    assert rc == 0 and out["correct"] is False, err[-2000:]


def _restoring(make):
    """A step builder whose steps give their outputs but leave ``state``
    (the named leaves of their arguments) as they found it."""
    def build(*a, **kw):
        step = make(*a, **kw)

        def run(*args):
            saved = [t.clone() for t in _state(args)]
            out = step(*args)
            for t, s in zip(_state(args), saved):
                t.copy_(s)
            return out
        return run
    return build


def _state(args):
    from repro_torch.common.tree import tree_leaves
    return [t for t in tree_leaves(args[1:3])
            if isinstance(t, torch.Tensor)]


def test_decode_state_left_unchanged(monkeypatch):
    from repro_torch.common.tree import tree_leaves
    from repro_torch.core import symbiosis
    make = symbiosis.make_compact_decode_step

    def build(*a, **kw):
        step = make(*a, **kw)

        def run(base, bank, caches, *rest):
            saved = [t.clone() for t in tree_leaves(caches)]
            out = step(base, bank, caches, *rest)
            for t, s in zip(tree_leaves(caches), saved):
                t.copy_(s)
            return out
        return run
    monkeypatch.setattr(symbiosis, "make_compact_decode_step", build)
    rc, out, err = run_cell(monkeypatch, "tiny-serve-backlog")
    assert rc == 0 and out["correct"] is False, err[-2000:]


def test_train_step_returns_its_state_unchanged(monkeypatch):
    from repro_torch.core import symbiosis
    monkeypatch.setattr(symbiosis, "make_compact_train_step",
                        _restoring(symbiosis.make_compact_train_step))
    rc, out, err = run_cell(monkeypatch, "granite-ft-8jobs")
    assert rc == 0 and out["correct"] is False, err[-2000:]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_each_batch_left_out(monkeypatch):
    from bench.traffic import JobStream
    orig = JobStream.batch

    def half(self, step):
        b = dict(orig(self, step))
        mask = torch.ones(b["tokens"].shape)
        mask[self.batch_size // 2:] = 0.0
        b["mask"] = mask
        return b
    monkeypatch.setattr(JobStream, "batch", half)
    rc, out, err = run_cell(monkeypatch, "deepseek-ft-4jobs")
    assert rc == 0 and out["correct"] is False, err[-2000:]


def test_without_a_card_there_is_no_result(monkeypatch, capsys):
    import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "granite-ft-8jobs", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""
