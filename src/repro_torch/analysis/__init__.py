"""repro_torch.analysis — machine-checked contracts of the port's hot path
(the port of ``repro.analysis``).

The contracts, each a named pass with a mutation self-test in
tests/test_torch_analysis.py (a broken program the pass must catch, beside
the real step it must pass):

* ``buckets``  — the engines declare their closed set of legal step keys;
                 a trace-count guard flags any step signature outside it,
                 or a second one under a key already run
                 (``analysis.tracecount``). The set a CUDA graph capture
                 of the steps would need.
* ``inplace``  — the step's persistent state (page pools, caches, bank,
                 optimizer state) comes back in the same storage, and the
                 frozen base is never written (``analysis.aliasing``: the
                 counterpart of JAX's donation pass).
* ``poolcopy`` — no op of one step materializes a tensor of a protected
                 pool's size outside in-place writes into it; an MoE body
                 of a training forward saves only its input for the
                 backward (``analysis.audit``: the counterparts of
                 ``repro.analysis.jaxpr_passes``).
* ``taint``    — the frozen base stays frozen through a step (no write, no
                 grad, no fresh base-shaped output), and differential
                 isolation probes: perturbing one client's adapter or one
                 train row's inputs leaves every other client's outputs
                 and state bit for bit unchanged (``analysis.taint``).

JAX's collective audit (``analysis.collectives``, base-sized collectives
under a mesh) has no counterpart: the port runs on one card.

Run: ``PYTHONPATH=src python -m repro_torch.analysis --all`` (on the card;
``--device cpu`` runs the kernels' plain versions).
"""
from repro_torch.analysis.report import PassResult, Violation

__all__ = ["PassResult", "Violation"]
