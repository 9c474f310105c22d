"""Static analysis + runtime concurrency tooling for the platform.

Three halves, one package:

- **graftlint** (``analysis/graftlint.py`` + ``analysis/rules.py``):
  AST-based invariant rules — per-file (frozen-mutation,
  uncached-list, swallowed-exception, blocking-under-lock,
  metric-naming, …) and whole-program over the package call graph
  (``analysis/callgraph.py``): ``lock-order-cycle``,
  ``blocking-reachable-under-lock``, ``await-holding-lock``, plus the
  exception-flow rules (``analysis/exceptions.py`` — interprocedural
  raise-set inference): ``error-contract``,
  ``handler-masks-fencing``, ``dead-except``, each reporting witness
  call chains. Run with ``python -m odh_kubeflow_tpu_torch.analysis``
  (exit-code gated; the tier-1 tests run it, ``tests/test_torch_analysis.py``);
  ``--format=json`` for machines, and a committed
  ``analysis/baseline.json`` ratchet so the gate fails only on NEW
  findings. The knob-registry drift lint (``analysis/knobs.py`` +
  ``knobs.json``) cross-checks every ``os.environ`` knob against the
  registry, the port's ``GUIDE.md``, and the overlay's env stanzas
  (``python -m odh_kubeflow_tpu_torch.analysis.knobs``).
- **sanitizer** (``analysis/sanitizer.py``): the ``GRAFT_SANITIZE=1``
  lock-wrapping layer that turns the randomized property tests into
  race probes (lock-order inversions, non-reentrant re-entry,
  blocking calls under store/cache locks).
- **schedule** (``analysis/schedule.py``): the deterministic schedule
  explorer — serializes scenario threads one-runnable-at-a-time via
  the sanitizer lock factories plus explicit ``sched_point`` markers,
  explores seeded random + bounded systematic interleavings, and
  replays any failing schedule from its seed (``GRAFT_SCHED=<n>``
  scales ``tests/test_torch_schedule.py``'s budgets).

This module is also the platform's single lint entry point:
``lint_registry`` re-exports the live-registry metric naming lint so
callers need exactly one import for every lint surface.
"""

import importlib

# The machinery imports ``sanitizer`` and ``schedule`` on every process
# start; the lint's modules load only when a name below is first used, so
# a control-plane process does not pay for graftlint's import.
_SUBMODULES = frozenset({
    "callgraph", "ducks", "exceptions", "graftlint", "knobs", "protocol",
    "rules", "sanitizer", "schedule",
})
_EXPORTS = {
    **{name: "graftlint" for name in (
        "RULES", "Finding", "ProgramRule", "Rule", "SourceFile", "active_rules",
        "apply_baseline", "default_baseline_path", "lint_source", "load_baseline",
        "main", "register", "run_package", "run_paths", "run_source",
    )},
    "metric_definition_sites": "rules",
}

__all__ = sorted(_SUBMODULES | set(_EXPORTS) | {"lint_registry"})


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name in _EXPORTS:
        return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    if name == "lint_registry":
        from odh_kubeflow_tpu_torch.utils.prometheus import lint_metric_names

        return lint_metric_names
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
