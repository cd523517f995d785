"""repro_torch.analysis -- the port's static consistency-contract checker.

The port of ``repro.analysis``.  Run it over the port::

    PYTHONPATH=src python -m repro_torch.analysis src/repro_torch [--strict]

It is pure AST: it imports neither ``torch`` nor ``jax`` and nothing of
``repro``, and runs wherever Python does (the card's machine has no JAX).
Rule families (``--list-rules`` for the catalog):

- ``rng``        -- ``repro_torch.rng`` keys consumed twice without a
  split/fold_in (``rng-reuse``);
- ``callbacks``  -- host syncs inside the clock-step scope, the functions
  a module names in ``CLOCK_STEP`` and what they reach (``host-sync``,
  the counterpart of ``host-callback``);
- ``collectives``-- mesh dimension hygiene and the masked-before-gather
  churn rule (``axis-unbound``, ``unmasked-gather``);
- ``dataclass``  -- the state classes frozen and never mutated, and the
  knob contract (``state-frozen``, ``state-mutation``, ``knob-split``;
  JAX's ``pytree-frozen`` / ``pytree-mutation``);
- ``cuda``       -- every CUDA kernel bound, dispatched beside a plain
  version that exists, and never wrapped in a fallback (``cuda-ref``,
  ``cuda-fallback``; JAX's ``pallas-ref``);
- ``staleness``  -- the abstract interpreter + model checker over the
  producers' clock-step contract (``staleness-contract``,
  ``staleness-extract``).

The JAX rules with **no counterpart** here, and why (nothing fakes them):

- ``traced-branch``, ``traced-coerce``, ``traced-static-arg``: torch runs
  eagerly, and the config's knobs are Python values
  (``core/consistency.py``), so a branch on a knob recompiles nothing;
- ``collective-outside-shardmap``: a ``torch.distributed`` collective may
  be called anywhere in a process of the world;
- ``pallas-interpret``, ``pallas-blockspec``: CUDA has no interpret mode,
  and no BlockSpec (a kernel's grid is computed in its C++ launcher).

Suppress a single finding inline with a reasoned ignore::

    x = risky()  # analysis: ignore[rule-id] -- why this one is fine

``--strict`` also rejects ignores without a reason.
"""
from .base import (Finding, RULE_DOCS, analyze_paths,  # noqa: F401
                   load_suppression_file)
from .staleness_check import (BoundModel,  # noqa: F401
                              Counterexample, EnforcementModel,
                              ExtractionError,
                              extract_bound_model,
                              extract_bound_model_from_source,
                              extract_enforcement,
                              extract_enforcement_from_source,
                              model_check)

__all__ = [
    "Finding", "RULE_DOCS", "analyze_paths", "load_suppression_file",
    "BoundModel", "EnforcementModel", "Counterexample", "ExtractionError",
    "extract_bound_model", "extract_bound_model_from_source",
    "extract_enforcement", "extract_enforcement_from_source",
    "model_check",
]
