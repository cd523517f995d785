"""Rule family ``dataclass``: the state classes and the knob contract.

The port of ``repro/analysis/pytree_rules.py``.  The JAX package
registers its state and config classes as pytrees; the port keeps them
as plain frozen dataclasses, and these rules hold that:

- ``state-frozen`` -- a class named in :data:`STATE_CLASSES` must be
  ``@dataclass(frozen=True)``.  The simulator, the sharded runtime and
  the sweep pass these objects between clocks, ranks and runs by value;
  in-place mutation would desynchronize a copy, and a frozen class turns
  that bug into an immediate ``FrozenInstanceError``.
- ``state-mutation`` -- attribute assignment (or ``object.__setattr__``)
  on a variable annotated with, or constructed as, one of those classes.
- ``knob-split`` -- every ``KNOB_BOUNDS`` key of ``core/consistency.py``
  is a field of ``ConsistencyConfig``, and ``INT_KNOBS`` is a subset of
  ``KNOB_BOUNDS``: the contract the sweep and the tuner assume.  The
  JAX rule's other half, that ``DATA_FIELDS`` and ``META_FIELDS``
  partition the fields, has no counterpart: the port's config registers
  no pytree, so it has no static/traced split (every knob is a Python
  value, ``core/consistency.py``).
"""
from __future__ import annotations

import ast

from .base import Finding, checker, dotted

# The port's counterparts of the JAX package's registered dataclasses:
# repro/core/ps.py:159 (Trace), core/delays.py:62 (ChurnSchedule),
# psrun/runtime.py:94 (PSState), comm/wire.py:84 (WireFaults) and
# core/consistency.py:282 (ConsistencyConfig).  The wire's per-clock
# state is a dict in the port, not a dataclass.
STATE_CLASSES = ("ConsistencyConfig", "ChurnSchedule", "Trace", "PSState",
                 "WireFaults")

_DOCS = {
    "state-frozen": "state or config dataclass is not frozen=True",
    "state-mutation": "attribute assignment on a state or config instance",
    "knob-split": "KNOB_BOUNDS/INT_KNOBS disagree with ConsistencyConfig's "
                  "fields",
}


def _dataclass_frozen(cls) -> bool | None:
    """True/False if decorated with @dataclass, None if not a dataclass."""
    for dec in cls.decorator_list:
        d = dotted(dec if not isinstance(dec, ast.Call) else dec.func)
        if d and d.split(".")[-1] == "dataclass":
            if isinstance(dec, ast.Call):
                for kw in dec.keywords:
                    if kw.arg == "frozen" \
                            and isinstance(kw.value, ast.Constant):
                        return bool(kw.value.value)
            return False
    return None


def _class_of(annotation) -> str | None:
    """The state class an annotation names (``PSState``, ``"PSState"``,
    ``ps.Trace``), else None."""
    if isinstance(annotation, ast.Constant) \
            and isinstance(annotation.value, str):
        name = annotation.value.split(".")[-1]
    else:
        d = dotted(annotation)
        name = d.split(".")[-1] if d else None
    return name if name in STATE_CLASSES else None


def _instance_vars(mod) -> dict:
    """var name -> class name, for vars bound to state instances."""
    out = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            d = dotted(node.value.func)
            if d and d.split(".")[-1] in STATE_CLASSES:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out[t.id] = d.split(".")[-1]
        elif isinstance(node, ast.arg) and node.annotation is not None:
            cls = _class_of(node.annotation)
            if cls:
                out[node.arg] = cls
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            cls = _class_of(node.annotation)
            if cls:
                out[node.target.id] = cls
    return out


@checker(_DOCS)
def check_state(mod, ctx):
    findings = []
    for cls in ast.walk(mod.tree):
        if isinstance(cls, ast.ClassDef) and cls.name in STATE_CLASSES \
                and _dataclass_frozen(cls) is not True:
            findings.append(Finding(
                "state-frozen", mod.rel, cls.lineno,
                f"state class `{cls.name}` is not @dataclass(frozen=True) "
                f"-- in-place mutation would desynchronize the copies "
                f"passed between clocks, ranks and runs"))

    inst = _instance_vars(mod)
    if inst:
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id in inst \
                            and t.value.id != "self":
                        findings.append(Finding(
                            "state-mutation", mod.rel, node.lineno,
                            f"attribute assignment on state instance "
                            f"`{t.value.id}` ({inst[t.value.id]}) -- use "
                            f"dataclasses.replace / construct a new "
                            f"instance"))
            elif isinstance(node, ast.Call):
                d = dotted(node.func)
                if d == "object.__setattr__" and node.args \
                        and isinstance(node.args[0], ast.Name) \
                        and node.args[0].id in inst:
                    findings.append(Finding(
                        "state-mutation", mod.rel, node.lineno,
                        f"object.__setattr__ on state instance "
                        f"`{node.args[0].id}` ({inst[node.args[0].id]})"))

    findings.extend(_check_knob_split(mod, ctx))
    return findings


def _check_knob_split(mod, ctx):
    """KNOB_BOUNDS and INT_KNOBS against the config's fields -- only in the
    defining module."""
    if ctx.consistency_mod is not mod or mod is None:
        return []
    findings = []
    line = 1
    fields = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ClassDef) \
                and node.name == "ConsistencyConfig":
            line = node.lineno
            for st in node.body:
                if isinstance(st, ast.AnnAssign) \
                        and isinstance(st.target, ast.Name):
                    fields.add(st.target.id)
    phantom = sorted(set(ctx.knob_bounds) - fields) if fields else []
    if phantom:
        findings.append(Finding(
            "knob-split", mod.rel, line,
            f"KNOB_BOUNDS entries that are not ConsistencyConfig fields: "
            f"{phantom} -- bounds describe the config's numeric knobs"))
    bad_int = sorted(set(ctx.int_knobs) - set(ctx.knob_bounds))
    if bad_int:
        findings.append(Finding(
            "knob-split", mod.rel, line,
            f"INT_KNOBS not covered by KNOB_BOUNDS: {bad_int}"))
    return findings
