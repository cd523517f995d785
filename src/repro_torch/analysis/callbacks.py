"""Rule ``host-sync``: a host sync inside the clock-step scope.

The counterpart of ``repro/analysis/callbacks.py``'s ``host-callback``.
The port's clock loop keeps the card's stream full only while the host
never waits for it: every clock enqueues its kernels and moves on, and
the Trace is read once the run returns (``chip_smoke.py``'s
``watch_syncs`` counts 0 syncs at run time; this rule is its static
side).  Inside the clock-step scope (``base.clock_step_functions``) it
flags what makes the host wait for the device:

- ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``;
- ``float(...)``, ``int(...)``, ``bool(...)`` of a tensor expression;
- ``torch.cuda.synchronize``;
- a tensor expression as the test of an ``if``, a ``while`` or a
  conditional expression (Python must read its value).

A *tensor expression* is one the function can see is a tensor: a call of
a ``torch.*`` function, a tensor method (``.sum()``, ``.any()``,
``.amax()``, ``.masked_fill()``, ...), a name assigned from one, or an
operator, comparison or subscript over one.  Shapes, dtypes, devices and
sizes (``.shape``, ``.dim()``, ``.numel()``) are host values, as are
identity tests (``t is None``).

Modules under ``obs/`` that declare no ``CLOCK_STEP`` (the host-side
drain, the event stream, the monitor and the exporters) are exempt, as
``repro/obs/`` is in the JAX package: they run after the run, on the
host.  ``obs/metrics.py``'s ``device_update`` runs every clock and is
checked.  A genuine one-off takes the reasoned suppression::

    n = int(mask.sum())  # analysis: ignore[host-sync] -- why
"""
from __future__ import annotations

import ast

from .base import Finding, checker, clock_step_functions, dotted, \
    enclosing_function

SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
COERCIONS = {"float", "int", "bool"}
SYNC_CALLS = {"torch.cuda.synchronize", "cuda.synchronize"}
# tensor methods that return a tensor
TENSOR_METHODS = {
    "sum", "amax", "amin", "max", "min", "any", "all", "mean", "prod",
    "norm", "count_nonzero", "abs", "clone", "to", "masked_fill",
    "masked_fill_", "where", "float", "int", "long", "bool", "half",
    "contiguous", "view", "reshape", "expand", "unsqueeze", "squeeze",
    "gather", "index_select", "cumsum", "argmax", "argmin", "eq", "ne",
    "lt", "le", "gt", "ge", "logical_and", "logical_or", "logical_not",
    "add", "sub", "mul", "div", "add_", "sub_", "mul_", "zero_", "fill_",
    "clamp", "square", "sqrt", "exp", "detach", "flatten", "unbind",
    "nonzero", "isfinite", "isnan", "remainder"}
# methods of a tensor that return host values
HOST_METHODS = {"size", "dim", "numel", "element_size", "stride",
                "data_ptr", "is_contiguous", "get_device", "nelement"}
# torch functions that return host values
HOST_TORCH = {"torch.is_tensor", "torch.device", "torch.Size",
              "torch.get_default_dtype", "torch.is_floating_point",
              "torch.numel", "torch.cuda.is_available",
              "torch.cuda.device_count", "torch.cuda.current_stream"}

_DOCS = {
    "host-sync": ".item()/.tolist()/.cpu()/.numpy(), float/int/bool of a "
                 "tensor, torch.cuda.synchronize, or a tensor branch "
                 "inside the clock-step scope (the host waits for the "
                 "card every clock)",
}


def _tensor_names(fnode) -> set:
    """Names the function assigns from tensor expressions (to a fixpoint,
    in source order)."""
    names: set = set()
    changed = True
    while changed:
        changed = False
        for node in ast.walk(fnode):
            if not isinstance(node, (ast.Assign, ast.AugAssign,
                                     ast.AnnAssign)):
                continue
            if node.value is None or not is_tensor(node.value, names):
                continue
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name) and n.id not in names:
                        names.add(n.id)
                        changed = True
    return names


def is_tensor(node, names: set) -> bool:
    """Does ``node`` evaluate to a tensor, as far as the function shows?"""
    if isinstance(node, ast.Name):
        return node.id in names
    if isinstance(node, ast.Call):
        d = dotted(node.func)
        if d is not None and d.startswith("torch."):
            return d not in HOST_TORCH and not d.startswith("torch.cuda.")
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr in HOST_METHODS or attr in SYNC_METHODS:
                return False
            return attr in TENSOR_METHODS and (
                is_tensor(node.func.value, names)
                or attr in {"sum", "amax", "amin", "any", "all", "mean",
                            "count_nonzero", "masked_fill", "argmax"})
        return False
    if isinstance(node, ast.Attribute):     # `.T`; `.shape` & co. are host
        return node.attr == "T" and is_tensor(node.value, names)
    if isinstance(node, ast.Subscript):
        return is_tensor(node.value, names)
    if isinstance(node, ast.BinOp):
        return is_tensor(node.left, names) or is_tensor(node.right, names)
    if isinstance(node, ast.UnaryOp):
        return is_tensor(node.operand, names)
    if isinstance(node, ast.BoolOp):
        return any(is_tensor(v, names) for v in node.values)
    if isinstance(node, ast.Compare):
        if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
               for op in node.ops):
            return False
        return is_tensor(node.left, names) or any(
            is_tensor(c, names) for c in node.comparators)
    if isinstance(node, ast.IfExp):
        return is_tensor(node.body, names) or is_tensor(node.orelse, names)
    return False


def _sync_of(node, names: set) -> str | None:
    """What makes the host wait in ``node`` (a Call), or None."""
    d = dotted(node.func)
    if d in SYNC_CALLS:
        return f"`{d}()`"
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr in SYNC_METHODS and not node.args \
            and not node.keywords:
        return f"`.{node.func.attr}()`"
    if isinstance(node.func, ast.Name) and node.func.id in COERCIONS \
            and len(node.args) == 1 and is_tensor(node.args[0], names):
        return f"`{node.func.id}(...)` of a tensor"
    return None


def _is_exempt(mod) -> bool:
    rel = mod.rel.replace("\\", "/")
    return "/obs/" in "/" + rel and not clock_step_functions(mod)


@checker(_DOCS)
def check_host_sync(mod, _ctx):
    if _is_exempt(mod):
        return []
    findings = []
    for fnode, _why in clock_step_functions(mod).items():
        names = _tensor_names(fnode)
        where = getattr(fnode, "name", "<lambda>")
        for node in ast.walk(fnode):
            if enclosing_function(node) is not fnode and node is not fnode:
                continue
            what = None
            if isinstance(node, ast.Call):
                what = _sync_of(node, names)
            elif isinstance(node, (ast.If, ast.While, ast.IfExp)) \
                    and is_tensor(node.test, names):
                kind = {ast.If: "if", ast.While: "while",
                        ast.IfExp: "conditional"}[type(node)]
                what = f"a tensor as the test of `{kind}`"
            if what is None:
                continue
            findings.append(Finding(
                "host-sync", mod.rel, node.lineno,
                f"{what} inside the clock step `{where}` -- the host waits "
                f"for the card every clock; keep the value on the device "
                f"(torch.where, a device accumulator) and read it after "
                f"the run"))
    return findings
