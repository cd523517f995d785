"""Rule family ``collectives``: mesh dimension hygiene + the churn mask
rule.

The port of ``repro/analysis/collectives.py``:

- ``axis-unbound`` -- a literal dimension name in ``mesh["x"]``,
  ``mesh.get_group("x")`` or ``mesh.get_local_rank("x")`` that no
  ``mesh_dim_names`` literal of the scanned tree (or of
  ``launch/mesh.py``) binds.  An unbound name fails only at run time *on
  the sharded path*, which a one-rank run never takes.
- ``unmasked-gather`` -- the churn race rule: inside churn-aware code (a
  function that derives a ``live``/``churn_live`` mask), a
  ``dist.all_gather*``, ``dist.all_reduce`` or ``dist.reduce_scatter*``
  over a worker group (the ``"data"``/``"pod"`` dimensions, or a group
  named ``*workers``) of a plain variable that was never run through the
  live mask (``torch.where(live..., x, 0)``, ``x.masked_fill(~live...,
  0)``).  A dead producer's stale rows entering a reduction silently
  diverge from the survivor-set simulator; masking *before* the gather
  keeps the reductions the simulator's.  The collectives also count when
  they are reached through a module-local wrapper (a function or method
  whose body calls one, e.g. the runtime's ``_Shard.gather``): its first
  argument is the operand and its group argument the group.

The JAX rule ``collective-outside-shardmap`` has no counterpart: a
``torch.distributed`` collective may be called anywhere in a process of
the world.  Variable (non-literal) dimension names are skipped.
"""
from __future__ import annotations

import ast

from .base import Finding, checker, dotted, enclosing_function

# torch.distributed collectives that reduce over producers (the mask rule),
# with the position of their input operand
REDUCING = {"all_gather": 1, "all_gather_into_tensor": 1,
            "all_gather_object": 1, "all_reduce": 0, "reduce_scatter": 1,
            "reduce_scatter_tensor": 1}
DIST_MODULES = {"dist", "distributed", "torch.distributed"}
# DeviceMesh methods that take a dimension name
DIM_METHODS = {"get_group", "get_local_rank", "size"}
WORKER_DIMS = {"data", "pod"}

_DOCS = {
    "axis-unbound": "a mesh dimension name no mesh_dim_names literal "
                    "binds",
    "unmasked-gather": "worker-group gather/all_reduce of un-live-masked "
                       "data in churn-aware code (the masked-before-gather "
                       "rule)",
}


def _dim_literal(node) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _is_dist_call(call) -> str | None:
    """The collective's name when ``call`` is ``dist.<collective>``."""
    d = dotted(call.func)
    if not d or "." not in d:
        return None
    base, _, last = d.rpartition(".")
    if last in REDUCING and base in DIST_MODULES:
        return last
    return None


def _group_arg(call, pos: int | None):
    for kw in call.keywords:
        if kw.arg == "group":
            return kw.value
    if pos is not None and len(call.args) > pos:
        return call.args[pos]
    return None


def _wrappers(mod) -> dict:
    """Module-local functions and methods that run a reducing collective
    on a parameter: name -> (operand index, group index) among their
    positional parameters (``self`` not counted)."""
    out: dict = {}
    fns = [n for n in ast.walk(mod.tree)
           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    changed = True
    while changed:
        changed = False
        for fn in fns:
            if fn.name in out:
                continue
            params = [a.arg for a in fn.args.posonlyargs + fn.args.args]
            if params and params[0] in ("self", "cls"):
                params = params[1:]
            if "group" not in params:
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                last = (dotted(node.func) or "").split(".")[-1]
                if _is_dist_call(node) or last in out:
                    out[fn.name] = (0, params.index("group"))
                    changed = True
                    break
    return out


def _is_worker_group(node, group_vars: dict) -> bool:
    if node is None:
        return False
    d = dotted(node)
    if d is not None:
        if d.split(".")[-1].endswith("workers"):
            return True
        if d in group_vars:
            return group_vars[d]
    if isinstance(node, ast.Call):
        last = (dotted(node.func) or "").split(".")[-1]
        if last == "get_group" and node.args:
            return _dim_literal(node.args[0]) in WORKER_DIMS
    return False


def _function_masked_vars(fnode):
    """(live_vars, masked_vars, group_vars) within one function body."""
    live_vars: set = set()
    masked: set = set()
    groups: dict = {}
    for node in ast.walk(fnode):
        if isinstance(node, ast.Assign):
            rhs_names = {n.id for n in ast.walk(node.value)
                         if isinstance(n, ast.Name)}
            tgt_names = [n.id for t in node.targets
                         for n in ast.walk(t) if isinstance(n, ast.Name)]
            if isinstance(node.value, ast.Call) and (
                    (dotted(node.value.func) or "").split(".")[-1]
                    == "churn_live"):
                live_vars.update(tgt_names)
                continue
            if _is_worker_group(node.value, groups):
                groups.update(dict.fromkeys(tgt_names, True))
            if any(v in live_vars or v.startswith("live")
                   for v in rhs_names):
                live_vars.update(t for t in tgt_names if t.startswith("live"))
                masked.update(tgt_names)
    if not isinstance(fnode, ast.Lambda):
        for a in fnode.args.args + fnode.args.kwonlyargs:
            if a.arg.startswith("live"):
                live_vars.add(a.arg)
    return live_vars, masked, groups


@checker(_DOCS)
def check_collectives(mod, ctx):
    findings = []
    known = set(ctx.mesh_dims)
    # dimension names bound by mesh_dim_names literals in this module
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.keyword) and node.arg == "mesh_dim_names":
            for n in ast.walk(node.value):
                if isinstance(n, ast.Constant) and isinstance(n.value, str):
                    known.add(n.value)
    wrappers = _wrappers(mod)
    fn_mask_cache: dict = {}

    for node in ast.walk(mod.tree):
        # axis-unbound: literal dimension names on a mesh
        dim = None
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in DIM_METHODS and node.args:
            owner = (dotted(node.func.value) or "").split(".")[-1]
            if node.func.attr != "size" or "mesh" in owner:
                dim = _dim_literal(node.args[0])
        elif isinstance(node, ast.Subscript) \
                and "mesh" in (dotted(node.value) or "").split(".")[-1]:
            dim = _dim_literal(node.slice)
        if dim is not None and dim not in known:
            findings.append(Finding(
                "axis-unbound", mod.rel, node.lineno,
                f"mesh dimension {dim!r} is bound by no mesh_dim_names "
                f"literal in the scanned tree"))

        if not isinstance(node, ast.Call):
            continue
        # unmasked-gather: worker-group reductions in churn-aware code
        coll = _is_dist_call(node)
        if coll is not None:
            op_pos, grp = REDUCING[coll], _group_arg(node, 2)
            name = f"dist.{coll}"
        else:
            last = (dotted(node.func) or "").split(".")[-1]
            if last not in wrappers:
                continue
            op_pos, gpos = wrappers[last]
            grp, name = _group_arg(node, gpos), last
        fnode = enclosing_function(node)
        if fnode is None or len(node.args) <= op_pos:
            continue
        root = fnode
        # the mask context is per outermost function: the clock step's
        # closures share its live_* locals
        while enclosing_function(root) is not None:
            root = enclosing_function(root)
        if root not in fn_mask_cache:
            fn_mask_cache[root] = _function_masked_vars(root)
        live_vars, masked, groups = fn_mask_cache[root]
        if not live_vars or not _is_worker_group(grp, groups):
            continue            # not churn-aware code, or no worker group
        operand = node.args[op_pos]
        if isinstance(operand, ast.Name) \
                and operand.id not in masked \
                and operand.id not in live_vars:
            findings.append(Finding(
                "unmasked-gather", mod.rel, node.lineno,
                f"worker-group `{name}` of `{operand.id}` in churn-aware "
                f"code without a prior live mask "
                f"(`torch.where(live..., {operand.id}, 0)`) -- dead "
                f"producers' stale rows enter the reduction"))
    return findings
