"""Rule family ``cuda``: every kernel has a plain version, and nothing
falls back to it on the card.

The counterpart of ``repro/analysis/pallas_rules.py`` for the port's
hand-written CUDA kernels (``kernels/csrc/*.cu``, bound with ctypes by
the ``kernels/*.py`` modules that call ``load_lib``):

- ``cuda-ref`` -- the chain from a kernel to its plain version is whole:
  every ``extern "C"`` entry of ``kernels/csrc/<name>.cu`` is bound by a
  ``kernels/*.py`` module (a key of the argtypes it passes to
  ``load_lib("<name>", ...)``, or its error-string function); every
  public launch wrapper of such a module (a function that counts its
  launch into ``launches``) is dispatched in ``kernels/ops.py`` by a
  function that also calls a ``ref.*`` plain version; and that ``ref``
  name exists in ``kernels/ref.py``.  The plain version is what the
  tests and ``chip_smoke.py`` hold the kernel against; a kernel without
  one is unverifiable (``pallas-ref``'s "every kernel has a registered
  reference").
- ``cuda-fallback`` -- a ``try`` whose body calls a kernel module's
  function (or the dispatch's) and whose handler calls a ``ref.*`` plain
  version or moves tensors to the CPU.  On the card the main path runs
  the kernels or fails (``kernels/ops.py``); a fallback would hide a
  broken kernel behind a slow, correct answer.

The JAX rules ``pallas-interpret`` and ``pallas-blockspec`` have no
counterpart: CUDA has no interpret mode, and a kernel's grid and blocks
are computed in its C++ launcher, not declared.
"""
from __future__ import annotations

import ast
import os
import re

from .base import Finding, checker, dotted, import_aliases, \
    load_lib_calls, module_assign

_DOCS = {
    "cuda-ref": "a CUDA entry point, launch wrapper or dispatch without "
                "its binding, ops.py dispatch with a ref.* plain version, "
                "or ref.py function",
    "cuda-fallback": "try/except around a kernel that falls back to the "
                     "plain version or the CPU",
}

_EXTERN_RE = re.compile(r'extern\s+"C"\s*\{')
_FUNC_RE = re.compile(r"\b([A-Za-z_]\w*)\s*\(")
_COMMENT_RE = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)


def extern_c_entries(source: str) -> list:
    """``(name, line)`` of each function defined at the top level of the
    ``extern "C" { ... }`` blocks of a CUDA source."""
    out = []
    for m in _EXTERN_RE.finditer(source):
        depth, i, start = 1, m.end(), m.end()
        stmt_start = start
        while i < len(source) and depth:
            ch = source[i]
            if source.startswith("//", i):
                i = source.find("\n", i)
                i = len(source) if i < 0 else i
                continue
            if ch == "{":
                if depth == 1:
                    # the definition's head, its comments blanked (offsets
                    # kept, so the line is the name's)
                    head = _COMMENT_RE.sub(lambda c: " " * len(c.group()),
                                           source[stmt_start:i])
                    fm = _FUNC_RE.search(head)
                    if fm is not None:
                        line = source.count("\n", 0,
                                            stmt_start + fm.start()) + 1
                        out.append((fm.group(1), line))
                depth += 1
            elif ch == "}":
                depth -= 1
                if depth == 1:
                    stmt_start = i + 1
            elif ch == ";" and depth == 1:
                stmt_start = i + 1
            i += 1
    return out


def _bindings(ctx) -> dict:
    """csrc source name -> entry names bound by the kernels/*.py modules
    (the argtypes keys of ``load_lib`` and its error-string function)."""
    out: dict = {}
    for mod in ctx.modules:
        for call in load_lib_calls(mod):
            if not call.args or not isinstance(call.args[0], ast.Constant):
                continue
            names = out.setdefault(call.args[0].value, set())
            if len(call.args) > 1:
                table = call.args[1]
                if isinstance(table, ast.Name):
                    table = module_assign(mod, table.id)
                if isinstance(table, ast.Dict):
                    names |= {k.value for k in table.keys
                              if isinstance(k, ast.Constant)}
            if len(call.args) > 2 and isinstance(call.args[2], ast.Constant):
                names.add(call.args[2].value)
    return out


def _counts_launch(fn) -> bool:
    """Does ``fn`` add to ``launches[...]`` (a launch wrapper)?"""
    for node in ast.walk(fn):
        if isinstance(node, ast.AugAssign) \
                and isinstance(node.target, ast.Subscript) \
                and (dotted(node.target.value) or "").split(".")[-1] \
                == "launches":
            return True
    return False


@checker(_DOCS, repo=True)
def check_cuda_ref(ctx):
    findings = []
    bound = _bindings(ctx)
    for src in ctx.cuda_sources:
        name = os.path.splitext(os.path.basename(src.path))[0]
        for entry, line in extern_c_entries(src.source):
            if entry not in bound.get(name, set()):
                findings.append(Finding(
                    "cuda-ref", src.rel, line,
                    f"extern \"C\" entry `{entry}` of {name}.cu is bound by "
                    f"no kernels/*.py module (load_lib(\"{name}\", ...) "
                    f"argtypes)"))
    for mod in ctx.modules:
        if "/kernels/" not in "/" + mod.rel or not load_lib_calls(mod):
            continue
        for fn in mod.tree.body:
            if isinstance(fn, ast.FunctionDef) \
                    and not fn.name.startswith("_") and _counts_launch(fn) \
                    and (mod.name, fn.name) not in ctx.dispatched:
                findings.append(Finding(
                    "cuda-ref", mod.rel, fn.lineno,
                    f"launch wrapper `{mod.name}.{fn.name}` is dispatched "
                    f"by no kernels/ops.py function that also calls a "
                    f"ref.* plain version -- the kernel is unverifiable"))
    if ctx.ops_mod is not None and ctx.ref_mod is not None:
        aliases = import_aliases(ctx.ops_mod.tree)
        for node in ast.walk(ctx.ops_mod.tree):
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.value, ast.Name) \
                    and aliases.get(node.value.id) == "ref" \
                    and node.attr not in ctx.ref_names \
                    and isinstance(getattr(node, "parent", None), ast.Call) \
                    and node.parent.func is node:
                findings.append(Finding(
                    "cuda-ref", ctx.ops_mod.rel, node.lineno,
                    f"`ref.{node.attr}` is not a function of "
                    f"kernels/ref.py"))
    return findings


def _moves_to_cpu(call) -> bool:
    if not isinstance(call.func, ast.Attribute):
        return False
    if call.func.attr == "cpu":
        return True
    if call.func.attr == "to":
        for a in list(call.args) + [k.value for k in call.keywords]:
            if isinstance(a, ast.Constant) and a.value == "cpu":
                return True
            if isinstance(a, ast.Call) and a.args \
                    and isinstance(a.args[0], ast.Constant) \
                    and a.args[0].value == "cpu":
                return True
    return False


@checker(_DOCS)
def check_cuda_fallback(mod, ctx):
    aliases = import_aliases(mod.tree)
    kernel = {a for a, m in aliases.items()
              if m in ctx.kernel_modules or m == "ops"}
    refs = {a for a, m in aliases.items() if m == "ref"}
    findings = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Try):
            continue
        calls_kernel = any(
            isinstance(n, ast.Call)
            and (dotted(n.func) or "").split(".")[0] in kernel
            and "." in (dotted(n.func) or "")
            for st in node.body for n in ast.walk(st))
        if not calls_kernel:
            continue
        for h in node.handlers:
            fallback = next(
                (n for st in h.body for n in ast.walk(st)
                 if isinstance(n, ast.Call)
                 and ((dotted(n.func) or "").split(".")[0] in refs
                      and "." in (dotted(n.func) or "")
                      or _moves_to_cpu(n))), None)
            if fallback is not None:
                findings.append(Finding(
                    "cuda-fallback", mod.rel, h.lineno,
                    f"the handler of a kernel call falls back to "
                    f"`{dotted(fallback.func) or 'the CPU'}` -- on the card "
                    f"the kernel runs or the call raises"))
    return findings
