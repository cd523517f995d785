"""Rule engine of the port's static checker (``repro_torch.analysis``).

The port of ``repro/analysis/base.py``.  The checker is a *static* pass:
it parses every Python module under the scanned roots into an AST (and
reads the ``extern "C"`` blocks of ``kernels/csrc/*.cu``) and runs a
registry of rule checkers over each.  Nothing is imported or executed: it
imports neither ``torch`` nor ``jax`` and nothing of ``repro``, so it runs
in seconds wherever Python does.

Vocabulary shared by the rule modules:

- **clock-step scope** -- the code that runs on every clock of a run.  A
  producer module names its per-clock functions in a module-level literal
  tuple ``CLOCK_STEP`` (``core/ps.py``, ``psrun/runtime.py``,
  ``comm/wire.py``, ``comm/substrate.py``, ``obs/metrics.py``); functions nested in those, and
  the module-local functions they call by name, belong to it too (a
  fixpoint within the module).  This takes the place of the JAX
  package's *traced context*: torch runs eagerly, so what matters is not
  what is staged but what runs once per clock, where a host sync stalls
  the card's stream.
- **suppression** -- an inline ``# analysis: ignore[rule-id] -- reason``
  comment on the flagged line (``// analysis: ignore[...]`` in a ``.cu``
  file).  ``--strict`` also reports ignores written without a reason
  (``bare-ignore``).  A repo-level suppression file (``--suppressions``,
  lines of ``path-glob:rule-id``) covers generated code.

Rule checkers are registered with :func:`checker`; each returns
`Finding`s tagged with a rule id from :data:`RULE_DOCS` (the catalog the
CLI prints with ``--list-rules``).
"""
from __future__ import annotations

import ast
import fnmatch
import os
import re
from dataclasses import dataclass

IGNORE_RE = re.compile(
    r"(?:#|//)\s*analysis:\s*ignore\[([A-Za-z0-9_\-, ]+)\]"
    r"(?:\s*--\s*(\S.*))?")

# rule id -> one-line doc (the catalog; see the rule modules for details)
RULE_DOCS: dict = {}

# registered checker callables: fn(module: ModuleInfo, ctx: RepoContext)
CHECKERS: list = []

# registered repo-wide checkers: fn(ctx: RepoContext) -> findings
REPO_CHECKERS: list = []


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def checker(rule_ids: dict, repo: bool = False):
    """Register a rule checker (per module, or once per scan with
    ``repo=True``) along with the rule ids it may emit."""
    def deco(fn):
        RULE_DOCS.update(rule_ids)
        (REPO_CHECKERS if repo else CHECKERS).append(fn)
        return fn
    return deco


def add_parents(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child.parent = node  # type: ignore[attr-defined]


def dotted(node) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def enclosing_function(node):
    """Nearest enclosing FunctionDef/AsyncFunctionDef/Lambda (or None)."""
    cur = getattr(node, "parent", None)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            return cur
        cur = getattr(cur, "parent", None)
    return None


def _parse_ignores(source: str):
    ignores: dict = {}
    bare: list = []
    for ln, text in enumerate(source.splitlines(), 1):
        m = IGNORE_RE.search(text)
        if m:
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            ignores[ln] = rules
            if not (m.group(2) or "").strip():
                bare.append((ln, tuple(sorted(rules))))
    return ignores, bare


class SourceInfo:
    """One scanned file (Python or CUDA) plus its inline suppressions."""

    def __init__(self, path: str, source: str, rel: str | None = None):
        self.path = path
        self.rel = (rel or path).replace(os.sep, "/")
        self.source = source
        self.name = os.path.splitext(os.path.basename(path))[0]
        # line -> suppressed rule ids; bare = ignores missing a reason
        self.ignores, self.bare_ignores = _parse_ignores(source)

    def suppressed(self, rule: str, line: int) -> bool:
        rules = self.ignores.get(line)
        return bool(rules) and (rule in rules or "*" in rules)


class ModuleInfo(SourceInfo):
    """One parsed Python module."""

    def __init__(self, path: str, source: str, rel: str | None = None):
        super().__init__(path, source, rel)
        self.tree = ast.parse(source, filename=path)
        add_parents(self.tree)


def literal_strings(node) -> set:
    out = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Constant) and isinstance(n.value, str):
            out.add(n.value)
    return out


def tuple_of_names(node) -> tuple | None:
    """String elements of a literal tuple/list/set, else None."""
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        vals = []
        for e in node.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                vals.append(e.value)
            else:
                return None
        return tuple(vals)
    return None


def module_assign(mod: ModuleInfo, name: str):
    """The value node of a module-level ``name = ...``, else None."""
    for stmt in mod.tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name) \
                and stmt.targets[0].id == name:
            return stmt.value
        if isinstance(stmt, ast.AnnAssign) \
                and isinstance(stmt.target, ast.Name) \
                and stmt.target.id == name and stmt.value is not None:
            return stmt.value
    return None


def import_aliases(tree) -> dict:
    """alias -> last segment of the imported module, for every
    ``import a.b as x``, ``from a import b [as x]`` and ``from . import
    b`` anywhere in ``tree`` (a name imported from a module maps to the
    name itself)."""
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = \
                    a.name.split(".")[-1] if a.asname else a.name
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                out[a.asname or a.name] = a.name
    return out


# --------------------------------------------------------------------------
# repo context: knowledge extracted statically from the scanned tree
# --------------------------------------------------------------------------

# Fallbacks when the scan set does not hold the port's source (e.g. the
# fixture tests): the mesh dimensions of `repro_torch.launch.mesh`.
_DEFAULT_DIMS = {"data", "model", "pod", "batch"}
# The port's kernel modules (kernels/*.py binding a csrc/*.cu source).
_DEFAULT_KERNEL_MODULES = {"ps_view", "delta_pack", "mf_sgd",
                           "flash_attention", "ssd_scan"}


class RepoContext:
    """Statically extracted repo knowledge shared by the rule checkers:
    the knobs of ``core/consistency.py``, the mesh dimension literals of
    ``launch/mesh.py``, the dispatch of ``kernels/ops.py``, the plain
    versions of ``kernels/ref.py`` and the ``extern "C"`` entries of
    ``kernels/csrc/*.cu``."""

    def __init__(self, modules: list, cuda_sources: list = ()):
        self.modules = modules
        self.cuda_sources = list(cuda_sources)
        self.knob_bounds: dict = {}
        self.int_knobs: tuple = ()
        self.mesh_dims = set(_DEFAULT_DIMS)
        self.consistency_mod: ModuleInfo | None = None
        self.ops_mod: ModuleInfo | None = None
        self.ref_mod: ModuleInfo | None = None
        # (kernel module name, function name) pairs dispatched by an ops.py
        # function that also calls a ref.* plain version
        self.dispatched: set = set()
        self.ref_names: set = set()
        self.kernel_modules = set(_DEFAULT_KERNEL_MODULES)
        for mod in modules:
            if mod.rel.endswith("core/consistency.py"):
                self._load_knobs(mod)
            if mod.rel.endswith("launch/mesh.py"):
                self.mesh_dims |= literal_strings(mod.tree)
            if mod.rel.endswith("kernels/ops.py"):
                self.ops_mod = mod
                self._load_dispatch(mod)
            if mod.rel.endswith("kernels/ref.py"):
                self.ref_mod = mod
                self.ref_names |= {
                    n.name for n in mod.tree.body
                    if isinstance(n, ast.FunctionDef)}
            if "/kernels/" in "/" + mod.rel and load_lib_calls(mod):
                self.kernel_modules.add(mod.name)

    def _load_knobs(self, mod: ModuleInfo) -> None:
        self.consistency_mod = mod
        ints = tuple_of_names(module_assign(mod, "INT_KNOBS"))
        if ints is not None:
            self.int_knobs = ints
        bounds = module_assign(mod, "KNOB_BOUNDS")
        if isinstance(bounds, ast.Dict):
            self.knob_bounds = {k.value: True for k in bounds.keys
                                if isinstance(k, ast.Constant)}

    def _load_dispatch(self, mod: ModuleInfo) -> None:
        """A kernel function counts as *dispatched* when some ops.py
        function references both ``<alias>.<fn>`` and a ``ref.*`` plain
        version."""
        top = import_aliases(ast.Module(body=[
            s for s in mod.tree.body
            if isinstance(s, (ast.Import, ast.ImportFrom))],
            type_ignores=[]))
        for fn in mod.tree.body:
            if not isinstance(fn, ast.FunctionDef):
                continue
            aliases = dict(top)
            aliases.update(import_aliases(fn))
            attrs = [(n.value.id, n.attr) for n in ast.walk(fn)
                     if isinstance(n, ast.Attribute)
                     and isinstance(n.value, ast.Name)]
            if not any(aliases.get(base) == "ref" for base, _ in attrs):
                continue
            for base, attr in attrs:
                target = aliases.get(base)
                if target and target != "ref":
                    self.dispatched.add((target, attr))


def load_lib_calls(mod: ModuleInfo) -> list:
    """The ``load_lib(...)`` calls of a module (the ctypes binding of a
    ``csrc/<name>.cu`` library)."""
    return [n for n in ast.walk(mod.tree)
            if isinstance(n, ast.Call)
            and (dotted(n.func) or "").split(".")[-1] == "load_lib"]


# --------------------------------------------------------------------------
# the clock-step scope
# --------------------------------------------------------------------------

def clock_step_names(mod: ModuleInfo) -> tuple:
    """The module's ``CLOCK_STEP`` literal tuple (empty when absent)."""
    return tuple_of_names(module_assign(mod, "CLOCK_STEP")) or ()


def clock_step_functions(mod: ModuleInfo) -> dict:
    """Map of function/lambda nodes in the clock-step scope -> reason.

    The functions named in ``CLOCK_STEP``, the functions and lambdas
    nested in them, and the module-local functions they call by name (a
    fixpoint within the module)."""
    names = clock_step_names(mod)
    if not names:
        return {}
    defs: dict = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, []).append(node)
    scope: dict = {}
    for name in names:
        for d in defs.get(name, []):
            scope[d] = "named in CLOCK_STEP"
    changed = True
    while changed:
        changed = False
        for node in list(scope):
            for inner in ast.walk(node):
                if inner is node:
                    continue
                if isinstance(inner, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda)):
                    if inner not in scope:
                        scope[inner] = "nested in the clock step"
                        changed = True
                if isinstance(inner, ast.Call):
                    callee = dotted(inner.func)
                    if callee and "." not in callee and callee in defs:
                        for d in defs[callee]:
                            if d not in scope:
                                scope[d] = "called from the clock step"
                                changed = True
    return scope


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

def collect_files(paths, suffix: str = ".py") -> list:
    files = []
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(suffix):
                files.append(p)
            continue
        for root, dirs, names in os.walk(p):
            dirs[:] = sorted(d for d in dirs if d != "__pycache__")
            for n in sorted(names):
                if n.endswith(suffix):
                    files.append(os.path.join(root, n))
    return files


def _read(path: str) -> str:
    with open(path, encoding="utf-8") as fh:
        return fh.read()


def load_modules(paths):
    """(modules, cuda sources, findings): unparsable files become
    syntax-error findings; ``.cu`` files count under ``kernels/csrc/``."""
    modules, findings = [], []
    for f in collect_files(paths):
        src = _read(f)
        try:
            modules.append(ModuleInfo(f, src, rel=os.path.relpath(f)))
        except SyntaxError as e:
            findings.append(Finding("syntax-error", f, e.lineno or 0,
                                    str(e.msg)))
    cuda = [SourceInfo(f, _read(f), rel=os.path.relpath(f))
            for f in collect_files(paths, ".cu")
            if "kernels/csrc/" in f.replace(os.sep, "/")]
    return modules, cuda, findings


def load_suppression_file(path: str) -> list:
    """Lines of ``path-glob:rule-id  # reason`` -> [(glob, rule)]."""
    out = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            glob, _, rule = line.rpartition(":")
            if glob and rule:
                out.append((glob, rule))
    return out


def register_rules() -> None:
    """Import the rule modules (each registers itself)."""
    from . import callbacks, collectives, cuda_rules, pytree_rules, \
        rng, staleness_check  # noqa: F401


def analyze_paths(paths, strict: bool = False,
                  suppressions: list | None = None,
                  model_check: bool = True):
    """Run every registered rule over the files under ``paths``.

    Returns the filtered (non-suppressed) findings, sorted by location.
    ``suppressions`` is a list of ``(path-glob, rule-id)`` pairs from a
    repo-level suppression file.
    """
    register_rules()
    modules, cuda, findings = load_modules(paths)
    ctx = RepoContext(modules, cuda)
    by_rel = {s.rel: s for s in [*modules, *cuda]}

    def keep(f: Finding) -> bool:
        src = by_rel.get(f.path)
        return src is None or not src.suppressed(f.rule, f.line)

    for mod in modules:
        for check in CHECKERS:
            findings.extend(f for f in check(mod, ctx) if keep(f))
    for check in REPO_CHECKERS:
        findings.extend(f for f in check(ctx) if keep(f))
    if strict:
        for src in [*modules, *cuda]:
            for ln, rules in src.bare_ignores:
                findings.append(Finding(
                    "bare-ignore", src.rel, ln,
                    f"suppression of {', '.join(rules)} has no reason; "
                    f"write `# analysis: ignore[rule] -- why`"))
    if model_check:
        from .staleness_check import check_repo
        findings.extend(f for f in check_repo(modules) if keep(f))
    if suppressions:
        findings = [
            f for f in findings
            if not any(r == f.rule and fnmatch.fnmatch(f.path, g)
                       for g, r in suppressions)]
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))
