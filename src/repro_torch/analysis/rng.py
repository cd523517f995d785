"""Rule ``rng-reuse``: a key consumed twice without a split/fold_in.

The port of ``repro/analysis/rng.py``, on the keys of ``repro_torch.rng``
(the port's replay of JAX's threefry key stream).  Keys are not stateful:
drawing with the same key twice yields *identical* (perfectly correlated)
draws, so between any two consumptions of a key variable there must be an
interleaving ``split``/``fold_in`` rebinding it.

The checker runs a small symbolic walk per function:

- **keys** are parameters named like keys (``rng``, ``key``, ``k_*``,
  ``*_rng``/``*_key``/``*_keys``) and variables assigned from
  ``rng.PRNGKey``/``rng.split``/``rng.fold_in`` (including tuple-unpack,
  ``.unbind`` and subscript of a ``split``);
- **consumption** is passing the key to any call: every other ``rng.<draw>``
  (``uniform``, ``bernoulli``, ``randint``, ``normal``, ``gumbel``,
  ``categorical``, ``gamma``, ...) consumes, and so does ``split`` itself
  (deriving from an already-used key is the classic decode bug); the
  derivers' *assignment targets* come back fresh, and ``fold_in`` mixes
  data into the stream without spending the base key;
- a deriver is recognised only through the port's ``rng`` module (an
  alias of ``repro_torch.rng`` or a name imported from it), so
  ``s.split(",")`` does not register;
- packing a key into a tuple/dict/return escapes it (carry idiom) and
  stops tracking rather than guessing;
- ``if``/``else`` branches fork the state and merge (a consumption on
  either live path counts; ``return``/``raise``-terminated branches drop
  out of the merge);
- loop bodies run twice so a consumption of a loop-invariant key is
  caught as cross-iteration reuse; ``for k in split(...)`` targets are
  fresh each iteration.

``repro_torch/rng.py`` itself is exempt: it *is* the key stream, hashing
one key's words over many counters (one draw spread over chunks), as the
JAX rule never scans ``jax.random``.
"""
from __future__ import annotations

import ast
import re

from .base import Finding, checker, dotted

KEY_NAME_RE = re.compile(r"(^|_)(rng|key|keys|prngkey)$|^k_|^rng")
DERIVERS = {"split", "fold_in", "PRNGKey"}

FRESH, CONSUMED = "fresh", "consumed"

_DOCS = {
    "rng-reuse": "repro_torch.rng key consumed twice without an "
                 "interleaving split/fold_in (correlated streams)",
}


def _is_key_name(name: str) -> bool:
    return bool(KEY_NAME_RE.search(name))


def rng_aliases(mod) -> tuple[set, set]:
    """(module aliases of ``repro_torch.rng``, deriver names imported from
    it) in ``mod``."""
    mods, names = set(), set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "repro_torch.rng" and a.asname:
                    mods.add(a.asname)
        elif isinstance(node, ast.ImportFrom):
            src = node.module or ""
            for a in node.names:
                if a.name == "rng" and (src == "repro_torch"
                                        or (node.level and not src)):
                    mods.add(a.asname or a.name)
                elif a.name in DERIVERS and (
                        src == "repro_torch.rng"
                        or (node.level and src == "rng")):
                    names.add(a.asname or a.name)
    return mods, names


def _call_kind(call, aliases) -> str | None:
    d = dotted(call.func)
    if not d:
        return None
    parts = d.split(".")
    last = parts[-1]
    mods, names = aliases
    if last in DERIVERS:
        # only through the port's rng module, so that `s.split(",")` /
        # `d.split(".")` string methods don't register
        if (len(parts) == 1 and last in names) \
                or (len(parts) == 2 and parts[0] in mods):
            # fold_in mixes data into the stream: `fold_in(rng, i)` per
            # step is the idiomatic multi-stream derivation and does not
            # spend the base key
            return "fold" if last == "fold_in" else "derive"
    return "call"


class _FnState:
    def __init__(self):
        self.keys: dict = {}      # name -> (state, line of last consumption)

    def copy(self):
        s = _FnState()
        s.keys = dict(self.keys)
        return s

    def merge(self, other):
        for name, (st, ln) in other.keys.items():
            cur = self.keys.get(name)
            if cur is None or (st == CONSUMED and cur[0] == FRESH):
                self.keys[name] = (st, ln)


def _terminates(stmts) -> bool:
    return any(isinstance(s, (ast.Return, ast.Raise, ast.Continue,
                              ast.Break)) for s in stmts)


class _Walker:
    def __init__(self, mod, fnode, aliases):
        self.mod = mod
        self.fnode = fnode
        self.aliases = aliases
        self.findings: list = []
        self._seen_lines: set = set()

    def report(self, name, node, prev_line):
        if node.lineno in self._seen_lines:
            return
        self._seen_lines.add(node.lineno)
        self.findings.append(Finding(
            "rng-reuse", self.mod.rel, node.lineno,
            f"PRNG key `{name}` consumed again without an interleaving "
            f"split/fold_in (previous consumption at line {prev_line}) — "
            f"identical streams"))

    # -- expression side: consumption events ---------------------------

    def consume(self, name, node, state):
        cur = state.keys.get(name)
        if cur is None:
            return
        st, ln = cur
        if st == CONSUMED:
            self.report(name, node, ln)
        state.keys[name] = (CONSUMED, node.lineno)

    def eval_expr(self, node, state):
        """Walk an expression, firing consumption on key-args of calls and
        escaping keys packed into containers."""
        for n in ast.walk(node):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                continue
            if isinstance(n, ast.Call):
                kind = _call_kind(n, self.aliases)
                for arg in list(n.args) + [kw.value for kw in n.keywords]:
                    if isinstance(arg, ast.Name) \
                            and arg.id in state.keys \
                            and kind in ("call", "derive"):
                        self.consume(arg.id, arg, state)
            elif isinstance(n, (ast.Tuple, ast.List, ast.Dict)):
                parent = getattr(n, "parent", None)
                if isinstance(parent, (ast.Return, ast.Assign, ast.Yield)):
                    for e in ast.walk(n):
                        if isinstance(e, ast.Name) and e.id in state.keys:
                            state.keys.pop(e.id, None)  # escaped via carry

    # -- statement side ------------------------------------------------

    def _rhs_fresh(self, value, state) -> bool:
        if isinstance(value, ast.Call):
            if isinstance(value.func, ast.Attribute) \
                    and value.func.attr == "unbind" \
                    and isinstance(value.func.value, ast.Call):
                # `rng.split(key, 3).unbind(0)`: fresh keys
                return self._rhs_fresh(value.func.value, state)
            return _call_kind(value, self.aliases) in ("derive", "fold")
        if isinstance(value, ast.Subscript):
            base = value.value
            # indexing a split result / an array-of-keys yields a fresh key
            return ((isinstance(base, ast.Call)
                     and _call_kind(base, self.aliases) in ("derive",
                                                            "fold"))
                    or (isinstance(base, ast.Name)
                        and base.id in state.keys))
        if isinstance(value, ast.IfExp):
            # `rng = rng if rng is not None else PRNGKey(0)` — fresh when
            # both arms are fresh keys (a fresh alias counts)
            def arm_fresh(arm):
                if isinstance(arm, ast.Name):
                    st = state.keys.get(arm.id)
                    return st is not None and st[0] == FRESH
                return self._rhs_fresh(arm, state)
            return arm_fresh(value.body) and arm_fresh(value.orelse)
        return False

    def assign_targets(self, targets, value, state):
        fresh = self._rhs_fresh(value, state)
        alias = (value.id if isinstance(value, ast.Name)
                 and value.id in state.keys else None)
        names = []
        for t in targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name):
                    names.append(n.id)
        for name in names:
            if fresh:
                state.keys[name] = (FRESH, value.lineno)
            elif alias is not None and len(names) == 1:
                state.keys[name] = state.keys[alias]
            elif name in state.keys:
                # rebound from an untracked expression: stop tracking
                state.keys.pop(name)

    def run_stmts(self, stmts, state):
        for st in stmts:
            self.run_stmt(st, state)

    def run_stmt(self, st, state):
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return
        if isinstance(st, ast.Assign):
            self.eval_expr(st.value, state)
            self.assign_targets(st.targets, st.value, state)
        elif isinstance(st, ast.AugAssign):
            self.eval_expr(st.value, state)
        elif isinstance(st, ast.AnnAssign):
            if st.value is not None:
                self.eval_expr(st.value, state)
                self.assign_targets([st.target], st.value, state)
        elif isinstance(st, (ast.Expr, ast.Return)):
            if getattr(st, "value", None) is not None:
                self.eval_expr(st.value, state)
        elif isinstance(st, ast.If):
            self.eval_expr(st.test, state)
            s_then, s_else = state.copy(), state.copy()
            self.run_stmts(st.body, s_then)
            self.run_stmts(st.orelse, s_else)
            live = []
            if not _terminates(st.body):
                live.append(s_then)
            if not _terminates(st.orelse):
                live.append(s_else)
            if not live:            # both branches terminate
                live = [s_then]
            state.keys = dict(live[0].keys)
            for s in live[1:]:
                state.merge(s)
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            self.eval_expr(st.iter, state)
            iter_fresh = (
                (isinstance(st.iter, ast.Call)
                 and _call_kind(st.iter, self.aliases) == "derive")
                or (isinstance(st.iter, ast.Name)
                    and st.iter.id in state.keys))
            body_state = state.copy()
            for _ in range(2):      # second pass catches loop-carried reuse
                if iter_fresh:
                    self.assign_targets([st.target], st.iter, body_state)
                    for n in ast.walk(st.target):
                        if isinstance(n, ast.Name):
                            body_state.keys[n.id] = (FRESH, st.lineno)
                self.run_stmts(st.body, body_state)
            state.merge(body_state)
            self.run_stmts(st.orelse, state)
        elif isinstance(st, ast.While):
            self.eval_expr(st.test, state)
            body_state = state.copy()
            for _ in range(2):
                self.run_stmts(st.body, body_state)
            state.merge(body_state)
            self.run_stmts(st.orelse, state)
        elif isinstance(st, ast.With):
            for item in st.items:
                self.eval_expr(item.context_expr, state)
            self.run_stmts(st.body, state)
        elif isinstance(st, ast.Try):
            self.run_stmts(st.body, state)
            for h in st.handlers:
                s_h = state.copy()
                self.run_stmts(h.body, s_h)
                state.merge(s_h)
            self.run_stmts(st.orelse, state)
            self.run_stmts(st.finalbody, state)
        elif isinstance(st, (ast.Assert, ast.Raise, ast.Delete)):
            pass
        # other statements carry no key flow


@checker(_DOCS)
def check_rng(mod, _ctx):
    if mod.rel.endswith("repro_torch/rng.py"):
        return []           # the key stream's own implementation
    findings = []
    aliases = rng_aliases(mod)
    for fnode in ast.walk(mod.tree):
        if not isinstance(fnode, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        state = _FnState()
        args = fnode.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs):
            if _is_key_name(a.arg):
                state.keys[a.arg] = (FRESH, fnode.lineno)
        w = _Walker(mod, fnode, aliases)
        # seed assignments from derivers even for non-key-named targets
        w.run_stmts([s for s in fnode.body
                     if not isinstance(s, (ast.FunctionDef,
                                           ast.AsyncFunctionDef))], state)
        findings.extend(w.findings)
    return findings
