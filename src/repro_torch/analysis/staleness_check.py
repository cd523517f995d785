"""The clock-step abstract interpreter + staleness model checker.

The port of ``repro/analysis/staleness_check.py``, pointed at the port's
Trace producers.  This is the ``staleness-contract`` rule: a *static race
detector for the consistency models themselves*.  The dynamic tests pin
the bound on the seeds they happen to run; this module instead

1. **extracts** the declared bound from the AST of
   ``core.delays.staleness_bound_matrix`` (symbolically evaluating its
   straight-line integer algebra, with and without the
   ``cfg.comm_active`` widening branch; the ``torch.where(same, intra,
   xpod)`` it returns may be cast with ``.to(...)``),
2. **extracts** the clock-update dataflow of each Trace producer -- the
   enforcement trigger ``forced = cview < (c - s_eff - 1)``, the
   refresh targets (``c - 1`` intra-pod / unwired,
   ``comm.shipped_through(c, agg_clocks)`` on the wired cross-pod
   channel) and the delivery targets (``c`` /
   ``comm.shipped_end(c, agg_clocks)``) -- from ``core/ps.py`` and
   ``psrun/runtime.py``, and verifies ``pods/runtime.py`` delegates its
   clock step to the psrun body (class ``PodsRuntime(PSRuntime)`` with no
   own enforcement code).  Where the JAX producers write each target as
   ``jnp.where(in_pod, c - K, <shipped boundary capped on wire_tip>)``,
   the port's route it through one helper, ``core.ps._xpod_target(cst,
   in_pod, c - K, comm.shipped_through(c, agg), faulted)``, which
   ``psrun/runtime.py`` imports: a call of a function of the producer's
   own module, or of one it imports from a module of the tree, counts as
   a target when its arguments carry the intra-pod ``c - K`` and the
   shipped boundary, and as capped when the helper's body reads
   ``cst["wire_tip"]``.  A helper that cannot be found fails extraction,
   and
3. **model-checks** the extracted transition system exhaustively over a
   grid of small ``(T, P, s, s_xpod, agg_clocks)`` configurations,
   including single reader-outage (churn) windows: per channel, the
   reader's visibility clock ``v`` evolves under adversarial delivery
   (the network may or may not deliver each clock -- every subset is
   explored) and the invariant checked at every read is the contract

       c - 1 - v  <=  bound(channel)

   with ``bound = s`` intra-pod, ``s + s_xpod`` cross-pod, widened by
   ``+ agg_clocks - 1`` when the comm substrate aggregates shipments and
   by ``+ retry_budget`` (= two conforming flight windows,
   `comm.wire.WireFaults.retry_budget`) on the lossy-wire channel: there
   the adversary also schedules each shipment's arrival anywhere inside
   the flight window (stop-and-wait -- a busy producer skips boundaries),
   and both refresh and delivery targets are capped by ``wire_tip``, the
   highest *arrived* boundary.

Channels are independent in the clock algebra (``cview`` updates are
elementwise), so checking one reader x producer channel per channel type
*is* exhaustive.  An off-by-one anywhere in the widening algebra (bound,
trigger, refresh or delivery target) produces a concrete counterexample
trace; ``tests/test_torch_analysis.py`` proves that by injecting mutants
and holding the counterexamples to the JAX checker's.

Extraction is deliberately *brittle*: if a producer's enforcement code
drifts so the patterns no longer match, the rule fails loudly
(``staleness-extract``) rather than silently verifying stale algebra.
"""
from __future__ import annotations

import ast
import itertools
import os
from dataclasses import dataclass

from .base import RULE_DOCS, Finding, dotted

RULE_DOCS.update({
    "staleness-contract": "a read can observe a visibility clock outside "
                          "the declared staleness bound",
    "staleness-extract": "could not extract the bound/enforcement "
                         "dataflow from a Trace producer",
})

PRODUCER_FILES = ("core/ps.py", "psrun/runtime.py", "pods/runtime.py")


# --------------------------------------------------------------------------
# 1. bound extraction: symbolic evaluation of staleness_bound_matrix
# --------------------------------------------------------------------------

class ExtractionError(Exception):
    pass


def _sym_eval(node, env: dict):
    """Evaluate a straight-line integer expression over ``env``.

    ``cfg.<knob>`` attributes and plain names resolve through ``env``;
    supported operators are +, -, * and parenthesized constants — exactly
    the integer algebra the bound is allowed to use.
    """
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    if isinstance(node, ast.Attribute):
        key = node.attr
        if key in env:
            return env[key]
        raise ExtractionError(f"unknown attribute `{key}` in bound expr")
    if isinstance(node, ast.Name):
        if node.id in env:
            v = env[node.id]
            return _sym_eval(v, env) if isinstance(v, ast.AST) else v
        raise ExtractionError(f"unknown name `{node.id}` in bound expr")
    if isinstance(node, ast.BinOp):
        left = _sym_eval(node.left, env)
        right = _sym_eval(node.right, env)
        if isinstance(node.op, ast.Add):
            return left + right
        if isinstance(node.op, ast.Sub):
            return left - right
        if isinstance(node.op, ast.Mult):
            return left * right
        raise ExtractionError(
            f"unsupported operator {type(node.op).__name__} in bound expr")
    raise ExtractionError(
        f"unsupported node {type(node).__name__} in bound expr")


@dataclass(frozen=True)
class BoundModel:
    """The declared per-channel staleness bound, as extracted functions."""

    intra_expr: ast.AST
    xpod_expr: ast.AST            # without the comm widening
    xpod_wired_expr: ast.AST      # with the comm widening applied

    def bound(self, channel: str, s: int, s_xpod: int, agg: int,
              retry_budget: int = 0) -> int:
        env = {"staleness": s, "s_xpod": s_xpod, "agg_clocks": agg,
               "retry_budget": retry_budget}
        expr = {"intra": self.intra_expr,
                "xpod": self.xpod_expr,
                "xpod-wired": self.xpod_wired_expr,
                "xpod-faulted": self.xpod_wired_expr}[channel]
        return _sym_eval(expr, env)


def _inline_names(expr, environment: dict):
    """Copy ``expr`` with Name references replaced by their (already
    resolved) environment expressions."""
    class R(ast.NodeTransformer):
        def visit_Name(self, node):
            if node.id in environment:
                return environment[node.id]
            return node
    return R().visit(ast.parse(ast.unparse(expr), mode="eval")).body


def extract_bound_model_from_source(source: str) -> BoundModel:
    """Parse ``staleness_bound_matrix`` out of delays.py source text."""
    tree = ast.parse(source)
    fn = None
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) \
                and node.name == "staleness_bound_matrix":
            fn = node
    if fn is None:
        raise ExtractionError("staleness_bound_matrix not found")
    # assignments resolve eagerly, so `x = x + k` (the widening idiom)
    # inlines the *previous* x rather than recursing
    env: dict = {}
    env_wired: dict | None = None
    ret = None
    for st in fn.body:
        if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                and isinstance(st.targets[0], ast.Name):
            env[st.targets[0].id] = _inline_names(st.value, env)
        elif isinstance(st, ast.If):
            # the comm_active widening branch
            names = {dotted(n) for n in ast.walk(st.test)
                     if isinstance(n, (ast.Attribute, ast.Name))}
            if not any(d and d.endswith("comm_active") for d in names):
                raise ExtractionError(
                    "unexpected branch in staleness_bound_matrix (not on "
                    "comm_active)")
            env_wired = dict(env)
            for sub in st.body:
                if isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                        and isinstance(sub.targets[0], ast.Name):
                    env_wired[sub.targets[0].id] = _inline_names(
                        sub.value, env_wired)
        elif isinstance(st, ast.Return):
            ret = st.value
    # a dtype cast of the where: `torch.where(...).to(torch.int32)`
    while isinstance(ret, ast.Call) and isinstance(ret.func, ast.Attribute) \
            and ret.func.attr in ("to", "int") \
            and isinstance(ret.func.value, ast.Call):
        ret = ret.func.value
    if ret is None or not isinstance(ret, ast.Call):
        raise ExtractionError("no torch.where return in "
                              "staleness_bound_matrix")
    d = dotted(ret.func)
    if not d or d.split(".")[-1] != "where" or len(ret.args) != 3:
        raise ExtractionError("return is not torch.where(same, intra, "
                              "xpod)")
    _, intra, xpod = ret.args
    return BoundModel(
        intra_expr=_inline_names(intra, env),
        xpod_expr=_inline_names(xpod, env),
        xpod_wired_expr=_inline_names(
            xpod, env_wired if env_wired is not None else env))


def extract_bound_model(delays_path: str) -> BoundModel:
    with open(delays_path, encoding="utf-8") as fh:
        return extract_bound_model_from_source(fh.read())


# --------------------------------------------------------------------------
# 2. producer extraction: the enforcement/delivery dataflow
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class EnforcementModel:
    """The clock-update dataflow of one Trace producer."""

    producer: str
    trigger_offset: int       # forced = cview < (c - s_eff - OFFSET)
    refresh_lag: int          # intra/unwired refresh target = c - LAG
    xpod_refresh_shipped: bool  # wired refresh -> shipped_through(c, agg)
    delivery_shipped: bool      # wired delivery -> shipped_end(c, agg)
    xpod_refresh_capped: bool = False  # faulted refresh min()s wire_tip
    delivery_capped: bool = False      # faulted delivery min()s wire_tip
    delegate: str | None = None


def _match_trigger(node) -> int | None:
    """``cview < (c - s_eff - K)`` -> K."""
    if not (isinstance(node, ast.Compare) and len(node.ops) == 1
            and isinstance(node.ops[0], ast.Lt)
            and isinstance(node.left, ast.Name)
            and node.left.id == "cview"):
        return None
    rhs = node.comparators[0]
    # (c - s_eff) - K
    if isinstance(rhs, ast.BinOp) and isinstance(rhs.op, ast.Sub) \
            and isinstance(rhs.right, ast.Constant) \
            and isinstance(rhs.left, ast.BinOp) \
            and isinstance(rhs.left.op, ast.Sub):
        inner = rhs.left
        if isinstance(inner.left, ast.Name) and inner.left.id == "c" \
                and isinstance(inner.right, ast.Name) \
                and inner.right.id == "s_eff":
            return rhs.right.value
    return None


def _calls_named(node, name: str) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            d = dotted(n.func)
            if d and d.split(".")[-1] == name:
                return True
    return False


def _caps_wire_tip(node) -> bool:
    """True when the expression reads ``...["wire_tip"]`` — the faulted
    target's arrived-boundary cap."""
    for n in ast.walk(node):
        if isinstance(n, ast.Subscript):
            sl = n.slice
            if isinstance(sl, ast.Constant) and sl.value == "wire_tip":
                return True
    return False


def _refresh_lag(node) -> int | None:
    """``c - K`` -> K (the non-shipped refresh/delivery target)."""
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub) \
            and isinstance(node.left, ast.Name) and node.left.id == "c" \
            and isinstance(node.right, ast.Constant):
        return node.right.value
    if isinstance(node, ast.Name) and node.id == "c":
        return 0
    return None


def _helpers(tree, modules: dict | None) -> dict:
    """name -> FunctionDef (or None where its module is not at hand) of
    the functions a producer may route its targets through: its own
    top-level functions, and the functions it imports by name (``from
    ..core.ps import _xpod_target``) from ``modules`` (source keyed by
    the path relative to the package, e.g. ``core/ps.py``)."""
    out = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    for node in tree.body:
        if not isinstance(node, ast.ImportFrom) or not node.module:
            continue
        suffix = node.module.replace(".", "/") + ".py"
        src = next((v for k, v in (modules or {}).items()
                    if k == suffix or k.endswith("/" + suffix)), None)
        defs = {} if src is None else {
            n.name: n for n in ast.parse(src).body
            if isinstance(n, ast.FunctionDef)}
        for a in node.names:
            out.setdefault(a.asname or a.name, defs.get(a.name))
    return out


def _target_call(call, helpers: dict):
    """``(then, capped)`` when ``call`` computes a visibility target:
    a ``where(cond, then, other)`` (capped when it reads ``wire_tip``),
    or a call of a helper with the intra-pod ``c - K`` among its
    arguments (capped when the helper's body reads ``wire_tip``)."""
    d = dotted(call.func)
    if d and d.split(".")[-1] == "where":
        if len(call.args) != 3:
            return None
        return call.args[1], _caps_wire_tip(call)
    if isinstance(call.func, ast.Name) and call.func.id in helpers:
        intra = next((a for a in call.args
                      if _refresh_lag(a) is not None), None)
        fn = helpers[call.func.id]
        if fn is None:
            if intra is not None and (_calls_named(call, "shipped_through")
                                      or _calls_named(call, "shipped_end")):
                raise ExtractionError(
                    f"the target helper `{call.func.id}` is imported from a "
                    f"module that is not at hand -- its wire_tip cap "
                    f"cannot be read")
            return None
        return intra, _caps_wire_tip(fn)
    return None


def extract_enforcement_from_source(source: str, producer: str,
                                    modules: dict | None = None
                                    ) -> EnforcementModel:
    """Extract the SSP/ESSP enforcement dataflow from a producer module.

    ``modules`` maps the paths of the package's other modules (e.g.
    ``core/ps.py``) to their source, for the target helpers the producer
    imports."""
    tree = ast.parse(source)

    # delegation: PodsRuntime subclasses PSRuntime and defines no
    # enforcement of its own — its clock step IS the psrun body
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) \
                and any(isinstance(b, (ast.Name, ast.Attribute))
                        and (dotted(b) or "").split(".")[-1] == "PSRuntime"
                        for b in node.bases):
            if any(_match_trigger(n) is not None
                   for n in ast.walk(node)):
                raise ExtractionError(
                    f"{producer}: delegating runtime re-implements "
                    f"enforcement — update the model checker")
            return EnforcementModel(
                producer=producer, trigger_offset=1, refresh_lag=1,
                xpod_refresh_shipped=True, delivery_shipped=True,
                xpod_refresh_capped=True, delivery_capped=True,
                delegate="psrun/runtime.py")

    trigger = None
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "forced":
            k = _match_trigger(node.value)
            if k is not None:
                trigger = k
    if trigger is None:
        raise ExtractionError(
            f"{producer}: no `forced = cview < (c - s_eff - K)` "
            f"enforcement trigger found")
    if not any(_calls_named(n, "staleness_bound_matrix")
               for n in ast.walk(tree) if isinstance(n, ast.Assign)
               and any(isinstance(t, ast.Name) and t.id == "s_eff"
                       for t in n.targets)):
        raise ExtractionError(
            f"{producer}: `s_eff` is not derived from "
            f"staleness_bound_matrix — the declared bound is not the one "
            f"enforced")

    # refresh/delivery targets: `cview = torch.where(forced, c - K, cview)`
    # on the unwired path; on the wired path the target routes through
    # `tgt = _xpod_target(cst, in_pod, c - K, comm.shipped_through(c, agg),
    # faulted)` (and delivery through comm.shipped_end) before the
    # forced/delivered where
    helpers = _helpers(tree, modules)
    refresh_lag = None
    xpod_refresh_shipped = False
    delivery_shipped = False
    xpod_refresh_capped = False
    delivery_capped = False
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)):
            continue
        target = _target_call(node.value, helpers)
        if target is None:
            continue
        then, capped = target
        args = node.value.args
        cond = args[0] if args else None
        cond_name = cond.id if isinstance(cond, ast.Name) else None
        if cond_name == "forced" and then is not None \
                and _refresh_lag(then) is not None:
            refresh_lag = _refresh_lag(then)
        if _calls_named(node.value, "shipped_through"):
            xpod_refresh_shipped = True
            if capped:
                xpod_refresh_capped = True   # the faulted branch's tgt
            if refresh_lag is None and then is not None \
                    and _refresh_lag(then) is not None:
                refresh_lag = _refresh_lag(then)   # the intra arm of tgt
        if _calls_named(node.value, "shipped_end"):
            delivery_shipped = True
            if capped:
                delivery_capped = True
    if refresh_lag is None:
        raise ExtractionError(
            f"{producer}: no forced-refresh target "
            f"`torch.where(forced, c - K, cview)` found")
    if not xpod_refresh_shipped:
        raise ExtractionError(
            f"{producer}: wired cross-pod refresh does not route through "
            f"comm.shipped_through — a forced refresh could observe "
            f"unshipped clocks")
    if not delivery_shipped:
        raise ExtractionError(
            f"{producer}: wired delivery does not route through "
            f"comm.shipped_end")
    if not xpod_refresh_capped:
        raise ExtractionError(
            f"{producer}: no faulted cross-pod refresh caps the shipped "
            f"boundary on cst[\"wire_tip\"] — a lossy-wire refresh could "
            f"observe unarrived clocks")
    if not delivery_capped:
        raise ExtractionError(
            f"{producer}: no faulted delivery caps comm.shipped_end on "
            f"cst[\"wire_tip\"]")
    return EnforcementModel(
        producer=producer, trigger_offset=trigger,
        refresh_lag=refresh_lag,
        xpod_refresh_shipped=xpod_refresh_shipped,
        delivery_shipped=delivery_shipped,
        xpod_refresh_capped=xpod_refresh_capped,
        delivery_capped=delivery_capped)


def extract_enforcement(path: str, producer: str) -> EnforcementModel:
    """`extract_enforcement_from_source` of a producer file, with the
    modules its relative imports name read from beside it."""
    with open(path, encoding="utf-8") as fh:
        source = fh.read()
    modules = {}
    for node in ast.parse(source).body:
        if isinstance(node, ast.ImportFrom) and node.level and node.module:
            base = os.path.dirname(os.path.abspath(path))
            for _ in range(node.level - 1):
                base = os.path.dirname(base)
            rel = node.module.replace(".", "/") + ".py"
            full = os.path.join(base, rel)
            if os.path.isfile(full):
                with open(full, encoding="utf-8") as fh:
                    modules[rel] = fh.read()
    return extract_enforcement_from_source(source, producer, modules)


# --------------------------------------------------------------------------
# 3. the model checker
# --------------------------------------------------------------------------

def _shipped_through(c: int, agg: int) -> int:
    return (c // agg) * agg - 1


def _shipped_end(c: int, agg: int) -> int:
    return ((c + 1) // agg) * agg - 1


@dataclass(frozen=True)
class Counterexample:
    producer: str
    channel: str
    config: tuple              # (T, P, s, s_xpod, agg)
    clock: int
    cview: int
    bound: int
    outage: tuple | None
    flight: int = 0            # conforming flight window (faulted channel)

    def __str__(self) -> str:
        T, P, s, s_xpod, agg = self.config
        churn = (f", reader dead on [{self.outage[0]},{self.outage[1]})"
                 if self.outage else "")
        faulted = (f", flight_budget={self.flight}"
                   if self.channel == "xpod-faulted" else "")
        return (f"{self.producer} {self.channel} channel, "
                f"(T={T}, P={P}, s={s}, s_xpod={s_xpod}, "
                f"agg_clocks={agg}){churn}{faulted}: read at clock "
                f"{self.clock} observes cview={self.cview} — lag "
                f"{self.clock - 1 - self.cview} > bound {self.bound}")


def check_channel(bound_model: BoundModel, enf: EnforcementModel,
                  channel: str, config: tuple,
                  outage: tuple | None = None) -> Counterexample | None:
    """Exhaustive DFS of one channel's (clock, cview) transition system.

    Per clock: (1) SSP/ESSP enforcement fires iff
    ``v < c - b - trigger_offset`` and refreshes to the channel's target,
    (2) the contract ``c - 1 - v <= b`` is checked at the read, (3) the
    adversary picks any delivery outcome for the end of the clock.  Dead
    readers (``outage``: clocks [t0, t1)) neither enforce, read, nor
    advance — their first read back must be forced back within bound.
    """
    T, _, s, s_xpod, agg = config
    b = bound_model.bound(channel, s, s_xpod, agg)
    wired = channel == "xpod-wired"
    states = {-1}                  # initial visibility: nothing seen
    for c in range(T):
        dead = outage is not None and outage[0] <= c < outage[1]
        next_states = set()
        for v in states:
            if not dead:
                if v < c - b - enf.trigger_offset:
                    if wired and enf.xpod_refresh_shipped:
                        v = max(v, _shipped_through(c, agg))
                    else:
                        v = max(v, c - enf.refresh_lag)
                if c - 1 - v > b:
                    return Counterexample(
                        producer=enf.producer, channel=channel,
                        config=config, clock=c, cview=v, bound=b,
                        outage=outage)
                # adversarial delivery: none, or advance to the channel's
                # delivery target
                next_states.add(v)
                if wired and enf.delivery_shipped:
                    next_states.add(max(v, _shipped_end(c, agg)))
                else:
                    next_states.add(max(v, c))
            else:
                next_states.add(v)   # frozen rows: no reads, no advance
        states = next_states
    return None


def check_channel_faulted(bound_model: BoundModel, enf: EnforcementModel,
                          config: tuple, flight: int,
                          outage: tuple | None = None
                          ) -> Counterexample | None:
    """Exhaustive DFS of the lossy-wire cross-pod channel.

    State is ``(v, tip, pend)``: the reader's visibility clock, the
    highest *arrived* shipment boundary (``wire_tip``), and the in-flight
    shipment as ``(boundary, arrival_clock)`` or None.  Per clock:
    (1) enforcement fires iff ``v < c - b - trigger_offset`` and
    refreshes to ``min(shipped_through(c, agg), tip)`` — the wire_tip
    cap; (2) the widened contract ``c - 1 - v <= b`` (``b`` includes
    ``retry_budget = 2 * flight``) is checked at the read; (3) a due
    arrival acks (``tip`` advances to its boundary); an idle-at-start
    producer ships at an aggregation boundary and the *conforming*
    adversary schedules its arrival anywhere in ``[c, c + flight]``
    (stop-and-wait: a busy producer skips the boundary — this is why two
    flight windows stack); (4) the adversary picks end-of-clock delivery
    or not, advancing ``v`` to ``min(shipped_end(c, agg), tip)``.
    Give-up is out of scope: a given-up shipment voids any finite bound
    (there the contract is mass conservation — `comm.wire`).
    """
    T, _, s, s_xpod, agg = config
    b = bound_model.bound("xpod-faulted", s, s_xpod, agg,
                          retry_budget=2 * flight)
    states = {(-1, -1, None)}
    for c in range(T):
        dead = outage is not None and outage[0] <= c < outage[1]
        nxt = set()
        for v, tip, pend in states:
            if not dead:
                if v < c - b - enf.trigger_offset:
                    if enf.xpod_refresh_capped:
                        v = max(v, min(_shipped_through(c, agg), tip))
                    else:  # uncapped mutant: sees unarrived clocks
                        v = max(v, _shipped_through(c, agg))
                if c - 1 - v > b:
                    return Counterexample(
                        producer=enf.producer, channel="xpod-faulted",
                        config=config, clock=c, cview=v, bound=b,
                        outage=outage, flight=flight)
            busy0 = pend is not None           # start-of-clock idleness
            if pend is not None and pend[1] == c:
                tip = max(tip, pend[0])        # due arrival acks
                pend = None
            if not busy0 and (c + 1) % agg == 0:
                wires = [(max(tip, c), None) if a == c else (tip, (c, a))
                         for a in range(c, c + flight + 1)]
            else:
                wires = [(tip, pend)]
            for tip2, pend2 in wires:
                nxt.add((v, tip2, pend2))      # adversary withholds
                if not dead:
                    tgt = (min(_shipped_end(c, agg), tip2)
                           if enf.delivery_capped
                           else _shipped_end(c, agg))
                    nxt.add((max(v, tgt), tip2, pend2))
        states = nxt
    return None


def model_check(bound_model: BoundModel, enf: EnforcementModel,
                Ts=(6, 9), Ps=((4, 1), (4, 2), (6, 3)),
                svals=(0, 1, 2), xvals=(0, 1, 2), aggs=(1, 2, 3),
                churn: bool = True, flights=(0, 1, 2),
                faulted_T: int = 12) -> list:
    """Exhaustively model-check the producer over the small-config grid.

    ``Ps`` pairs are (P, n_pods): n_pods == 1 exercises only the intra
    channel; n_pods > 1 adds the cross-pod channel, unwired and wired
    (the wired variant only when ``agg_clocks`` matters, i.e. always —
    agg=1 must reduce to the unwired algebra).  With ``churn`` every
    single reader-outage window [t0, t1) x each config is also explored.

    The lossy-wire channel runs per ``flights`` value at ``faulted_T``
    clocks (long enough for two stacked flight windows to bite on every
    agg; ``flight=0`` must reduce exactly to the wired algebra) without
    outage windows — the reader-outage interplay is already covered on
    the other channels, and a producer-side outage voids the conforming
    premise (churn drain gates retransmission).
    """
    ces = []
    for T, (P, n_pods), s, s_xpod, agg in itertools.product(
            Ts, Ps, svals, xvals, aggs):
        config = (T, P, s, s_xpod, agg)
        channels = ["intra"]
        if n_pods > 1:
            channels += ["xpod", "xpod-wired"]
        outages = [None]
        if churn:
            outages += [(t0, t1) for t0 in range(T)
                        for t1 in range(t0 + 1, T + 1)]
        for channel in channels:
            for outage in outages:
                ce = check_channel(bound_model, enf, channel, config,
                                   outage)
                if ce is not None:
                    ces.append(ce)
                    break          # one trace per (channel, config) row
    for (P, n_pods), s, s_xpod, agg in itertools.product(
            Ps, svals, xvals, aggs):
        if n_pods == 1:
            continue
        config = (faulted_T, P, s, s_xpod, agg)
        for flight in flights:
            ce = check_channel_faulted(bound_model, enf, config, flight)
            if ce is not None:
                ces.append(ce)
                break              # one trace per (config, flights) row
    return ces


# --------------------------------------------------------------------------
# repo entry point (called from analyze_paths)
# --------------------------------------------------------------------------

def check_repo(modules) -> list:
    """Run extraction + model check when the scan set contains the three
    Trace producers; silently skip when it does not (fixture scans)."""
    by_suffix = {}
    delays = None
    for mod in modules:
        for suffix in PRODUCER_FILES:
            if mod.rel.endswith(suffix):
                by_suffix[suffix] = mod
        if mod.rel.endswith("core/delays.py"):
            delays = mod
    if delays is None or len(by_suffix) != len(PRODUCER_FILES):
        return []
    findings = []
    try:
        bound_model = extract_bound_model_from_source(delays.source)
    except ExtractionError as e:
        return [Finding("staleness-extract", delays.rel, 1, str(e))]
    sources = {mod.rel: mod.source for mod in modules}
    for suffix in PRODUCER_FILES:
        mod = by_suffix[suffix]
        try:
            enf = extract_enforcement_from_source(mod.source, suffix,
                                                  sources)
        except ExtractionError as e:
            findings.append(Finding("staleness-extract", mod.rel, 1,
                                    str(e)))
            continue
        for ce in model_check(bound_model, enf):
            findings.append(Finding("staleness-contract", mod.rel, 1,
                                    str(ce)))
    return findings
