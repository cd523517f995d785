"""The port's static checker (``repro_torch.analysis``) on its fixtures, on
the port and against the JAX package's checker.

- Each ``tests/torch_analysis_fixtures/bad_<family>`` reports exactly its
  ``# VIOLATION: <rule>`` markers (rule and line), each ``good_<family>``
  nothing; the cuda fixtures are a small fake kernel package.
- Inline suppression, ``bare-ignore`` under ``--strict``, the CLI's exit
  codes and ``--list-rules`` (the rules without a counterpart absent).
- ``src/repro_torch`` scans clean under ``--strict``, and the rules bite
  on it: a planted host sync in the clock loop and an unmasked gather in
  the sharded runtime are found in a copy.
- ``import repro_torch.analysis`` leaves ``torch`` and ``jax`` unloaded.
- The translated fixtures (rng, collectives, dataclass, host sync) give
  the (line, rule) pairs JAX's checker gives on its own fixtures, for the
  rules with a counterpart (``pytree-*`` -> ``state-*``,
  ``host-callback`` -> ``host-sync``).
- The staleness checker: the bound model and the three producers'
  enforcement models equal JAX's; the model check is clean on both; both
  refute the ``agg_clocks - 2`` and retry-budget mutants and a lagging
  refresh with the same counterexamples; extraction fails on drift; the
  churn-outage grid is covered.
"""
from __future__ import annotations

import dataclasses
import os
import re
import shutil
import subprocess
import sys

import pytest

from repro_torch.analysis import (analyze_paths, extract_bound_model,
                                  extract_bound_model_from_source,
                                  extract_enforcement,
                                  extract_enforcement_from_source,
                                  model_check)
from repro_torch.analysis.staleness_check import ExtractionError, \
    check_channel_faulted

HERE = os.path.dirname(__file__)
REPO = os.path.dirname(HERE)
FIXTURES = os.path.join(HERE, "torch_analysis_fixtures")
JAX_FIXTURES = os.path.join(HERE, "analysis_fixtures")
SRC = os.path.join(REPO, "src", "repro_torch")
JAX_SRC = os.path.join(REPO, "src", "repro")

FAMILIES = ("rng", "host_sync", "collectives", "dataclass", "cuda")
# port family -> the JAX fixture family it translates
TRANSLATED = {"rng": "rng", "host_sync": "callbacks",
              "collectives": "collectives", "dataclass": "pytree"}
RENAMED = {"pytree-frozen": "state-frozen",
           "pytree-mutation": "state-mutation",
           "host-callback": "host-sync"}
NO_COUNTERPART = ("traced-branch", "traced-coerce", "traced-static-arg",
                  "collective-outside-shardmap", "pallas-interpret",
                  "pallas-blockspec")
PRODUCERS = ("core/ps.py", "psrun/runtime.py", "pods/runtime.py")


def _fixture(kind: str, family: str) -> str:
    path = os.path.join(FIXTURES, f"{kind}_{family}")
    return path if os.path.isdir(path) else path + ".py"


def _expected_violations(path):
    """(rel path, line, rule) of every VIOLATION marker under ``path``."""
    files = [path] if os.path.isfile(path) else sorted(
        os.path.join(r, n) for r, _, ns in os.walk(path) for n in ns
        if n.endswith((".py", ".cu")))
    out = []
    for f in files:
        with open(f, encoding="utf-8") as fh:
            for ln, line in enumerate(fh, 1):
                m = re.search(r"(?:#|//) VIOLATION: ([\w-]+)", line)
                if m:
                    out.append((os.path.relpath(f), ln, m.group(1)))
    return sorted(out)


def _pairs(findings):
    return sorted((f.path, f.line, f.rule) for f in findings)


@pytest.mark.parametrize("family", FAMILIES)
def test_bad_fixture_caught(family):
    """Every marked violation is reported with its exact rule and line,
    and nothing else."""
    path = _fixture("bad", family)
    expected = _expected_violations(path)
    assert expected, f"fixture {path} carries no VIOLATION markers"
    assert _pairs(analyze_paths([path], model_check=False)) == expected


@pytest.mark.parametrize("family", FAMILIES)
def test_good_fixture_clean(family):
    findings = analyze_paths([_fixture("good", family)], strict=True,
                             model_check=False)
    assert findings == [], [str(f) for f in findings]


def test_suppression_comment(tmp_path):
    """An inline reasoned ignore silences exactly its rule on its line;
    ``--strict`` rejects one without a reason."""
    src = open(_fixture("bad", "rng"), encoding="utf-8").read()
    patched = src.replace("# VIOLATION: rng-reuse",
                          "# analysis: ignore[rng-reuse] -- fixture", 1)
    p = tmp_path / "patched.py"
    p.write_text(patched)
    rules = [f.rule for f in analyze_paths([str(p)], model_check=False)]
    assert rules == ["rng-reuse", "rng-reuse"]          # 3 - 1 suppressed
    p.write_text(patched.replace("-- fixture", ""))
    strict = analyze_paths([str(p)], strict=True, model_check=False)
    assert [f.rule for f in strict].count("bare-ignore") == 1
    assert [f.rule for f in analyze_paths([str(p)], model_check=False)] \
        == ["rng-reuse", "rng-reuse"]
    # a suppression file silences a rule by path glob
    supp = tmp_path / "supp.txt"
    supp.write_text(f"*patched.py:rng-reuse  # generated\n")
    from repro_torch.analysis import load_suppression_file
    assert analyze_paths([str(p)], model_check=False,
                         suppressions=load_suppression_file(str(supp))) == []


def test_self_scan_clean():
    """src/repro_torch is finding-free (but reasoned inline ignores),
    staleness model check included."""
    findings = analyze_paths([SRC], strict=True)
    assert findings == [], "\n".join(str(f) for f in findings)


def _env():
    return dict(os.environ,
                PYTHONPATH=os.path.join(REPO, "src") + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


def test_cli_exit_codes():
    run = lambda *a: subprocess.run(  # noqa: E731
        [sys.executable, "-m", "repro_torch.analysis", *a],
        capture_output=True, text=True, env=_env(), cwd=REPO)
    clean = run("--strict")                 # the default path: the port
    assert clean.returncode == 0, clean.stdout + clean.stderr
    assert clean.stdout.strip().endswith("(strict): 0 findings")
    dirty = run(_fixture("bad", "rng"), "--no-model-check")
    assert dirty.returncode == 1 and "rng-reuse" in dirty.stdout
    rules = run("--list-rules")
    assert rules.returncode == 0
    listed = {ln.split()[0] for ln in rules.stdout.splitlines()}
    assert listed == {"rng-reuse", "host-sync", "axis-unbound",
                      "unmasked-gather", "state-frozen", "state-mutation",
                      "knob-split", "cuda-ref", "cuda-fallback",
                      "staleness-contract", "staleness-extract"}
    assert not listed & set(NO_COUNTERPART)


def test_import_leaves_torch_and_jax_out():
    probe = ("import sys, repro_torch.analysis as a\n"
             "a.analyze_paths(['src/repro_torch/core'], model_check=True)\n"
             "print(sorted(m for m in ('torch', 'jax', 'repro') "
             "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, env=_env(), cwd=REPO, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("family", list(TRANSLATED))
def test_translated_fixtures_match_jax(family):
    """The line-for-line translations report JAX's (line, rule) pairs for
    the rules with a counterpart."""
    jax_analysis = pytest.importorskip("repro.analysis")
    want = sorted(
        (f.line, RENAMED.get(f.rule, f.rule))
        for f in jax_analysis.analyze_paths(
            [os.path.join(JAX_FIXTURES, f"bad_{TRANSLATED[family]}.py")],
            model_check=False)
        if f.rule not in NO_COUNTERPART)
    got = sorted((f.line, f.rule) for f in analyze_paths(
        [_fixture("bad", family)], model_check=False))
    assert got == want and want


# ----------------------------------------------------------- host sync


@pytest.mark.parametrize(("line", "sync"), [
    ("n = x.tolist()", True), ("n = x.cpu()", True),
    ("n = x.numpy()", True), ("n = int(x.sum())", True),
    ("n = bool(torch.any(x))", True), ("n = 1 if x.any() else 0", True),
    ("n = float(y)", True), ("n = int(x.shape[0])", False),
    ("n = int(c)", False), ("n = float(cfg.v0)", False),
    ("n = x.dim() if x is not None else 0", False),
    ("n = torch.where(x > 0, x, 0.0)", False)])
def test_host_sync_forms(tmp_path, line, sync):
    """The forms that make the host wait, inside the clock step only."""
    src = ("import torch\n\nCLOCK_STEP = ('step',)\n\n\n"
           "def step(x, c, cfg):\n    y = x.amax()\n"
           f"    {line}\n    while y > 0:\n        y = y - 1\n"
           "    return n\n\n\n"
           f"def host(x, c, cfg):\n    y = x.amax()\n    {line}\n"
           "    return n\n")
    p = tmp_path / "clock.py"
    p.write_text(src)
    got = [(f.line, f.rule) for f in analyze_paths([str(p)],
                                                   model_check=False)]
    # the while on a tensor (line 9) always, the form (line 8) if a sync;
    # the host-side copy in `host` never
    assert got == ([(8, "host-sync")] if sync else []) + [(9, "host-sync")]


def test_obs_host_side_modules_exempt(tmp_path):
    d = tmp_path / "repro_torch" / "obs"
    d.mkdir(parents=True)
    src = "def drain(acc):\n    return acc['x'].item()\n"
    (d / "report.py").write_text(src)
    (d / "metrics.py").write_text("CLOCK_STEP = ('drain',)\n\n\n" + src)
    got = [(os.path.basename(f.path), f.line)
           for f in analyze_paths([str(tmp_path)], model_check=False)]
    assert got == [("metrics.py", 5)]


# ----------------------------------------------------- dataclass rules


def test_object_setattr_and_knob_split(tmp_path):
    """``object.__setattr__`` on a state instance; KNOB_BOUNDS naming no
    field, INT_KNOBS outside KNOB_BOUNDS."""
    p = tmp_path / "mut.py"
    p.write_text("def f(cfg: 'ConsistencyConfig'):\n"
                 "    object.__setattr__(cfg, 'staleness', 9)\n"
                 "    cfg.v0 += 1.0\n")
    assert [(f.line, f.rule) for f in analyze_paths(
        [str(p)], model_check=False)] == [(2, "state-mutation"),
                                          (3, "state-mutation")]
    core = tmp_path / "core"
    core.mkdir()
    src = open(os.path.join(SRC, "core", "consistency.py"),
               encoding="utf-8").read()
    (core / "consistency.py").write_text(src)
    assert analyze_paths([str(core)], model_check=False) == []
    bad = src.replace('"topk_frac": (0.01, 1.0),',
                      '"topk_frac": (0.01, 1.0),\n    "knob_x": (0, None),')
    bad = bad.replace('INT_KNOBS = ("staleness",',
                      'INT_KNOBS = ("staleness", "window",')
    assert bad.count("knob_x") == 1 and bad.count('"window",') == 1
    (core / "consistency.py").write_text(bad)
    msgs = [f.message for f in analyze_paths([str(core)], model_check=False)
            if f.rule == "knob-split"]
    assert len(msgs) == 2 and "knob_x" in msgs[0] and "window" in msgs[1]


# ------------------------------------------------ the rules on the port


def _port_copy(tmp_path):
    dst = tmp_path / "repro_torch"
    shutil.copytree(SRC, dst, ignore=shutil.ignore_patterns("__pycache__"))
    return dst


def test_rules_bite_on_the_port(tmp_path):
    """A host sync planted in simulate's clock loop and an unmasked worker
    gather planted in the runtime's clock step are found in a copy."""
    dst = _port_copy(tmp_path)
    ps = dst / "core" / "ps.py"
    src = ps.read_text()
    anchor = "        staleness = cview - c\n"
    assert src.count(anchor) == 1
    ps.write_text(src.replace(
        anchor, anchor + "        _n = int(forced.sum())\n"))
    rt = dst / "psrun" / "runtime.py"
    src = rt.read_text()
    anchor = "            u_all = sh.gather(u_l, sh.workers, 0)"
    assert src.count(anchor) == 1
    rt.write_text(src.replace(
        anchor, "            u_raw = u_l * 1.0\n"
        "            u_all = sh.gather(u_raw, sh.workers, 0)"))
    got = {(os.path.relpath(f.path, dst).replace(os.sep, "/"), f.rule)
           for f in analyze_paths([str(dst)], model_check=False)}
    assert got == {("core/ps.py", "host-sync"),
                   ("psrun/runtime.py", "unmasked-gather")}


# ------------------------------------------------------------- staleness


def _jax_staleness():
    return pytest.importorskip("repro.analysis.staleness_check")


def _bound_models(mutate=None):
    J = _jax_staleness()
    srcs = [open(os.path.join(root, "core", "delays.py"),
                 encoding="utf-8").read() for root in (SRC, JAX_SRC)]
    if mutate is not None:
        old, new = mutate
        assert all(old in s for s in srcs)
        srcs = [s.replace(old, new) for s in srcs]
    return (extract_bound_model_from_source(srcs[0]),
            J.extract_bound_model_from_source(srcs[1]))


def test_bound_extraction_equals_jax():
    port, jax_bm = _bound_models()
    for ch in ("intra", "xpod", "xpod-wired", "xpod-faulted"):
        for s in range(3):
            for sx in range(3):
                for agg in (1, 2, 3):
                    for rb in (0, 2, 4):
                        assert port.bound(ch, s, sx, agg, rb) \
                            == jax_bm.bound(ch, s, sx, agg, rb)
    assert port.bound("xpod-wired", 1, 2, 3) == 1 + 2 + 3 - 1
    assert port.bound("xpod-faulted", 1, 2, 3, 4) == 1 + 2 + 3 - 1 + 4


def _enforcement(producer):
    J = _jax_staleness()
    return (extract_enforcement(os.path.join(SRC, producer), producer),
            J.extract_enforcement(os.path.join(JAX_SRC, producer),
                                  producer))


def _fields(enf):
    return {f.name: getattr(enf, f.name) for f in dataclasses.fields(enf)
            if f.name not in ("producer", "delegate")}


@pytest.mark.parametrize("producer", PRODUCERS)
def test_enforcement_equals_jax_and_model_checks_clean(producer):
    port, jax_enf = _enforcement(producer)
    assert _fields(port) == _fields(jax_enf)
    assert port.trigger_offset == 1 and port.refresh_lag == 1
    assert port.xpod_refresh_capped and port.delivery_capped
    if producer == "pods/runtime.py":
        assert port.delegate == "psrun/runtime.py"
    J = _jax_staleness()
    bm, jbm = _bound_models()
    assert model_check(bm, port) == [] == J.model_check(jbm, jax_enf)


MUTANTS = {
    "agg_clocks": ("(cfg.agg_clocks - 1)", "(cfg.agg_clocks - 2)"),
    "retry_budget": ("+ retry_budget", "+ (retry_budget - 1)"),
}


def _ce(ces):
    return [dataclasses.astuple(c) for c in ces]


@pytest.mark.parametrize("mutant", [*MUTANTS, "lagging_refresh"])
def test_mutants_refuted_alike(mutant):
    """Both checkers refute the mutant with the same counterexamples."""
    J = _jax_staleness()
    port_enf, jax_enf = _enforcement("psrun/runtime.py")
    if mutant == "lagging_refresh":
        bm, jbm = _bound_models()
        port_enf = dataclasses.replace(port_enf, refresh_lag=3)
        jax_enf = dataclasses.replace(jax_enf, refresh_lag=3)
    else:
        bm, jbm = _bound_models(MUTANTS[mutant])
    got, want = model_check(bm, port_enf), J.model_check(jbm, jax_enf)
    assert got, f"{mutant} not refuted"
    assert _ce(got) == _ce(want)
    assert [str(c) for c in got] == [str(c) for c in want]
    chans = {c.channel for c in got}
    if mutant == "agg_clocks":
        assert "xpod-wired" in chans
        assert chans <= {"xpod-wired", "xpod-faulted"}
    if mutant == "retry_budget":
        assert "xpod-faulted" in chans
        good, _ = _bound_models()
        config = (12, 4, 0, 0, 1)      # the tight corner at flight 1
        assert check_channel_faulted(bm, port_enf, config, 1) is not None
        assert check_channel_faulted(good, port_enf, config, 1) is None


def test_extraction_fails_on_drift():
    """A drifted trigger, a dropped wire_tip cap (in the helper both
    producers share) or a helper out of reach fails extraction loudly."""
    ps_src = open(os.path.join(SRC, "core", "ps.py"),
                  encoding="utf-8").read()
    rt_src = open(os.path.join(SRC, "psrun", "runtime.py"),
                  encoding="utf-8").read()
    drifted = rt_src.replace("forced = cview < (c - s_eff - 1)",
                             "forced = cview <= (c - s_eff - 1)")
    assert drifted != rt_src
    with pytest.raises(ExtractionError, match="trigger"):
        extract_enforcement_from_source(drifted, "psrun/runtime.py",
                                        {"core/ps.py": ps_src})
    uncapped = ps_src.replace('cst["wire_tip"]', 'cst["pend_clock"]')
    assert uncapped != ps_src
    with pytest.raises(ExtractionError, match="wire_tip"):
        extract_enforcement_from_source(uncapped, "core/ps.py")
    with pytest.raises(ExtractionError, match="wire_tip"):
        extract_enforcement_from_source(rt_src, "psrun/runtime.py",
                                        {"core/ps.py": uncapped})
    with pytest.raises(ExtractionError, match="not at hand"):
        extract_enforcement_from_source(rt_src, "psrun/runtime.py")
    unshipped = ps_src.replace("comm.shipped_end(c, agg)", "c")
    assert unshipped != ps_src
    with pytest.raises(ExtractionError, match="shipped_end"):
        extract_enforcement_from_source(unshipped, "core/ps.py")
    delays = open(os.path.join(SRC, "core", "delays.py"),
                  encoding="utf-8").read()
    with pytest.raises(ExtractionError, match="where"):
        extract_bound_model_from_source(delays.replace(
            "return torch.where(same, cfg.staleness, xpod_bound)",
            "return torch.maximum(same, xpod_bound)"))


def test_model_check_covers_churn_outages(monkeypatch):
    """Dead-reader windows are part of the grid: every single outage
    [t0, t1) of each config is explored on each channel, and freezing
    cview during an outage and forcing on rejoin stays within bound."""
    from repro_torch.analysis import staleness_check as S
    bm = extract_bound_model(os.path.join(SRC, "core", "delays.py"))
    enf = extract_enforcement(os.path.join(SRC, "psrun", "runtime.py"),
                              "psrun/runtime.py")
    seen = set()
    real = S.check_channel

    def record(bm_, enf_, channel, config, outage=None):
        seen.add((channel, config[0], outage))
        return real(bm_, enf_, channel, config, outage)

    monkeypatch.setattr(S, "check_channel", record)
    assert S.model_check(bm, enf, churn=True) == []
    for channel in ("intra", "xpod", "xpod-wired"):
        for T in (6, 9):
            want = {None} | {(t0, t1) for t0 in range(T)
                             for t1 in range(t0 + 1, T + 1)}
            assert {o for ch, t, o in seen if ch == channel and t == T} \
                == want
