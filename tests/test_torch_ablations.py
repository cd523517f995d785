"""The kernel ablation scripts (``*_ablation.py`` at the root) on the CPU:
each copy's textual changes still apply to the CUDA source it changes, so
that an edit of a kernel that breaks a script's table fails here and not
at its next run on the card; and ``ablation_kit.patched`` refuses a
change whose text is not there."""
from __future__ import annotations

import importlib
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import ablation_kit  # noqa: E402

SCRIPTS = sorted(p.stem for p in ROOT.glob("*_ablation.py"))
# the scripts whose changes must each match exactly once
ONCE = {"attention_bwd_ablation"}


def test_every_ablation_script_is_listed():
    assert SCRIPTS == ["attention_ablation", "attention_bwd_ablation",
                       "mf_ablation", "mla_ablation", "ssd_ablation",
                       "ssd_bwd_ablation", "vap_ablation"]


@pytest.mark.parametrize("script", SCRIPTS)
def test_ablation_table_applies_to_its_source(script):
    mod = importlib.import_module(script)
    texts = ablation_kit.sources(mod.SRC, mod.ABLATIONS,
                                 once=script in ONCE)
    src = (ROOT / mod.SRC).read_text()
    assert set(texts) == set(mod.ABLATIONS)
    assert texts["as_built"] == src
    for name, subs in mod.ABLATIONS.items():
        if subs:    # every copy but the one as built differs from it
            assert texts[name] != src, name


def test_patched_refuses_a_change_that_is_not_there():
    assert ablation_kit.patched("a b a", [("a", "c")], "x") == "c b c"
    with pytest.raises(RuntimeError, match="does not hold"):
        ablation_kit.patched("a b", [("z", "c")], "x")
    with pytest.raises(RuntimeError, match="once"):
        ablation_kit.patched("a b a", [("a", "c")], "x", once=True)


def test_sources_takes_only_and_parent(tmp_path):
    mod = importlib.import_module("ssd_bwd_ablation")
    parent = tmp_path / "parent"
    (parent / mod.SRC).parent.mkdir(parents=True)
    (parent / mod.SRC).write_text("// the parent's source\n")
    texts = ablation_kit.sources(mod.SRC, mod.ABLATIONS, parent=parent,
                                 only={"no_chunk"})
    assert set(texts) == {"no_chunk", "parent"}
    assert texts["parent"] == "// the parent's source\n"
