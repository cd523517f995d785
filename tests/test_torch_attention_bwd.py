"""The walk of the bf16 backward's persistent kernels over the work
(``ref.attention_bwd_schedule``, the plain version of
``csrc/flash_attention_bwd.cu``'s producers), on the CPU.

On each shape that ``chip_smoke.py`` holds the card's backward to
(``BWD_SHAPES``), every visible (query, key, head) triple must lie in
exactly one tile that each kernel sends, every item must be taken by
exactly one CTA, and each item's tiles must come in the fixed order the
deterministic sums rely on: the MLA kernels' walk at MLA's (576, 512),
the wgmma kernels' at every other shape.  The tiles must be the kernel
source's, and the source's variant rule the wrapper's.
"""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
BWD_SHAPES = chip_smoke.BWD_SHAPES
SMS = 132   # an H100 SXM's SMs: the kernels' persistent grid


def _positions(kind, B, Sq, Sk, seed=0):
    """``(q_pos, kv_pos)`` as ``chip_smoke.attn_inputs`` makes them:
    queries at the last Sq positions, keys at ``arange`` with a quarter
    masked ("holes") or every key 5 positions after the first query
    ("late_keys")."""
    r = np.random.default_rng(seed)
    qp = np.broadcast_to(np.arange(Sk - Sq, Sk), (B, Sq)).astype(np.int32)
    kp = np.broadcast_to(np.arange(Sk), (B, Sk)).astype(np.int32).copy()
    if kind == "holes":
        kp[:, r.choice(Sk, Sk // 4, replace=False)] = -1
    elif kind == "late_keys":
        kp += 5 + Sk - Sq
    return (torch.from_numpy(np.ascontiguousarray(qp)),
            torch.from_numpy(kp))


def _visible_tiles(mask, bq, bk):
    """``[B, nq, nk]`` bool: the (query tile, key tile) pairs holding a
    visible pair, and ``[B, nq, nk]`` their counts of visible pairs."""
    B, Sq, Sk = mask.shape
    nq, nk = -(-Sq // bq), -(-Sk // bk)
    m = torch.nn.functional.pad(mask, (0, nk * bk - Sk, 0, nq * bq - Sq))
    counts = m.reshape(B, nq, bq, nk, bk).sum((2, 4))
    return counts > 0, counts


def _variant(dt, Dk, Dv):
    """The persistent walk a shape of `BWD_SHAPES` is held to: the MLA
    kernels' at their bf16 size, else the wgmma kernels'."""
    mla = dt == "bf16" and (Dk, Dv) in fa.BWD_BF16_RULE["mla_wgmma"]
    return "mla_wgmma" if mla else "wgmma_tma"


def _check_mla_schedule(sched, mask, H, Hkv):
    """The MLA kernels' walk: dK items of 64 keys over units of 32 (query,
    head) rows of their KV head in q's order, the last unit first, dQ
    items of 64 such rows over 32-key tiles in order; each visible (query,
    key, head) triple in exactly one sent unit of each kernel, each item
    once, the units in their fixed order."""
    B, Sq, Sk = mask.shape
    rep = H // Hkv
    # the rows of one KV head's rep heads, row rr at query rr // rep
    rmask = mask.repeat_interleave(rep, dim=1)           # [B, Sq*rep, Sk]
    for kernel, (item_rows, unit_rows), keys_first in (
            ("dkdv", ref.BWD_MLA_DK_TILES, True),
            ("dq", ref.BWD_MLA_DQ_TILES, False)):
        bq, bk = (unit_rows, item_rows) if keys_first else (item_rows,
                                                             unit_rows)
        seen, counts = _visible_tiles(rmask, bq, bk)
        n_rb, n_kb = seen.shape[1:]
        items = [it for cta in sched[kernel] for it in cta]
        n_items = (n_kb if keys_first else n_rb) * Hkv * B
        assert len(sched[kernel]) == min(n_items, SMS)
        assert sorted(it[:3] for it in items) == [
            (b, hk, x) for b in range(B) for hk in range(Hkv)
            for x in range(n_kb if keys_first else n_rb)]
        sent = set()
        for b, hk, x, units in items:
            order = [u for u, _ in units]
            assert order == sorted(set(order), reverse=keys_first)
            assert all(cls != ref.TILE_SKIP for _, cls in units)
            sent.update((b, hk, u, x) if keys_first else (b, hk, x, u)
                        for u in order)
        want = {(b, hk, rb, kb) for b, rb, kb in seen.nonzero().tolist()
                for hk in range(Hkv)}
        assert want <= sent
        assert sum(int(counts[b, rb, kb]) for b, _, rb, kb in sent) \
            == H * int(mask.sum())


@pytest.mark.parametrize("name", list(BWD_SHAPES))
def test_bwd_schedule_covers_every_visible_triple_once(name):
    B, Sq, Sk, H, Hkv, Dk, Dv, causal, window, dt, kind = BWD_SHAPES[name]
    qp, kp = _positions(kind, B, Sq, Sk)
    variant = _variant(dt, Dk, Dv)
    sched = ref.attention_bwd_schedule(qp, kp, H, Hkv, causal, window,
                                       ctas=SMS, variant=variant)
    mask = ref._block_mask(qp, kp, causal, window).expand(B, Sq, Sk)
    if variant == "mla_wgmma":
        _check_mla_schedule(sched, mask, H, Hkv)
        return
    rep = H // Hkv

    # dK/dV: items of 128 keys of a KV head, 64-query tiles of its heads
    kb, qt_rows = ref.BWD_DKDV_TILES
    n_kb = -(-Sk // kb)
    seen, counts = _visible_tiles(mask, qt_rows, kb)
    items = [it for cta in sched["dkdv"] for it in cta]
    assert len(sched["dkdv"]) == min(n_kb * Hkv * B, SMS)
    assert sorted((b, hk, kt) for b, hk, kt, _ in items) == [
        (b, hk, kt) for b in range(B) for hk in range(Hkv)
        for kt in range(n_kb)]
    sent = set()
    for b, hk, kt, tiles in items:
        # the fixed order, once each: chunks of 32 query tiles, each
        # chunk's tiles head by head
        order = [(qt // 32, h, qt) for h, qt, _ in tiles]
        assert order == sorted(set(order))
        for h, qt, cls in tiles:
            assert h // rep == hk and cls != ref.TILE_SKIP
            sent.add((b, h, qt, kt))
    want = {(b, h, qt, kt) for b, qt, kt in seen.nonzero().tolist()
            for h in range(H)}
    assert want <= sent
    assert sum(int(counts[b, qt, kt]) for b, _, qt, kt in sent) \
        == H * int(mask.sum())

    # dQ: items of 128 queries of a head, 64-key tiles
    qb_rows, kt_keys = ref.BWD_DQ_TILES
    n_qb = -(-Sq // qb_rows)
    seen, counts = _visible_tiles(mask, qb_rows, kt_keys)
    items = [it for cta in sched["dq"] for it in cta]
    assert len(sched["dq"]) == min(n_qb * H * B, SMS)
    assert sorted((b, h, qb) for b, h, qb, _ in items) == [
        (b, h, qb) for b in range(B) for h in range(H) for qb in range(n_qb)]
    sent = set()
    for b, h, qb, tiles in items:
        order = [kt for kt, _ in tiles]
        assert order == sorted(set(order))
        assert all(cls != ref.TILE_SKIP for _, cls in tiles)
        sent.update((b, h, qb, kt) for kt in order)
    want = {(b, h, qb, kt) for b, qb, kt in seen.nonzero().tolist()
            for h in range(H)}
    assert want <= sent
    assert sum(int(counts[b, qb, kt]) for b, _, qb, kt in sent) \
        == H * int(mask.sum())


@pytest.mark.parametrize("n_items,ctas", [(10, 4), (1024, 132), (2048, 132),
                                          (7, 7), (131, 132), (265, 132)])
def test_persistent_items_take_each_item_once(n_items, ctas):
    """The snake over the grid's rounds (``item_of``) gives every item to
    one CTA, each CTA's items rising round by round."""
    walk = ref.persistent_items(n_items, ctas)
    assert sorted(i for seq in walk for i in seq) == list(range(n_items))
    for j, seq in enumerate(walk):
        assert seq == sorted(seq)
        assert all(i // ctas == k for k, i in enumerate(seq))
        if seq:
            assert seq[0] == j


def test_bwd_tiles_match_the_kernel_source():
    """`ref.BWD_DKDV_TILES`, `ref.BWD_DQ_TILES`, `ref.BWD_MLA_DK_TILES`
    and `ref.BWD_MLA_DQ_TILES` are the tiles of the source's
    ``DkdvLayout``, ``DqLayout``, ``MlaDkLayout`` and ``MlaDqLayout``,
    and all four kernels walk their items with ``item_of``."""
    src = (CSRC / "flash_attention_bwd.cu").read_text()
    for layout, (item, tile), keys_first in (
            ("DkdvLayout", ref.BWD_DKDV_TILES, True),
            ("DqLayout", ref.BWD_DQ_TILES, False),
            ("MlaDkLayout", ref.BWD_MLA_DK_TILES, True),
            ("MlaDqLayout", ref.BWD_MLA_DQ_TILES, False)):
        body = src.split(f"struct {layout} {{", 1)[1].split("};", 1)[0]
        bq = int(re.search(r"\bBQ = (\d+)", body).group(1))
        bk = int(re.search(r"\bBK = (\d+)", body).group(1))
        got = (bk, bq) if keys_first else (bq, bk)
        assert got == (item, tile), layout
    assert src.count("item_of(n, blockIdx.x, gridDim.x)") == 4


def _rule_pairs(expr):
    """The (Dk, Dv) pairs of a C++ disjunction of ``(dk == a && dv ==
    b)`` terms."""
    return {(int(a), int(b)) for a, b in re.findall(
        r"dk == (\d+) && dv == (\d+)", expr)}


def test_bwd_variant_rule_matches_the_library_source():
    """The library's ``bwd_variant_of`` (parsed) gives each bf16 head size
    the variant of `flash_attention.BWD_BF16_RULE` and float32 the CUDA-core
    kernels at `BWD_HEAD_DIMS`' float32 sizes; its enum numbers the
    variants in `BWD_VARIANTS`' order, and every kernel `BWD_KERNELS`
    names is one of the source's."""
    src = (CSRC / "flash_attention_bwd.cu").read_text()
    enum = src.split("enum BwdVariant {", 1)[1].split("};", 1)[0]
    numbers = {name: int(v) for name, v in
               re.findall(r"(BV_\w+) = (-?\d+)", enum)}
    body = src.split("int bwd_variant_of(int bf16_, int dk, int dv) {",
                     1)[1].split("\n}\n", 1)[0]
    sets = {name: _rule_pairs(expr) for name, expr in re.findall(
        r"const bool (\w+) = (.*?);", body, flags=re.S)}
    bf16_ret = re.search(r"if \(bf16_\)\s*return (.*?);", body,
                         flags=re.S).group(1)
    chosen = re.findall(r"(\w+) \? (BV_\w+)", bf16_ret)
    got = {}
    for cond, var in chosen:
        got.setdefault(fa.BWD_VARIANTS[numbers[var]], set()).update(
            sets[cond])
    assert got == {k: set(v) for k, v in fa.BWD_BF16_RULE.items()}
    assert set().union(*got.values()) == set(fa.BWD_HEAD_DIMS[torch.bfloat16])
    f32_ret = body.rsplit("return", 1)[1]
    f32 = set().union(*(sets[c] for c in re.findall(r"(\w+)(?= \|\||\s*\?)",
                                                    f32_ret)))
    assert re.search(r"\? (BV_\w+)", f32_ret).group(1) == "BV_F32"
    assert numbers["BV_F32"] == fa.BWD_VARIANTS.index("f32_cuda_cores")
    assert f32 == set(fa.BWD_HEAD_DIMS[torch.float32])
    assert set(fa.BWD_KERNELS) == set(fa.BWD_BF16_RULE)
    for names in fa.BWD_KERNELS.values():
        for name in names:
            assert re.search(rf"__global__ void __launch_bounds__\([^)]*\) "
                             rf"{name}\(", src), name
