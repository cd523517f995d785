"""The walk of the bf16 backward's persistent kernels over the work
(``ref.attention_bwd_schedule``, the plain version of
``csrc/flash_attention_bwd.cu``'s producers), on the CPU.

On each shape that ``chip_smoke.py`` holds the card's backward to
(``BWD_SHAPES``), every visible (query, key, head) triple must lie in
exactly one tile that each kernel sends, every item must be taken by
exactly one CTA, and each item's tiles must come in the fixed order the
deterministic sums rely on.  The tiles must be the kernel source's.
"""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("name", list(BWD_SHAPES))
def test_bwd_schedule_covers_every_visible_triple_once(name):
    B, Sq, Sk, H, Hkv, _, _, causal, window, _, kind = BWD_SHAPES[name]
    qp, kp = _positions(kind, B, Sq, Sk)
    sched = ref.attention_bwd_schedule(qp, kp, H, Hkv, causal, window,
                                       ctas=SMS)
    mask = ref._block_mask(qp, kp, causal, window).expand(B, Sq, Sk)
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
    """`ref.BWD_DKDV_TILES` and `ref.BWD_DQ_TILES` are the tiles of the
    source's ``DkdvLayout`` and ``DqLayout``, and both kernels walk their
    items with ``item_of``."""
    src = (CSRC / "flash_attention_bwd.cu").read_text()
    for layout, (item, tile) in (("DkdvLayout", ref.BWD_DKDV_TILES),
                                 ("DqLayout", ref.BWD_DQ_TILES)):
        body = src.split(f"struct {layout} {{", 1)[1].split("};", 1)[0]
        bq = int(re.search(r"\bBQ = (\d+)", body).group(1))
        bk = int(re.search(r"\bBK = (\d+)", body).group(1))
        got = (bk, bq) if layout == "DkdvLayout" else (bq, bk)
        assert got == (item, tile), layout
    assert src.count("item_of(n, blockIdx.x, gridDim.x)") == 2
