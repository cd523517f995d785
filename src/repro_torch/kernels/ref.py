"""Plain PyTorch versions of the port's kernels.

They state each kernel's contract: the CPU path runs them, the tests hold
them against the JAX package's ``kernels/ref.py``, and ``chip_smoke.py``
holds each hand-written kernel against them on the card.
"""
from __future__ import annotations

import torch

RING_INVALID = -(10**8)   # uclock values below this mark empty ring slots
RING_EMPTY = -(10**9)     # initial uclock fill (no clock stored yet)
# Both sentinels are int32 and part of the Trace-producer contract: the
# kernels compare uclock/cview in int32 against them.


def ring_view(base, uring, uclock, cview):
    """Materialize per-reader parameter views from the update ring.

    base [d], uring [W,P,d] (slot, producer, dim), uclock [W] int32 (clock
    stored in each slot; < RING_INVALID when empty), cview [R,P] int32
    (reader, producer) visibility clocks for R <= P readers (all P in the
    simulator, a shard's own rows in the sharded runtime).  Returns views
    [R,d]:

        view[r] = base + Σ_{w,q : uclock[w] <= cview[r,q], slot valid} uring[w,q]
    """
    valid = uclock > RING_INVALID
    vis = (uclock[None, :, None] <= cview[:, None, :]) & valid[None, :, None]
    return base[None, :] + torch.einsum("rwq,wqd->rd", vis.to(uring.dtype),
                                        uring)


def delta_pack(delta, thresh, scale, quant: str = "f32"):
    """Error-feedback compression pack of per-producer delta rows.

    ``delta [P, d]`` aggregated deltas, ``thresh [P]`` per-row magnitude
    threshold (the k-th largest ``|delta|``, ``comm.substrate.row_threshold``),
    ``scale [P]`` int8 dequant scale (absmax / 127; read only when
    ``quant == "int8"``).  Returns ``(wire [P, d], residual [P, d])``::

        mask     = |delta| >= thresh
        wire     = mask ? Q(delta) : 0
        residual = mask ? delta - Q(delta) : delta     (f32: mask ? 0 : delta)

    Bit-equal to the JAX package's reference as XLA compiles it inside the
    simulator's scan (and to its Pallas body):

    - f32: the residual is the masked complement, never ``delta - delta``,
      so ``wire + residual == delta`` exactly;
    - bf16: ``Q`` rounds to the nearest even bf16; ``delta - Q(delta)`` is
      exact in float32;
    - int8: ``r = clamp(round_half_even(delta / s), ±127)`` with a true
      division, the wire is ``float32(r·s)``, and the residual is ``delta
      - r·s`` rounded once, as the fused multiply-add that XLA contracts
      it into (``r·s`` is exact in float64, so is the difference, and the
      cast rounds once).
    """
    mask = delta.abs() >= thresh[:, None]
    zero = delta.new_zeros(())
    if quant == "f32":
        return torch.where(mask, delta, zero), torch.where(mask, zero, delta)
    if quant == "bf16":
        q = delta.to(torch.bfloat16).to(torch.float32)
        return (torch.where(mask, q, zero),
                torch.where(mask, delta - q, delta))
    if quant == "int8":
        s = scale[:, None]
        r = torch.clamp(torch.round(delta / s), -127.0, 127.0)
        exact = delta.double() - r.double() * s.double()
        return (torch.where(mask, r * s, zero),
                torch.where(mask, exact.to(torch.float32), delta))
    raise ValueError(f"unknown quant {quant!r}")


def ring_view_tolerance(base, uring) -> float:
    """Largest difference allowed between two ``ring_view`` results that
    add the same terms in different orders: each float32 sum of ``n =
    W·P + 1`` terms is within ``n·eps·Σ|terms|`` of the exact sum, so two
    orders differ by at most twice that, taken at the worst column."""
    W, P, _ = uring.shape
    mag = base.abs() + uring.abs().sum(dim=(0, 1))
    eps = torch.finfo(torch.float32).eps
    return float(2 * (W * P + 1) * eps * mag.max())


def vap_suffix_norms(uring, uclock, c: int):
    """Inf-norms of per-producer suffix aggregates of the newest k clocks.

    Returns norms [W+1, P] with norms[k, q] = || Σ_{j=1..k} u_q(c-j) ||_inf
    (norms[0] = 0: the empty suffix).  This is the quantity VAP bounds by
    v_t, and the one-gather source of the in-transit metric in `core.ps`.
    The suffix is a float32 running sum over k, one ring row per step, as
    in the TPU and CUDA kernels (so all three agree exactly; torch's CPU
    ``cumsum`` would accumulate in float64).  Like them it reads only the
    row of the slot holding clock c-k (a NaN elsewhere in the ring does
    not reach the norms; the slots hold distinct clocks).
    """
    return _suffix_norms(uring, uclock, c, None)


def _suffix_norms(uring, uclock, c, keep):
    """``vap_suffix_norms`` over the columns where ``keep`` [d] is True
    (all of them for ``None``)."""
    W, P, d = uring.shape
    suffix = uring.new_zeros((P, d))
    norms = [uring.new_zeros((P,))]
    for k in range(1, W + 1):
        hit = uclock == c - k                                       # [W]
        row = uring.index_select(0, hit.to(torch.int32).argmax().reshape(1))
        suffix = suffix + torch.where(hit.any(), row[0], 0.0)       # one row
        mag = suffix.abs()
        if keep is not None:
            mag = torch.where(keep, mag, torch.zeros_like(mag))
        norms.append(mag.amax(dim=-1))
    return torch.stack(norms)


VAP_FAULTS = ("tail_dropped", "head_dropped", "seam_dropped",
              "oldest_slot_skipped")


def vap_spiked_ring(W, P, d, seams, *, c=1000, seed=0, device="cpu"):
    """A ring on which ``vap_suffix_norms`` sees a dropped column.

    ``uring [W, P, d]`` holds ``0.01·N(0, 1)`` draws from ``seed``, plus
    ``±1`` in every slot of one column per producer; the slots hold the
    clocks c-1..c-W in a random order.  So each producer's largest
    ``|suffix|`` sits, at every k, in its spike column (k against at most
    ~0.5 elsewhere), and a kernel that leaves that column out, or skips
    a slot, gives other norms.  The spike columns are, producer by
    producer and then over again: the first column, the last, and the
    columns on both sides of the seams at multiples of ``seams`` (the
    kernel's tile width): the first seam, the last, then others across
    the row.  Returns ``(uring, uclock, c, spikes)``, ``spikes[q]`` the
    column of producer q."""
    gd = torch.Generator(device=device).manual_seed(seed)
    uring = 0.01 * torch.randn((W, P, d), generator=gd, device=device)
    g = torch.Generator(device="cpu").manual_seed(seed)
    uclock = (c - 1 - torch.randperm(W, generator=g)).to(torch.int32)
    cuts = list(range(seams, d, seams))
    if cuts:
        cuts = [cuts[0], cuts[-1], *cuts[1:-1:max(1, len(cuts) // 8)]]
    cols = [0, d - 1] + [j for s in cuts for j in (s - 1, s)]
    cols = list(dict.fromkeys(cols))                # in order, once each
    spikes = [cols[q % len(cols)] for q in range(P)]
    sign = torch.tensor([1.0 if q % 2 == 0 else -1.0 for q in range(P)])
    uring[:, torch.arange(P), torch.tensor(spikes)] += sign.to(device)
    return uring, uclock.to(device), c, spikes


def vap_suffix_norms_fault(uring, uclock, c, fault: str, seam: int):
    """``vap_suffix_norms`` as a kernel with one of :data:`VAP_FAULTS`
    would compute it: ``tail_dropped`` leaves out the last column,
    ``head_dropped`` the first, ``seam_dropped`` the two columns on both
    sides of each multiple of ``seam``, ``oldest_slot_skipped`` the slot
    holding clock c-W.  A check of the kernel must tell each of them
    from the contract."""
    W, P, d = uring.shape
    keep = torch.ones(d, dtype=torch.bool, device=uring.device)
    if fault == "tail_dropped":
        keep[d - 1] = False
    elif fault == "head_dropped":
        keep[0] = False
    elif fault == "seam_dropped":
        cuts = torch.arange(seam, max(seam, d), seam, device=uring.device)
        keep[cuts] = False
        keep[cuts - 1] = False
    elif fault == "oldest_slot_skipped":
        uclock = torch.where(uclock == c - W,
                             torch.full_like(uclock, RING_EMPTY), uclock)
        keep = None
    else:
        raise ValueError(f"unknown fault {fault!r}; one of {VAP_FAULTS}")
    return _suffix_norms(uring, uclock, c, keep)


# ==========================================================================
# attention (the model zoo's prefill; kernel: flash_attention.py)
# ==========================================================================
NEG_INF = torch.finfo(torch.float32).min / 2


def acc_dtype(dtype):
    """The type values of ``dtype`` accumulate, norm and softmax in:
    float32, or float64 for float64 (a plain run one precision above
    float32, which the card-against-CPU checks take as the exact step)."""
    return torch.promote_types(dtype, torch.float32)


def _block_mask(q_pos, kv_pos, causal, window):
    """[B,Sq,Sk] visibility of kv positions (pad slots have kv_pos < 0)."""
    valid = (kv_pos >= 0)[:, None, :]
    if causal:
        valid = valid & (kv_pos[:, None, :] <= q_pos[:, :, None])
    if window is not None:
        valid = valid & (kv_pos[:, None, :] > q_pos[:, :, None] - window)
    return valid


TILE_SKIP, TILE_FULL, TILE_PARTIAL = 0, 1, 2


def attention_tile_classes(q_pos, kv_pos, causal, window, bq, bk):
    """[B, ceil(Sq/bq), ceil(Sk/bk)] int8 class of each (query block, KV
    tile), the rule of the CUDA ``flash_attention``'s wgmma kernel.  From
    the range [kmin, kmax] of a tile's non-negative key positions, whether
    any key is masked (``kv_pos < 0``, or past Sk), and the range [qmin,
    qmax] of the block's query positions (rows past Sq left out):

    - ``TILE_SKIP``: no key, or causal and kmin > qmax, or a window and
      kmax <= qmin - window: no pair can be visible;
    - ``TILE_FULL``: no masked key, (not causal or kmax <= qmin) and (no
      window or kmin > qmax - window): every pair is visible;
    - ``TILE_PARTIAL``: the element mask is applied.

    Positions compare in int32, as the element mask does."""
    B, Sq = q_pos.shape
    Sk = kv_pos.shape[1]
    nq, nk = -(-Sq // bq), -(-Sk // bk)
    hi, lo = torch.iinfo(torch.int32).max, torch.iinfo(torch.int32).min
    qp = torch.nn.functional.pad(q_pos, (0, nq * bq - Sq), value=hi)
    qin = torch.nn.functional.pad(torch.ones_like(q_pos, dtype=torch.bool),
                                  (0, nq * bq - Sq), value=False)
    qp, qin = qp.reshape(B, nq, bq), qin.reshape(B, nq, bq)
    qmin = torch.where(qin, qp, hi).amin(-1)[:, :, None]
    qmax = torch.where(qin, qp, lo).amax(-1)[:, :, None]
    kp = torch.nn.functional.pad(kv_pos, (0, nk * bk - Sk),
                                 value=-1).reshape(B, nk, bk)
    neg = (kp < 0).any(-1)[:, None, :]
    kmin = torch.where(kp >= 0, kp, hi).amin(-1)[:, None, :]
    kmax = torch.where(kp >= 0, kp, lo).amax(-1)[:, None, :]
    skip = kmin > kmax
    full = ~neg
    if causal:
        skip = skip | (kmin > qmax)
        full = full & (kmax <= qmin)
    if window is not None:
        w = torch.tensor(window, dtype=torch.int32)
        skip = skip | (kmax <= qmin - w)
        full = full & (kmin > qmax - w)
    out = torch.full((B, nq, nk), TILE_PARTIAL, dtype=torch.int8,
                     device=q_pos.device)
    out[full.expand(B, nq, nk)] = TILE_FULL
    out[skip.expand(B, nq, nk)] = TILE_SKIP
    return out


# The bf16 backward's tiles (csrc/flash_attention_bwd.cu, `DkdvLayout` and
# `DqLayout`): the dK/dV kernel's items of 128 keys walk 64-query tiles,
# the dQ kernel's items of 128 queries walk 64-key tiles.
BWD_DKDV_TILES = (128, 64)    # (keys an item, queries a tile)
BWD_DQ_TILES = (128, 64)      # (queries an item, keys a tile)
# At MLA's (576, 512) (`MlaDkLayout`, `MlaDqLayout`): the dK kernel's items
# of 64 keys walk units of 32 (query, head) rows in q's order, the dQ
# kernel's items of 64 (query, head) rows walk 32-key tiles.
BWD_MLA_DK_TILES = (64, 32)   # (keys an item, rows a unit)
BWD_MLA_DQ_TILES = (64, 32)   # (rows an item, keys a tile)


def persistent_items(n_items: int, ctas: int) -> list[list[int]]:
    """The items each CTA of a persistent grid of ``ctas`` takes, in its
    order (``item_of`` in ``csrc/fa_hopper.cuh``): CTA j takes j, 2P - 1 -
    j, 2P + j, 4P - 1 - j, ... below ``n_items``."""
    out = []
    for j in range(ctas):
        seq, k = [], 0
        while (item := k * ctas + (ctas - 1 - j if k & 1 else j)) < n_items:
            seq.append(item)
            k += 1
        out.append(seq)
    return out


def attention_bwd_schedule(q_pos, kv_pos, H, Hkv, causal, window,
                           ctas=132, variant="wgmma_tma"):
    """The walk of the bf16 backward's two persistent kernels over the
    work, as ``csrc/flash_attention_bwd.cu`` runs it on ``min(items,
    ctas)`` CTAs (132 on an H100 SXM).  ``variant="wgmma_tma"`` (the
    kernels at (64, 64), (80, 80) and (128, 128)):

    - ``"dkdv"``: for each CTA its items in order, each ``(b, hk, kt,
      tiles)``: keys ``kt * 128`` on of KV head ``hk`` and batch row ``b``
      (items ordered by (b, hk), then ``kt``), and the tiles its producer
      sends, ``(h, qt, cls)``: the 64-query tiles ``qt`` in chunks of 32
      (the producer classes a chunk at once, a lane a tile), each chunk's
      tiles for each rep head ``h`` of ``hk`` in turn, those of class
      ``TILE_SKIP`` left out;
    - ``"dq"``: each item ``(b, h, qb, tiles)``: queries ``qb * 128`` on of
      head ``h`` (the forward's order: the rep heads of a KV head next to
      each other, query blocks last first), and its 64-key tiles ``(kt,
      cls)`` in order, skipped ones left out.

    ``variant="mla_wgmma"`` (MLA's (576, 512)), on the rows of a KV head's
    rep query heads in q's order (row ``rr``: query ``rr // rep`` of head
    ``hk * rep + rr % rep``; `_mla_bwd_schedule`):

    - ``"dkdv"``: each item ``(b, hk, kt, units)``: keys ``kt * 64`` on
      (items ordered by ``kt``, then (b, hk): causal, the heaviest first),
      and its 32-row units ``(u, cls)`` from the last down (the CTAs on
      one (b, hk) then read each unit at about the same time), skipped
      ones left out;
    - ``"dq"``: each item ``(b, hk, blk, tiles)``: rows ``blk * 64`` on
      (the last block first, then (b, hk)), and its 32-key tiles ``(kt,
      cls)`` in order, skipped ones left out.

    Classes by `attention_tile_classes` on each kernel's tiles.  Every
    visible (query, key, head) triple lies in exactly one sent tile of each
    kernel, and the sums over a kernel's tiles run in this fixed order."""
    if variant == "mla_wgmma":
        return _mla_bwd_schedule(q_pos, kv_pos, H, Hkv, causal, window, ctas)
    if variant != "wgmma_tma":
        raise ValueError(f"no persistent walk for variant {variant!r}")
    B, Sq = q_pos.shape
    Sk = kv_pos.shape[1]
    rep = H // Hkv
    kb_keys, kq = BWD_DKDV_TILES
    cls = attention_tile_classes(q_pos, kv_pos, causal, window, kq,
                                 kb_keys).tolist()       # [B, nq, nk]
    n_kb, n_qt = -(-Sk // kb_keys), -(-Sq // kq)
    n_items = n_kb * Hkv * B
    dkdv = []
    for seq in persistent_items(n_items, min(n_items, ctas)):
        walk = []
        for item in seq:
            g, kt = divmod(item, n_kb)
            b, hk = divmod(g, Hkv)
            walk.append((b, hk, kt, [
                (hk * rep + hh, qt, cls[b][qt][kt])
                for c0 in range(0, n_qt, 32) for hh in range(rep)
                for qt in range(c0, min(c0 + 32, n_qt))
                if cls[b][qt][kt] != TILE_SKIP]))
        dkdv.append(walk)
    qb_rows, kk = BWD_DQ_TILES
    cls = attention_tile_classes(q_pos, kv_pos, causal, window, qb_rows,
                                 kk).tolist()
    n_qb, n_kt = -(-Sq // qb_rows), -(-Sk // kk)
    n_items = n_qb * H * B
    dq = []
    for seq in persistent_items(n_items, min(n_items, ctas)):
        walk = []
        for item in seq:
            g = item // rep // n_qb
            b, hk = divmod(g, Hkv)
            qb = n_qb - 1 - item // rep % n_qb
            walk.append((b, hk * rep + item % rep, qb, [
                (kt, cls[b][qb][kt]) for kt in range(n_kt)
                if cls[b][qb][kt] != TILE_SKIP]))
        dq.append(walk)
    return {"dkdv": dkdv, "dq": dq}


def _mla_bwd_schedule(q_pos, kv_pos, H, Hkv, causal, window, ctas):
    """`attention_bwd_schedule`'s walk of the MLA kernels
    (``fa_bwd_dkdv_mla``, ``fa_bwd_dq_mla``): classes of the (query, head)
    rows' blocks, each row at its query's position."""
    B = q_pos.shape[0]
    Sk = kv_pos.shape[1]
    rep = H // Hkv
    row_pos = q_pos.repeat_interleave(rep, dim=1)          # [B, Sq * rep]
    rows = row_pos.shape[1]
    G = B * Hkv
    kb_keys, ku = BWD_MLA_DK_TILES
    cls = attention_tile_classes(row_pos, kv_pos, causal, window, ku,
                                 kb_keys).tolist()       # [B, nu, nk]
    n_kb, n_units = -(-Sk // kb_keys), -(-rows // ku)
    n_items = n_kb * G
    dkdv = []
    for seq in persistent_items(n_items, min(n_items, ctas)):
        walk = []
        for item in seq:
            kt, g = divmod(item, G)
            b, hk = divmod(g, Hkv)
            walk.append((b, hk, kt, [(u, cls[b][u][kt])
                                     for u in reversed(range(n_units))
                                     if cls[b][u][kt] != TILE_SKIP]))
        dkdv.append(walk)
    rb, kk = BWD_MLA_DQ_TILES
    cls = attention_tile_classes(row_pos, kv_pos, causal, window, rb,
                                 kk).tolist()
    n_blk, n_kt = -(-rows // rb), -(-Sk // kk)
    n_items = n_blk * G
    dq = []
    for seq in persistent_items(n_items, min(n_items, ctas)):
        walk = []
        for item in seq:
            blk = n_blk - 1 - item // G
            b, hk = divmod(item % G, Hkv)
            walk.append((b, hk, blk, [(kt, cls[b][blk][kt])
                                      for kt in range(n_kt)
                                      if cls[b][blk][kt] != TILE_SKIP]))
        dq.append(walk)
    return {"dkdv": dkdv, "dq": dq}


def attention_dense(q, k, v, *, scale, q_pos, kv_pos, causal=True,
                    window=None):
    """Naive quadratic oracle. q [B,Sq,H,Dk], k [B,Sk,Hkv,Dk],
    v [B,Sk,Hkv,Dv] -> [B,Sq,H,Dv]; logits accumulate in float32."""
    B, Sq, H, Dk = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    qg = q.reshape(B, Sq, Hkv, rep, Dk)
    ft = acc_dtype(q.dtype)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg.to(ft), k.to(ft)) * scale
    mask = _block_mask(q_pos, kv_pos, causal, window)       # [B,Sq,Sk]
    s = torch.where(mask[:, None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", w.to(v.dtype), v)
    return out.reshape(B, Sq, H, v.shape[-1])


def attention(q, k, v, *, scale, q_pos, kv_pos, causal=True, window=None,
              kv_chunk=1024, q_chunk=2048):
    """Blocked flash-style attention: online softmax over KV chunks, an
    outer loop over Q chunks; never more than ``[B,Hkv,rep,q_chunk,
    kv_chunk]`` logits at a time.

    The contract of the CUDA ``flash_attention``: shapes as
    `attention_dense`, Dk and Dv may differ; products of the input dtype
    accumulate in float32, ``p`` is rounded to V's dtype before the PV
    product, a query that sees no key returns 0, and the output has q's
    dtype.  (The JAX package's ``assume_prefix`` shortcut is off on its
    default path and is not ported.)"""
    return attention_lse(q, k, v, scale=scale, q_pos=q_pos, kv_pos=kv_pos,
                         causal=causal, window=window, kv_chunk=kv_chunk,
                         q_chunk=q_chunk)[0]


def attention_lse(q, k, v, *, scale, q_pos, kv_pos, causal=True,
                  window=None, kv_chunk=1024, q_chunk=2048):
    """`attention`'s output and each row's log-sum-exp ``lse [B, H, Sq]``
    in ``acc_dtype`` (float32 for bf16 and float32 inputs): ``lse = log
    sum_k exp(scale * q.k)`` over the keys the row sees, in natural-log
    units, ``+inf`` for a row that sees no key (its ``P = exp(s - lse)``
    is then 0).  The CUDA forward writes the same quantity: its float32
    kernel keeps its softmax in natural units, its wgmma kernel in log2
    units with the scale folded in, and converts once a row."""
    Sq = q.shape[1]
    if Sq <= q_chunk:
        return _attention_impl(q, k, v, scale=scale, q_pos=q_pos,
                               kv_pos=kv_pos, causal=causal, window=window,
                               kv_chunk=kv_chunk)
    parts = [_attention_impl(
        q[:, i:i + q_chunk], k, v, scale=scale, q_pos=q_pos[:, i:i + q_chunk],
        kv_pos=kv_pos, causal=causal, window=window, kv_chunk=kv_chunk)
        for i in range(0, Sq, q_chunk)]
    return (torch.cat([o for o, _ in parts], dim=1),
            torch.cat([lse for _, lse in parts], dim=2))


def _attention_impl(q, k, v, *, scale, q_pos, kv_pos, causal, window,
                    kv_chunk):
    B, Sq, H, Dk = q.shape
    _, Sk, Hkv, _ = k.shape
    Dv = v.shape[-1]
    rep = H // Hkv
    C = min(kv_chunk, Sk)
    ft = acc_dtype(q.dtype)
    qg = q.reshape(B, Sq, Hkv, rep, Dk).to(ft)
    m = torch.full((B, Hkv, rep, Sq), NEG_INF, dtype=ft, device=q.device)
    l = torch.zeros((B, Hkv, rep, Sq), dtype=ft, device=q.device)
    acc = torch.zeros((B, Hkv, rep, Sq, Dv), dtype=ft, device=q.device)
    # the last chunk may be short: the JAX reference pads it with masked
    # keys (kv_pos = -1), which add nothing
    for c0 in range(0, Sk, C):
        kb, vb = k[:, c0:c0 + C], v[:, c0:c0 + C]
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kb.to(ft)) * scale
        mask = _block_mask(q_pos, kv_pos[:, c0:c0 + C], causal,
                           window)[:, None, None]           # [B,1,1,Sq,C]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(m_new <= NEG_INF, 0.0, m_new)
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
        corr = torch.exp(torch.where(m <= NEG_INF, NEG_INF, m - m_safe))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgrqk,bkgd->bgrqd", p.to(v.dtype).to(ft), vb.to(ft))
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    lse = torch.where(l > 0, m + torch.log(torch.where(l > 0, l, 1.0)),
                      float("inf"))
    return (out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv).to(q.dtype),
            lse.reshape(B, H, Sq))


def v_is_k_prefix(k, v) -> bool:
    """Whether ``v`` is the view ``k[..., :Dv]`` of ``k`` with ``Dv <
    Dk`` (the same storage, offset and strides), as MLA passes its latent
    values (``models.attention._mla_blocked``).  Then attention's gradient
    folds dV into dK (`attention_bwd`), the kernels read V from K's rows,
    and the CUDA forward admits ``v`` although it is not contiguous."""
    return (v.data_ptr() == k.data_ptr() and v.stride() == k.stride()
            and v.shape[:-1] == k.shape[:-1] and v.shape[-1] < k.shape[-1])


def attention_bwd(q, k, v, out, lse, dout, *, scale, q_pos, kv_pos,
                  causal=True, window=None, q_chunk=512):
    """The gradient of `attention` with respect to ``q``, ``k`` and ``v``
    for the output cotangent ``dout [B,Sq,H,Dv]``, from the forward's
    ``out`` and ``lse`` (`attention_lse`), by the flash recompute:

        P  = exp(scale * Q K^T - lse)      (0 where the mask hides a pair)
        D  = rowsum(dO * O)
        dV = P^T dO
        dS = P * (dO V^T - D)
        dQ = scale * dS K
        dK = scale * dS^T Q

    dK and dV sum over the ``rep = H / Hkv`` query heads of each KV head;
    a row that sees no key (``lse = +inf``) adds nothing.  Returns
    ``(dq, dk, dv)`` in the dtypes of ``q``, ``k`` and ``v``.  The
    contract of the CUDA ``flash_attention_bwd``: everything runs in
    ``acc_dtype``, and for bf16 inputs ``P`` and ``dS`` are rounded to
    bf16 before the products that take them (dV, and dQ and dK), as the
    kernel's tensor-core products do.  ``q_chunk`` queries at a time
    (``[B, H, q_chunk, Sk]`` scores).

    V as K's prefix (`v_is_k_prefix`: MLA's latent values): the gradient
    of the storage ``v`` shares is dK with dV added into its first Dv
    columns, so the result is ``(dq, dk + [dv, 0], None)``, rounded once
    to k's dtype.  One accumulator takes both sums, so the scale enters
    dS before its rounding: ``dS_r = bf16(scale * dS)`` (no rounding in
    float32), ``dQ = dS_r K``, ``dK = dS_r^T Q + [P^T dO, 0]``."""
    return _attention_bwd(q, k, v, out, lse, dout, scale=scale,
                          q_pos=q_pos, kv_pos=kv_pos, causal=causal,
                          window=window, q_chunk=q_chunk)


def _attention_bwd(q, k, v, out, lse, dout, *, scale, q_pos, kv_pos,
                   causal, window, q_chunk, unfolded=False):
    B, Sq, H, Dk = q.shape
    _, Sk, Hkv, _ = k.shape
    Dv = v.shape[-1]
    rep = H // Hkv
    fold = v_is_k_prefix(k, v)
    ft = acc_dtype(q.dtype)
    kf, vf = k.to(ft), v.to(ft)
    dk = torch.zeros((B, Sk, Hkv, Dk), dtype=ft, device=q.device)
    dv = torch.zeros((B, Sk, Hkv, Dv), dtype=ft, device=q.device)
    dq = []
    for i in range(0, Sq, q_chunk):
        n = min(q_chunk, Sq - i)
        qg = q[:, i:i + n].reshape(B, n, Hkv, rep, Dk).to(ft)
        og = out[:, i:i + n].reshape(B, n, Hkv, rep, Dv).to(ft)
        dog = dout[:, i:i + n].reshape(B, n, Hkv, rep, Dv).to(ft)
        L = lse[:, :, i:i + n].reshape(B, Hkv, rep, n).to(ft)
        mask = _block_mask(q_pos[:, i:i + n], kv_pos, causal,
                           window)[:, None, None]           # [B,1,1,n,Sk]
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kf) * scale
        p = torch.where(mask, torch.exp(s - L[..., None]), 0.0)
        del s
        D = (dog * og).sum(-1).permute(0, 2, 3, 1)           # [B,Hkv,rep,n]
        dp = torch.einsum("bqgrd,bkgd->bgrqk", dog, vf)
        ds = p * (dp - D[..., None])
        del dp
        dv += torch.einsum("bgrqk,bqgrd->bkgd", p.to(v.dtype).to(ft), dog)
        del p
        if fold:    # the scale before the rounding: one accumulator
            ds = (ds * scale).to(q.dtype).to(ft)
            dk += torch.einsum("bgrqk,bqgrd->bkgd", ds, qg)
            dq.append(torch.einsum("bgrqk,bkgd->bqgrd", ds,
                                   kf).reshape(B, n, H, Dk))
            continue
        ds = ds.to(q.dtype).to(ft)
        dk += torch.einsum("bgrqk,bqgrd->bkgd", ds, qg) * scale
        dq.append((torch.einsum("bgrqk,bkgd->bqgrd", ds, kf)
                   * scale).reshape(B, n, H, Dk))
    dq = torch.cat(dq, dim=1).to(q.dtype)
    if fold:
        if not unfolded:
            dk[..., :Dv] += dv
        return dq, dk.to(k.dtype), None
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def attention_bwd_fault(q, k, v, out, lse, dout, *, fault: str, tile=64,
                        **kw):
    """`attention_bwd` with a planted fault, which the card's limit must
    fail: ``"d_zero"`` takes D as 0 (dS = P * dO V^T); ``"dropped_tile"``
    leaves one key tile (``tile`` key slots, the tile the later half of
    the queries sees most pairs of) out for the later half of the queries,
    as a kernel that skipped it would; ``"unfolded_dv"`` (V as K's prefix
    only) leaves dV out of dK's first Dv columns.  The forward's ``lse``
    is kept, so only the dropped pairs change."""
    if fault == "d_zero":
        return attention_bwd(q, k, v, torch.zeros_like(out), lse, dout,
                             **kw)
    if fault == "unfolded_dv":
        if not v_is_k_prefix(k, v):
            raise ValueError("unfolded_dv needs v as k's prefix")
        return _attention_bwd(q, k, v, out, lse, dout, unfolded=True,
                              **{"causal": True, "window": None,
                                 "q_chunk": 512} | kw)
    if fault != "dropped_tile":
        raise ValueError(f"unknown fault {fault!r}")
    h, Sk = q.shape[1] // 2, k.shape[1]
    seen = _block_mask(kw["q_pos"][:, h:], kw["kv_pos"], kw["causal"],
                       kw["window"]).sum((0, 1))             # [Sk]
    n = -(-Sk // tile)
    per_tile = torch.nn.functional.pad(seen, (0, n * tile - Sk)).reshape(
        n, tile).sum(-1)
    t0 = int(per_tile.argmax()) * tile
    kp = kw["kv_pos"].clone()
    kp[:, t0:t0 + tile] = -1
    early = attention_bwd(q[:, :h], k, v, out[:, :h], lse[:, :, :h],
                          dout[:, :h], **kw | {"q_pos": kw["q_pos"][:, :h]})
    late = attention_bwd(q[:, h:], k, v, out[:, h:], lse[:, :, h:],
                         dout[:, h:], **kw | {"q_pos": kw["q_pos"][:, h:],
                                              "kv_pos": kp})
    return (torch.cat([early[0], late[0]], dim=1),
            (early[1].float() + late[1].float()).to(k.dtype),
            None if early[2] is None else
            (early[2].float() + late[2].float()).to(v.dtype))


# ==========================================================================
# Mamba-2 SSD (state-space duality) chunked scan (kernel: ssd_scan.py)
# ==========================================================================
def ssd_chunked(x, dt, A, B, C, chunk):
    """SSD forward (matches Mamba-2's ``ssd_minimal_discrete``).

    x  [b, s, h, p]   per-head inputs (p = headdim)
    dt [b, s, h]      softplus-activated step sizes (>= 0), float32
    A  [h]            negative state decay rates (A < 0), float32
    B  [b, s, g, n]   input projections (g groups, n = d_state)
    C  [b, s, g, n]   output projections
    Returns y [b, s, h, p] in x's dtype and the final state [b, h, p, n]
    in float32.  A ragged ``s`` is padded with dt = 0, x = 0 positions,
    which leave the carried state as it was.  As in the JAX reference,
    the scores ``C·Bᵀ`` have B's dtype (bfloat16 on the models' path).
    """
    y_intra, c_decayed, prev_states, state = _ssd_parts(x, dt, A, B, C,
                                                        chunk)
    return _ssd_output(x, y_intra, c_decayed, prev_states), state


def ssd_chunked_y_fault(x, dt, A, B, C, chunk, fault: str):
    """``y`` of `ssd_chunked` with one planted fault in the inter-chunk
    term, the part a chunk loop can get wrong: ``"chunks_alone"`` drops
    it (each chunk scanned from a zero state), ``"state_late"`` computes
    chunk c's term from the state before chunk c - 1 (zero for chunks 0
    and 1).  `ssd_tolerance` must fail both."""
    y_intra, c_decayed, prev_states, _ = _ssd_parts(x, dt, A, B, C, chunk)
    if fault == "chunks_alone":
        prev_states = torch.zeros_like(prev_states)
    elif fault == "state_late":
        prev_states = torch.cat([torch.zeros_like(prev_states[:, :1]),
                                 prev_states[:, :-1]], dim=1)
    else:
        raise ValueError(f"unknown SSD fault {fault!r}")
    return _ssd_output(x, y_intra, c_decayed, prev_states)


def _ssd_parts(x, dt, A, B, C, chunk):
    """The pieces of `ssd_chunked` over the padded sequence: the
    intra-chunk output ``y_intra [b, nc, l, h, p]``, ``C·e^cum``
    ``[b, nc, l, h, n]`` (float32), the state entering each chunk
    ``[b, nc, h, p, n]`` and the final state."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        pad = chunk - s % chunk
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, 0, 0, pad))
        s = s + pad
    nc = s // chunk
    rep = h // g

    xbar = x * dt[..., None]                                # float32
    da = dt * A[None, None, :]                              # [b,s,h]
    xc = xbar.reshape(b, nc, chunk, h, p)
    dac = da.reshape(b, nc, chunk, h)
    Bh = torch.repeat_interleave(B.reshape(b, nc, chunk, g, n), rep, dim=3)
    Ch = torch.repeat_interleave(C.reshape(b, nc, chunk, g, n), rep, dim=3)

    cum = torch.cumsum(dac, dim=2)                          # [b,nc,l,h]
    scores = torch.einsum("bclhn,bcmhn->bclmh", Ch, Bh)     # l=query m=key
    # the exponent is clamped at 0: the upper triangle is masked below.
    # torch.minimum, as JAX's jnp.minimum: at a tie (an exact 0, i > j)
    # it passes half the gradient, torch.clamp all of it
    d = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    decay = torch.exp(torch.minimum(
        d, torch.zeros((), dtype=d.dtype, device=d.device)))
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    w = torch.where(causal[None, None, :, :, None], scores * decay, 0.0)
    y_intra = torch.einsum("bclmh,bcmhp->bclhp", w, xc)

    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)       # [b,nc,l,h]
    ft = xc.dtype
    state_c = torch.einsum("bclhn,bclhp->bchpn",
                           Bh.to(ft) * decay_to_end[..., None], xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])               # [b,nc,h]
    state = torch.zeros((b, h, p, n), dtype=ft, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + state_c[:, c]
    prev_states = torch.stack(prev, dim=1)                  # [b,nc,h,p,n]
    return y_intra, Ch.to(ft) * torch.exp(cum)[..., None], prev_states, state


def _ssd_output(x, y_intra, c_decayed, prev_states):
    """``y`` in x's dtype, cut to x's length, from `_ssd_parts`."""
    b, s, h, p = x.shape
    y_inter = torch.einsum("bclhn,bchpn->bclhp", c_decayed, prev_states)
    y = (y_intra + y_inter).reshape(b, -1, h, p).to(x.dtype)
    return y[:, :s]


SSD_BWD_FAULTS = ("state_late", "no_tie_rule", "head_missing")


def bf16_split3(v):
    """``(hi, mid, lo)``, bf16 pieces of float32 ``v`` that sum to it
    exactly: ``hi = bf16(v)``, ``mid = bf16(v − hi)``, ``lo = bf16(v − hi
    − mid)``, each difference exact in float32, so 24 significand bits go
    into three of 8.  Exact for ``|v| ≥ 2^-110`` (``lo``'s last bit,
    2^-23 of ``v``'s exponent, is then at least bf16's 2^-133); below, off
    by at most 2^-133.  A product of a bf16 operand with ``v`` is then
    three bf16 products, each exact in float32: how the CUDA ``ssd_bwd``
    runs its float32 operands on the tensor cores (``split2`` in
    ``csrc/ssd_scan_bwd.cu``)."""
    v = v.to(torch.float32)
    hi = v.to(torch.bfloat16)
    r = v - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def ssd_bwd(x, dt, A, B, C, dy, dstate, chunk):
    """The gradient of `ssd_chunked` for the cotangents ``dy [b,s,h,p]``
    of ``y`` and ``dstate [b,h,p,n]`` of the final state (None: the final
    state takes no gradient), computed from the chunked decomposition
    itself, not by autograd.  Per (b, h) and chunk c of length L, with
    ``x̄ = dt·x``, ``cum = cumsum(dt·A)`` inside the chunk, ``S_c`` the
    state entering chunk c and ``G_c`` the gradient of the state leaving
    it (``G_{nc-1} = dstate``, ``G_{c-1} = e^{cum_{L-1}} G_c + Σ_i
    e^{cum_i} dy_i ⊗ C_i``):

        dx̄_j = Σ_{i≥j} (C_i·B_j) e^{cum_i−cum_j} dy_i
               + e^{cum_{L−1}−cum_j} G_c B_j
        dC_i = Σ_{j≤i} e^{cum_i−cum_j} (dy_i·x̄_j) B_j + e^{cum_i} S_cᵀ dy_i
        dB_j = Σ_{i≥j} e^{cum_i−cum_j} (dy_i·x̄_j) C_i
               + e^{cum_{L−1}−cum_j} G_cᵀ x̄_j
        dcum_i = Σ_{j<i} t_ij − Σ_{k>i} t_ki + dy_i·y_inter_i − u_i,
                 t_ij = (C_i·B_j) e^{cum_i−cum_j} (dy_i·x̄_j),
                 u_j = x̄_j · e^{cum_{L−1}−cum_j} G_c B_j,
        dcum_{L−1} += Σ_j u_j + e^{cum_{L−1}} ⟨S_c, G_c⟩

    ``t_ij`` is halved where ``cum_i == cum_j`` exactly (i > j) and taken
    as 0 where ``cum_i > cum_j``: the gradient of ``minimum(cum_i − cum_j,
    0)``, JAX's rule.  Then ``d(da)`` is the reverse cumsum of ``dcum``,
    ``ddt = d(da)·A + Σ_p dx̄·x``, ``dx = dx̄·dt``, ``dA = Σ d(da)·dt``,
    and dB, dC sum the ``h/g`` heads of each group.  Returns ``(dx, ddt,
    dA, dB, dC)`` in the dtypes of the inputs.  The contract of the CUDA
    ``ssd_bwd``: everything in ``acc_dtype`` (float32, or float64 for
    float64 inputs) from the inputs as given, the scores ``C·B`` included
    (the forward's plain version rounds them to bf16 on the bf16 path;
    the kernel accumulates them in float32, as the forward kernel does).
    One chunk at a time (``[b, L, L, h]`` pair tensors)."""
    return _ssd_bwd(x, dt, A, B, C, dy, dstate, chunk, None)


def ssd_bwd_fault(x, dt, A, B, C, dy, dstate, chunk, fault: str):
    """`ssd_bwd` with a planted fault (`SSD_BWD_FAULTS`), which the card's
    limit must fail: ``"state_late"`` gives chunk c the gradient of the
    state leaving chunk c + 1 (zero for the last chunk), as a reverse walk
    one chunk late would; ``"no_tie_rule"`` passes the whole ``t_ij`` at
    a tie ``cum_i == cum_j`` (torch.clamp's gradient), which shows only
    where ties occur; ``"head_missing"`` leaves the first head of each
    group out of dB."""
    if fault not in SSD_BWD_FAULTS:
        raise ValueError(f"unknown SSD backward fault {fault!r}")
    return _ssd_bwd(x, dt, A, B, C, dy, dstate, chunk, fault)


def _ssd_bwd(x, dt, A, B, C, dy, dstate, chunk, fault):
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    s_orig = s
    if s % chunk:
        pad = chunk - s % chunk
        x, dy, B, C = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                       for t in (x, dy, B, C))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        s = s + pad
    nc, L, rep = s // chunk, chunk, h // g
    ft = acc_dtype(x.dtype)
    xf = x.to(ft).reshape(b, nc, L, h, p)
    dyf = dy.to(ft).reshape(b, nc, L, h, p)
    dtf = dt.to(ft).reshape(b, nc, L, h)
    Af = A.to(ft)
    Bh = torch.repeat_interleave(B.to(ft).reshape(b, nc, L, g, n), rep,
                                 dim=3)                     # [b,nc,L,h,n]
    Ch = torch.repeat_interleave(C.to(ft).reshape(b, nc, L, g, n), rep,
                                 dim=3)
    xbar = xf * dtf[..., None]
    cum = torch.cumsum(dtf * Af, dim=2)                     # [b,nc,L,h]
    ecum = torch.exp(cum)
    dte = torch.exp(cum[:, :, -1:, :] - cum)
    ecl = torch.exp(cum[:, :, -1, :])                       # [b,nc,h]

    # S_c, the state entering each chunk, and G_c, the gradient of the
    # state leaving it
    st_c = torch.einsum("bclhn,bclhp->bchpn", Bh * dte[..., None], xbar)
    dy_c = torch.einsum("bclhp,bclhn->bchpn", dyf * ecum[..., None], Ch)
    S = torch.zeros((b, h, p, n), dtype=ft, device=x.device)
    Ss = []
    for c in range(nc):
        Ss.append(S)
        S = S * ecl[:, c, :, None, None] + st_c[:, c]
    G = (torch.zeros_like(S) if dstate is None else dstate.to(ft))
    Gs = [None] * nc
    for c in reversed(range(nc)):
        Gs[c] = G
        G = G * ecl[:, c, :, None, None] + dy_c[:, c]
    if fault == "state_late":
        Gs = Gs[1:] + [torch.zeros_like(S)]
    del st_c, dy_c

    lower = torch.ones((L, L), dtype=torch.bool,
                       device=x.device).tril()[None, :, :, None]
    strict = torch.ones((L, L), dtype=torch.bool,
                        device=x.device).tril(-1)[None, :, :, None]
    zero = torch.zeros((), dtype=ft, device=x.device)
    # the share of t_ij a tie cum_i == cum_j takes (JAX's minimum: half)
    half = torch.full((), 1.0 if fault == "no_tie_rule" else 0.5,
                      dtype=ft, device=x.device)
    dx, ddt, dB, dC = [], [], [], []
    dA = torch.zeros((h,), dtype=ft, device=x.device)
    for c in range(nc):
        cc, Bc, Cc = cum[:, c], Bh[:, c], Ch[:, c]
        xc, xbc, dyc = xf[:, c], xbar[:, c], dyf[:, c]
        Gc, Sc = Gs[c], Ss[c]
        d = cc[:, :, None, :] - cc[:, None, :, :]            # [b,i,j,h]
        E = torch.exp(torch.minimum(d, zero))
        W = torch.where(lower, torch.einsum("bihn,bjhn->bijh", Cc, Bc) * E,
                        zero)
        DW = torch.einsum("bihp,bjhp->bijh", dyc, xbc)
        DS = torch.where(lower, DW * E, zero)
        f = torch.where(d < 0, 1.0, torch.where(d == 0, half, zero))
        t = torch.where(strict, DW * W * f, zero)
        del d, E, DW, f
        gb = torch.einsum("bjhn,bhpn->bjhp", Bc, Gc) * dte[:, c, :, :, None]
        dxb = torch.einsum("bijh,bihp->bjhp", W, dyc) + gb
        c_inter = (torch.einsum("bihp,bhpn->bihn", dyc, Sc)
                   * ecum[:, c, :, :, None])
        dC.append(torch.einsum("bijh,bjhn->bihn", DS, Bc) + c_inter)
        dB.append(torch.einsum("bijh,bihn->bjhn", DS, Cc)
                  + torch.einsum("bjhp,bhpn->bjhn", xbc, Gc)
                  * dte[:, c, :, :, None])
        del W, DS
        u = (xbc * gb).sum(-1)                               # [b,L,h]
        dcum = t.sum(2) - t.sum(1) + (Cc * c_inter).sum(-1) - u
        dcum[:, -1] += u.sum(1) + ecl[:, c] * (Sc * Gc).sum((-1, -2))
        dda = torch.flip(torch.cumsum(torch.flip(dcum, (1,)), 1), (1,))
        ddt.append(dda * Af + (dxb * xc).sum(-1))
        dx.append(dxb * dtf[:, c, :, :, None])
        dA = dA + (dda * dtf[:, c]).sum((0, 1))

    def whole(parts):
        return torch.stack(parts, 1).reshape(b, s, *parts[0].shape[2:])[
            :, :s_orig]

    dBh = whole(dB).reshape(b, s_orig, g, rep, n)
    if fault == "head_missing":
        dBh = dBh[:, :, :, 1:]
    return (whole(dx).to(x.dtype), whole(ddt).to(dt.dtype), dA.to(A.dtype),
            dBh.sum(3).to(B.dtype),
            whole(dC).reshape(b, s_orig, g, rep, n).sum(3).to(C.dtype))


def ssd_recurrent(x, dt, A, B, C, state):
    """Single-token SSD decode step.

    x [b,h,p], dt [b,h], B/C [b,g,n], state [b,h,p,n] -> (y, state'),
    both float32 (the JAX reference's type promotion)."""
    g = B.shape[1]
    h = x.shape[1]
    rep = h // g
    ft = acc_dtype(x.dtype)
    Bh = torch.repeat_interleave(B, rep, dim=1).to(ft)      # [b,h,n]
    Ch = torch.repeat_interleave(C, rep, dim=1).to(ft)
    decay = torch.exp(dt * A[None, :])[..., None, None]     # [b,h,1,1]
    upd = (dt[..., None] * x)[..., None] * Bh[:, :, None, :]
    state = state * decay + upd
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    return y, state


def ssd_tolerance(y_ref, dtype) -> float:
    """Largest difference allowed between two SSD outputs ``y`` that take
    the same sums in other orders, at the scale of ``y_ref``: the in-chunk
    cumulative decay (in order, in parallel, or through float64 on the
    CPU), the score and state contractions over a chunk and ``d_state``.
    float32: 1e-4 of the scale (the JAX kernel test's bound); bfloat16
    outputs: 1e-2, which also covers one bfloat16 rounding of the output
    and of the scores (the reference rounds ``C·Bᵀ`` to bfloat16, the
    kernel accumulates it in float32).  The final state has its own
    limit, `ssd_state_tolerance`."""
    scale = max(1.0, float(y_ref.abs().max()))
    return scale * (1e-2 if dtype == torch.bfloat16 else 1e-4)


def ssd_state_tolerance(state_ref) -> float:
    """Largest difference allowed between two SSD final states (float32
    in every dtype: ``x̄``, the decays and the state products stay
    float32), at the scale of ``state_ref``: 2e-5, five times the widest
    sound reading (4.2e-6 of scale, the in-chunk cumsum taken in other
    orders) and a hundredth of one bfloat16 rounding of the state."""
    return 2e-5 * max(1.0, float(state_ref.abs().max()))


def ssd_bwd_tolerance(dtype) -> tuple[float, float]:
    """``(atol, rtol)`` between the CUDA ``ssd_bwd`` and `ssd_bwd` on the
    same inputs, for each gradient in its own dtype (dx, dB, dC in x's;
    ddt and dA float32): ``atol`` a share of the gradient's largest
    magnitude, ``rtol`` of each entry's.  Both take the same float32 sums
    in other orders (the pair sums over a chunk, the reductions over p
    and n, the walks over the chunks, the group's heads, dA over b and the
    chunks).  float32: 1e-4 and 1e-4, the forward's limit.  bfloat16
    gradients: 1e-4 of scale and 1e-2 of each entry, which covers one
    bfloat16 rounding of float32 values that differ in their last bits
    (at most 2^-7 of the entry).  A chunk given the state gradient of the
    next, the tie rule dropped or a head left out of dB moves a gradient
    by tens of percent of its scale."""
    return (1e-4, 1e-2) if dtype == torch.bfloat16 else (1e-4, 1e-4)


def ssd_bwd_within(got, want) -> bool:
    """Each of the five gradients ``got`` within `ssd_bwd_tolerance` of
    ``want``."""
    for g, w in zip(got, want, strict=True):
        atol, rtol = ssd_bwd_tolerance(w.dtype)
        g, w = g.float(), w.float()
        if not bool(((g - w).abs() <= atol * w.abs().max()
                     + rtol * w.abs()).all()):
            return False
    return True


def attention_tolerance(dtype) -> tuple[float, float]:
    """``(atol, rtol)`` between the CUDA ``flash_attention`` and
    `attention` on the same inputs.  float32: 3e-5 (the JAX kernel test's
    bound).  bfloat16: 2e-2 absolute, under a typical output entry at a
    thousand visible keys (their mean of unit values, ~0.05), so a key
    tile dropped or misweighted fails; 1e-2 relative covers one bfloat16
    rounding of a large output and of ``p``, which the two round from
    float32 values that differ."""
    return (2e-2, 1e-2) if dtype == torch.bfloat16 else (3e-5, 3e-5)


def attention_bwd_tolerance(dtype) -> tuple[float, float]:
    """``(atol, rtol)`` between the CUDA ``flash_attention_bwd`` and
    `attention_bwd` on the same inputs, for each of dq, dk and dv: ``atol``
    is a share of the output's largest magnitude, ``rtol`` of each
    entry's.  float32: 3e-5 and 3e-5, the forward's (both sum the same
    float32 terms in other orders; the kernel's exp differs from torch's by
    an ulp or two).  bfloat16: 1e-2 and 1e-2: both round ``P`` and ``dS``
    to bf16 from float32 values that differ by a few float32 ulp, so a
    rare entry lands one bf16 step (2^-8 of it) away, and each output's
    own bf16 rounding (2^-8 relative) may go the other way; a dropped key
    tile or D taken as 0 moves the outputs it touches by tens of percent
    of their scale."""
    return (1e-2, 1e-2) if dtype == torch.bfloat16 else (3e-5, 3e-5)


# ==========================================================================
# MF-SGD dense-block update (the paper's hot loop; kernel: mf_sgd.py)
# ==========================================================================
# The longest chain of float32 additions that either implementation takes
# in the loss's sum of squares (see `mf_sgd_tolerance`).
MF_LOSS_CHAIN = 2048


def _f32(x, device) -> torch.Tensor:
    # filled on the device (no host copy); a Python float rounds to
    # float32 as JAX rounds its weakly typed scalars
    return torch.full((), x, dtype=torch.float32, device=device)


def mf_residual(L, R, D, mask):
    """``E = where(mask, D − L@R, 0)``: the mask selects, so a NaN or Inf
    of ``D`` at an unobserved entry never reaches ``E``."""
    return torch.where(mask, D - L @ R, L.new_zeros(()))


def mf_update(L, R, E, mask, gamma, lam):
    """``(dL, dR, loss)`` from the residual ``E`` of `mf_residual`::

        dL   = γ (E Rᵀ − (λ·rowcount) L)
        dR   = γ (Lᵀ E − (λ·colcount) R)
        loss = ΣE² / max(Σmask, 1)

    with the JAX reference's association ``(λ·count)·L``, integer counts
    converted once to float32, and the loss a true division by a count
    tensor (on CUDA, ``t / python_float`` multiplies by the reciprocal)."""
    dev = L.device
    g, lm = _f32(gamma, dev), _f32(lam, dev)
    rowc = mask.sum(dim=1, keepdim=True).to(torch.float32)        # [N,1]
    colc = mask.sum(dim=0, keepdim=True).to(torch.float32)        # [1,M]
    cnt = torch.clamp(mask.sum(), min=1).to(torch.float32)
    dL = g * (E @ R.t() - (lm * rowc) * L)
    dR = g * (L.t() @ E - (lm * colc) * R)
    return dL, dR, torch.sum(E * E) / cnt


def mf_drop_first_entry(E, mask):
    """``E`` with the first observed entry (row-major) set to 0: a planted
    fault, one observed rating left out of both products and the loss
    while the counts still include it (``mf_update`` on the result)."""
    first = int(mask.reshape(-1).to(torch.int8).argmax())
    E = E.clone()
    E.view(-1)[first] = 0.0
    return E


def mf_sgd_block(L, R, D, mask, gamma, lam):
    """One SGD step over a dense block of ratings.

    ``L [N,K]``, ``R [K,M]``, ``D [N,M]`` float32 ratings, valid where
    ``mask [N,M]`` (bool) is set; ``gamma`` and ``lam`` Python floats.
    Returns ``(dL [N,K], dR [K,M], loss [])``: the paper's update summed
    over every observed entry of the block and the mean squared error
    (contract of the JAX package's ``kernels/ref.py::mf_sgd_block``)."""
    return mf_update(L, R, mf_residual(L, R, D, mask), mask, gamma, lam)


def mf_sgd_tolerance(L, R, D, mask, gamma, lam) -> tuple[float, float, float]:
    """``(tol_dL, tol_dR, tol_loss)``: the largest differences allowed
    between two `mf_sgd_block` results that take the same float32 sums in
    other orders (full float32 products, no TF32), each the largest over
    the entries of an elementwise bound:

    - ``L@R``: a float32 sum of ``K`` products is within ``K·eps·Σ|L||R|``
      of the exact sum in any order, so two orders give residuals within
      ``δE = 2K·eps·(|L|@|R|) + 2eps·|E|`` (the second term the rounding of
      ``D − L@R``), where observed;
    - ``E Rᵀ`` (``Lᵀ E``): adding an exact zero is exact, so a row's
      (column's) sum takes ``rowcount`` (``colcount``) rounded additions in
      any order or tree: within ``δE @ |R|ᵀ + 2·rowcount·eps·(|E| @ |R|ᵀ)``;
    - the ``γ(· − (λ·count)·L)`` epilogue rounds the same operands twice
      more: ``4eps`` of its magnitude;
    - the loss sums non-negative terms, whose float32 sum is within
      (longest chain of additions)·eps of the exact one: the kernel sums
      eight squares in a tree, adds at most 256 such sums in order within
      2048 columns of a row, those sums in order along the row
      (``ceil(M / 2048)`` of them), then the rows in runs of 64 and a
      tree over 1024 threads: ``3 + 256 + ceil(M / 2048) + 64 +
      ceil(N / 65536) + 10`` additions, under `MF_LOSS_CHAIN` for any
      ``M`` below 3.5 million columns; PyTorch's reductions take a
      per-thread run and trees, under it at the sizes run; plus
      ``2|E|δE`` per entry.
    """
    eps = torch.finfo(torch.float32).eps
    K = L.shape[1]
    aL, aR = L.abs(), R.abs()
    E = mf_residual(L, R, D, mask)
    aE = E.abs()
    zero = L.new_zeros(())
    dE = torch.where(mask, 2 * K * eps * (aL @ aR) + 2 * eps * aE, zero)
    rowc = mask.sum(dim=1, keepdim=True).to(torch.float32)
    colc = mask.sum(dim=0, keepdim=True).to(torch.float32)
    ER, LE = aE @ aR.t(), aL.t() @ aE
    tol_dL = gamma * (dE @ aR.t() + 2 * eps * rowc * ER
                      + 4 * eps * (ER + lam * rowc * aL))
    tol_dR = gamma * (aL.t() @ dE + 2 * eps * colc * LE
                      + 4 * eps * (LE + lam * colc * aR))
    cnt = max(int(mask.sum()), 1)
    tol_loss = (2 * (aE * dE).sum() + 2 * MF_LOSS_CHAIN * eps
                * (E * E).sum()) / cnt
    return float(tol_dL.max()), float(tol_dR.max()), float(tol_loss)
