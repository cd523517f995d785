"""LDA topic modeling via collapsed Gibbs sampling on the parameter server.

The port of ``repro/apps/lda.py``: the paper's second benchmark (NYT,
K=100, 50% minibatch per clock).  The shared PS state is the topic-word
count table ``n_kw`` (K×V, additive count deltas = INC updates); the
doc-topic counts ``n_dk`` and topic assignments ``z`` are worker-local.
Each clock a worker resamples a minibatch of its tokens against its
(possibly stale) view of ``n_kw``::

    p(z = k) ∝ (n_dk + α) (ñ_kw + β) / (ñ_k + Vβ)

and sends the count deltas to the server.  Sampling within a minibatch is
done against frozen counts; the PS staleness applies between clocks.
Quality metric: predictive log-likelihood of the whole corpus under point
estimates of θ, φ.

What changed in the port:

- the corpus is drawn from :mod:`repro_torch.rng`, JAX's key stream, and
  the word draw (a Gumbel arg-max over the vocabulary for every token)
  hashes its ``[tokens, V]`` counters a block of tokens at a time
  (``rng.categorical_rows``), so the ``[D, doc_len, V]`` logits never
  exist;
- the worker update is batched over the ``P`` workers (the contract of
  ``core/ps.py``), and never writes into the state it was given;
- the one-hots compare with an ``arange`` (``F.one_hot`` checks its range
  on the host), the minibatch's start is a Python int and the loss's mean
  divides by a device tensor, so a clock makes no host sync;
- the logs go through ``rng.log``, XLA's float32 log, so the sampler's
  logits, and so its draws, are the JAX app's on the CPU.

Every count is a float32 integer below 2**24, so the deltas, the views
and the per-topic totals sum exactly in any order, on any device.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import rng as jrng
from ..core.ps import PSApp
from ..core.timemodel import TimeModel
from ..device import resolve_device


def lda_time_model(**kw) -> TimeModel:
    """Paper-class wall-clock constants for the LDA/Gibbs app: a Gibbs
    clock costs more compute than an SGD minibatch (t_comp = 0.2 s) and a
    producer's per-clock count deltas are sparser (2 MB per channel)."""
    kw.setdefault("t_comp", 0.2)
    kw.setdefault("bytes_per_channel", 2e6)
    return TimeModel(**kw)


@dataclass(frozen=True)
class LDAConfig:
    n_docs: int = 64          # total documents (divisible by n_workers)
    doc_len: int = 96         # tokens per document
    vocab: int = 200          # V
    n_topics: int = 10        # K
    true_topics: int = 10
    alpha: float = 0.5        # doc-topic prior
    beta: float = 0.1         # topic-word prior
    n_workers: int = 8
    minibatch_frac: float = 0.5   # fraction of local tokens per clock
    concentration: float = 0.05   # Dirichlet concentration of true topics
    seed: int = 0


def _f32(x, device) -> torch.Tensor:
    # filled on the device: torch.tensor(x, device=cuda) would synchronize
    return torch.full((), x, dtype=torch.float32, device=device)


def _sizes(cfg: LDAConfig):
    P = cfg.n_workers
    if cfg.n_docs % P:
        raise ValueError("n_docs must divide by n_workers")
    docs_per = cfg.n_docs // P
    ntok = docs_per * cfg.doc_len                     # tokens per worker
    B = max(1, int(ntok * cfg.minibatch_frac))       # minibatch per clock
    return P, docs_per, ntok, B


def _onehot(z, K: int) -> torch.Tensor:
    return (z[..., None] == torch.arange(K, device=z.device)).float()


def lda_corpus(cfg: LDAConfig, device=None) -> dict:
    """The synthetic corpus and the initial assignments, drawn as the JAX
    app draws them: ``{"words", "docid", "z"}``, int32 ``[P, ntok]``."""
    dev = resolve_device(device)
    P, docs_per, ntok, _ = _sizes(cfg)
    D, L = cfg.n_docs, cfg.doc_len
    key = jrng.PRNGKey(cfg.seed, dev)
    k_phi, k_theta, k_words, k_z = jrng.split(key, 4).unbind(0)
    conc = torch.full((cfg.vocab,), cfg.concentration, dtype=torch.float32,
                      device=dev)
    phi_true = jrng.dirichlet(k_phi, conc, (cfg.true_topics,))
    prior = torch.full((cfg.true_topics,), 0.3, dtype=torch.float32,
                       device=dev)
    theta_true = jrng.dirichlet(k_theta, prior, (D,))
    kz, kw = jrng.split(k_words).unbind(0)
    z_true = jrng.categorical(kz, jrng.log(theta_true)[:, None, :],
                              shape=(D, L))
    words = jrng.categorical_rows(kw, jrng.log(phi_true), z_true.long())
    docid = torch.arange(docs_per, dtype=torch.int32, device=dev)
    docid = docid.repeat_interleave(L).expand(P, ntok).contiguous()
    z0 = jrng.randint(k_z, (P, ntok), 0, cfg.n_topics)
    return {"words": words.reshape(P, ntok), "docid": docid, "z": z0}


def lda_counts(cfg: LDAConfig, corpus: dict):
    """``(x0 [K·V], ndk [P, docs_per, K])``: the topic-word counts of all
    workers and each worker's doc-topic counts, as float32."""
    P, docs_per, ntok, _ = _sizes(cfg)
    K, V = cfg.n_topics, cfg.vocab
    z = corpus["z"].long()
    dev = z.device
    pidx = torch.arange(P, device=dev)[:, None]
    ones = torch.ones((P * ntok,), dtype=torch.float32, device=dev)
    ndk = torch.zeros((P * docs_per * K,), dtype=torch.float32, device=dev)
    ndk.index_put_((((pidx * docs_per + corpus["docid"].long()) * K
                     + z).reshape(-1),), ones, accumulate=True)
    nkw = torch.zeros((K * V,), dtype=torch.float32, device=dev)
    nkw.index_put_(((z * V + corpus["words"].long()).reshape(-1),), ones,
                   accumulate=True)
    return nkw, ndk.reshape(P, docs_per, K)


def lda_app(cfg: LDAConfig, x0, local0: dict) -> PSApp:
    """The LDA app over given state: ``x0 [K·V]`` float32 and ``local0``
    ``{"words", "docid", "z"}`` int32 ``[P, ntok]`` and ``"ndk"`` float32
    ``[P, docs_per, K]``, on the device of ``x0``."""
    P, docs_per, ntok, B = _sizes(cfg)
    K, V = cfg.n_topics, cfg.vocab
    dev = x0.device
    alpha, beta = _f32(cfg.alpha, dev), _f32(cfg.beta, dev)
    vbeta, kalpha = _f32(V * cfg.beta, dev), _f32(K * cfg.alpha, dev)
    pidx_all = torch.arange(P, device=dev)[:, None]
    ks = torch.arange(K, device=dev)
    steps = torch.arange(B, device=dev)
    words = local0["words"].long()
    docid = local0["docid"].long()

    def worker_update(views, local, wids, clock: int, keys):
        # R rows: all P workers in the simulator, a shard's own workers in
        # the sharded runtime (its rows of the corpus by worker id)
        R = views.shape[0]
        pidx, rows = pidx_all[:R], wids.long()
        nkw = views.view(R, K, V)
        # staleness can make counts transiently negative: clamp at read
        nk = torch.clamp(nkw, min=0.0).sum(dim=-1)              # [R, K]
        start = (clock * B) % ntok                              # host int
        idx = (steps + start) % ntok
        w, d = words[rows][:, idx], docid[rows][:, idx]         # [R, B]
        zold = local["z"][:, idx].long()
        oh_old = _onehot(zold, K)                               # [R, B, K]
        ndk_tok = local["ndk"][pidx, d] - oh_old                # exclude self
        nkw_tok = torch.clamp(nkw[pidx[..., None], ks, w[..., None]],
                              min=0.0) - oh_old
        nk_tok = nk[:, None, :] - oh_old
        logits = ((jrng.log(ndk_tok + alpha)
                   + jrng.log(torch.clamp(nkw_tok, min=0.0) + beta))
                  - jrng.log(torch.clamp(nk_tok, min=0.0) + vbeta))
        znew = jrng.categorical(keys, logits).long()            # [R, B]
        ndk = local["ndk"].index_put((pidx.expand(R, B), d),
                                     _onehot(znew, K) - oh_old,
                                     accumulate=True)
        z = local["z"].clone()
        z[:, idx] = znew.to(z.dtype)
        # INC deltas on the shared topic-word table: +1 for the new
        # topic, -1 for the old, exact float32 counts in any order
        delta = torch.zeros((R * K * V,), dtype=torch.float32, device=dev)
        base = pidx * (K * V) + w
        delta.index_put_((torch.cat([(base + znew * V).reshape(-1),
                                     (base + zold * V).reshape(-1)]),),
                         torch.cat([torch.ones(R * B, device=dev),
                                    torch.full((R * B,), -1.0,
                                               device=dev)]),
                         accumulate=True)
        return delta.view(R, K * V), dict(local, z=z, ndk=ndk)

    n_all = _f32(float(P * ntok), dev)

    def loss(x, locals_):
        """Negative predictive log-likelihood per token (lower = better)."""
        nkw = torch.clamp(x.view(K, V), min=0.0)
        phi = (nkw + beta) / (nkw.sum(dim=-1, keepdim=True) + vbeta)
        ndk = locals_["ndk"]                                    # [P, Dp, K]
        theta = (ndk + alpha) / (ndk.sum(dim=-1, keepdim=True) + kalpha)
        th = theta[pidx_all, docid]                             # [P, ntok, K]
        ph = phi.t()[words]                                     # [P, ntok, K]
        ll = jrng.log((th * ph).sum(dim=-1) + 1e-30)
        # a tensor divisor: on CUDA a Python one is a reciprocal multiply
        return -(ll.sum() / n_all)

    return PSApp(name="lda", dim=K * V, n_workers=P, x0=x0, local0=local0,
                 worker_update=worker_update, loss=loss)


def make_lda_app(cfg: LDAConfig, device=None) -> PSApp:
    """The LDA app with its synthetic corpus, on ``device`` (default
    cuda)."""
    corpus = lda_corpus(cfg, device)
    x0, ndk = lda_counts(cfg, corpus)
    return lda_app(cfg, x0, dict(corpus, ndk=ndk))
