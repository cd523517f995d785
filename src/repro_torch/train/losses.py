"""Training losses: the JAX package's ``train/losses.py``."""
from __future__ import annotations

import torch

from ..kernels.ref import acc_dtype


def _mean(x):
    """``jnp.mean``: the sum over a divisor filled on the device (a Python
    divisor is a multiply by its reciprocal on CUDA)."""
    return x.sum() / torch.full((), x.numel(), dtype=x.dtype,
                                device=x.device)


def softmax_xent(logits, labels, z_loss: float = 1e-4):
    """Mean next-token cross entropy with the z-loss regularizer
    ``z_loss * mean(lse^2)`` (off at 0).

    logits [B, S, V] (any float dtype, taken to float32), labels [B, S]
    integer."""
    lf = logits.to(acc_dtype(logits.dtype))
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    loss = _mean(lse - ll)
    if z_loss:
        loss = loss + z_loss * _mean(torch.square(lse))
    return loss


def shift_labels(tokens):
    """Next-token prediction targets: labels[t] = tokens[t+1], last = 0."""
    return torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
