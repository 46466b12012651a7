"""Cross-entropy (fp32 softmax, vocab-padding masked) + z-loss.

The port of ``repro.models.losses``.  Two formulations:

  * ``cross_entropy`` — takes materialised logits [B,T,Vp]. Simple, but the
    fp32 softmax state makes the logits tensor the single largest
    activation of a training step.
  * ``fused_cross_entropy`` — takes the final hidden states and the head
    weights and computes the logits chunk by chunk over tokens, each chunk
    under ``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint``
    inside a scan): backward recomputes each chunk's logits, so peak
    memory is O(chunk*V), not O(T*V).
"""
from __future__ import annotations

from functools import partial

import torch
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30


def _masked_f32(logits: torch.Tensor, real_vocab: int) -> torch.Tensor:
    lf = logits.float()
    vp = lf.shape[-1]
    if real_vocab < vp:
        pad = torch.arange(vp, device=lf.device) >= real_vocab
        lf = lf.masked_fill(pad, NEG_INF)
    return lf


def _gold(lf: torch.Tensor, labels: torch.Tensor, real_vocab: int):
    idx = labels.clamp(0, real_vocab - 1).long()[..., None]
    return torch.gather(lf, -1, idx)[..., 0]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  real_vocab: int, z_loss_coef: float = 1e-4):
    """logits: [B,T,Vp]; labels: [B,T] int32 (-1 = ignore).

    Returns (loss, metrics dict). Softmax in fp32; padded vocab rows
    masked."""
    lf = _masked_f32(logits, real_vocab)
    lse = torch.logsumexp(lf, dim=-1)  # [B,T]
    nll = lse - _gold(lf, labels, real_vocab)
    valid = (labels >= 0).float()
    denom = torch.clamp(valid.sum(), min=1.0)
    loss = (nll * valid).sum() / denom
    z = ((lse ** 2) * valid).sum() / denom
    total = loss + z_loss_coef * z
    acc = ((lf.argmax(-1) == labels).float() * valid).sum() / denom
    return total, {"nll": loss, "z_loss": z, "accuracy": acc,
                   "tokens": valid.sum()}


def _chunk_stats(x_c, labels_c, w, *, real_vocab: int, transpose_w: bool):
    """Per-chunk (nll_sum, z_sum, acc_sum, valid_sum). x_c: [B,c,D]."""
    logits = x_c @ (w.t() if transpose_w else w)
    lf = _masked_f32(logits, real_vocab)
    lse = torch.logsumexp(lf, dim=-1)
    valid = (labels_c >= 0).float()
    nll = ((lse - _gold(lf, labels_c, real_vocab)) * valid).sum()
    z = ((lse ** 2) * valid).sum()
    acc = ((lf.argmax(-1) == labels_c).float() * valid).sum()
    return nll, z, acc, valid.sum()


def fused_cross_entropy(x, w, labels, *, real_vocab: int,
                        transpose_w: bool, chunk: int = 512,
                        z_loss_coef: float = 1e-4, unroll: bool = False):
    """x: [B,T,D] final hiddens; w: head weights ([D,Vp] or [Vp,D] when
    ``transpose_w``, i.e. tied embeddings); labels: [B,T].

    ``unroll`` is accepted for the JAX package's signature: there it
    chooses a Python loop over a ``lax.scan``; here the chunks are always
    a Python loop.  Chunks are checkpointed only when autograd records."""
    T = x.shape[1]
    c = min(chunk, T)
    while T % c:
        c //= 2
    stats_fn = partial(_chunk_stats, real_vocab=real_vocab,
                       transpose_w=transpose_w)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    nll = z = acc = n = zero
    for i in range(T // c):
        args = (x[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c], w)
        if torch.is_grad_enabled():
            part = checkpoint(stats_fn, *args, use_reentrant=False)
        else:
            part = stats_fn(*args)
        nll, z, acc, n = (a + b for a, b in zip((nll, z, acc, n), part))
    denom = torch.clamp(n, min=1.0)
    loss = nll / denom
    zl = z / denom
    return loss + z_loss_coef * zl, {"nll": loss, "z_loss": zl,
                                     "accuracy": acc / denom, "tokens": n}
