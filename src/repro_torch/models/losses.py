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

Both take a ``mesh`` (port-only) where the vocabulary splits over its
``model`` axis (``layout="tp"``, as the JAX package's specs lay the
logits ``batch_spec(pcfg, None, "model")``): the logits, or the head's
weights, are then this rank's block of the vocabulary, and every
``model`` rank computes the same loss from the blocks.  The padding mask
takes global indices; a row's maximum and its argmax come from
``sharded.model_argmax`` (no gradient), the exponentials' sum and the
gold logit (from the rank that holds the label) are summed over
``model`` by ``sharded.reduce_from_model``, so ``lse``, the z-loss and
the accuracy are the whole vocabulary's; the fused head's input enters
through ``sharded.copy_to_model``, its gradient the sum of the ranks'.
Under the fused head's per-chunk checkpoint the recompute issues the
same collectives in the same order on every rank.
"""
from __future__ import annotations

from functools import partial

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.parallel import sharded

NEG_INF = -1e30


def _start(lf: torch.Tensor, mesh) -> int:
    """The global index of the first column of this rank's block."""
    return 0 if mesh is None else mesh.axis_index("model") * lf.shape[-1]


def _masked_f32(logits: torch.Tensor, real_vocab: int, start: int = 0
                ) -> torch.Tensor:
    lf = logits.float()
    vp = lf.shape[-1]
    if real_vocab < start + vp:
        pad = torch.arange(start, start + vp, device=lf.device) >= real_vocab
        lf = lf.masked_fill(pad, NEG_INF)
    return lf


def _gold(lf: torch.Tensor, labels: torch.Tensor, real_vocab: int):
    idx = labels.clamp(0, real_vocab - 1).long()[..., None]
    return torch.gather(lf, -1, idx)[..., 0]


def _block_stats(lf: torch.Tensor, labels: torch.Tensor, real_vocab: int,
                 start: int, m: torch.Tensor):
    """A block's part of each row's sums over the vocabulary, from its
    masked float32 logits ``lf`` (global columns from ``start``) and the
    rows' maxima ``m``: (the sum of ``exp(l - m)``, the gold logit where
    the block holds the label, else -0.0, so that the sum over the blocks
    is the holder's value bit for bit)."""
    n = lf.shape[-1]
    rel = labels.clamp(0, real_vocab - 1).long() - start
    mine = (rel >= 0) & (rel < n)
    gold = torch.gather(lf, -1, rel.clamp(0, n - 1)[..., None])[..., 0]
    return (torch.exp(lf - m[..., None]).sum(-1),
            torch.where(mine, gold, torch.full_like(gold, -0.0)))


def _row_stats(lf: torch.Tensor, labels: torch.Tensor, real_vocab: int,
               mesh=None):
    """(lse, gold logit, argmax) of each row of the whole vocabulary from
    the masked float32 logits ``lf`` (this rank's block with ``mesh``)."""
    if mesh is None:
        return (torch.logsumexp(lf, dim=-1), _gold(lf, labels, real_vocab),
                lf.argmax(-1))
    m, top = sharded.model_argmax(lf, mesh)
    total, gold = _block_stats(lf, labels, real_vocab, _start(lf, mesh), m)
    return (m + torch.log(sharded.reduce_from_model(total, mesh)),
            sharded.reduce_from_model(gold, mesh), top)


def _sums(lse, gold, top, labels):
    """(nll_sum, z_sum, acc_sum, valid_sum) over the rows of ``labels``
    (-1 ignored)."""
    valid = (labels >= 0).float()
    return (((lse - gold) * valid).sum(), ((lse ** 2) * valid).sum(),
            ((top == labels).float() * valid).sum(), valid.sum())


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  real_vocab: int, z_loss_coef: float = 1e-4, mesh=None):
    """logits: [B,T,Vp] (with ``mesh``, this rank's ``[B, T, Vp / M]``
    block of the vocabulary); labels: [B,T] int32 (-1 = ignore).

    Returns (loss, metrics dict). Softmax in fp32; padded vocab rows
    masked."""
    lf = _masked_f32(logits, real_vocab, _start(logits, mesh))
    nll, z, acc, n = _sums(*_row_stats(lf, labels, real_vocab, mesh),
                           labels)
    denom = torch.clamp(n, min=1.0)
    loss = nll / denom
    z = z / denom
    return loss + z_loss_coef * z, {"nll": loss, "z_loss": z,
                                    "accuracy": acc / denom, "tokens": n}


def head_product(x: torch.Tensor, w: torch.Tensor, transpose_w: bool
                 ) -> torch.Tensor:
    """The fused head's logits of a chunk: ``x @ w`` (``w.t()`` where
    ``transpose_w``)."""
    return x @ (w.t() if transpose_w else w)


def _chunk_stats(x_c, labels_c, w, *, real_vocab: int, transpose_w: bool,
                 mesh=None):
    """Per-chunk (nll_sum, z_sum, acc_sum, valid_sum). x_c: [B,c,D]."""
    logits = head_product(x_c, w, transpose_w)
    lf = _masked_f32(logits, real_vocab, _start(logits, mesh))
    return _sums(*_row_stats(lf, labels_c, real_vocab, mesh), labels_c)


def fused_cross_entropy(x, w, labels, *, real_vocab: int,
                        transpose_w: bool, chunk: int = 512,
                        z_loss_coef: float = 1e-4, unroll: bool = False,
                        mesh=None):
    """x: [B,T,D] final hiddens; w: head weights ([D,Vp] or [Vp,D] when
    ``transpose_w``, i.e. tied embeddings; with ``mesh``, this rank's
    block of the vocabulary: ``[D, Vp / M]`` or ``[Vp / M, D]``);
    labels: [B,T].

    ``unroll`` is accepted for the JAX package's signature: there it
    chooses a Python loop over a ``lax.scan``; here the chunks are always
    a Python loop.  Chunks are checkpointed only when autograd records."""
    T = x.shape[1]
    c = min(chunk, T)
    while T % c:
        c //= 2
    if mesh is not None:
        x = sharded.copy_to_model(x, mesh)
    stats_fn = partial(_chunk_stats, real_vocab=real_vocab,
                       transpose_w=transpose_w, mesh=mesh)
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
