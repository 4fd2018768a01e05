"""Losses of the GAN training step (counterpart of ``sg2im_tpu/losses.py``,
upstream ``sg2im/losses.py`` and ``scripts/train.py:387-412``).

Every loss takes an optional validity ``mask`` over its leading axes, so
that padded graph batches give the means upstream's ragged batches give.
The auxiliary-classifier cross-entropy lives here, not in the
discriminator.  Every mean goes through :func:`masked_mean`, so that in a
data-parallel step each is over the global batch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sg2im_tpu_torch.parallel import collectives


def masked_mean(x, mask=None):
    """Mean over every element, or over the elements whose mask (over x's
    leading axes, trailing axes averaged too) is 1.  Numerator and
    denominator count the same broadcast elements; masked-out NaN or inf
    entries are selected away, not multiplied by 0.

    Inside ``parallel.collectives.global_batch(group)`` the denominator is
    the global count, over every rank's rows, and the result is this
    rank's share of the global mean: the ranks' results sum to it, and so
    do their gradients.  Every rank holds the same number of rows."""
    pg = collectives.group()
    if mask is None:
        if pg is None:
            return x.mean()
        return x.sum() / (x.numel() * collectives.world())
    mask = mask.to(x.dtype)
    m = mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim)).expand(x.shape)
    denom = m.sum()
    if pg is not None:
        denom = collectives.all_reduce(denom.detach().clone(), pg)
    denom = denom.clamp_min(1.0)
    return (torch.where(m > 0, x, torch.zeros_like(x)) * m).sum() / denom


def bce_with_logits(logits, targets):
    """Numerically stable sigmoid BCE (upstream ``losses.py:39-57``)."""
    return (logits.clamp_min(0.0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def gan_g_loss(scores_fake, mask=None):
    return masked_mean(bce_with_logits(scores_fake,
                                       torch.ones_like(scores_fake)), mask)


def gan_d_loss(scores_real, scores_fake, mask=None):
    loss_real = masked_mean(
        bce_with_logits(scores_real, torch.ones_like(scores_real)), mask)
    loss_fake = masked_mean(
        bce_with_logits(scores_fake, torch.zeros_like(scores_fake)), mask)
    return loss_real + loss_fake


def wgan_g_loss(scores_fake, mask=None):
    return -masked_mean(scores_fake, mask)


def wgan_d_loss(scores_real, scores_fake, mask=None):
    return masked_mean(scores_fake, mask) - masked_mean(scores_real, mask)


def lsgan_g_loss(scores_fake, mask=None):
    return masked_mean((torch.sigmoid(scores_fake) - 1.0) ** 2, mask)


def lsgan_d_loss(scores_real, scores_fake, mask=None):
    return (masked_mean((torch.sigmoid(scores_real) - 1.0) ** 2, mask)
            + masked_mean(torch.sigmoid(scores_fake) ** 2, mask))


GAN_LOSSES = {"gan": (gan_g_loss, gan_d_loss),
              "wgan": (wgan_g_loss, wgan_d_loss),
              "lsgan": (lsgan_g_loss, lsgan_d_loss)}


def get_gan_losses(gan_type: str):
    """(g_loss, d_loss) of a GAN type (upstream ``losses.py:21-36``)."""
    if gan_type not in GAN_LOSSES:
        raise ValueError(f'Unrecognized GAN type "{gan_type}"')
    return GAN_LOSSES[gan_type]


def l1_loss(pred, target):
    return masked_mean((pred - target).abs())


def mse_loss(pred, target, mask=None):
    return masked_mean((pred - target) ** 2, mask)


def cross_entropy(logits, labels, mask=None):
    """Masked softmax cross-entropy (the AC and predicate losses).  Labels
    on masked rows may be out of range (read as 0); an out-of-range label
    on a real row gives NaN, as the JAX package's gather does, which the
    train step's finite guard then catches."""
    logp = F.log_softmax(logits, dim=-1)
    labels = labels.long()
    if mask is not None:
        labels = torch.where(mask > 0, labels, torch.zeros_like(labels))
    C = logits.shape[-1]
    ok = (labels >= 0) & (labels < C)
    nll = -torch.gather(logp, -1, labels.clamp(0, C - 1)[..., None])[..., 0]
    nll = torch.where(ok, nll, torch.full_like(nll, float("nan")))
    return masked_mean(nll, mask)


def binary_cross_entropy(probs, targets, mask=None):
    """BCE on probabilities (the mask loss), with ``probs`` clamped to
    [1e-7, 1 - 1e-7] so that the backward stays bounded where an upstream
    sigmoid saturates to exactly 0 or 1."""
    eps = 1e-12
    p = probs.clamp(1e-7, 1.0 - 1e-7)
    bce = -(targets * torch.log(p + eps)
            + (1.0 - targets) * torch.log(1.0 - p + eps))
    return masked_mean(bce, mask)


def gradient_penalty(x_real, x_fake, f, gamma: float = 1.0, eps=None,
                     generator=None):
    """WGAN-GP penalty (upstream ``losses.py:148-160``, defined there and
    never called): ((|grad f(x_hat)| - gamma) / gamma)^2 averaged, x_hat =
    eps * x_real + (1 - eps) * x_fake with eps (N, 1, ..., 1) drawn from a
    normal, as upstream draws it (from ``generator``, unless given)."""
    N = x_real.shape[0]
    if eps is None:
        eps = torch.randn((N,) + (1,) * (x_real.ndim - 1), dtype=x_real.dtype,
                          device=x_real.device, generator=generator)
    x_hat = eps * x_real + (1.0 - eps) * x_fake
    if not x_hat.requires_grad:
        x_hat.requires_grad_()
    s = f(x_hat)
    if s.ndim > 1:
        s = s.reshape(N, -1).mean(dim=1)
    (grad,) = torch.autograd.grad(s.sum(), x_hat, create_graph=True)
    norm = torch.sqrt((grad.reshape(N, -1) ** 2).sum(dim=1) + 1e-12)
    return masked_mean(((norm - gamma) ** 2) / (gamma * gamma))
