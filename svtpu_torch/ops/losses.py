"""Loss library (``svtpu/ops/losses.py:23-157``), on tensors.

Reductions and epsilons are the reference's, which is why none of these
calls ``F.pairwise_distance``, ``F.triplet_margin_loss`` or ``F.kl_div``:
``triplet_margin`` passes ``eps=1e-8`` into its distance where torch's
triplet loss uses 1e-6, ``kl_binary_concrete`` applies a sigmoid to what
the trainers feed it (already a probability, as the reference trainers do),
and ``js_distance_bernoulli`` computes in float32 and clips both categories.
"""
from __future__ import annotations

import math

import torch


def recon_mse(x_recon: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Mean squared error over all elements."""
    d = x_recon - x
    return (d * d).mean()


def l1_sparsity(q_logits: torch.Tensor, lamb: float) -> torch.Tensor:
    """``lamb * ||logits||_1``."""
    return lamb * q_logits.abs().sum()


def kl_binary_concrete(q: torch.Tensor, p: float = 0.5,
                       eps: float = 1e-8) -> torch.Tensor:
    """KL(Bernoulli(sigmoid(q)) || Bernoulli(p)), summed over the last dim,
    meaned over the rest. The sigmoid is applied to ``q`` whatever it holds
    (the trainers pass the relaxed sample ``z_seq``)."""
    q = torch.sigmoid(q).clamp(eps, 1.0 - eps)
    log_p = math.log(p)
    log_1mp = math.log1p(-p)
    kl = (q * (torch.log(q + eps) - log_p)
          + (1.0 - q) * (torch.log((1.0 - q) + eps) - log_1mp))
    return kl.sum(-1).mean()


def pairwise_distance(x1: torch.Tensor, x2: torch.Tensor, p: float = 2.0,
                      eps: float = 1e-6) -> torch.Tensor:
    """``||x1 - x2 + eps||_p`` over the last dim."""
    d = x1 - x2 + eps
    if p == 2.0:
        return torch.sqrt((d * d).sum(-1))
    return (d.abs() ** p).sum(-1) ** (1.0 / p)


def cosine_distance(x1: torch.Tensor, x2: torch.Tensor,
                    eps: float = 1e-8) -> torch.Tensor:
    """``1 - cos_sim`` over the last dim."""
    num = (x1 * x2).sum(-1)
    den = torch.clamp(torch.linalg.vector_norm(x1, dim=-1)
                      * torch.linalg.vector_norm(x2, dim=-1), min=eps)
    return 1.0 - num / den


def contrastive(x1: torch.Tensor, x2: torch.Tensor, label: float,
                margin: float = 1.0, dist: str = "euclidean") -> torch.Tensor:
    """Pairwise contrastive loss: ``label`` 0 = similar (minimise the
    distance), 1 = dissimilar (push beyond ``margin``); mean over all but
    the last dim."""
    if dist == "euclidean":
        d = pairwise_distance(x1, x2)
    elif dist == "cosine":
        d = cosine_distance(x1, x2)
    else:
        raise ValueError(f"unknown dist {dist!r}")
    similar = (1.0 - label) * d * d
    dissim = label * torch.clamp(margin - d, min=0.0) ** 2
    return (similar + dissim).mean()


def triplet_margin(anchor: torch.Tensor, positive: torch.Tensor,
                   negative: torch.Tensor, margin: float = 1.0,
                   p: float = 2.0, eps: float = 1e-8,
                   swap: bool = True) -> torch.Tensor:
    """Triplet margin loss, mean reduction; with ``swap`` the negative
    distance is ``min(d(a, n), d(p, n))``."""
    d_ap = pairwise_distance(anchor, positive, p=p, eps=eps)
    d_an = pairwise_distance(anchor, negative, p=p, eps=eps)
    if swap:
        d_an = torch.minimum(d_an, pairwise_distance(positive, negative,
                                                     p=p, eps=eps))
    return torch.relu(d_ap - d_an + margin).mean()


def js_distance_bernoulli(p: torch.Tensor, q: torch.Tensor,
                          eps: float = 1e-8) -> torch.Tensor:
    """Jensen–Shannon distance between per-dim Bernoullis of ``[batch,
    latent]`` probabilities: per-dim 2-category JS divergence, mean over the
    categories, mean over the batch, then sqrt → ``[latent]``. In float32,
    both categories clipped (a bf16 probability of exactly 1 would make
    the off category's ``0 * log 0``)."""
    p = p.float()
    q = q.float()
    p2 = torch.stack([p, 1.0 - p], -1).clamp(eps, 1.0)
    q2 = torch.stack([q, 1.0 - q], -1).clamp(eps, 1.0)
    m2 = 0.5 * (p2 + q2)
    kl_pm = p2 * (torch.log(p2) - torch.log(m2))
    kl_qm = q2 * (torch.log(q2) - torch.log(m2))
    js = (0.5 * (kl_pm + kl_qm)).mean(-1).mean(0)
    return torch.sqrt(js + 1e-12)


def triplet_js(anchor: torch.Tensor, positive: torch.Tensor,
               negative: torch.Tensor, margin: float = 1.0,
               eps: float = 1e-8, swap: bool = False) -> torch.Tensor:
    """Triplet loss under the Bernoulli JS distance. As in the reference,
    the hinge uses ``d(a, n)`` whatever ``swap`` says (its swapped distance
    is discarded there)."""
    d_ap = js_distance_bernoulli(anchor, positive, eps)
    d_an = js_distance_bernoulli(anchor, negative, eps)
    return torch.relu(d_ap - d_an + margin).mean()


def kl_binary_gumbel(logits2: torch.Tensor, p: float = 0.5,
                     eps: float = 1e-10) -> torch.Tensor:
    """KL(softmax(logits) || [1-p, p]) of the 2-logit Gumbel-Softmax
    parameterisation, summed over categories and latent dims, meaned over
    the batch."""
    q = torch.softmax(logits2, -1)
    prior = torch.tensor([1.0 - p, p], dtype=q.dtype, device=q.device)
    kl = q * (torch.log(q + eps) - torch.log(prior + eps))
    return kl.sum((-1, -2)).mean()
