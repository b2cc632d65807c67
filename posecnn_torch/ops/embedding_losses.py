"""Pixel-embedding metric losses: triplet and lifted structured
(counterpart of `posecnn_tpu/ops/embedding_losses.py`; the reference's
`Triplet` and `Liftedstruct` ops).

`triplet_loss` samples, for each of `num_triplets` anchors, k = 8
candidate positives and negatives and keeps the first candidate of the
anchor's class (else the anchor itself) and the first of another class
(else the first candidate); a triplet counts only where both exist. The
draws (anchors, candidates) come from a `torch.Generator`, or are passed
in as `draws`, so that a test can feed JAX's `jax.random` draw: the same
distribution, other numbers. `lifted_structured_loss` is the dense Gram
form over all pairs (Song et al., CVPR 2016).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

CANDIDATES = 8


def triplet_draws(n: int, num_triplets: int, generator: Optional[torch.Generator] = None,
                  device=None):
    """(anchors (T,), positive candidates (T, 8), negative candidates
    (T, 8)) uniform in [0, n)."""
    def draw(shape):
        return torch.randint(0, n, shape, generator=generator, device=device)

    return (draw((num_triplets,)), draw((num_triplets, CANDIDATES)),
            draw((num_triplets, CANDIDATES)))


def _first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True of each row (0 where none), jnp.argmax's."""
    return torch.argmax(mask.to(torch.uint8), dim=1)


def triplet_loss(embeddings: torch.Tensor, labels: torch.Tensor,
                 generator: Optional[torch.Generator] = None, *, num_triplets: int = 1024,
                 margin: float = 1.0, draws: Optional[Sequence[torch.Tensor]] = None):
    """Mean of max(‖a − p‖² − ‖a − n‖² + margin, 0) over the valid sampled
    triplets (`embedding_losses.py:24-66`). embeddings (N, C), labels (N,)."""
    n = embeddings.shape[0]
    anchors, cand_p, cand_n = draws if draws is not None else triplet_draws(
        n, num_triplets, generator, embeddings.device)
    rows = torch.arange(anchors.shape[0], device=embeddings.device)
    la = labels[anchors]
    same_p = labels[cand_p] == la[:, None]
    diff_n = labels[cand_n] != la[:, None]
    has_p, has_n = same_p.any(1), diff_n.any(1)
    p_idx = torch.where(has_p, cand_p[rows, _first(same_p)], anchors)
    n_idx = torch.where(has_n, cand_n[rows, _first(diff_n)], cand_n[:, 0])
    valid = (has_p & has_n).to(embeddings.dtype)
    a = embeddings[anchors]
    d_ap = ((a - embeddings[p_idx]) ** 2).sum(-1)
    d_an = ((a - embeddings[n_idx]) ** 2).sum(-1)
    hinge = torch.clamp(d_ap - d_an + margin, min=0.0) * valid
    return hinge.sum() / torch.clamp(valid.sum(), min=1.0)


def lifted_structured_loss(embeddings: torch.Tensor, labels: torch.Tensor, *,
                           margin: float = 1.0):
    """J_ij = log(Σ_{k∉i} e^{m − D_ik} + Σ_{l∉j} e^{m − D_jl}) + D_ij over
    the positive pairs, L = Σ max(J_ij, 0)² / (2|P|)
    (`embedding_losses.py:69-88`)."""
    gram = embeddings.float() @ embeddings.float().T
    sq = torch.diagonal(gram)
    d = torch.sqrt(torch.clamp(sq[:, None] - 2 * gram + sq[None, :], min=1e-12))
    same = labels[:, None] == labels[None, :]
    pos = same & ~torch.eye(labels.shape[0], dtype=torch.bool, device=labels.device)
    neg_sum = torch.where(~same, torch.exp(margin - d), 0.0).sum(1)
    j_ij = torch.log(torch.clamp(neg_sum[:, None] + neg_sum[None, :], min=1e-12)) + d
    hinge = torch.clamp(torch.where(pos, j_ij, 0.0), min=0.0)
    return (hinge ** 2).sum() / (2.0 * torch.clamp(pos.sum(), min=1))
