"""Council mutual-agreement losses -- the paper's core mechanism.

Counterpart of ``councilx/losses/council.py``. Member i's translated output,
channel-concatenated with the input image, is scored by every council
discriminator D^_j; the generator is rewarded when the OTHER members' D^_j
accept it, while D^_i is trained to tell member i's pairs from the other
members' pairs. The JAX package vmaps the discriminators over the pair grid;
here each council discriminator runs once on the folded (N*B) batch of all
pairs, in a loop over discriminators.

``polarity`` (Config.council.council_polarity): "own_real" (D^_i's real
class is member i's own pairs) or "own_fake" (labels swapped). Generators
always target the own-class label.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _pair_grid_logits(cdis: Sequence[Callable], pairs: torch.Tensor,
                      remat: bool = False) -> List[torch.Tensor]:
    """Every council discriminator on every member's (fake || input) pair.

    pairs: (N, B, H, W, C'). Returns a per-scale list of logit grids shaped
    (N_dis, N_out, B, h, w, 1). ``remat`` recomputes each discriminator's
    activations in the backward (one discriminator's live at a time), as
    the JAX package's ``scan=True``; the numbers are the same."""
    n, b = pairs.shape[0], pairs.shape[1]
    flat = pairs.reshape((n * b,) + tuple(pairs.shape[2:]))
    per_dis = []
    for d in cdis:
        outs = (checkpoint(d, flat, use_reentrant=False,
                           preserve_rng_state=False) if remat else d(flat))
        per_dis.append([o.reshape((n, b) + tuple(o.shape[1:])) for o in outs])
    return [torch.stack(scale) for scale in zip(*per_dis)]


def make_pairs(x_fakes: torch.Tensor, x_in: torch.Tensor,
               conditional: bool = True) -> torch.Tensor:
    """(N, B, H, W, C) fakes + (B, H, W, C) input -> (N, B, H, W, 2C) pairs
    (or the fakes alone when not ``conditional``)."""
    if not conditional:
        return x_fakes
    x_rep = x_in[None].expand((x_fakes.shape[0],) + tuple(x_in.shape))
    return torch.cat([x_fakes, x_rep.to(x_fakes.dtype)], dim=-1)


def _pair_mask(n_dis: int, n_out: int, dis_offset: int, out_offset: int,
               device) -> torch.Tensor:
    """[j, i] indicator of j_global == i_global for (possibly shard-local)
    discriminator rows j and output columns i, f32."""
    j = torch.arange(n_dis, device=device) + dis_offset
    i = torch.arange(n_out, device=device) + out_offset
    return (j[:, None] == i[None, :]).float()


def _per_pair(g: torch.Tensor) -> torch.Tensor:
    return g.mean(dim=(2, 3, 4, 5))


def council_gen_loss(cdis: Sequence[Callable], x_fakes: torch.Tensor,
                     x_in: torch.Tensor, gan_type: str = "lsgan",
                     conditional: bool = True, dis_offset: int = 0,
                     out_offset: int = 0, remat: bool = False,
                     polarity: str = "own_real") -> torch.Tensor:
    """Generator-side agreement loss: the sum over ordered pairs (i, j != i)
    of D^_j's generator GAN loss on member i's output, each a mean over
    batch and patches. ``dis_offset``/``out_offset`` are the global member
    indices of the first discriminator / first output row, so the diagonal
    is excluded on global indices."""
    pairs = make_pairs(x_fakes, x_in, conditional)
    grids = _pair_grid_logits(cdis, pairs, remat)
    n_dis, n_out = grids[0].shape[0], x_fakes.shape[0]
    off_diag = 1.0 - _pair_mask(n_dis, n_out, dis_offset, out_offset,
                                x_fakes.device)
    own_real = polarity == "own_real"
    loss = 0.0
    for g in grids:
        g = g.float()
        if gan_type == "lsgan":
            target = (g - 1.0) ** 2 if own_real else g ** 2
        elif gan_type == "nsgan":
            target = F.softplus(g) - g if own_real else F.softplus(g)
        else:
            raise ValueError(f"unsupported gan_type: {gan_type}")
        loss = loss + torch.sum(_per_pair(target) * off_diag)
    return loss


def council_dis_loss(cdis: Sequence[Callable], x_fakes: torch.Tensor,
                     x_in: torch.Tensor, gan_type: str = "lsgan",
                     conditional: bool = True, dis_offset: int = 0,
                     n_total: Optional[int] = None, remat: bool = False,
                     polarity: str = "own_real") -> torch.Tensor:
    """Council-discriminator loss (reference dis_council_update). Under
    "own_real": D^_i's real class is member i's own pairs (the diagonal),
    its fake class the other members' pairs, averaged over the N-1 others;
    "own_fake" swaps the labels. The caller detaches the fakes; ``x_fakes``
    always carries every member's outputs."""
    n = n_total if n_total is not None else x_fakes.shape[0]
    if n < 2:
        return torch.zeros((), dtype=torch.float32, device=x_fakes.device)
    pairs = make_pairs(x_fakes, x_in, conditional)
    grids = _pair_grid_logits(cdis, pairs, remat)
    n_dis, n_out = grids[0].shape[0], x_fakes.shape[0]
    eye = _pair_mask(n_dis, n_out, dis_offset, 0, x_fakes.device)
    off_diag = 1.0 - eye
    loss = 0.0
    for g in grids:
        g = g.float()
        if gan_type == "lsgan":
            real_term = _per_pair((g - 1.0) ** 2)
            fake_term = _per_pair(g ** 2)
        elif gan_type == "nsgan":
            real_term = _per_pair(F.softplus(g) - g)
            fake_term = _per_pair(F.softplus(g))
        else:
            raise ValueError(f"unsupported gan_type: {gan_type}")
        if polarity == "own_real":
            loss = loss + torch.sum(real_term * eye)
            loss = loss + torch.sum(fake_term * off_diag) / (n - 1)
        else:
            loss = loss + torch.sum(fake_term * eye)
            loss = loss + torch.sum(real_term * off_diag) / (n - 1)
    return loss
