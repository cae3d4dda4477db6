"""Token sampling (twin of ``clusterfusion_tpu/models/sampling.py:10-34``) on a
``torch.Generator``."""

from __future__ import annotations

from typing import Optional

import torch


def sample_top_p(logits: torch.Tensor, temperature: float, top_p: float,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Nucleus sampling.  logits: [vocab] f32.  Returns a 0-d long tensor.

    Probabilities sorted descending; a token is kept while the mass before
    it is <= ``top_p`` (the first token always), the kept mass is
    renormalised and sampled."""
    probs = torch.softmax(logits.float() / max(temperature, 1e-6), dim=-1)
    sorted_probs, sorted_idx = torch.sort(probs, descending=True)
    cum = torch.cumsum(sorted_probs, dim=-1)
    keep = (cum - sorted_probs) <= top_p
    masked = torch.where(keep, sorted_probs, torch.zeros_like(sorted_probs))
    masked = masked / masked.sum()
    choice = torch.multinomial(masked, 1, generator=generator)
    return sorted_idx[choice[0]]


def sample(logits: torch.Tensor, temperature: float = 0.6, top_p: float = 0.9,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy when temperature == 0, else top-p.  Returns a 0-d long tensor."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    return sample_top_p(logits, temperature, top_p, generator)
