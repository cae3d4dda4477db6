"""Token sampling (twin of ``clusterfusion_tpu/models/sampling.py``) on a
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


def sample_batch(logits: torch.Tensor, temperatures, top_ps,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Per-row sampling (twin of ``sampling.py:37-52``): logits [B, vocab]
    f32, temperatures/top_ps [B] (host sequences or tensors).  Rows with
    temperature <= 0 are greedy, the others nucleus-sample, each on its
    own; returns [B] long on the logits' device.

    The nucleus draw inverts the kept mass's running sum at one uniform
    number per row from ``generator``, so NaN logits yield some index (for
    the serving watchdog to report) instead of a device-side error."""
    temps = torch.as_tensor(temperatures, dtype=torch.float32).cpu()
    out = torch.argmax(logits, dim=-1)
    rows = torch.nonzero(temps > 0).flatten()
    if rows.numel() == 0:
        return out
    dev = logits.device
    t = temps[rows].to(dev)
    p_top = torch.as_tensor(top_ps, dtype=torch.float32).cpu()[rows].to(dev)
    lg = logits[rows.to(dev)].float()
    probs = torch.softmax(lg / t[:, None], dim=-1)
    sorted_probs, sorted_idx = torch.sort(probs, dim=-1, descending=True)
    cum = torch.cumsum(sorted_probs, dim=-1)
    keep = (cum - sorted_probs) <= p_top[:, None]     # a prefix, >= 1 token
    cdf = torch.cumsum(torch.where(keep, sorted_probs, 0.), dim=-1)
    u = torch.rand((rows.numel(), 1), generator=generator, device=dev) \
        * cdf[:, -1:]
    choice = (cdf < u).sum(dim=-1).clamp(max=lg.shape[-1] - 1)
    out[rows.to(dev)] = sorted_idx.gather(1, choice[:, None])[:, 0]
    return out
