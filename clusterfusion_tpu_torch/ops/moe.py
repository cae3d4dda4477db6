"""Mixture-of-Experts SwiGLU FFN (twin of ``clusterfusion_tpu/ops/moe.py``).

Top-k routed experts as DeepSeek-V2 runs them beside its shared expert,
plain PyTorch as in the JAX package (which has no Pallas kernel here), bf16
weights only:

- decode: the top-k experts' weights are gathered by a device-side index
  (``w13_all[sel]``, a copy of k experts per call: no host sync) and run as
  k dense SwiGLUs;
- prefill: masked-dense, every expert on every token, weighted by the
  router's gates.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def route_top_k(x, router_w, top_k: int, *, norm_topk_prob: bool = True,
                routed_scaling_factor: float = 1.0):
    """x [T, h], router_w [h, E] -> (gates [T, E] f32 with exactly top_k
    nonzero per row, sel [T, top_k] expert indices).  ``norm_topk_prob``
    renormalizes the selected probabilities to sum 1 (V3); otherwise they
    are scaled by ``routed_scaling_factor`` (V2 / V2-Lite)."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    vals, sel = torch.topk(probs, top_k, dim=-1)
    if norm_topk_prob:
        vals = vals / vals.sum(dim=-1, keepdim=True)
    else:
        vals = vals * routed_scaling_factor
    gates = torch.zeros_like(probs).scatter(-1, sel, vals)
    return gates, sel


def _swiglu(x, w13, w2):
    """SwiGLU of x [..., h] through w13 [2, h, f] and w2 [f, h]: float32
    gate/up, bf16 activation, float32 output."""
    if w13.dtype != torch.bfloat16 or w2.dtype != torch.bfloat16:
        raise NotImplementedError("MoE: only bf16 experts are ported "
                                  "(quantized experts are not)")
    if x.device.type == "cpu":
        y = torch.einsum("...d,udf->...uf", x.float(), w13.float())
        act = (F.silu(y[..., 0, :]) * y[..., 1, :]).to(x.dtype)
        return act.float() @ w2.float()
    # on the card: bf16 products with float32 output
    y = torch.stack([torch.mm(x.reshape(-1, x.shape[-1]), w13[i],
                              out_dtype=torch.float32) for i in (0, 1)], -2)
    act = (F.silu(y[..., 0, :]) * y[..., 1, :]).to(x.dtype)
    return torch.mm(act, w2, out_dtype=torch.float32).reshape(
        *x.shape[:-1], w2.shape[-1])


def moe_ffn_decode(x, router_w, w13_all, w2_all, top_k: int = 2, *,
                   norm_topk_prob: bool = True,
                   routed_scaling_factor: float = 1.0):
    """Gathered-expert MoE for decode.  x [1, h]; w13_all [E, 2, h, f];
    w2_all [E, f, h].  Returns [1, h] in x.dtype."""
    gates, sel = route_top_k(x, router_w, top_k,
                             norm_topk_prob=norm_topk_prob,
                             routed_scaling_factor=routed_scaling_factor)
    idx = sel[0]
    w13, w2 = w13_all[idx], w2_all[idx]                  # k experts' copies
    g = gates[0, idx]
    out = torch.zeros((1, x.shape[-1]), dtype=torch.float32, device=x.device)
    for i in range(top_k):
        out = out + g[i] * _swiglu(x, w13[i], w2[i])
    return out.to(x.dtype)


def moe_ffn_dense(x, router_w, w13_all, w2_all, top_k: int = 2, *,
                  norm_topk_prob: bool = True,
                  routed_scaling_factor: float = 1.0):
    """Masked-dense MoE: every expert runs on every token, in expert order.
    x [T, h] -> [T, h]."""
    gates, _ = route_top_k(x, router_w, top_k,
                           norm_topk_prob=norm_topk_prob,
                           routed_scaling_factor=routed_scaling_factor)
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(w13_all.shape[0]):
        acc = acc + gates[:, e:e + 1] * _swiglu(x, w13_all[e], w2_all[e])
    return acc.to(x.dtype)
