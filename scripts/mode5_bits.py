"""Bits of the tp-2 mode-5 step on one card, saved from one checkout and
compared with another's.

    python3 scripts/mode5_bits.py --save FILE [--tree DIR]
    python3 scripts/mode5_bits.py --compare FILE FILE

``--save`` runs the checkout ``--tree`` (default: this one; an unpacked
``git archive`` of another commit, to compare two commits on one card) on
the inputs of ``chip_smoke.py`` phase 15: Llama-2-7B with random weights
(seed 0) and a random cache at pos 600 (seed 2) in two tp shards, one
virtual rank per CUDA stream over a loopback communicator.  It saves each
rank's ``fused_decoder_stack(reduce_axis="tp")`` outputs (x_out, the
residual, the appended K/V rows of every layer), then the logits of 4
greedy steps of ``make_sharded_decode_step(fused_collectives=True)`` after
a 128-token prefill.  ``--compare`` prints, for each saved tensor, whether
the two files hold the same bits, and exits 1 where one differs.  Needs a
CUDA card for ``--save``.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path


def save(path: str) -> None:
    import torch
    from clusterfusion_tpu_torch import parallel as par
    from clusterfusion_tpu_torch.config import LlamaConfig
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.models.generation import Llama
    from clusterfusion_tpu_torch.ops import stack_kernel as sk
    from clusterfusion_tpu_torch.parallel import collective as col
    from clusterfusion_tpu_torch.parallel.decode import lm_logits
    from clusterfusion_tpu_torch.parallel.mesh import AXES
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    eng = Llama.synthetic(LlamaConfig.llama2_7b(), seed=0, fused=True,
                          device=dev)
    cfg, p, pos, tp = eng.cfg, eng.params, 600, 2
    lw = p["layers"]
    gen = torch.Generator(device=dev).manual_seed(2)
    kc, vc = model.init_cache(cfg, max_seq=1024, device=dev)
    kc[:, :, :pos] = torch.randn(kc[:, :, :pos].shape, generator=gen,
                                 device=dev).bfloat16()
    vc[:, :, :pos] = torch.randn(vc[:, :, :pos].shape, generator=gen,
                                 device=dev).bfloat16()
    x = p["embed"][torch.tensor([7], device=dev)]
    cos, sin = model.rope_row(cfg, pos, dev)
    kw = dict(group=cfg.n_heads // cfg.kv_heads, head_dim=cfg.head_dim_,
              rope_style=cfg.rope_style, eps=cfg.norm_eps)
    # every kernel of the path loaded before a virtual rank spins
    sk.fused_decoder_stack(x, lw["attn_norm"], lw["ffn_norm"], cos, sin,
                           lw["wqkv_f"], lw["wo_f"], lw["w13"], lw["w2"],
                           kc.clone(), vc.clone(), pos, **kw)
    alone = par.Mesh(shape={a: 1 for a in AXES}, coords={a: 0 for a in AXES},
                     groups={a: None for a in AXES})
    out = {}
    lb = col.LoopbackComm(tp, dev)
    try:
        meshes = [lb.mesh(r) for r in range(tp)]
        shards = [par.shard_params(p, cfg, m) for m in meshes]
        caches = [(par.shard_cache(kc, m), par.shard_cache(vc, m))
                  for m in meshes]
        streams = [torch.cuda.Stream(dev) for _ in range(tp)]
        for r in range(tp):
            streams[r].wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(streams[r]):
                sl = shards[r]["layers"]
                xo, ro, k, v = sk.fused_decoder_stack(
                    x, sl["attn_norm"], sl["ffn_norm"], cos, sin,
                    sl["wqkv_f"], sl["wo_f"], sl["w13"], sl["w2"],
                    *caches[r], pos, reduce_axis="tp", mesh=meshes[r], **kw)
                out[f"rank{r}_x_out"] = xo
                out[f"rank{r}_residual"] = ro
                out[f"rank{r}_k_rows"] = k[:, :, pos]
                out[f"rank{r}_v_rows"] = v[:, :, pos]
        torch.cuda.synchronize()
        lb.check()
        prompt = [(i * 37 + 11) % cfg.vocab_size for i in range(128)]
        k0, v0 = model.init_cache(cfg, max_seq=1024, device=dev)
        lg, k0, v0 = model.prefill(p, k0, v0, prompt, cfg)
        first, pos0 = int(torch.argmax(lg[-1])), len(prompt)
        x0 = torch.zeros((1, cfg.hidden_dim), dtype=torch.bfloat16, device=dev)
        for sh in shards:          # the LM head's product at a shard's width
            lm_logits(sh, x0, x0, cfg, alone)
        steps = [par.make_sharded_decode_step(cfg, m, fused_collectives=True)
                 for m in meshes]
        caches = [[par.shard_cache(k0, m), par.shard_cache(v0, m)]
                  for m in meshes]
        toks = [torch.tensor(first, device=dev) for _ in range(tp)]
        for i in range(4):
            for r in range(tp):
                with torch.cuda.stream(streams[r]):
                    lg, kk, vv = steps[r](shards[r], *caches[r], toks[r],
                                          pos0 + i)
                    caches[r] = [kk, vv]
                    toks[r] = torch.argmax(lg)
                    out[f"rank{r}_step{i}_logits"] = lg
        torch.cuda.synchronize()
        lb.check()
    finally:
        lb.close()
    torch.save({k: t.detach().contiguous().cpu() for k, t in out.items()},
               path)
    print(f"[mode5_bits] saved={path} tensors={len(out)} "
          f"card={torch.cuda.get_device_name(0)!r}", flush=True)


def compare(a: str, b: str) -> int:
    import torch
    ta, tb = torch.load(a), torch.load(b)
    bad = 0
    for k in sorted(set(ta) | set(tb)):
        x, y = ta.get(k), tb.get(k)
        same = (x is not None and y is not None and x.shape == y.shape
                and x.dtype == y.dtype
                and torch.equal(x.view(torch.uint8), y.view(torch.uint8)))
        bad += not same
        print(f"[mode5_bits] tensor={k} bit_identical={same}", flush=True)
    print(f"[mode5_bits] a={a} b={b} tensors={len(ta)} differing={bad}",
          flush=True)
    return 1 if bad else 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--save")
    ap.add_argument("--compare", nargs=2)
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    import torch
    if not args.save or not torch.cuda.is_available():
        print("mode5_bits: --save needs a CUDA card", file=sys.stderr)
        return 1
    path = os.path.abspath(args.save)
    tree = os.path.abspath(args.tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    save(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
