"""Run-to-run spread of ``chip_smoke.py`` phase 15's mode-5 check, on one card.

    python3 scripts/mode5_spread.py [--runs 5] [--tree DIR]
    python3 scripts/mode5_spread.py --flow [--runs 4] [--tree DIR]

Kernel 7 (``fused_decoder_stack``) splits its GEMVs' sums over blocks.
Where the blocks meet by atomicAdd, two runs on the same inputs may differ
in the last bits, and the difference compounds over the 32 layers of
Llama-2-7B; where they meet in a fixed order, the runs agree bit for bit.

Without ``--flow`` the script prints (1) how far kernel 7 drifts from
itself: four runs of the unsharded step on phase 15's inputs (random
weights, seed 0; a random cache at pos 600, seed 2), bit-equality with the
first run, the largest residual difference and the residual limit phase 15
uses (0.05 + 1 % of the largest value); (2) the step's time, without and
with the LM head (CUDA events, mean of 20 steps after 3 warm-up steps);
(3) phase 15's own check, ``chip_smoke.phase_mode5`` (mode 5 at tp 2 in
loopback against the unsharded step), ``--runs`` times in a fresh process.

With ``--flow`` it runs ``chip_smoke.main()`` up to phase 15, samples the
check ``--runs`` times in the state the earlier phases leave, and stops.
``--tree`` names the checkout whose ``chip_smoke.py`` and package run (an
unpacked ``git archive`` of another commit, to compare two commits on one
card).  Both print the failures.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path


def isolated(cs, runs: int) -> None:
    import torch
    from clusterfusion_tpu_torch.config import LlamaConfig
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.models.generation import Llama
    from clusterfusion_tpu_torch.ops import stack_kernel as sk
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cs.phase_card()
    cs.phase_build()
    eng = Llama.synthetic(LlamaConfig.llama2_7b(), seed=0, fused=True,
                          device=dev)
    cfg, p, pos = eng.cfg, eng.params, 600
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
    outs = []
    for _ in range(4):
        outs.append(sk.fused_decoder_stack(
            x, lw["attn_norm"], lw["ffn_norm"], cos, sin, lw["wqkv_f"],
            lw["wo_f"], lw["w13"], lw["w2"], kc.clone(), vc.clone(), pos,
            **kw))
    torch.cuda.synchronize()
    first = outs[0][1].float()
    cs.say("kernel7_repeat", runs=len(outs),
           x_out_bit_equal=[torch.equal(o[0], outs[0][0]) for o in outs],
           residual_bit_equal=[torch.equal(o[1], outs[0][1]) for o in outs],
           residual_max_abs_diff=max((o[1].float() - first).abs().max().item()
                                     for o in outs),
           residual_limit=0.05 + 1e-2 * first.abs().max().item())
    lm = dict(final_norm=p["final_norm"], lm_head=p["lm_head"])
    for name, extra in (("no_lm_head", {}), ("lm_head", lm)):
        def step():
            return sk.fused_decoder_stack(
                x, lw["attn_norm"], lw["ffn_norm"], cos, sin, lw["wqkv_f"],
                lw["wo_f"], lw["w13"], lw["w2"], kc, vc, pos, **kw, **extra)
        for _ in range(3):
            step()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(20):
            step()
        t1.record()
        torch.cuda.synchronize()
        cs.say("kernel7_time", variant=name, pos=pos,
               ms_per_step=f"{t0.elapsed_time(t1) / 20:.4f}")
    fails = 0
    for _ in range(runs):
        try:
            cs.phase_mode5(eng, dev)
        except AssertionError as e:
            fails += 1
            cs.say("mode5_failed", error=repr(str(e)))
    cs.say("mode5_spread", where="fresh process", runs=runs, failed=fails)


def in_flow(cs, runs: int, tree: str) -> int:
    orig = cs.phase_mode5

    def sampled(eng, dev, pos=600):
        fails = 0
        for _ in range(runs):
            try:
                orig(eng, dev, pos)
            except AssertionError as e:
                fails += 1
                cs.say("mode5_failed", error=repr(str(e)))
        cs.say("mode5_spread", where="after chip_smoke phases 1-15a",
               tree=tree, runs=runs, failed=fails)
        raise SystemExit(0)

    cs.phase_mode5 = sampled
    return cs.main()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--flow", action="store_true")
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("mode5_spread: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    if args.flow:
        return in_flow(cs, args.runs, tree)
    isolated(cs, args.runs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
