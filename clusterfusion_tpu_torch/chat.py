"""Streaming chat CLI of the port (twin of the root ``chat.py``, bf16 path):
streams a completion and prints the total time and tokens/sec.

Usage:
    python -m clusterfusion_tpu_torch.chat --synthetic
    python -m clusterfusion_tpu_torch.chat --synthetic --eager
    python -m clusterfusion_tpu_torch.chat --synthetic --device cpu

Loading a checkpoint is not ported yet, so ``--synthetic`` (random
weights, byte tokenizer) is required.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompt", type=str,
                    default="Tell me the story about computer science.")
    ap.add_argument("--temperature", type=float, default=0.6)
    ap.add_argument("--top_p", type=float, default=0.9)
    ap.add_argument("--max_seq_len", type=int, default=1024)
    ap.add_argument("--max_gen_len", type=int, default=512)
    ap.add_argument("--synthetic", action="store_true",
                    help="random tiny model + byte tokenizer (no checkpoint)")
    ap.add_argument("--eager", action="store_true",
                    help="disable the fused decode kernel")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--quant", type=str, default=None)
    ap.add_argument("--kv_fp8", action="store_true")
    ap.add_argument("--kv_int8", action="store_true")
    ap.add_argument("--spec_draft", type=str, default=None)
    args = ap.parse_args(argv)

    for flag, given in (("--quant", args.quant), ("--kv_fp8", args.kv_fp8),
                        ("--kv_int8", args.kv_int8),
                        ("--spec_draft", args.spec_draft)):
        if given:
            sys.exit(f"{flag}: not yet ported")
    if not args.synthetic:
        sys.exit("loading a checkpoint is not yet ported: pass --synthetic")

    from clusterfusion_tpu_torch.config import LlamaConfig
    from clusterfusion_tpu_torch.models.generation import Llama

    cfg = LlamaConfig.tiny(max_seq_len=args.max_seq_len)
    gen = Llama.synthetic(cfg, fused=not args.eager, device=args.device)
    toks = gen.tokenizer.encode(args.prompt, bos=True, eos=False)
    print(f"[prompt: {len(toks)} tokens | fused={gen.fused} | "
          f"device={gen.device}]")
    t0 = time.perf_counter()
    n = 0
    for t in gen.stream_generate(toks, args.max_gen_len, args.temperature,
                                 args.top_p):
        n += 1
        sys.stdout.write(gen.tokenizer.decode([t]))
        sys.stdout.flush()
    dt = time.perf_counter() - t0
    print(f"\n\n[{n} tokens in {dt:.2f}s -> {n / dt:.2f} tokens/sec]")


if __name__ == "__main__":
    main()
