"""Streaming chat CLI of the port (twin of the root ``chat.py``): streams a
completion and prints the total time and tokens/sec.

Usage:
    python -m clusterfusion_tpu_torch.chat --synthetic
    python -m clusterfusion_tpu_torch.chat --synthetic --eager
    python -m clusterfusion_tpu_torch.chat --synthetic --device cpu
    python -m clusterfusion_tpu_torch.chat --synthetic --spec_draft synthetic
    python -m clusterfusion_tpu_torch.chat --synthetic --quant int8
    python -m clusterfusion_tpu_torch.chat --synthetic --quant int8 \
        --spec_draft synthetic
    python -m clusterfusion_tpu_torch.chat --synthetic --kv_int8
    python -m clusterfusion_tpu_torch.chat --synthetic --kv_fp8 \
        --spec_draft synthetic

Loading a checkpoint is not ported yet, so ``--synthetic`` (random
weights, byte tokenizer) is required, and ``--spec_draft`` takes only
``synthetic`` (a random tiny draft, seed 1, bf16 whatever ``--quant``
is, as in the root ``chat.py``).  ``--quant int8`` runs the int8
weight-only engine: kernel 7's int8 mode for the stream, and with
``--spec_draft`` kernel 8's int8 mode for the verify.  ``--quant int4``
runs the int4 engine (groups of 128) the same way, in kernels 7's and 8's
int4 modes, W4A8 as ``KernelConfig.int4_w4a8`` is by default (the header
line names the mode).  ``--kv_int8`` (an ``Int8KV`` cache: int8 rows with
per-position scales) and ``--kv_fp8`` (float8 e4m3) give the target an
8-bit KV cache: kernel 7's 8-bit modes for the stream, kernel 8's for the
verify (the draft keeps a bf16 cache); ``--kv_int8`` wins when both are
given, as in the root ``chat.py``, and the header line names the kind.
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
    ap.add_argument("--quant", type=str, default=None,
                    choices=["int8", "int4"],
                    help="weight-only quantization of the target")
    ap.add_argument("--kv_fp8", action="store_true")
    ap.add_argument("--kv_int8", action="store_true")
    ap.add_argument("--spec_draft", type=str, default=None,
                    help="'synthetic' for a random tiny draft model "
                         "(speculative decoding; forces greedy sampling)")
    ap.add_argument("--n_draft", type=int, default=4,
                    help="draft tokens per speculative round")
    args = ap.parse_args(argv)

    if args.spec_draft not in (None, "synthetic"):
        sys.exit("--spec_draft: loading a draft checkpoint is not yet ported")
    if not args.synthetic:
        sys.exit("loading a checkpoint is not yet ported: pass --synthetic")

    import torch

    from clusterfusion_tpu_torch.config import LlamaConfig
    from clusterfusion_tpu_torch.models.generation import Llama

    fused = not args.eager
    kv = "int8" if args.kv_int8 else "fp8" if args.kv_fp8 else None
    kv_dtype = {"int8": "int8", "fp8": torch.float8_e4m3fn,
                None: torch.bfloat16}[kv]
    cfg = LlamaConfig.tiny(max_seq_len=args.max_seq_len)
    gen = Llama.synthetic(cfg, fused=fused, quant=args.quant,
                          device=args.device, kv_dtype=kv_dtype)
    draft = None
    if args.spec_draft == "synthetic":
        draft = Llama.synthetic(LlamaConfig.tiny(max_seq_len=args.max_seq_len),
                                seed=1, fused=fused, device=args.device)
    toks = gen.tokenizer.encode(args.prompt, bos=True, eos=False)
    mode = ""
    if args.quant == "int4":
        mode = " W4A8" if gen.kcfg.int4_w4a8 else " exact"
    print(f"[prompt: {len(toks)} tokens | fused={gen.fused}{mode} | "
          f"device={gen.device}"
          + (f" | quant={args.quant}" if args.quant else "")
          + (f" | kv={kv}" if kv else "")
          + (f" | spec n_draft={args.n_draft}" if draft else "") + "]")
    t0 = time.perf_counter()
    if draft is not None:
        out = gen.spec_generate(toks, args.max_gen_len, draft,
                                n_draft=args.n_draft)
        n = len(out)
        sys.stdout.write(gen.tokenizer.decode(out))
        sys.stdout.flush()
        dt = time.perf_counter() - t0
        st = gen.spec_stats
        print(f"\n\n[{n} tokens in {dt:.2f}s -> {n / dt:.2f} tokens/sec | "
              f"{st['rounds']} rounds, {st['accepted_drafts']} drafts "
              f"accepted]")
        return
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
