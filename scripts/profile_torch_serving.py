"""Where the time goes in a B=8 serving step of the port, Llama-2-7B bf16,
on one card.

    python3 scripts/profile_torch_serving.py

Random weights (seed 0).  Eight greedy requests of 32..512 prompt tokens
(the ``chip_smoke.py`` serving set) are admitted and prefilled; then five
decode steps of the whole batch are profiled with ``torch.profiler``, once
through the default batched step (``paged_attention`` per layer) and once
through the fused step (``llama_decoder_layer_paged`` per layer).  Prints
the wall ms per step of five unprofiled steps, then the profiled steps'
device time by kernel name, the device busy share, the busy time with
overlapping kernels' intervals merged and the kernels per step
(``profiling.py``: markers, whole-count retry).  Needs a CUDA card.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from clusterfusion_tpu_torch.config import LlamaConfig  # noqa: E402
from clusterfusion_tpu_torch.models.generation import Llama  # noqa: E402
from clusterfusion_tpu_torch.runtime import ServingEngine  # noqa: E402
from profile_torch_decode import show  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = LlamaConfig.llama2_7b()
    eng = Llama.synthetic(cfg, seed=0, device="cuda")
    text = "Serving many users at once on one card, page by page. " * 12
    prompts = [eng.tokenizer.encode(text[:n - 1], bos=True, eos=False)
               for n in (32, 64, 128, 200, 256, 300, 400, 512)]
    for impl in ("batched", "fused"):
        srv = ServingEngine(eng.params, cfg, page_size=16, num_pages=200,
                            max_batch=8, step_impl=impl)
        for i, p in enumerate(prompts):
            srv.submit(i, p, 40, temperature=0.0)
        for _ in range(4):                   # admission, prefill, warm steps
            srv.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            srv.step()
        torch.cuda.synchronize()
        print(f"{impl}: {(time.perf_counter() - t0) * 200:.3f} ms per step "
              "(unprofiled wall, 5 steps)")
        show(f"{impl} step (B=8, contexts 40..521), per step", 5, srv.step,
             top=14)
    return 0


if __name__ == "__main__":
    sys.exit(main())
