"""Where the time goes in the port's Llama-2-7B bf16 main path, on one card.

    python3 scripts/profile_torch_decode.py

Prints, for random weights (seed 0): the decode step's device time by
kernel name over 5 steps at pos 600 (``torch.profiler``), the device busy
share of those steps, the same for 5 speculative verify calls of 5 rows at
pos 600 (``verify_step``, kernel 8), and a 512-token prefill's first and
warm wall times with its device time by kernel name; each profile with
its kernels per call (``profiling.py``: markers, whole-count retry).
Needs a CUDA card.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import profiling  # noqa: E402
from clusterfusion_tpu_torch.config import LlamaConfig  # noqa: E402
from clusterfusion_tpu_torch.models import llama as model  # noqa: E402
from clusterfusion_tpu_torch.models import speculative as spec  # noqa: E402
from clusterfusion_tpu_torch.models.generation import Llama  # noqa: E402


def profiled(fn, reps, top=12):
    """(device ms per call, busy ms per call, kernels per call, profiled
    wall ms per call, [(name, ms per call, launches per call)]) of ``reps``
    calls of ``fn`` (``profiling.profile_calls``: markers, whole-count
    retry)."""
    ev, wall = profiling.profile_calls(fn, reps)
    total = sum(b - a for a, b, _ in ev) / 1e3 / reps
    return (total, profiling.busy_ms(ev) / reps, len(ev) / reps, wall,
            profiling.by_kernel(ev, reps, top))


def show(title, reps, fn, top=12):
    total, busy, n, wall, rows = profiled(fn, reps, top)
    print(f"{title}: device {total:.4f} ms per call over {wall:.3f} ms "
          f"profiled wall (busy {100 * total / wall:.1f} %); busy with the "
          f"overlapping kernels' intervals merged {busy:.4f} ms; "
          f"{n:g} kernels per call")
    for name, ms, k in rows:
        print(f"  {ms:9.4f} ms {k:6g}x  {name[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    cfg = LlamaConfig.llama2_7b()
    eng = Llama.synthetic(cfg, seed=0, device=dev)
    p = eng.params

    # decode: 5 fused steps at pos 600 over a random-filled cache
    pos = 600
    kc, vc = model.init_cache(cfg, max_seq=1024, device=dev)
    kc[:, :, :pos].normal_()
    vc[:, :, :pos].normal_()
    for _ in range(2):
        model.decode_step(p, kc, vc, 7, pos, cfg)
    show("decode (pos 600), per step", 5,
         lambda: model.decode_step(p, kc, vc, 7, pos, cfg))

    # speculative verify: 5 n=5 verify calls at pos 600 (n_draft 4)
    n = 5
    vt = list(range(11, 11 + n))
    for _ in range(2):
        spec.verify_step(p, kc, vc, vt, pos, cfg)
    show(f"verify n={n} (pos 600), per call", 5,
         lambda: spec.verify_step(p, kc, vc, vt, pos, cfg))

    # prefill: first call, then warm, then the warm call's breakdown
    toks = list(range(3, 515))
    for label in ("first", "warm"):
        kc, vc = model.init_cache(cfg, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(p, kc, vc, toks, cfg)
        torch.cuda.synchronize()
        print(f"prefill 512 tokens ({label}): "
              f"{(time.perf_counter() - t0) * 1e3:.2f} ms wall")
    show("prefill 512 tokens (warm, profiled)", 1,
         lambda: model.prefill(p, kc, vc, toks, cfg))
    return 0


if __name__ == "__main__":
    sys.exit(main())
