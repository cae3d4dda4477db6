"""Where the time goes in the port's Llama-2-7B bf16 main path, on one card.

    python3 scripts/profile_torch_decode.py

Prints, for random weights (seed 0): the decode step's device time by
kernel name over 5 steps at pos 600 (``torch.profiler``), the device busy
share of those steps, and a 512-token prefill's first and warm wall times
with its device time by kernel name.  Needs a CUDA card.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from clusterfusion_tpu_torch.config import LlamaConfig  # noqa: E402
from clusterfusion_tpu_torch.models import llama as model  # noqa: E402
from clusterfusion_tpu_torch.models.generation import Llama  # noqa: E402


def by_kernel(prof, top=12):
    """(total device ms, [(name, device ms, calls)]) of a profile."""
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        if t and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.key, t / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows[:top]


def show(title, total, rows, wall_ms=None):
    extra = "" if wall_ms is None else \
        f" over {wall_ms:.3f} ms wall (busy {100 * total / wall_ms:.1f} %)"
    print(f"{title}: device {total:.3f} ms{extra}")
    for name, ms, n in rows:
        print(f"  {ms:9.3f} ms {n:6d}x  {name[:90]}")


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
    for _ in range(3):
        model.decode_step(p, kc, vc, 7, pos, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            model.decode_step(p, kc, vc, 7, pos, cfg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    total, rows = by_kernel(prof)
    show("decode x5 (pos 600)", total, rows, wall)

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
    kc, vc = model.init_cache(cfg, device=dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.prefill(p, kc, vc, toks, cfg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    total, rows = by_kernel(prof)
    show("prefill 512 tokens (warm, profiled)", total, rows, wall)
    return 0


if __name__ == "__main__":
    sys.exit(main())
