"""Where the time goes in the port's DeepSeek-V2-Lite decode, on one card.

    python3 scripts/profile_torch_deepseek.py

For ``DeepSeekConfig(max_seq_len=4096)`` (dense FFN, 27 layers) with random
weights (seed 0) after a 128-token prompt, prints: the prefill's first and
warm wall times; ``decode_loop`` ms per step over 63 steps (twice, before
any profiler runs in the process); ``decode_step`` repeated at one position
(the step alone, without the loop's argmax); the host's time by Python
function over 20 steps (``cProfile``; a ctypes call's C time counts in
its caller); the device time by kernel and the device busy share over 8
steps (``torch.profiler``; also the busy time with the overlapping kernels'
intervals merged); and ``decode_loop`` again after the profiler
has run.  Needs a CUDA card.
"""

from __future__ import annotations

import cProfile
import pstats
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from clusterfusion_tpu_torch.config import DeepSeekConfig  # noqa: E402
from clusterfusion_tpu_torch.models import deepseek as ds  # noqa: E402
import profiling  # noqa: E402

PROMPT = [(i * 37 + 11) % 102400 for i in range(128)]


def loop_ms(p, cache, cfg, steps=63):
    """ms per step of ``decode_loop`` over ``steps`` tokens after PROMPT."""
    ds.decode_loop(p, cache, 5, len(PROMPT), cfg, n_steps=4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds.decode_loop(p, cache, 5, len(PROMPT), cfg, n_steps=steps)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    cfg = DeepSeekConfig(max_seq_len=4096)
    p = ds.init_params(cfg, seed=0, device=dev)
    for label in ("first", "warm"):
        cache = ds.init_cache(cfg, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ds.prefill(p, cache, PROMPT, cfg)
        torch.cuda.synchronize()
        print(f"prefill {len(PROMPT)} tokens ({label}): "
              f"{(time.perf_counter() - t0) * 1e3:.2f} ms wall")
    for i in (1, 2):
        print(f"decode_loop, run {i}, no profiler yet: "
              f"{loop_ms(p, cache, cfg):.3f} ms/step")

    rope = ds.full_rope_table(cfg, dev)
    tok = torch.tensor(5, device=dev)

    def step():
        ds.decode_step(p, cache, tok, len(PROMPT), cfg, rope=rope)

    for _ in range(5):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        step()
    torch.cuda.synchronize()
    print(f"decode_step at one position: "
          f"{(time.perf_counter() - t0) * 1e3 / 20:.3f} ms/step")

    prof = cProfile.Profile()
    prof.enable()
    for _ in range(20):
        step()
    torch.cuda.synchronize()
    prof.disable()
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:10]
    print("host time by function over 20 steps (cProfile, own time):")
    for (fname, line, func), (_, ncalls, tottime, _, _) in rows:
        print(f"  {tottime * 1e6 / 20:9.1f} us/step {ncalls / 20:6.1f}x  "
              f"{Path(fname).name}:{line}({func})")

    ev, wall = profiling.profile_calls(step, 8)
    total = sum(b - a for a, b, _ in ev) / 1e3 / 8
    print(f"decode step: device {total:.4f} ms over {wall:.4f} ms wall "
          f"(profiled; busy {100 * total / wall:.1f} %); busy with the "
          f"overlapping kernels' intervals merged "
          f"{profiling.busy_ms(ev) / 8:.4f} ms per step; "
          f"{len(ev) / 8:g} kernels per step")
    for name, ms, n in profiling.by_kernel(ev, 8):
        print(f"  {ms:9.4f} ms {n:6.1f}x  {name[:90]}")
    for i in (1, 2):
        print(f"decode_loop, run {i}, after the profiler: "
              f"{loop_ms(p, cache, cfg):.3f} ms/step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
