"""Does ``torch.profiler`` keep every kernel event, and what makes it lose
them?  Counts the kernel events of profiles of 8 calls of kernel 5
(``fused_ffn`` at DeepSeek-V2-Lite width, one launch a call), each call
sequence between two marker kernels (``torch.cuda._sleep``, left out) of
1000 cycles, as ``scripts/profiling.py`` brackets its calls, or of 20 ms,
the first ended before the calls start.  Stages: a fresh process in each
of the profiler's two set-ups (device activity only, host + device) with
and without a garbage collection first; after device timing by events
behind a spin kernel (``chip_smoke.queued_ms``); after one CUDA graph is
captured and replayed; with ``--age S``, every 15 s of a process kept busy
for S seconds, device activity only (short and long markers) against host
+ device.  Prints one line a stage and set-up with the events each profile
saw (8 is whole).

    python3 scripts/profiler_events.py              # ~1 min on a card
    python3 scripts/profiler_events.py --age 300    # ~6 min
"""

from __future__ import annotations

import gc
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
import profiling  # noqa: E402

REPS, PROFILES = 8, 3
T0 = time.perf_counter()


def long_marked(fn) -> None:
    """``REPS`` calls between two 20 ms markers, the first ended before the
    calls start."""
    torch.cuda._sleep(40_000_000)
    torch.cuda.synchronize()
    for _ in range(REPS):
        fn()
    torch.cuda._sleep(40_000_000)
    torch.cuda.synchronize()


def counts(fn, cuda_only: bool = True, collect: bool = True,
           profiles: int = PROFILES, long: bool = False):
    """Kernel events (markers left out) seen by each of ``profiles``
    profiles of ``REPS`` calls, taken once each, no retry."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] if cuda_only else \
        [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(profiles):
        if collect:
            gc.collect()
        with profile(activities=acts) as prof:
            if long:
                long_marked(fn)
            else:
                profiling._marked_calls(fn, REPS)
        seen.append(len(profiling.kernel_events(prof)))
    return seen


def graph_ms(fn, n: int = 20) -> float:
    """Device ms a call: one replay of a CUDA graph of ``n`` calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(n):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def say(**kv) -> None:
    print("[profiler_events] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def stage(name, fn):
    for cuda_only in (True, False):
        for collect in (False, True):
            say(stage=name, activities="cuda" if cuda_only else "cpu+cuda",
                gc=collect, markers="short",
                events_per_profile=counts(fn, cuda_only, collect), whole=REPS)


def main() -> int:
    if not torch.cuda.is_available():
        print("profiler_events: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from clusterfusion_tpu_torch.ops import ffn
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    hid, f, L = 2048, 11264, 2

    def rnd(*shape, s=0.02):
        return (s * torch.randn(shape, generator=gen, device=dev)).bfloat16()

    x, res = rnd(1, hid, s=1.0), rnd(1, hid, s=1.0)
    norm, w13, w2 = rnd(L, hid, s=1.0), rnd(L, 2, hid, f), rnd(L, f, hid)
    call = lambda: ffn.fused_ffn(x, res, norm, w13, w2, eps=1e-6,  # noqa: E731
                                 layer_id=1)
    call()
    torch.cuda.synchronize()
    stage("fresh", call)
    say(queued_ms=f"{chip_smoke.queued_ms(call):.4f}")
    stage("after_queued_ms", call)
    say(graph_ms=f"{graph_ms(call):.4f}")
    stage("after_cuda_graph", call)
    say(queued_ms_after_graph=f"{chip_smoke.queued_ms(call):.4f}")
    age = float(sys.argv[sys.argv.index("--age") + 1]) \
        if "--age" in sys.argv else 0.0
    next_at = 0.0
    while time.perf_counter() - T0 < age:
        for _ in range(500):
            call()
        torch.cuda.synchronize()
        now = time.perf_counter() - T0
        if now >= next_at:
            say(stage="aged", process_s=f"{now:.0f}",
                cuda=counts(call, profiles=2),
                cuda_long_markers=counts(call, profiles=2, long=True),
                cpu_cuda=counts(call, False, False, profiles=2), whole=REPS)
            next_at = now + 15.0
    return 0


if __name__ == "__main__":
    sys.exit(main())
