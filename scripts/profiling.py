"""Device-time readings from ``torch.profiler`` for ``chip_smoke.py`` and the
port's profile scripts, in one copy.

On the card's torch a profile now and then loses its first or last device
event, or all of them, which reads a time low by one kernel.  So every
profile here brackets its calls between two marker kernels
(``torch.cuda._sleep``; left out of every reading), so that a lost edge
event is a marker's, and is taken again (up to ``attempts`` times in all)
when its kernels are not a whole number per call.

    import profiling
    ms = profiling.device_ms(fn, reps=20)            # kernels' own time
    busy, span, own, by_pass, launches = profiling.timeline_by_pass(
        fn, (("gemv", "rows_gemv_kernel"), ...))

Scripts put their own directory on ``sys.path`` and ``import profiling``,
so that a script run against an older unpacked tree (``--tree``, or from
its directory) still reads its profiles this way.  Needs a CUDA card when
called; imports nothing but torch.
"""

from __future__ import annotations

import time

import torch

MARKER = "spin_kernel"     # torch.cuda._sleep's kernel
LOSSY = 3                  # profiles that lost events before giving up


class LostEvents(AssertionError):
    """No profile of the calls saw a whole number of kernels per call."""


def note(**kv) -> None:
    print("[profiler] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def _marked_calls(fn, reps: int, before=None) -> None:
    """``reps`` calls of ``fn`` (each after ``before``, if given) between
    two marker kernels, then a synchronisation."""
    torch.cuda._sleep(1000)
    for _ in range(reps):
        if before is not None:
            before()
        fn()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def kernel_events(prof, keep=None, streams: bool = False):
    """(start µs, end µs, name) of a profile's device events in start
    order, the markers left out, and only those whose name ``keep``
    accepts when it is given; with ``streams``, the CUDA stream fourth."""
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  + ((e.device_resource_id,) if streams else ())
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and MARKER not in e.name
                  and (keep is None or keep(e.name)))


def profile_calls(fn, reps: int, *, before=None, keep=None,
                  attempts: int = 8, warmup: int = 1, streams: bool = False,
                  whole: bool = False):
    """Profile ``reps`` calls of ``fn`` (``before`` runs ahead of each and,
    with ``keep``, its kernels are left out by name).  Returns (events,
    profiled wall ms per call): the kernels of the first profile whose
    count is a whole number per call, or, after ``LOSSY`` profiles that
    lost events, of the last one with a note (with ``whole``,
    ``LostEvents`` instead: a profile that lost events reads low).  A
    profile that saw no device event at all is taken again after a pause
    that doubles from 0.25 s up to 2 s (on the card's torch, three empty
    profiles in a row ended two of four ``chip_smoke.py`` runs of one
    call).  Host and device activity are traced: on the card's torch a
    profile of device activity alone loses more kernel events the older
    the process (none in its first half minute, all 8 calls of kernel 5
    from about 2.5 minutes), and no retry brings them back; with host
    activity too, about half the late profiles still see every event
    (``scripts/profiler_events.py --age``)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    lost = 0
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _marked_calls(fn, reps, before)
            wall = (time.perf_counter() - t0) * 1e3 / reps
        ev = kernel_events(prof, keep, streams)
        is_whole = bool(ev) and len(ev) % reps == 0
        lost += bool(ev) and not is_whole
        if is_whole or (ev and (attempt == attempts or lost == LOSSY)):
            if not is_whole:
                note(events_not_whole_per_call=len(ev), reps=reps)
                if whole:
                    raise LostEvents(f"{attempt} profiles of {reps} calls "
                                     "lost kernel events")
            if attempt > 1:
                note(device_events_on_attempt=attempt)
            return ev, wall
        if not ev and attempt < attempts:
            time.sleep(min(0.25 * 2 ** (attempt - 1), 2.0))
    raise LostEvents(f"the profiler saw no device time in {attempts} "
                     "profiles")


def device_ms(fn, reps: int = 20, attempts: int = 5,
              whole: bool = False) -> float:
    """Mean device time in ms of all kernels one call of ``fn`` launches
    (their own durations summed; the host's time between launches
    excluded).  ``whole``: as ``profile_calls`` takes it."""
    ev, _ = profile_calls(fn, reps, attempts=attempts, whole=whole)
    return sum(b - a for a, b, _ in ev) / 1e3 / reps


def busy_ms(ev) -> float:
    """Device busy ms of events: the union of their intervals (kernels
    launched with programmatic dependent launch overlap, so their own
    durations add up to more than the time they took)."""
    busy, end = 0.0, None
    for start, stop, _ in ev:
        if end is None or start > end:
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy / 1e3


def by_kernel(ev, reps: int, top: int = 12):
    """[(name, device ms per call, launches per call)] of events, the
    largest first, at most ``top``."""
    rows = {}
    for start, stop, name in ev:
        ms, n = rows.get(name, (0.0, 0))
        rows[name] = (ms + (stop - start) / 1e3, n + 1)
    out = sorted(((k, ms / reps, n / reps) for k, (ms, n) in rows.items()),
                 key=lambda r: -r[1])
    return out[:top]


def charged(ev):
    """[(start, stop, name, charged µs)]: each kernel charged from the end
    of the kernels before it to its own end (the time the call advanced
    while it was the last to finish), so the charges add up to the busy
    time."""
    out, end = [], ev[0][0] if ev else 0.0
    for start, stop, name in ev:
        c = stop - max(start, end) if stop > end else 0.0
        end = max(end, stop)
        out.append((start, stop, name, c))
    return out


# The passes of a tp decode step's kernels, by kernel name: kernel 7's
# (the ring GEMVs: mode 5's O and down projections, which push their sums
# to the ranks, and the LM head's product, which pushes its vocab shard
# for the logits' gather; the down projection, the others; the split and
# merge passes, the norms, mode 5's norms that wait for a reduce, and the
# gather's wait), kernels 13 and 14 standalone, kernels 6 and 2; then the
# int8 instances of the ring GEMV (kernel 7's int8 mode 5 and its others).
TP_STEP_PASSES = (("gemv_o_push", "ring_gemv_kernel<false, 1>"),
                  ("gemv_down_push", "ring_gemv_kernel<true, 1>"),
                  ("gemv_lm_push", "ring_gemv_kernel<false, 2>"),
                  ("gather_wait", "gather_wait_kernel"),
                  ("gemv_down", "ring_gemv_kernel<true"),
                  ("gemv", "ring_gemv_kernel"), ("split", "attn_split_kernel"),
                  ("merge", "attn_merge_kernel"),
                  ("reduce_norm", "resnorm_reduce_kernel"),
                  ("norm", "resnorm_kernel"), ("kernels13_14", "comm_kernel"),
                  ("kernel6", "decoder_layer_kernel"),
                  ("kernel2", "rmsnorm_kernel"),
                  ("gemv8_o_push", "ring_gemv8_kernel<false, 1>"),
                  ("gemv8_down_push", "ring_gemv8_kernel<true, 1>"),
                  ("gemv8_lm_push", "ring_gemv8_kernel<false, 2>"),
                  ("gemv8", "ring_gemv8_kernel"))


def breakdown(ev, reps: int, passes):
    """Per call of a profile of ``reps`` calls (``profile_calls`` events),
    by pass (``passes``: (label, substring of the kernel's name); the rest
    "other"): the ms charged as ``charged`` says, the kernels' own ms and
    their launches."""
    rows = {k: [0.0, 0.0, 0] for k, _ in passes}
    rows["other"] = [0.0, 0.0, 0]
    for start, stop, name, c in charged(ev):
        k = next((k for k, key in passes if key in name), "other")
        rows[k][0] += c
        rows[k][1] += stop - start
        rows[k][2] += 1
    per = 1e3 * reps            # µs over reps -> ms per call
    return {k: (c / per, own / per, n / reps) for k, (c, own, n) in rows.items()}


def timeline_by_pass(fn, passes, reps: int = 8):
    """``reps`` profiled calls of ``fn``, per call: the device's busy time,
    the span from the first kernel's start to the last one's end, the sum
    of the kernels' own durations, and the busy time and launches by pass
    (``breakdown``).  Kernels launched with programmatic dependent launch
    start while the one before them runs and wait inside, so each is
    charged only as ``charged`` says, and the passes add up to the busy
    time."""
    ev, _ = profile_calls(fn, reps)
    rows = breakdown(ev, reps, passes)
    span = (ev[-1][1] - ev[0][0]) / (1e3 * reps)
    return (sum(c for c, _, _ in rows.values()), span,
            sum(own for _, own, _ in rows.values()),
            {k: c for k, (c, _, _) in rows.items()},
            {k: n for k, (_, _, n) in rows.items()})


def short_name(name: str) -> str:
    """A kernel's name without its namespace, return type and parameters,
    its template arguments kept, spaces taken out."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    return name.replace("void ", "", 1).replace(" ", "")[:60]


def timeline(ev, first: int, n: int):
    """Kernels ``first`` .. ``first + n - 1`` of a profile's events, as
    lines: the stream (events taken with ``streams``), start and end in µs
    from the first of them, length, and the kernel's short name."""
    rows = ev[first:first + n]
    t0 = rows[0][0] if rows else 0.0
    return [(f"stream={r[3]} " if len(r) > 3 else "")
            + f"start_us={r[0] - t0:.1f} end_us={r[1] - t0:.1f} "
            f"us={r[1] - r[0]:.1f} kernel={short_name(r[2])}" for r in rows]
