"""Kernels 13 and 14 (the all-reduce and all-gather kernels of
``csrc/collective.cu``) beside NCCL over every card of one machine,
repeated: the first part of ``chip_smoke.py``'s phase 16 (each run checks
both kernels against their plain versions over 64 calls, then times them,
NCCL and the plain versions on the tp step's shapes, the slowest rank's
median of 5 batches of 100 calls), ``--runs`` times in one set of rank
processes, then the median and spread of each time over the runs.

    python3 scripts/retime_torch_collectives.py [--runs 3]

Needs two cards or more with peer access.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def rank_main(rank, world, tmp, hbm, runs):
    import torch.distributed as dist
    from clusterfusion_tpu_torch import parallel as par
    from clusterfusion_tpu_torch.config import MeshConfig
    from clusterfusion_tpu_torch.parallel import collective as col
    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            world_size=world, rank=rank)
    try:
        mesh = par.build_mesh(MeshConfig(tp=world))
        outs = [cs._multicard_collectives(rank, world, dev, mesh, hbm)
                for _ in range(runs)]
        dist.barrier()
    finally:
        col.release_communicators()
        dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(tmp, "runs.json"), "w") as f:
            json.dump(outs, f)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    count = torch.cuda.device_count()
    world = cs._multicard_world(count)
    if world < 2:
        print(f"needs two cards or more (found {count})", file=sys.stderr)
        return 1
    cs.phase_card()
    cs.phase_build()
    hbm = cs.card_rates(torch.cuda.get_device_name(0))[0]
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(rank_main, args=(world, tmp, hbm, args.runs), nprocs=world,
                 join=True)
        with open(os.path.join(tmp, "runs.json")) as f:
            runs = json.load(f)
    for key in ("all_reduce_ms", "all_reduce_nccl_ms", "all_gather_ms",
                "all_gather_nccl_ms"):
        vals = [r[key] for r in runs]
        print(f"[retime] {key} median={statistics.median(vals):.5f} "
              f"min={min(vals):.5f} max={max(vals):.5f} runs={len(vals)}",
              flush=True)
    for k, n in (("all_reduce", "all_reduce_nccl"),
                 ("all_gather", "all_gather_nccl")):
        ratios = [r[f"{k}_ms"] / r[f"{n}_ms"] for r in runs]
        print(f"[retime] {k}_over_nccl per run="
              + ",".join(f"{x:.3f}" for x in ratios), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
