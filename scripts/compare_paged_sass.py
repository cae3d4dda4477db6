"""Compare the SASS of kernels 9's and 10's units with an older tree's.

    python3 scripts/compare_paged_sass.py OLD_TREE

OLD_TREE is an unpacked checkout (``git archive``) of an older commit.  The
two units that include ``csrc/paged_attention.cuh`` (``paged_attention.cu``
and ``paged_decoder_layer.cu``) of each tree are built, in parallel, as
``ops/_build.py`` builds them, into small libraries under
``build/paged_sass/``; then ``scripts/compare_sass.py`` compares their
paged kernels (the pool kind appended to their template arguments as
``(int)0``, the bf16 instances), the GEMVs, norms and split passes they
share with the other units.  Needs a CUDA toolkit (nvcc, cuobjdump).
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from clusterfusion_tpu_torch.ops import _build  # noqa: E402

UNITS = ("paged_attention.cu", "paged_decoder_layer.cu")
ALIAS = ["--alias", "false>=false, (int)0>", "--alias", "true>=true, (int)0>"]


def build(tag: str, csrc: Path, libs: dict) -> None:
    src = ROOT / "build" / "paged_sass" / tag / "csrc"
    shutil.rmtree(src.parent, ignore_errors=True)
    src.mkdir(parents=True)
    for p in csrc.glob("*.cuh"):
        shutil.copy(p, src)
    for n in UNITS:
        shutil.copy(csrc / n, src)
    libs[tag] = _build.build(src, src.parent / "lib")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("old_tree")
    args = ap.parse_args()
    libs: dict = {}
    threads = [threading.Thread(target=build, args=a) for a in (
        ("old", Path(args.old_tree) / "clusterfusion_tpu_torch" / "csrc",
         libs), ("this", _build.CSRC, libs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if set(libs) != {"old", "this"}:
        raise RuntimeError("a build failed")
    rc = 0
    for match, extra in (("paged_", ALIAS), ("gemv", []), ("norm", []),
                         ("attn_", [])):
        r = subprocess.run([sys.executable, str(ROOT / "scripts" /
                                                "compare_sass.py"),
                            str(libs["old"]), str(libs["this"]), "--match",
                            match, *extra], capture_output=True, text=True)
        lines = [x for x in r.stdout.splitlines() if x.startswith("[sass]")]
        kernels = [x for x in lines if " kernel=" in x]
        print(f"[paged_sass] match={match} kernels={len(kernels)} "
              f"same={sum('same=True' in x for x in kernels)} "
              f"rc={r.returncode}", flush=True)
        for x in lines:
            if "same=True" not in x:
                print("  ", x[:300])
        rc |= r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
