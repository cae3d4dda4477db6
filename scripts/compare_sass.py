"""Compare the SASS of the kernels two builds of the port share.

    python3 scripts/compare_sass.py LIB_A LIB_B [--match ring_gemv_kernel]
        [--alias "ring_gemv_kernel<false>=ring_gemv_kernel<false, false>"]

LIB_A and LIB_B are built libraries (``build/clusterfusion_tpu_torch/
libcftorch_*.so``, e.g. of an unpacked older checkout and of this one).
For every kernel of LIB_A whose demangled name holds ``--match``, in every
source file, the script prints whether LIB_B holds it with the same
instructions (``cuobjdump -sass``; addresses and encodings left out) and
the registers of each (``cuobjdump -res-usage``).  A kernel is named by its
source file (the unnamed namespace's name, its hash taken out) and its
demangled name up to the parameter list; ``--alias OLD=NEW`` rewrites a
name of LIB_A into LIB_B's (a kernel that gained a template parameter).
Exits 1 where a kernel of LIB_A differs from its counterpart.  Needs the
CUDA toolkit's ``cuobjdump`` and ``cu++filt`` (or binutils' ``c++filt``).
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys

_NS = re.compile(r"_ZN(\d+)")


def _tool(name: str) -> str:
    return shutil.which(name) or f"/usr/local/cuda/bin/{name}"


def _demangle(names):
    filt = shutil.which("cu++filt") or ("/usr/local/cuda/bin/cu++filt"
                                        if shutil.which("c++filt") is None
                                        else shutil.which("c++filt"))
    out = subprocess.run([filt], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return dict(zip(names, out))


def _file_of(mangled: str) -> str:
    """The source file of a kernel in an unnamed namespace (whose name holds
    a hash of the file's path and one of its contents, both taken out)."""
    m = _NS.match(mangled)
    if not m or "_GLOBAL__N_" not in mangled:
        return ""
    ns = mangled[m.end():m.end() + int(m.group(1))]
    m = re.match(r"_GLOBAL__N__[0-9a-f]+_\d+_(\w+?_cu)", ns)
    return m.group(1) if m else ns


def _name(demangled: str) -> str:
    """A demangled kernel's name with its template arguments, without its
    return type, namespace and parameter list."""
    d = demangled.strip()
    depth, cut = 0, len(d)
    for i in range(len(d) - 1, -1, -1):      # the last top-level "(...)"
        if d[i] == ")":
            depth += 1
        elif d[i] == "(":
            depth -= 1
            if depth == 0:
                cut = i
                break
    d = d[:cut]
    if d.startswith("void "):
        d = d[5:]
    d = d.replace("(bool)0", "false").replace("(bool)1", "true")
    return re.sub(r"^(<unnamed>|\(anonymous namespace\))::", "", d)


def _keys(mangled_names, match):
    dem = _demangle(list(mangled_names))
    keys = {}
    for m in mangled_names:
        d = _name(dem[m])
        if match in d:
            keys[m] = f"{_file_of(m)}:{d}"
    return keys


def sass(lib: str, match: str):
    """{kernel key: [instructions]} of ``lib``'s kernels matching."""
    out = subprocess.run([_tool("cuobjdump"), "-sass", lib],
                         capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;?\s*/\*", line)
        if m and cur is not None:
            funcs[cur].append(m.group(1))
    keys = _keys(funcs, match)
    return {keys[m]: ins for m, ins in funcs.items() if m in keys}


def registers(lib: str, match: str):
    out = subprocess.run([_tool("cuobjdump"), "-res-usage", lib],
                         capture_output=True, text=True, check=True).stdout
    regs, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"REG:(\d+)", line)
        if m and cur is not None:
            regs[cur] = int(m.group(1))
    keys = _keys(regs, match)
    return {keys[m]: r for m, r in regs.items() if m in keys}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("lib_a")
    ap.add_argument("lib_b")
    ap.add_argument("--match", default="ring_gemv_kernel")
    ap.add_argument("--alias", action="append", default=[])
    args = ap.parse_args()
    a, b = sass(args.lib_a, args.match), sass(args.lib_b, args.match)
    ra, rb = registers(args.lib_a, args.match), registers(args.lib_b,
                                                          args.match)
    aliases = [x.split("=", 1) for x in args.alias]
    differing, mapped = 0, set()
    for k in sorted(a):
        kb = k
        for old, new in aliases:
            kb = kb.replace(old, new)
        mapped.add(kb)
        same = kb in b and a[k] == b[kb]
        differing += not same
        print(f"[sass] kernel={k!r} counterpart={kb if kb in b else None!r} "
              f"instructions={len(a[k])}/{len(b.get(kb, []))} same={same} "
              f"registers={ra.get(k)}/{rb.get(kb)}", flush=True)
    for k in sorted(set(b) - mapped):
        print(f"[sass] only_in_b={k!r} instructions={len(b[k])} "
              f"registers={rb.get(k)}", flush=True)
    print(f"[sass] compared={len(a)} differing={differing}", flush=True)
    return 1 if differing else 0


if __name__ == "__main__":
    sys.exit(main())
