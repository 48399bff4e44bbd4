"""What nvcc made of the port's CUDA kernels, on the machine with the card.

    python3 -m raft_tpu_torch.tools.inspect_build [--source NAME ...]

Compiles ``raft_tpu_torch/csrc/<NAME>.cu`` (every source by default)
with the port's flags plus ``-Xptxas -v`` into
``build/raft_tpu_torch/inspect/``, then prints, for each kernel: its
registers, spill bytes and static shared memory as ptxas reports them,
and how many tensor-core instructions (HMMA for ``mma.sync``, HGMMA for
``wgmma``) its SASS holds, from ``cuobjdump -sass``.
"""

from __future__ import annotations

import argparse
import collections
import re
import subprocess
from pathlib import Path

from raft_tpu_torch import _build


def _demangle(names):
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, check=True)
        return dict(zip(names, out.stdout.splitlines()))
    except (OSError, subprocess.CalledProcessError):
        return {n: n for n in names}


def inspect(src: Path, out_dir: Path):
    lib = out_dir / f"lib{src.stem}.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
         str(_build._CSRC), "-o", str(lib), str(src)],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stderr}")
    props, fn = {}, None
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            props[fn] = {}
        elif fn and "spill stores" in line:
            props[fn]["spill_bytes"] = int(re.search(
                r"(\d+) bytes spill stores", line).group(1))
        elif fn and "Used" in line and "registers" in line:
            props[fn]["registers"] = int(re.search(
                r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            props[fn]["smem"] = int(smem.group(1)) if smem else 0
    sass = subprocess.run(
        [str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
        capture_output=True, text=True, check=True).stdout
    mma, fn = collections.Counter(), None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = m.group(1)
        elif fn and re.search(r"\bHG?MMA\b", line):
            mma[fn, "HGMMA" if "HGMMA" in line else "HMMA"] += 1
    names = _demangle(sorted(props))
    for f in sorted(props):
        ops = {kind: n for (g, kind), n in mma.items() if g == f}
        print(f"{src.name}: {names[f][:110]}\n    {props[f]} tensor-core "
              f"instructions {ops or 0}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", nargs="*", default=None)
    args = ap.parse_args(argv)
    out_dir = _build._BUILD_ROOT / "inspect"
    out_dir.mkdir(parents=True, exist_ok=True)
    for src in _build._sources():
        if args.source is None or src.stem in args.source:
            inspect(src, out_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
