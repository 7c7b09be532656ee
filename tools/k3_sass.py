#!/usr/bin/env python3
"""K3's Hopper-kernel SASS in this checkout against another commit's.

    git archive <commit> src/repro_torch/csrc | tar -x -C build/parent
    python3 tools/k3_sass.py --parent build/parent     # from the repository root

Needs nvcc and cuobjdump (the CUDA toolkit), no card.  Builds
``csrc/flash_attn.cu`` of the parent directory and of this checkout with
``kernels.build``'s nvcc flags, both at once, into ``OUT``; logs each Hopper
instantiation's registers and spills in this checkout, and any nvcc warning
or performance note; then compares ``cuobjdump -sass`` of every
``flash_fwd_wgmma_kernel`` instantiation that both libraries have,
instruction by instruction with their encodings (symbol names and
cuobjdump's column padding aside), one line per instantiation, and writes
the differing lines to ``OUT/sass_<hd>_<causal>_<softcap>.diff``.  Exits 1
when an instantiation differs, so a change meant for one head width shows
whether it moved the others.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import hopper_resources  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

SOURCE = Path("src/repro_torch/csrc/flash_attn.cu")
SASS_KERNEL = re.compile(r"flash_fwd_wgmma_kernelILi(\d+)ELb(\d)ELb(\d)E")


def sass_by_kernel(lib: Path) -> dict[tuple, list[str]]:
    """Each Hopper instantiation's SASS lines (instructions and their
    encodings, runs of blanks made one), keyed (hd, causal, softcap), the
    function's name line dropped."""
    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out, key = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            m = SASS_KERNEL.search(line)
            key = tuple(int(g) for g in m.groups()) if m else None
            if key:
                out[key] = []
        elif key and line.strip():
            out[key].append(" ".join(line.split()))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="unpacked sources of the commit to compare with")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "k3_sass",
                    help="directory for the libraries, nvcc logs and SASS differences")
    args = ap.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    libs = {"parent": args.out / "parent.so", "change": args.out / "change.so"}
    procs = {"parent": build.start_nvcc(args.parent / SOURCE, libs["parent"]),
             "change": build.start_nvcc(ROOT / SOURCE, libs["change"])}
    failed = False
    for name, proc in procs.items():      # wait for both before raising
        log_text, _ = proc.communicate()
        (args.out / f"{name}.log").write_text(log_text)
        if proc.returncode != 0:
            print(f"nvcc failed for the {name}'s {SOURCE}:\n{log_text}", file=sys.stderr)
            failed = True
            continue
        for line in log_text.splitlines():
            if re.search(r"warning|Performance Loss", line, re.I):
                print(f"[build {name}] {line.strip()}")
        if name == "change":
            for kern, regs, spill in hopper_resources(log_text):
                print(f"[build change] {kern}: {regs} registers, {spill} bytes spilled")
    if failed:
        return 1

    sass_p, sass_c = sass_by_kernel(libs["parent"]), sass_by_kernel(libs["change"])
    differ = 0
    for key in sorted(set(sass_p) & set(sass_c)):
        a, b = sass_p[key], sass_c[key]
        tag = "hd={} causal={} softcap={}".format(*key)
        changed = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
        differ += bool(changed)
        if changed:   # the first differing lines, by position
            diff = [f"{i}\n- {x}\n+ {y}" for i, (x, y) in enumerate(zip(a, b)) if x != y]
            (args.out / "sass_{}_{}_{}.diff".format(*key)).write_text("\n".join(diff[:200]))
        print(f"[sass {tag}] parent {len(a)} lines, change {len(b)} lines: "
              + ("identical" if not changed else f"{changed} lines differ"))
    only = ["hd={} causal={} softcap={}".format(*k) for k in sorted(set(sass_c) - set(sass_p))]
    print(f"[sass] only in the change: {only}")
    print(f"[sass] {differ} of {len(set(sass_p) & set(sass_c))} common instantiations differ")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
