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

Where one differs it then runs both libraries' forward on the card, as
serving calls it (no lse), at the five serving shapes of ``SERVING``:
their outputs must agree bit for bit, and each pair is timed in turns
(``chip_smoke.interleaved_ms``: 5 rounds of 20 launches, medians).  A
library that exports no ``repro_flash_attention_abi`` is called without
the lse argument, as its commit's wrapper called it.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import (hopper_resources, interleaved_ms, nvidia_smi,  # noqa: E402
                        sass_functions)
from repro_torch.kernels import build, flash  # noqa: E402

SOURCE = Path("src/repro_torch/csrc/flash_attn.cu")
SASS_KERNEL = re.compile(r"flash_fwd_wgmma_kernelILi(\d+)ELb(\d)ELb(\d)E")
# K3's serving shapes, one prefill (B = 1), bf16, causal: (name, S, H, KVH,
# hd, scale, softcap, window, prefix) -- starcoder2's, gemma2's local layer,
# paligemma's prefix, deepseek-moe's and zamba2's shared block
SERVING = (("starcoder2-3b", 2048, 24, 2, 128, 128 ** -0.5, 0.0, 0, 0),
           ("gemma2-2b window", 6144, 8, 4, 256, 0.0625, 50.0, 4096, 0),
           ("paligemma-3b prefix", 512, 8, 1, 256, 256 ** -0.5, 0.0, 0, 256),
           ("deepseek-moe-16b", 2048, 16, 16, 128, 128 ** -0.5, 0.0, 0, 0),
           ("zamba2-2.7b", 2048, 32, 32, 80, 80 ** -0.5, 0.0, 0, 0))


def sass_by_kernel(lib: Path) -> dict[tuple, list[str]]:
    """Each Hopper instantiation's SASS lines (``chip_smoke.sass_functions``),
    keyed (hd, causal, softcap)."""
    out = {}
    for name, lines in sass_functions(lib).items():
        m = SASS_KERNEL.search(name)
        if m:
            out[tuple(int(g) for g in m.groups())] = lines
    return out


def forward_call(lib: Path, q, k, v, out, shape):
    """A call of ``repro_flash_attention`` from library ``lib`` as serving
    makes it: with a null lse, or none where the library takes none."""
    import torch

    name, s, h, kvh, hd, scale, cap, window, prefix = shape
    dll = ctypes.CDLL(str(lib))
    with_lse = hasattr(dll, "repro_flash_attention_abi")
    fn = dll.repro_flash_attention
    fn.argtypes = flash.FWD_ARGTYPES if with_lse else flash.FWD_ARGTYPES[:-2] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    args = ([x.data_ptr() for x in (q, k, v, out)] + [1, s, s, h, kvh, hd, 2, scale, cap, 1,
                                                     window, prefix]
            + [None] * with_lse + [torch.cuda.current_stream().cuda_stream])

    def call():
        code = fn(*args)
        if code:
            raise RuntimeError(f"{lib.name}: CUDA error {code} at {name}")
    return call


def time_forward(libs: dict) -> None:
    """Both libraries' forward at the serving shapes: outputs bit for bit
    equal, then timed in turns."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    print(f"[time] {nvidia_smi()}")
    for shape in SERVING:
        name, s, h, kvh, hd = shape[:5]
        q = torch.randn(1, s, h, hd, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(1, s, kvh, hd, generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        outs = {which: torch.empty_like(q) for which in libs}
        calls = {which: forward_call(libs[which], q, k, v, outs[which], shape)
                 for which in libs}
        for call in calls.values():
            call()
        torch.cuda.synchronize()
        if not torch.equal(outs["parent"], outs["change"]):
            raise AssertionError(f"the two forwards differ at {name}")
        ms = interleaved_ms(calls)
        print(f"[time {name} S={s} H={h} KVH={kvh} hd={hd}] outputs equal; parent "
              f"{ms['parent']:.4f} ms, change {ms['change']:.4f} ms "
              f"({ms['change'] / ms['parent'] - 1:+.2%})")


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
    if differ:
        time_forward(libs)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
