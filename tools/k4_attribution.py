#!/usr/bin/env python3
"""Where K4 ``round_fused``'s time goes: the kernel's device time with one
phase cut out at a time.

    python3 tools/k4_attribution.py [--out results.json]

Builds variants of ``src/repro_torch/csrc/round_fused.cu`` with ``nvcc``
(each with one phase removed by a text edit of the source: the MES terms,
the moments, the triangles' divisions, the sum over the rows above a panel,
the RBF cross term, the V tile's load, the scaled pool, all panels, L's
staging, the last block's ticket; or the kernel returning at its start or
right after its once-per-block staging) into ``build/k4_variants/``, and
times each at ``chip_smoke.py``'s K4 shapes with the shipped launch plan.
A variant computes wrong values; only its time means anything: the full
kernel's time less a variant's is what that phase costs on the critical
path. Prints the card's name and power limit and one line per variant.
Needs a CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

#: variant name -> (text in round_fused.cu, its replacement)
CUTS = {
    "no_mes": ("      for (int sb = 0; sb < S; sb += G) {",
               "      af = mean_d + std_d;\n"
               "      for (int sb = 0; sb < 0; sb += G) {"),
    "no_moments": ("        for (; q + 8 <= qs; q += 8) {",
                   "        q = P;\n        for (; q + 8 <= qs; q += 8) {"),
    "no_division": (
        "            if (t == tq) v = acc[kq] / Lrow[kq * lsk + q];",
        "            if (t == tq) v = acc[kq];"),
    "no_rows_above": ("          int q = 0;\n          if (lvec) {",
                      "          int q = r0;\n          if (lvec) {"),
    "no_cross": ("          int f = 1;\n          if (d >= 4) {",
                 "          int f = d;\n          if (0) {"),
    "no_v_tile": ("              cp_async4(dst + (size_t)cc * vst + q,",
                  "              if (0) cp_async4(dst + (size_t)cc * vst + q,"),
    "no_scaled_pool": ("        scale_block(p.w * p.ct, d,",
                       "        if (0) scale_block(p.w * p.ct, d,"),
    "no_panels": ("      const int np = (B + p.R - 1) / p.R;  // panels",
                  "      const int np = 0;"),
    "no_L_staging": ("    stage_L(sL, a, 0, m, B, s0, B, Ps);", ""),
    "no_ticket": ("    last_block = atomicAdd(a.ticket, 1u) == gridDim.x - 1;",
                  "    last_block = 0;"),
    "return_at_start": ("  const int tid = threadIdx.x;",
                        "  const int tid = threadIdx.x;\n  if (m > 0) return;"),
    "return_after_staging": (
        "  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {",
        "  if (m > 0) return;\n"
        "  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {"),
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the times as JSON here")
    args = ap.parse_args()

    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        print("k4_attribution: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import round_fused as K4

    src = (build.CSRC / "round_fused.cu").read_text()
    variants = {"full": src}
    for name, (old, new) in CUTS.items():
        if src.count(old) != 1:
            raise AssertionError(f"{name}: its anchor is not in the source "
                                 f"once: {old!r}")
        variants[name] = src.replace(old, new)
    out_dir = build.BUILD_DIR.parent / "k4_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cmds = []
    for name, text in variants.items():
        (out_dir / f"{name}.cu").write_text(text)
        cmds.append([build._nvcc(), *build.ARCH, *build.COMMON_FLAGS,
                     *build.EXTRA_FLAGS["round_fused.cu"], "-shared",
                     str(out_dir / f"{name}.cu"), "-o",
                     str(out_dir / f"{name}.so")])
    build._run_all(cmds)

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    problems = []
    for nc, C, P, s0 in cs.K4_SHAPES:
        t = cs.k4_problem(dev, nc, C, 26, P, 3, 10, seed=nc * C + P + s0)
        problems.append(((nc, C, P, s0), [t[k] for k in cs.K4_ARGS]))
    print("variant              " + " ".join(
        f"{str(list(shape)):>22s}" for shape, _ in problems))
    times = {}
    library = build.library()
    for name in variants:
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        lib.round_fused_launch.argtypes = build.SIGNATURES["round_fused_launch"]
        lib.round_fused_launch.restype = ctypes.c_int
        build._LIB = lib  # round_select calls build.library()
        row = []
        for (nc, C, P, s0), kargs in problems:
            large = nc * C >= cs.K4_LARGE
            row.append(cs.time_ms(lambda: K4.round_select(*kargs, s0=s0),
                                  reps=3 if large else 10,
                                  repeats=3 if large else 5)[0])
        times[name] = row
        print(f"{name:20s} " + " ".join(f"{x:22.4f}" for x in row),
              flush=True)
    build._LIB = library
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(
            card=card, shapes=[list(s) for s, _ in problems],
            ms=times), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
