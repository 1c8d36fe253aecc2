#!/usr/bin/env python3
"""Compare the SASS of one CUDA source of the port between two source trees.

    python3 tools/sass_diff.py --tree DIR [--source flash_attn_tc.cu]

Compiles ``src/repro_torch/csrc/<source>`` of this checkout and of the tree
in DIR (e.g. a ``git archive`` of another commit) with
``kernels/build.py``'s flags into cubins (``nvcc -cubin``), dumps both with
``cuobjdump --dump-sass`` and compares each kernel's instructions (their
addresses and encodings stripped). Prints one line a kernel, identical or
not, with its instruction count; exits 1 if a kernel differs or is on one
side only. Needs ``nvcc`` and ``cuobjdump`` (the machine with the card).
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def kernels_sass(tree: Path, source: str, tmp: Path) -> dict[str, list[str]]:
    """{mangled kernel name: its SASS instructions} of one tree's source."""
    from repro_torch.kernels import build

    src = tree / "src" / "repro_torch" / "csrc" / source
    cubin = tmp / f"{abs(hash(str(tree)))}.cubin"
    subprocess.run([build._nvcc(), *build.ARCH, "-std=c++17", "-O3",
                    *build.EXTRA_FLAGS.get(source, []), "-cubin", str(src),
                    "-o", str(cubin)], check=True)
    tool = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "--dump-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            out[cur] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if cur is not None and m:
            out[cur].append(m.group(1))
    return dict(zip(demangle(list(out)), out.values()))


def demangle(names: list[str]) -> list[str]:
    """Names without the file's hash that nvcc puts into an anonymous
    namespace's mangled names (``c++filt``, where it is there)."""
    try:
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    except FileNotFoundError:
        pass
    return [re.sub(r"_INTERNAL_\w+?_cu_[0-9a-f]+(::)?", "", n) for n in names]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True,
                    help="root of the other source tree")
    ap.add_argument("--source", default="flash_attn_tc.cu",
                    help="file under src/repro_torch/csrc")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        mine = kernels_sass(ROOT, args.source, Path(tmp))
        other = kernels_sass(Path(args.tree).resolve(), args.source,
                             Path(tmp))
    same = True
    for name in sorted(set(mine) | set(other)):
        a, b = mine.get(name), other.get(name)
        ok = a is not None and a == b
        same &= ok
        print(f"  {name}: {'identical' if ok else 'DIFFERS'} "
              f"({None if a is None else len(a)} / "
              f"{None if b is None else len(b)} instructions)")
    print(f"sass_diff {args.source}: {len(mine)} kernels here, {len(other)} "
          f"in {args.tree}: {'identical' if same else 'different'}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
