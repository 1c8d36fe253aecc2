"""No module of the benchmark loads JAX or the JAX package (compared by
whole top-level names: the port's ``repro_torch`` begins with ``repro``),
and the reference loads nothing of the program."""
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _loaded(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path[:0] = [%r, %r]\n%s\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"
         % (str(ROOT), str(ROOT / "src"), code)],
        capture_output=True, text=True, check=True, cwd=ROOT)
    return set(out.stdout.split())


def _modules(sub: str) -> list[str]:
    return sorted(f"portbench.{sub}.{p.stem}" for p in (PKG / sub).glob("*.py")
                  if p.stem != "__init__")


def test_harness_drivers_metrics_reference_load_no_jax():
    code = "\n".join(
        ["import importlib", "from portbench import bench, run, calibrate, faults",
         "from portbench import program, sizes, trace, weights"]
        + [f"importlib.import_module({m!r})" for m in _modules("drivers")
           + _modules("reference")]
        + [f"bench.reader({p.stem!r})" for p in sorted((PKG / "metrics").glob("*.py"))]
        + ["import repro_torch.serve, repro_torch.train, repro_torch.models"])
    loaded = _loaded(code)
    assert "repro_torch" in loaded and "portbench" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded("\n".join(f"import {m}" for m in _modules("reference")))
    assert "portbench" in loaded
    assert not loaded & (FORBIDDEN | {"repro_torch"}), loaded
