"""The port stands alone: it imports neither ``jax`` nor anything of
``repro``, and it never runs on the CPU unless asked to."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers that share the
# cores, and torch's per-process thread pools oversubscribe them
torch.set_num_threads(1)

import numpy as np

import repro_torch
from repro_torch import device as tdevice
from repro_torch.core import make_space, soc_tuner
from repro_torch.random import GeneratorDraws
from repro_torch.soc import VLSIFlow

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
PORT_MODULES = sorted(
    "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
    for p in PORT.rglob("*.py") if p.name != "__init__.py")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_import_with_jax_blocked_loads_no_jax_or_repro():
    """Every module of the port imports in a fresh interpreter where any
    ``import jax`` fails, and leaves no ``jax``/``repro`` module loaded."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "flax"), (path, name)


def test_cuda_is_the_default_and_cpu_must_be_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    space = make_space()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdevice.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VLSIFlow(space, "resnet50")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GeneratorDraws(0)
    pool = space.sample(torch.Generator().manual_seed(0), 16).numpy()
    flow = VLSIFlow(space, "resnet50", device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        soc_tuner(space, pool, flow, T=1, n=4, b=2)
    assert flow.calls == 0
    res = soc_tuner(space, pool, flow, T=1, n=4, b=2, gp_steps=2,
                    device="cpu")
    assert len(res.evaluated_rows) == len(set(res.evaluated_rows.tolist()))
    assert np.isfinite(res.y).all()
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_to_run_without_the_card(tmp_path):
    """Without CUDA, and from a directory holding only the script, the smoke
    test exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=_env(), capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(alone)], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_serve_entry_points_need_the_card_unless_asked_for_the_cpu(
        monkeypatch, capsys):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import LM, init, init_cache

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("mistral-nemo-12b@smoke")
    for build in (lambda: LM(cfg), lambda: init_cache(cfg, 1, 8),
                  lambda: init(cfg, torch.Generator()),
                  lambda: serve_cli.main(["--arch", cfg.arch_id])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    assert serve_cli.main(["--arch", cfg.arch_id, "--device", "cpu",
                           "--gen", "3"]) == 0
    assert "generated (4, 3)" in capsys.readouterr().out
