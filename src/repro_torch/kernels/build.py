"""Build the CUDA kernels of ``csrc/`` with ``nvcc`` and load them with ctypes.

Every ``*.cu`` file under ``repro_torch/csrc`` exposes a plain C launch
function that takes raw device pointers and a ``cudaStream_t`` and returns
``cudaGetLastError()``. :func:`library` compiles the sources for ``sm_90a``
(one ``nvcc`` per source, all started together), links them into one shared
library under ``build/repro_torch_kernels/`` at the repository root (named by
a hash of the sources, the ``*.cuh`` headers they include and the flags, so an
unchanged tree reuses it and an edited header rebuilds), and loads it
once per process. Nothing is compiled when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

__all__ = ["library", "library_path", "BUILD_DIR", "CSRC", "build_seconds",
           "build_log"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
#: per-source extra flags. systolic_eval and round_fused round every product
#: and sum on its own (no fused multiply-add contraction) so they match their
#: plain versions' op-by-op float32 rounding; pairdist accumulates with FMA on
#: purpose.
EXTRA_FLAGS = {"systolic_eval.cu": ["-fmad=false"],
               "round_fused.cu": ["-fmad=false"]}

#: ctypes signature of each launch function: (argtypes) -> int error code
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "systolic_eval_launch": [_P, _P, _P] + [_I] * 7 + [_P],
    "systolic_eval_multi_launch": [_P] * 4 + [_I] * 8 + [_P],
    "pairdist_launch": [_P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    "pareto_count_launch": [_P, _P] + [_I] * 8 + [_P],
    "round_fused_launch": [_P] * 15 + [_I] * 14 + [_P],
    # K5: (pointers, B, Sq, Sk, q_offset, H, KH, dqk, dv, window, causal
    # [, splits], scale, stream)
    "flash_attn_launch": [_P] * 4 + [_I] * 10 + [_F, _P],
    "flash_attn_tc_launch": [_P] * 6 + [_I] * 10 + [_F, _P],
    "flash_attn_bwd_launch": [_P] * 13 + [_I] * 11 + [_F, _P],
    "flash_attn_tc_smem_bytes": [_I, _I],
    "flash_attn_bwd_smem_bytes": [_I, _I, _I],
}

_LIB: ctypes.CDLL | None = None
_BUILD_SECONDS: float | None = None
#: held while the library is built and loaded: concurrent first callers
#: (a flow pool's worker threads) wait for one build instead of racing
_LIB_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("repro_torch: nvcc not found (set CUDA_HOME); the "
                           "CUDA kernels cannot be built")
    return found


def _sources() -> list[Path]:
    """The compiled sources: every ``*.cu`` under ``CSRC``."""
    return sorted(CSRC.glob("*.cu"))


def _headers() -> list[Path]:
    """The headers the sources include (``*.cuh`` under ``CSRC``)."""
    return sorted(CSRC.glob("*.cuh"))


def _tag(sources: list[Path], headers: list[Path] = ()) -> str:
    """A hash of the sources, the headers and the flags."""
    h = hashlib.sha1()
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
        h.update(" ".join(EXTRA_FLAGS.get(src.name, [])).encode())
    for hdr in headers:
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    h.update(" ".join(ARCH + COMMON_FLAGS).encode())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands concurrently and return their joined output; raise
    with the compiler's output if any fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], False
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        logs.append(f"$ {' '.join(cmd)}\n{out}")
        failed = failed or p.returncode != 0
    if failed:
        raise RuntimeError("repro_torch: kernel build failed\n" + "\n".join(logs))
    return "\n".join(logs)


def _build(target: Path) -> None:
    """Compile every source (``-Xptxas -v`` reports registers and spills)
    and link; the compiler output is kept beside the library as ``.log``."""
    nvcc = _nvcc()
    sources = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in sources]
        log = _run_all([[nvcc, *ARCH, *COMMON_FLAGS,
                         *EXTRA_FLAGS.get(s.name, []), "-Xptxas", "-v", "-c",
                         str(s), "-o", str(o)]
                        for s, o in zip(sources, objs)])
        tmp_so = Path(tmp) / target.name
        log += _run_all([[nvcc, *ARCH, "-shared", *map(str, objs), "-o",
                          str(tmp_so)]])
        target.with_suffix(".log").write_text(log)
        os.replace(tmp_so, target)  # atomic: a reader never sees half a file


def build_log() -> str:
    """The compiler output of the library :func:`library` loaded."""
    return library_path().with_suffix(".log").read_text()


def library_path() -> Path:
    """Where the library of the current sources is (or will be) built."""
    return BUILD_DIR / \
        f"librepro_torch_kernels_{_tag(_sources(), _headers())}.so"


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use: once a process, also
    when several threads call it first at the same time."""
    global _LIB, _BUILD_SECONDS
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        if _LIB is None:
            t0 = time.perf_counter()
            target = library_path()
            if not target.exists():
                _build(target)
            lib = ctypes.CDLL(str(target))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _BUILD_SECONDS = time.perf_counter() - t0
            _LIB = lib
    return _LIB


def build_seconds() -> float | None:
    """Wall seconds the first :func:`library` call took (build + load)."""
    return _BUILD_SECONDS


def check(err: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"repro_torch: {name} launch failed with CUDA "
                           f"error {err}")


#: the device each thread has made current for a launch (``stream_ptr``)
_CURRENT = threading.local()


def stream_ptr(t) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``t``'s
    device, with that device made current in the calling thread first
    (once a thread, and again if the thread's device changed): a launch
    from a thread that has made no CUDA call through PyTorch (a worker
    thread, or autograd's device thread when K5's backward is the first
    node it runs) fails with ``cudaErrorInvalidValue`` on the H100, every
    time, and succeeds after ``torch.cuda.set_device``."""
    import torch

    if getattr(_CURRENT, "device", None) != t.device or \
            torch.cuda.current_device() != t.device.index:
        torch.cuda.set_device(t.device)
        _CURRENT.device = t.device
    return torch.cuda.current_stream(t.device).cuda_stream
