#!/usr/bin/env python3
"""Per-device dot flops and collective bytes of the port's dry run
against the reference's ``analyze_hlo``, on the same smoke programs over a
(2, 2) data x model mesh.

    PYTHONPATH=src python tools/dryrun_flops.py [--cases dense_train,moe_train]

The port's side runs in this process over a fake process group of 4 ranks
(``repro_torch.launch.program_stats``); the reference's compiles the same
cell (its ``launch.specs.build_cell`` at the smoke config and a small
shape) in a subprocess that forces 4 CPU host devices, and walks its HLO.
Prints one JSON object: per case, both dot-flop counts and their ratio,
and each side's collective result bytes by kind (DTensor's collectives
against the ones XLA chose: they need not agree, and no bound holds them);
the reference's side can also give its per-device slice of a leaf sharded
over two mesh axes (``index_shape``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import textwrap
from typing import Optional

#: name -> (arch, kind, global batch, sequence length): the smoke programs
CASES = {
    "dense_train": ("mistral-nemo-12b", "train", 4, 32),
    "dense_prefill": ("mistral-nemo-12b", "prefill", 4, 32),
    "moe_train": ("deepseek-v2-lite-16b", "train", 4, 32),
    "moe_prefill": ("deepseek-v2-lite-16b", "prefill", 4, 32),
}

_REFERENCE = textwrap.dedent("""
    import json, sys
    import jax, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec
    import repro.launch.specs as S
    from repro.configs import ShapeSpec, get_config
    from repro.launch.hlo_stats import analyze_hlo
    from repro.parallel.sharding import axis_rules
    assert jax.device_count() == 4, jax.devices()
    S.get_config = lambda a: get_config(a, smoke=True)
    cases, index_shape = json.loads(sys.argv[1]), json.loads(sys.argv[2])
    out = {}
    mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2), ("data", "model"))
    for name, (arch, kind, B, L) in cases.items():
        S.SHAPES = {name: ShapeSpec(name, L, B, kind)}
        with mesh, axis_rules(mesh) as rules:
            cell = S.build_cell(arch, name, rules)
            hlo = jax.jit(cell.fn).lower(*cell.args).compile().as_text()
        st = analyze_hlo(hlo)
        out[name] = st.dot_flops
        out["collectives"] = dict(out.get("collectives", {}),
                                  **{name: dict(st.coll_bytes)})
    if index_shape:
        pod = Mesh(np.asarray(jax.devices()).reshape(2, 2), ("pod", "data"))
        sh = NamedSharding(pod, PartitionSpec(("pod", "data"), None))
        idx = sh.devices_indices_map(tuple(index_shape))
        flat = list(pod.devices.reshape(-1))
        out["indices"] = [[idx[d][0].start, idx[d][0].stop] for d in flat]
    print(json.dumps(out))
""")


def start_reference(cases: dict, index_shape=None) -> subprocess.Popen:
    """Start the reference's side (see :func:`reference_flops`) in a
    subprocess with 4 host devices; :func:`reference_result` waits."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(root, "src")]
                   + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    return subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, json.dumps(cases),
         json.dumps(index_shape)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def reference_result(proc: subprocess.Popen, timeout: int = 560) -> dict:
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
    if proc.returncode:
        raise RuntimeError(out[-2000:] + err[-4000:])
    return json.loads(out.strip().splitlines()[-1])


def reference_flops(cases: dict, index_shape=None) -> dict:
    """The reference's per-device dot flops of ``cases`` (and, with
    ``index_shape``, the row slice [start, stop) of each device, in mesh
    order, of a leaf at ``P(("pod", "data"), None)`` on a (2, 2) mesh of
    axes ("pod", "data")), from a subprocess with 4 host devices."""
    return reference_result(start_reference(cases, index_shape))


def port_flops(cases: dict, collectives: Optional[dict] = None) -> dict:
    """The port's per-device dot flops of ``cases``: each cell built by
    ``launch.specs.build_cell`` at the smoke config and run once over a
    fake process group of 4 ranks (torn down after). ``collectives``, when
    given, takes each case's collective result bytes by kind."""
    import numpy as np
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.mesh import init_fake_process_group
    from repro_torch.launch.program_stats import Counter, fake_safe_dtensor
    from repro_torch.launch.specs import build_cell
    from repro_torch.parallel.sharding import (Mesh, axis_rules,
                                               mixed_with_dtensors)

    init_fake_process_group(4)
    out = {}
    try:
        mesh = Mesh(np.full((2, 2), "cpu", dtype=object), ("data", "model"))
        for name, (arch, kind, B, L) in cases.items():
            with axis_rules(mesh) as rules, fake_safe_dtensor(), \
                    FakeTensorMode(allow_non_fake_inputs=True):
                cell = build_cell(arch + "@smoke",
                                  ShapeSpec(name, L, B, kind), rules)
                counter = Counter()
                with counter, mixed_with_dtensors():
                    cell.fn(*cell.args)
            out[name] = counter.stats.dot_flops
            if collectives is not None:
                collectives[name] = dict(counter.stats.coll_bytes)
    finally:
        torch.distributed.destroy_process_group()
    return out


def main() -> int:
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default=",".join(CASES))
    args = ap.parse_args()
    cases = {k: CASES[k] for k in args.cases.split(",")}
    proc = start_reference(cases)
    coll = {}
    port = port_flops(cases, coll)
    ref = reference_result(proc)
    print(json.dumps({k: {"port": port[k], "reference": ref[k],
                          "ratio": port[k] / ref[k],
                          "collective_bytes": {
                              "port": coll[k],
                              "reference": ref["collectives"][k]}}
                      for k in cases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
