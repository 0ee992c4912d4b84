"""Multi-pod dry-run: trace every (arch x shape x mesh) cell's step on the
production mesh, one rank's view, with nothing allocated.

Port of ``repro/launch/dryrun.py``. The reference forces 512 host devices
(``xla_force_host_platform_device_count``), lowers and compiles each
cell's jitted step against abstract inputs and reads XLA's memory and
cost analyses and its HLO. The port has no compiler: the process starts a
``fake`` process group of 512 ranks (collectives return at once, nothing
moves), lays the production mesh ((16, 16) over its first 256 ranks, or
(2, 16, 16)) over it on the ``cpu`` device type, makes each argument a
DTensor laid out by the cell's sharding plan over fake local shards
(``FakeTensorMode``: shapes and dtypes, no storage), and runs the step
once under ``parallel/hlo_analysis.py:analyze_step``, which counts what
rank 0 executes. On the ``cpu`` device type attention runs its plain
version (models/attention.py), which performs the same products as the
kernel and computes nothing here.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm_135m \
        --shape train_4k [--multi-pod] [--out artifacts/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Each cell writes the reference's JSON record. ``lower_s`` is the trace's
seconds; ``memory_analysis`` holds one rank's argument bytes (the local
shards of parameters, optimizer state, batch and caches) and the traced
peak of the tensors the step makes; ``cost_analysis`` and
``hlo_analysis`` come from the analysis. Keys with no counterpart are
listed under ``no_counterpart`` with the reason. A cell whose trace fails
is written with ``"status": "error"`` and its error, as the reference
does, and keeps its argument bytes.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import (ARCHS, SHAPES, SKIPPED_CELLS,
                                 applicable_shapes, get_config)
from repro_torch.configs.base import MeshConfig, TrainConfig
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.launch.steps import (default_microbatches, make_decode_step,
                                      make_prefill_step, make_train_step)
from repro_torch.parallel.act_sharding import activation_rules
from repro_torch.parallel.hlo_analysis import analyze_step
from repro_torch.parallel.sharding import (is_sharding, make_plan,
                                           sanitize_shardings)

WORLD = 512                      # the multi-pod mesh's ranks

NO_COUNTERPART = {
    "compile_s": "no compiler: the step runs eagerly; lower_s is the "
                 "trace's seconds",
    "memory_analysis.output_size_in_bytes": "no compiled program: outputs "
                                            "are among the traced tensors",
    "memory_analysis.alias_size_in_bytes": "no buffer donation in eager "
                                           "PyTorch",
    "memory_analysis.temp_size_in_bytes": "peak_traced_bytes: the most "
                                          "bytes of tensors the step made "
                                          "alive at once",
    "memory_analysis.generated_code_size_in_bytes": "no generated code",
    "cost_analysis.transcendentals": "not counted: only matmul-class "
                                     "operations are",
    "hlo_analysis.trip_counts": "Python loops run every layer: no loop "
                                "body is counted once",
}


def cell_name(arch: str, shape: str, multi_pod: bool) -> str:
    return f"{arch}__{shape}__{'pod2' if multi_pod else 'pod1'}"


def start_fake_group(world: int = WORLD) -> None:
    """A ``fake`` process group of ``world`` ranks in this process (this
    process is rank 0), unless one of at least that size runs."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() < world:
            raise RuntimeError(f"a process group of "
                               f"{dist.get_world_size()} ranks runs; the "
                               f"dry-run needs {world}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _fake_dtensors(args, shardings):
    """Each meta tensor of ``args`` as a DTensor laid out by the
    NamedSharding at its place, its local shard a fake tensor (call under
    ``FakeTensorMode``); -> (tree, rank 0's local bytes of each
    top-level argument)."""
    from torch.distributed.tensor import DTensor

    def walk(a, sh, acc):
        if is_sharding(sh):
            local = torch.empty(sh.shard_shape(a.shape), dtype=a.dtype)
            acc[0] += local.numel() * local.element_size()
            return DTensor.from_local(local, sh.mesh, sh.placements,
                                      run_check=False, shape=a.shape,
                                      stride=a.stride())
        if isinstance(a, dict):
            return {k: walk(v, sh[k], acc) for k, v in a.items()}
        if isinstance(a, tuple):
            items = [walk(x, s, acc) for x, s in zip(a, sh)]
            return type(a)(*items) if hasattr(a, "_fields") \
                else tuple(items)
        return a

    out, sizes = [], []
    for a, sh in zip(args, shardings):
        acc = [0]
        out.append(walk(a, sh, acc))
        sizes.append(acc[0])
    return tuple(out), sizes


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Path, overrides: dict = None,
             microbatches: int = 0) -> dict:
    t_start = time.time()
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = SHAPES[shape_name]
    mesh_cfg = MeshConfig(multi_pod=multi_pod)
    start_fake_group()
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    mode = "train" if shape.kind == "train" else "serve"
    plan = make_plan(cfg, shape, mesh, mesh_cfg, mode)
    tcfg = TrainConfig(microbatches=microbatches
                       or default_microbatches(cfg, shape))

    kind, args = input_specs(cfg, shape, tcfg)
    if kind == "train":
        step = make_train_step(cfg, tcfg)
        in_shardings = (plan.param_shardings(cfg), plan.opt_shardings(cfg),
                        plan.batch_shardings(cfg, kind))
        groups = ("params", "opt_state", "batch")
    elif kind == "prefill":
        step = make_prefill_step(cfg, shape)
        in_shardings = (plan.param_shardings(cfg),
                        plan.batch_shardings(cfg, kind))
        groups = ("params", "batch")
    else:
        step = make_decode_step(cfg, shape)
        in_shardings = (plan.param_shardings(cfg), plan.token_sharding(),
                        plan.cache_shardings(cfg), plan.named())
        groups = ("params", "token", "caches", "pos")
    in_shardings = sanitize_shardings(in_shardings, args, plan.axis_sizes)

    record = {
        "cell": cell_name(arch, shape_name, multi_pod),
        "arch": arch, "shape": shape_name,
        "mesh": list(mesh_cfg.shape), "axes": list(mesh_cfg.axes),
        "kind": kind, "microbatches": tcfg.microbatches,
        "status": "running",
    }
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    try:
        with FakeTensorMode():
            dargs, sizes = _fake_dtensors(args, in_shardings)
            # one rank's arguments, kept when the trace fails
            record["memory_analysis"] = {
                "argument_size_in_bytes": sum(sizes),
                **{f"{g}_bytes": n for g, n in zip(groups, sizes)}}
            t0 = time.time()
            with activation_rules(plan.act_rules, plan.axis_sizes, mesh), \
                    implicit_replication():
                st = analyze_step(step, *dargs)
            record["lower_s"] = round(time.time() - t0, 2)
        record["memory_analysis"]["peak_traced_bytes"] = st.peak_bytes
        record["cost_analysis"] = {"flops": st.dot_flops,
                                   "bytes accessed": st.hbm_bytes}
        record["hlo_analysis"] = {
            "dot_flops_per_device": st.dot_flops,
            "hbm_bytes_per_device": st.hbm_bytes,
            "flash_bytes_per_device": st.flash_bytes,
            "collective_bytes_per_device": st.bytes_by_kind,
            "collective_counts": st.count_by_kind,
            "trip_counts": st.trip_counts,
            "local_ops": st.ops,
        }
        record["no_counterpart"] = NO_COUNTERPART
        record["status"] = "ok"
        print(f"[dryrun] {record['cell']}: OK (trace {record['lower_s']}s)")
        print(f"  memory_analysis: {record['memory_analysis']}")
        print(f"  cost_analysis: {record['cost_analysis']}")
    except Exception as e:  # noqa: BLE001 — record failures as artifacts
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
        print(f"[dryrun] {record['cell']}: FAILED {record['error'][:200]}")
    record["total_s"] = round(time.time() - t_start, 2)

    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{record['cell']}.json"
    path.write_text(json.dumps(record, indent=1, default=str))
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)
    out = Path(args.out)

    cells = []
    if args.all:
        for arch in ARCHS:
            for shape in applicable_shapes(arch):
                for mp in (False, True):
                    cells.append((arch, shape, mp))
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        meshes = [False, True] if args.both_meshes else [args.multi_pod]
        cells = [(args.arch, args.shape, mp) for mp in meshes]

    ok = failed = skipped = 0
    for arch, shape, mp in cells:
        path = out / f"{cell_name(arch, shape, mp)}.json"
        if args.skip_existing and path.exists():
            prev = json.loads(path.read_text())
            if prev.get("status") == "ok":
                skipped += 1
                continue
        rec = run_cell(arch, shape, mp, out, microbatches=args.microbatches)
        ok += rec["status"] == "ok"
        failed += rec["status"] != "ok"
    print(f"[dryrun] done: {ok} ok, {failed} failed, {skipped} skipped; "
          f"{len(SKIPPED_CELLS)} cells skipped by design")


if __name__ == "__main__":
    main()
