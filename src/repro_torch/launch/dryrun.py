"""Dry run of every (arch x shape) cell on the production meshes, on the
``meta`` device: the port of the reference's ``launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-8b \\
        --shape prefill_32k [--multi-pod] [--policy manual|ppipe]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Where the reference lowers and compiles each cell for 256 (or 512) XLA
devices, the port builds the cell (``launch/specs.py``) on a mesh of a
``fake`` process group of that size (``launch/mesh.py::fake_world``, torn
down after the sweep) and runs its function on ``meta`` tensors: the
outputs must come back with the shapes and dtypes their shardings lay out,
and nothing is computed. ``--policy`` takes the reference's names: one
containing ``skip`` sets the ``causal_skip`` attention mode (the roofline
then counts half the causal score work), one containing ``kvapp`` the
``append`` decode mode. ``--policy manual`` and ``--policy ppipe`` run one
rank's function (``distributed/manual_tp.py``, ``distributed/pp_spmd.py``)
on that rank's ``meta`` shards; the ppipe stage runs at full width, as the
reference leaves tensor parallelism inside a stage to its compiler.

A record holds the roofline (``roofline/analysis.py::analyze`` at the
H100's data-sheet peaks; the collective term from
``analytic.collective_bytes_per_device``, as the port emits no HLO) and
the bytes one device holds: ``arg_bytes`` (params, optimizer state,
caches and inputs, each leaf's shard under its spec) and ``out_bytes``.
Temporary bytes, compile time and code size need a compiler: they are
recorded as null. Records are appended as JSON lines under
``experiments/dryrun_torch/`` at the checkout's root (``--out`` elsewhere).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch

from repro_torch.configs import SHAPES, applicable_shapes, get_config, \
    list_configs
from repro_torch.kernels import ops
from repro_torch.launch.mesh import ensure_world, make_pp_mesh, \
    make_production_mesh
from repro_torch.launch.specs import device_bytes, local_structs, make_cell
from repro_torch.models.common import as_dtype
from repro_torch.roofline import analysis, analytic

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

def _global_outputs(cfg, shape, policy):
    """The global outputs of a pipelined (logits) or manual-TP (logits and
    every layer's K and V) prefill, as ``meta`` tensors."""
    dt = as_dtype(cfg.dtype)
    logits = torch.empty((shape.global_batch, cfg.padded_vocab), dtype=dt,
                         device="meta")
    if "ppipe" in policy:
        return logits
    kv = torch.empty((cfg.n_periods, shape.global_batch, shape.seq_len,
                      cfg.n_kv_heads, cfg.head_dim), dtype=dt, device="meta")
    return logits, {"k": kv, "v": kv}


def _run(fn, args, in_sh, out_sh, want=None, axes=None):
    """``fn`` on the global ``args``, or, given the global outputs ``want``,
    on one rank's shards of ``args`` over the mesh axes ``axes``, whose
    outputs must then be that rank's shards of ``want``. Returns the bytes
    of one device's outputs."""
    out = fn(*(args if want is None else local_structs(args, in_sh, axes)))
    got = [(tuple(t.shape), t.dtype, t.device.type) for t in _leaves(out)]
    if want is not None:
        exp = [(tuple(t.shape), t.dtype, "meta") for t in _leaves(
            local_structs(want, out_sh, axes))]
        if got != exp:
            raise ValueError(f"one rank's outputs {got}, want {exp}")
        out = want
    if any(dev != "meta" for _, _, dev in got):
        raise TypeError(f"dry-run outputs off the meta device: {got}")
    return device_bytes(out, out_sh)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             policy: str = "baseline", verbose: bool = True) -> dict:
    """One cell's record, in the sweep's process group (``fake_world``) or
    in one of its own for the call if none is open. A policy naming
    ``skip`` runs under the ``causal_skip`` attention mode and one naming
    ``kvapp`` under the ``append`` decode mode, as the reference's; both
    modes are put back after the cell. On ``meta`` the decode mode moves
    the trace (the append branch runs) and the attention mode does not
    (flash takes ``mha_reference`` in both, and the roofline reads the
    skip from the policy): it is set so that the modes a cell runs under
    are the reference's, and code that reads ``ops.attention_mode()``
    inside a cell sees the policy's."""
    chips = 512 if multi_pod else 256
    saved = ops.attention_mode(), ops.decode_mode()
    ops.set_attention_mode("causal_skip" if "skip" in policy
                           else "masked_full")
    ops.set_decode_mode("append" if "kvapp" in policy else "scatter")
    try:
        with ensure_world(chips):
            return _run_cell(arch, shape_name, multi_pod, policy, verbose,
                             chips)
    finally:
        ops.set_attention_mode(saved[0])
        ops.set_decode_mode(saved[1])


def _run_cell(arch, shape_name, multi_pod, policy, verbose, chips):
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    data = chips // 16
    t0 = time.time()

    if "ppipe" in policy and shape.kind == "prefill":
        from repro_torch.distributed import pp_spmd
        if not pp_spmd.supports(cfg):
            raise ValueError(f"{arch}: PP-SPMD unsupported")
        mesh = make_pp_mesh(4)
        mesh_name, data = "4x4x16(pp)", 4
        fn, args, in_sh, out_sh, donate = pp_spmd.make_pp_prefill(
            cfg, mesh, shape.global_batch, shape.seq_len)
        local = ("stage", "data")        # full width inside a stage
    elif "manual" in policy and shape.kind == "prefill":
        from repro_torch.distributed import manual_tp
        if not manual_tp.supports(cfg):
            raise ValueError(f"{arch}: manual TP unsupported")
        fn, args, in_sh, out_sh, donate = manual_tp.make_manual_prefill(
            cfg, mesh, shape.global_batch, shape.seq_len)
        local = tuple(mesh.mesh_dim_names)
    else:
        fn, args, in_sh, out_sh, donate = make_cell(cfg, shape, mesh,
                                                    policy=policy)
        local = None
    arg_bytes = device_bytes(args, in_sh)
    with torch.no_grad() if shape.kind != "train" else \
            contextlib.nullcontext():
        out_bytes = _run(fn, args, in_sh, out_sh,
                         None if local is None else
                         _global_outputs(cfg, shape, policy), local)
    t_meta = time.time() - t0

    cm = analytic.collective_bytes_per_device(
        cfg, shape, chips, cfg.size_bytes(), data=data, model=16)
    coll = {"all-reduce": int(cm.allreduce), "all-gather": int(cm.allgather),
            "reduce-scatter": int(cm.reducescatter),
            "all-to-all": int(cm.alltoall), "collective-permute": 0}
    roof = analysis.analyze(arch, shape, mesh_name, chips, {},
                            {"temp_bytes": None, "argument_bytes": arg_bytes},
                            "", cfg, policy=policy, coll_bytes=coll)
    rec = roof.row()
    rec.update({
        "policy": policy,
        "lower_s": round(t_meta, 2), "compile_s": None,
        "temp_bytes": None, "arg_bytes": arg_bytes, "out_bytes": out_bytes,
        "gen_code_bytes": None, "ok": True,
    })
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} on {mesh_name} "
              f"(policy={policy}): OK "
              f"compute={roof.compute_s*1e3:.2f}ms "
              f"memory={roof.memory_s*1e3:.2f}ms "
              f"collective={roof.collective_s*1e3:.2f}ms "
              f"dominant={roof.dominant} "
              f"args/dev={arg_bytes / (1 << 30):.2f}GiB "
              f"meta={t_meta:.1f}s", flush=True)
    return rec


def cells(multi_pod: bool):
    for arch, cfg in sorted(list_configs().items()):
        if arch in ("llama2-7b", "llama2-13b", "opt-6.7b"):
            continue                      # paper models: bench-only
        for shape in applicable_shapes(cfg):
            yield arch, shape.name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--policy", default="baseline")
    ap.add_argument("--out", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="skip cells already recorded")
    args = ap.parse_args(argv)

    out_dir = args.out or os.path.abspath(OUT_DIR)
    os.makedirs(out_dir, exist_ok=True)
    mesh_name = "2x16x16" if args.multi_pod else "16x16"
    out_path = os.path.join(out_dir, f"{mesh_name}_{args.policy}.jsonl")

    done = set()
    if args.resume and os.path.exists(out_path):
        with open(out_path) as f:
            for line in f:
                r = json.loads(line)
                if r.get("ok"):
                    done.add((r["arch"], r["shape"]))

    todo = ([(args.arch, args.shape)] if not args.all
            else list(cells(args.multi_pod)))
    failures = []
    t_sweep = time.time()
    with open(out_path, "a") as f, ensure_world(512 if args.multi_pod
                                                else 256):
        for arch, shape in todo:
            if (arch, shape) in done:
                print(f"[dryrun] skip {arch} x {shape} (done)")
                continue
            try:
                rec = run_cell(arch, shape, args.multi_pod, args.policy)
            except (ValueError, TypeError, KeyError, NotImplementedError,
                    RuntimeError, MemoryError, OSError) as e:
                # a cell that fails to build or run is recorded and the
                # sweep continues; anything else (KeyboardInterrupt,
                # SystemExit, real bugs like NameError) propagates
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                       "policy": args.policy, "ok": False, "error": str(e)}
                failures.append((arch, shape, str(e)))
            f.write(json.dumps(rec) + "\n")
            f.flush()
    print(f"[dryrun] {len(todo)} cells in {time.time() - t_sweep:.1f} s")
    if failures:
        print(f"[dryrun] FAILURES: {failures}")
        raise SystemExit(1)
    print("[dryrun] all cells ran on meta")


if __name__ == "__main__":
    main()
