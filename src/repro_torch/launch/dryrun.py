"""Multi-pod dry-run: trace every (arch x shape x mesh) pair on a fake
process group and count what each device would run.

Counterpart of ``repro.launch.dryrun``.  For each pair this proves the
sharding config is coherent (every operation of the step has a DTensor
sharding rule, every collective is accounted) and gives the roofline
terms of one device:

  compute_s    = flops_per_device / 989e12      (H100 dense bf16 peak)
  memory_s     = bytes_per_device / 3.35e12     (HBM3 bandwidth)
  collective_s = collective_bytes_per_device / 450e9   (NVLink 4, one
                 direction)

Each pair starts torch's ``fake`` process group of 256 (16x16) or 512
(2x16x16) ranks, which runs no collective and touches no device, builds
the step's inputs as ``meta`` tensors (``launch.specs``), lays them out
as DTensors by the ported shardings (``launch.sharding``) and runs the
step under ``launch.hlo_cost.CostCounter``.  Numbers are derived from
operation counts and the datasheet peaks, not measured.  ``memory`` is
this device's argument and output shards and the peak of the tensors the
counter tracked; ``trace_s`` is the host's seconds for the traced run.

Usage (a process of its own: it owns the default process group):
  python -m repro_torch.launch.dryrun --arch all --shape all --mesh both \\
      --out runs/dryrun_torch.json
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import signal
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.configs.base import FIRMConfig
from repro_torch.launch import hlo_cost
from repro_torch.launch import sharding as sh
from repro_torch.launch import specs as specs_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import (HBM_BW, ICI_BW_PER_LINK, MULTI_POD,
                                     PEAK_FLOPS_BF16, SINGLE_POD,
                                     AbstractMesh, make_production_mesh)


# a pair whose traced step has not finished after this many seconds is
# recorded as an error and the run moves on (DTensor plans some layouts
# of the 3-D mesh for far longer than any other pair takes)
PAIR_TIMEOUT_S = 600


class PairTimeout(Exception):
    pass


@contextlib.contextmanager
def _time_limit(seconds: int):
    """Raise ``PairTimeout`` in this (the main) thread after ``seconds``."""
    def expire(signum, frame):
        raise PairTimeout(f"the traced step did not finish within "
                          f"{seconds} s")
    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


@contextlib.contextmanager
def fake_world(n: int):
    """A default process group of ``n`` ranks on torch's ``fake`` backend
    (this process is rank 0), destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group exists already; the "
                           "dry-run needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _shardings_for(kind, cfg, shape, mesh, spec, multi_pod, fc):
    tp = cfg.tensor_parallel
    # pure DP (tp off): the batch rides BOTH mesh axes — the model axis
    # must not duplicate work
    data_axes = ("data",) if tp else ("data", "model")
    if multi_pod:
        data_axes = ("pod",) + data_axes
    if kind == "train":
        if multi_pod:
            state_sh = sh.param_shardings(spec["state"], mesh,
                                          extra_leading=1,
                                          leading_axis="pod",
                                          tensor_parallel=tp)
            b_axes = ("data",) if tp else ("data", "model")
            batch_sh = sh.batch_shardings(spec["batch"], mesh,
                                          extra_leading_axes=("pod", None),
                                          data_axes=b_axes)
            aux_sh = (sh.batch_shardings(spec["aux"], mesh,
                                         extra_leading_axes=("pod", None),
                                         data_axes=b_axes)
                      if spec["aux"] is not None else None)
        else:
            state_sh = sh.param_shardings(spec["state"], mesh,
                                          tensor_parallel=tp)
            batch_sh = sh.batch_shardings(spec["batch"], mesh,
                                          data_axes=data_axes)
            aux_sh = (sh.batch_shardings(spec["aux"], mesh,
                                         data_axes=data_axes)
                      if spec["aux"] is not None else None)
        frozen_sh = sh.param_shardings(spec["frozen"], mesh,
                                       tensor_parallel=tp)
        return (state_sh, frozen_sh, batch_sh, aux_sh)
    if kind == "prefill":
        p_sh = sh.param_shardings(spec["params"], mesh, tensor_parallel=tp)
        t_sh = sh.batch_shardings(spec["tokens"], mesh, data_axes=data_axes)
        a_sh = (sh.batch_shardings(spec["aux"], mesh, data_axes=data_axes)
                if spec["aux"] is not None else None)
        return (p_sh, t_sh, a_sh)
    p_sh = sh.param_shardings(spec["params"], mesh, tensor_parallel=tp)
    c_sh = sh.cache_shardings(cfg, spec["cache"], mesh,
                              shape.global_batch, data_axes=data_axes)
    t_sh = sh.batch_shardings(spec["token"], mesh, data_axes=data_axes)
    return (p_sh, c_sh, t_sh)


def _multi_pod_train_spec(cfg, fc, shape, n_pods=2):
    """Pod-stacked ClientState + (pods, K, B/pods, ...) batches."""
    per_pod = dataclasses.replace(shape,
                                  global_batch=max(1, shape.global_batch
                                                   // n_pods))
    base = specs_lib.input_specs(cfg, per_pod, fc)

    def stack(tree, lead):
        return sh.tree_map(lambda s: specs_lib.sds(lead + tuple(s.shape),
                                                   s.dtype), tree)

    return {
        "kind": "train",
        "state": stack(base["state"], (n_pods,)),
        "frozen": base["frozen"],
        "batch": stack(base["batch"], (n_pods, fc.local_steps)),
        "aux": (stack(base["aux"], (n_pods, fc.local_steps))
                if base["aux"] is not None else None),
    }


def _parse_overrides(pairs):
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        if v in ("True", "False"):
            out[k] = v == "True"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                try:
                    out[k] = float(v)
                except ValueError:
                    out[k] = v
    return out


def _local_bytes(tree) -> int:
    """Bytes of this device's shards of a tree's tensors, each storage
    once."""
    seen, total = set(), 0
    for t in sh.tree_leaves(tree):
        if not isinstance(t, torch.Tensor):
            continue
        t = t.to_local() if hasattr(t, "to_local") else t
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            total += t.numel() * t.element_size()
    return total


def run_pair(arch: str, shape_name: str, multi_pod: bool,
             fc: FIRMConfig, overrides=None) -> dict:
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = INPUT_SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "status": "ok"}
    if shape_name == "long_500k" and not cfg.subquadratic:
        rec["status"] = "skipped"
        rec["reason"] = "full-attention arch; long_500k needs sub-quadratic" \
            " attention (DESIGN §4)"
        return rec
    n_dev = AbstractMesh(*(MULTI_POD if multi_pod else SINGLE_POD)).size
    with fake_world(n_dev):
        mesh = make_production_mesh(multi_pod=multi_pod)
        if multi_pod and shape.kind == "train":
            spec = _multi_pod_train_spec(cfg, fc, shape)
            fn = steps_lib.make_federated_round(cfg, fc, n_pods=2)
            args = (spec["state"], spec["frozen"], spec["batch"],
                    spec["aux"])
        else:
            spec = specs_lib.input_specs(cfg, shape, fc)
            fn, args = steps_lib.step_and_args(cfg, shape.kind, fc, spec)
        # the reference's specs, less the head splits DTensor cannot view
        in_sh = tuple(sh.head_split_shardings(cfg, s) for s in _shardings_for(
            spec["kind"], cfg, shape, mesh, spec, multi_pod, fc))
        args = tuple(sh.place(a, s) for a, s in zip(args, in_sh))
        t0 = time.time()
        with _time_limit(PAIR_TIMEOUT_S), \
                hlo_cost.CostCounter(mesh) as counter:
            out = fn(*args)
        trace_s = time.time() - t0
        walked = counter.totals()
        memory = {"argument_bytes": _local_bytes(args),
                  "output_bytes": _local_bytes(out),
                  "temp_bytes": walked["peak_bytes"]}
        del out, args
    coll = {"bytes_by_op": {k: v["bytes"] for k, v
                            in walked["collectives"].items()},
            "counts": {k: v["count"] for k, v
                       in walked["collectives"].items()},
            "total_bytes": walked["collective_bytes"],
            "bytes_by_mesh_dim": walked["collective_bytes_by_dim"],
            "by_mesh_dim": walked["collectives_by_dim"]}
    flops_dev = float(walked["flops"])
    bytes_dev = float(walked["bytes"])
    coll_dev = float(walked["collective_bytes"])
    # MODEL_FLOPS = 6 N D (6 N_active D for MoE)
    n_active = cfg.param_count(active_only=True)
    dec_len, _ = specs_lib.seq_lens(cfg, shape)
    tokens = shape.global_batch * (dec_len if shape.kind != "decode" else 1)
    fwd_bwd = 1.0 if shape.kind != "train" else 3.0
    model_flops = 2.0 * n_active * tokens * fwd_bwd  # 2ND fwd, 6ND train
    if shape.kind == "train":
        model_flops *= fc.local_steps if multi_pod else 1
    rec.update({
        "devices": n_dev,
        "trace_s": round(trace_s, 2),
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll_dev,
        "collectives": coll,
        "kernel_calls": walked["kernels"],
        "memory": memory,
        "roofline": {
            "compute_s": flops_dev / PEAK_FLOPS_BF16,
            "memory_s": bytes_dev / HBM_BW,
            "collective_s": coll_dev / ICI_BW_PER_LINK,
        },
        "model_flops_total": model_flops,
        "model_flops_per_device": model_flops / n_dev,
        "useful_flop_ratio": (model_flops / n_dev) / max(flops_dev, 1.0),
        "params_total": cfg.param_count(),
        "params_active": n_active,
    })
    r = rec["roofline"]
    rec["dominant_term"] = max(r, key=r.get)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="runs/dryrun_torch.json")
    ap.add_argument("--objectives", type=int, default=2)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--override", action="append", default=[],
                    help="ModelConfig field override, e.g. mlstm_chunk=64")
    args = ap.parse_args(argv)
    overrides = _parse_overrides(args.override)

    archs = list(ASSIGNED_ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    fc = FIRMConfig(n_objectives=args.objectives,
                    local_steps=args.local_steps)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results
            if r.get("status") in ("ok", "skipped")}

    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                key = (arch, shape_name, "2x16x16" if mp else "16x16")
                if key in done:
                    print(f"[skip-done] {key}")
                    continue
                print(f"[dryrun] {key} ...", flush=True)
                try:
                    rec = run_pair(arch, shape_name, mp, fc, overrides)
                    if overrides:
                        rec["overrides"] = overrides
                except Exception as e:  # noqa: BLE001  (recorded, reported)
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": key[2], "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                results = [r for r in results
                           if (r["arch"], r["shape"], r["mesh"]) != key]
                results.append(rec)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    extra = (f" trace={rec['trace_s']}s "
                             f"dom={rec['dominant_term']}")
                elif status == "error":
                    extra = " " + rec["error"][:200]
                print(f"[{status}] {key}{extra}", flush=True)

    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"-> {args.out}")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
