"""Dry run: one step of every (arch x shape) cell on the production
meshes, with no devices, to prove memory fit and get roofline terms
under the H100's constants (``launch/mesh.py``).

Each cell's state is built on the ``meta`` device and distributed as
DTensors over the mesh, which sits on PyTorch's fake process group
(this process is rank 0 of 256 or 512).  The step then runs eagerly:
DTensor desugars every op into this rank's local ops and collectives on
``meta`` tensors, ``OpCounter`` counts their FLOPs, bytes and collective
traffic (``launch/op_cost.py``) and the peak of the live local
storages: one device's numbers.

A step's layers are identical, and so are its microbatches: the loops
whose trip counts the reference's ``hlo_cost`` multiplies out.  So each
cell runs at 2 and 3 repeating units of depth (a layer; zamba2: a group
of ``shared_attn_period`` layers and its shared block) and, in training,
2 and 3 microbatches of the cell's size, and every count is extended to
the cell's depth and microbatches along those lines (``_extend``): it is
linear in each.  The peak is linear in the depth from 2 units on (a
prefill's first layer peaks lower than the others) and the same from
the second microbatch on.  ``depth_and_micro`` gives the cell's own.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from typing import Any, Callable

import torch

from ..data import BatchSpec, make_batch_specs
from ..dist import sharding as shd
from ..dist.context import activation_batch_axis, attention_seq_axis
from ..models import registry, transformer
from ..models.registry import leaves
from ..optim import AdamWConfig
from ..train.step import (init_train_state, make_train_step,
                          train_state_shardings, train_state_specs)
from . import op_cost
from . import shapes as shp
from .mesh import (HBM_BW, HBM_PER_CHIP, LINK_BW, NVLINK_BW,
                   PEAK_FLOPS_BF16, make_production_mesh)


def _inputs(mesh, cfg, specs: dict, axis, device) -> dict:
    """The step's inputs as DTensors whose rows are laid over ``axis``:
    shapes only on ``meta``; on a real device token ids below the
    vocabulary, normal features and a mask of about 1 in 10 frames,
    drawn from a generator seeded with 1."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    dims = [mesh.mesh_dim_names.index(a) for a in shd._names(axis)]
    gen = (None if str(device) == "meta"
           else torch.Generator(device=device).manual_seed(1))
    out = {}
    for k, v in specs.items():
        if gen is None:
            t = torch.empty(v.shape, dtype=v.dtype, device="meta")
        elif v.dtype.is_floating_point:
            t = torch.randn(v.shape, generator=gen, device=device).to(v.dtype)
        elif v.dtype == torch.bool:
            t = torch.rand(v.shape, generator=gen, device=device) < 0.1
        else:
            t = torch.randint(0, cfg.vocab_size, v.shape, generator=gen,
                              device=device, dtype=v.dtype)
        rows = [Shard(0) if i in dims and v.shape and mesh.shape[i] > 1
                else Replicate() for i in range(mesh.ndim)]
        out[k] = distribute_tensor(t, mesh, rows, src_data_rank=None)
    return out


def _batch_axis(shape: shp.Shape, micro: int, mesh):
    if shape.kind == "train":
        return shd.batch_axis(mesh, shape.global_batch // micro,
                              shd.RULES_TRAIN)
    return shd.batch_axis(mesh, shape.global_batch, shd.RULES_DECODE)


def cell_batch_axis(arch: str, shape_name: str, mesh):
    """-> (axis, extent) the activation batch dim is sharded over."""
    ax = _batch_axis(shp.SHAPES[shape_name], shp.microbatches_for(arch),
                     mesh)
    return ax, shd._mesh_extent(mesh, ax)


def step_context(mesh, axis) -> contextlib.ExitStack:
    """The contexts a cell's step runs in: the activations' batch over
    ``axis``, ``attn_sp`` over the model axis, plain tensors made inside
    the models taken as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    stack = contextlib.ExitStack()
    stack.enter_context(activation_batch_axis(axis,
                                              shd._mesh_extent(mesh, axis)))
    stack.enter_context(attention_seq_axis(
        "model", shd.mesh_axes(mesh).get("model", 1)))
    stack.enter_context(implicit_replication())
    return stack


def _serve_rules(arch: str, cfg, kind: str, mesh) -> shd.Rules:
    """The reference's serving layouts (``repro.launch.dryrun``)."""
    rules = shd.RULES_DECODE
    if shp.no_tp(arch):
        rules = rules.replace(mlp=(None,), heads=(None,), kv_heads=(None,),
                              head_dim=(None,), vocab=(None,),
                              embed=("data", None))
    model_size = shd.mesh_axes(mesh).get("model", 1)
    if cfg.block in ("attn", "zamba2") and cfg.n_kv_heads % model_size:
        # kv heads that do not divide fall back to head_dim TP, so q
        # matches them there
        rules = rules.replace(heads=(None,), head_dim=("model", None))
        if kind == "prefill":
            # prefill: replicate the (cache-free) kv heads and shard the
            # q heads; where those do not divide either, all of q/k/v
            # take head_dim
            if cfg.n_heads % model_size == 0:
                rules = rules.replace(heads=("model", None),
                                      kv_heads=(None,), head_dim=(None,))
            else:
                rules = rules.replace(heads=(None,), kv_heads=(None,),
                                      head_dim=("model", None))
    return rules


def _at_depth(cfg, units: int):
    """``cfg`` cut to ``units`` repeating units of depth."""
    if cfg.block == "zamba2":
        period = cfg.shared_attn_period
        return cfg.replace(n_layers=units * period + cfg.n_layers % period)
    return cfg.replace(n_layers=units)


def depth_and_micro(arch: str, shape_name: str) -> tuple[int, int]:
    """The cell's repeating units of depth and its microbatches (1
    outside training)."""
    shape = shp.SHAPES[shape_name]
    cfg = registry.get_config(arch)
    units = (cfg.n_layers // cfg.shared_attn_period
             if cfg.block == "zamba2" else cfg.n_layers)
    return units, (shp.microbatches_for(arch) if shape.kind == "train"
                   else 1)


def build_cell(arch: str, shape_name: str, mesh, units: int | None = None,
               micro: int | None = None, *, shape: shp.Shape | None = None,
               cell_micro: int | None = None, device: Any = "meta"
               ) -> tuple[Callable[[], Any], Any, Any]:
    """-> (step, state, cfg): ``step()`` runs the cell's step once on
    the mesh; ``state`` is the tree of its DTensor inputs (parameters,
    optimizer state, cache, batch).  ``units`` cuts the depth
    (``_at_depth``); ``micro`` runs that many microbatches of the cell's
    size (the batch is ``shape.global_batch / cell_micro`` rows a
    microbatch; ``cell_micro`` defaults to the cell's).  ``shape``
    replaces the cell's batch and length; ``device`` other than
    ``meta`` makes real tensors from seeds (the same step, run)."""
    shape = shape or shp.SHAPES[shape_name]
    cfg = shp.configure_for_cell(registry.get_config(arch), shape)
    if units is not None:
        cfg = _at_depth(cfg, units)
    cell_micro = cell_micro or depth_and_micro(arch, shape_name)[1]
    specs = make_batch_specs(cfg, shape.global_batch, shape.seq_len)

    if shape.kind == "train":
        opt = AdamWConfig()
        rules = shd.RULES_TRAIN
        if shp.no_tp(arch):
            # small model: no feature-TP, weights FSDP over data only; the
            # model axis carries sequence parallelism (attn_sp)
            rules = rules.replace(mlp=(None,), heads=(None,),
                                  kv_heads=(None,), head_dim=(None,),
                                  vocab=(None,))
        tree = init_train_state(cfg, opt, device=device).tree()
        st_specs = train_state_specs(cfg)
        st_sh = train_state_shardings(st_specs, tree, mesh, rules)
        tree = shd.distribute(tree, st_specs, mesh, rules)
        rows = shape.global_batch // cell_micro
        micro = micro or cell_micro
        mb_axis = _batch_axis(shape, cell_micro, mesh)
        batch = _inputs(mesh, cfg, {
            k: BatchSpec((rows * micro, *v.shape[1:]), v.dtype)
            for k, v in specs.items()}, mb_axis, device)
        step = make_train_step(cfg, opt, micro, batch_axis=mb_axis,
                               grad_shardings=st_sh["params"])
        return (lambda: step(tree, batch)), {"state": tree,
                                             "batch": batch}, cfg

    rules = _serve_rules(arch, cfg, shape.kind, mesh)
    params = shd.distribute(transformer.init_params(cfg, device=device),
                            transformer.param_specs(cfg), mesh, rules)
    bax = _batch_axis(shape, 1, mesh)
    if shape.kind == "prefill":
        specs.pop("labels", None)
        batch = _inputs(mesh, cfg, specs, bax, device)

        @torch.no_grad()
        def prefill():
            logits, _ = transformer.forward(params, cfg, batch)
            if cfg.encoder_only:
                return logits          # encoder output IS the product
            return logits[:, -1:]      # serving emits next-token logits
        return prefill, {"params": params, "batch": batch}, cfg

    max_len = shp.decode_cache_len(cfg, shape)
    cache = shd.distribute(
        transformer.init_cache(cfg, shape.global_batch, max_len,
                               device=device),
        transformer.cache_specs(cfg, shape.global_batch, max_len), mesh,
        rules)
    tokens = _inputs(mesh, cfg, {"tokens": BatchSpec(
        (shape.global_batch, 1), torch.int32)}, bax, device)["tokens"]

    @torch.no_grad()
    def decode():
        # the newest token at the end of the context: a full cache
        return transformer.decode_step(params, cfg, cache, tokens,
                                       shape.seq_len - 1)
    return decode, {"params": params, "cache": cache, "tokens": tokens}, cfg


def _tree_bytes(tree: Any) -> float:
    return float(sum(math.prod(t.shape) * t.element_size()
                     for t in leaves(tree)))


def _ideal_bytes(shape: shp.Shape, state: dict) -> float:
    """Lower bound on HBM traffic, all devices together: every weight
    byte (and in decode every cache byte) read once.  The
    bytes-efficiency numerator for memory-bound cells."""
    if shape.kind == "train":
        # fwd+bwd reads weights ~3x + writes grads; params are f32 here
        return 4.0 * _tree_bytes(state["state"]["params"])
    if shape.kind == "prefill":
        return _tree_bytes(state["params"]) + _tree_bytes(state["batch"])
    return _tree_bytes(state["params"]) + 2.0 * _tree_bytes(state["cache"])


def model_flops(cfg, shape: shp.Shape) -> float:
    """Analytic useful FLOPs per step: 6ND train, 2ND forward (active
    params for MoE)."""
    n_active = registry.count_active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch          # one token


def measure(step: Callable[[], Any], state: dict, record: bool = False
            ) -> tuple[op_cost.Cost, int, dict, list | None]:
    """Run ``step()`` once under ``OpCounter`` -> (per-device cost, peak
    live bytes a device, the peak by kind, the per-op rows if
    ``record``).  Parameters and optimizer state count as "Parameter" and
    "Optstate", the inputs and caches as "Other"."""
    if "state" in state:
        tracked = {"Parameter": leaves(state["state"]["params"]),
                   "Optstate": leaves(state["state"]["opt_state"]),
                   "Other": leaves(state["batch"])}
    else:
        tracked = {"Parameter": leaves(state["params"]),
                   "Other": leaves({k: v for k, v in state.items()
                                    if k != "params"})}
    tracked = {k: list(v) for k, v in tracked.items()}
    _, cost, rows, counter = op_cost.count(step, record=record,
                                           tracked=tracked)
    return cost, counter.peak, dict(counter.peak_by_kind), rows


ROW_KINDS = ("bytes", "flops", "collective")


def _flat(cost: op_cost.Cost, live: int, by_kind: dict, ideal: float,
          rows: list | None = None) -> dict[str, float]:
    """The numbers ``_extend`` extends, by name; with ``rows`` (from
    ``OpCounter(record=True)``) also each (op, shape, function)'s bytes,
    FLOPs and collective bytes as ``rows/<kind>/<op>|<shape>|<fn>``."""
    out = {"flops": cost.flops,
           "bytes": cost.bytes, "collective_bytes": cost.collective_bytes,
           "score_traffic": cost.score_traffic, "live": live,
           "ideal_bytes": ideal}
    out.update({f"by_collective/{k}": v
                for k, v in cost.by_collective.items()})
    out.update({f"collective_calls/{k}": v
                for k, v in cost.collective_calls.items()})
    out.update({f"comm_debug_calls/{k}": v
                for k, v in cost.comm_debug_calls.items()})
    out.update({f"memory/{k}": v for k, v in by_kind.items()})
    for row in rows or ():
        key = f"{row[3]}|{row[4]}|{row[5]}"
        for kind, v in zip(ROW_KINDS, row[:3]):
            if v:
                name = f"rows/{kind}/{key}"
                out[name] = out.get(name, 0.0) + v
    return out


UNITS = (2, 3)


def _extend(runs: dict, units: int, micro: int) -> dict[str, float]:
    """Counts at (units, micro) from the runs at ``UNITS`` and micro 2, 3
    (a one-microbatch step and serving: micro 1 only): bilinear in the
    two, the peak (``live``, ``memory/*``) linear in the units from the
    runs at the fewest microbatches."""
    u0, u1 = UNITS
    m0 = min(m for _, m in runs)
    keys = set().union(*runs.values())

    def at(u, m, k):
        return float(runs[(u, m)].get(k, 0.0))

    out = {}
    for k in keys:
        du = at(u1, m0, k) - at(u0, m0, k)
        v = at(u0, m0, k) + (units - u0) * du
        if (u0, m0 + 1) in runs and not (k == "live" or k.startswith(
                "memory/")):
            dm = at(u0, m0 + 1, k) - at(u0, m0, k)
            duv = at(u1, m0 + 1, k) - at(u1, m0, k) - dm
            v += (micro - m0) * (dm + (units - u0) * duv)
        out[k] = v
    return out


def measure_cell(arch: str, shape_name: str, mesh, record: bool = False,
                 *, shape: shp.Shape | None = None, units: int | None = None,
                 micro: int | None = None) -> tuple[dict[str, float], Any]:
    """The cell's per-device numbers (``_flat``'s keys; ``ideal_bytes``
    is all devices'), extended from runs at ``UNITS`` of depth (and in
    training 2 and 3 microbatches, or 1 for a one-microbatch step) ->
    (numbers, the full cell's config).  ``shape``, ``units`` and
    ``micro`` replace the cell's batch and length, depth and
    microbatches."""
    shape = shape or shp.SHAPES[shape_name]
    cell_units, cell_micro = depth_and_micro(arch, shape_name)
    units, micro = units or cell_units, micro or cell_micro
    bax = _batch_axis(shape, micro, mesh)
    micros = ((2, 3) if micro > 1 else (1,)) if shape.kind == "train" \
        else (None,)
    runs = {}
    # the first run warms DTensor's caches (its first sight of an op
    # issues ops the later ones do not); the others are counted
    for u, m in [(1, micros[0])] + [(u, m) for u in UNITS for m in micros]:
        step, state, _ = build_cell(arch, shape_name, mesh, u, m,
                                    shape=shape, cell_micro=micro)
        with step_context(mesh, bax):
            cost, live, by_kind, rows = measure(step, state, record)
        if u in UNITS:
            runs[(u, m or 1)] = _flat(cost, live, by_kind,
                                      _ideal_bytes(shape, state), rows)
        del step, state
    cfg = shp.configure_for_cell(registry.get_config(arch), shape)
    return _extend(runs, units, micro), cfg


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str | None = None, verbose: bool = True) -> dict:
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh.size()
    shape = shp.SHAPES[shape_name]
    t0 = time.time()
    c, cfg = measure_cell(arch, shape_name, mesh)
    live = int(c["live"])

    def group(prefix):
        return {k.split("/", 1)[1]: v for k, v in c.items()
                if k.startswith(prefix + "/")}
    cost = op_cost.Cost(flops=c["flops"], bytes=c["bytes"],
                        collective_bytes=c["collective_bytes"],
                        score_traffic=c["score_traffic"],
                        by_collective=group("by_collective"),
                        collective_calls={k: int(v) for k, v in
                                          group("collective_calls").items()},
                        comm_debug_calls={k: int(v) for k, v in group(
                            "comm_debug_calls").items()})
    by_kind = {k: int(v) for k, v in group("memory").items()}

    mf = model_flops(cfg, shape)
    compute_s = cost.flops / PEAK_FLOPS_BF16
    memory_s = cost.bytes / HBM_BW
    collective_s = cost.collective_bytes / LINK_BW
    dominant = max(("compute", compute_s), ("memory", memory_s),
                   ("collective", collective_s), key=lambda kv: kv[1])[0]
    ideal_bytes = c["ideal_bytes"] / n_dev
    units, micro = depth_and_micro(arch, shape_name)
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": n_dev, "kind": shape.kind,
        # DTensor picks each op's layout beyond the pinned ones itself,
        # and PyTorch versions pick differently: the record holds for
        # this version only
        "torch": torch.__version__,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "seconds": round(time.time() - t0, 1),
        "extended": {"units": units, "microbatches": micro,
                     "from_units": list(UNITS), "from_microbatches":
                     [2, 3] if shape.kind == "train" else [1]},
        "memory": {
            "live_bytes_per_device": live,
            "by_category": by_kind,
            "hbm_per_chip": HBM_PER_CHIP,
            "hbm_utilization": live / HBM_PER_CHIP,
            "fits_hbm": bool(live < HBM_PER_CHIP),
        },
        "op_cost": {
            "flops_per_device": cost.flops,
            "bytes_per_device": cost.bytes,
            "collective_bytes_per_device": cost.collective_bytes,
            "by_collective": dict(cost.by_collective),
            "collective_calls": dict(cost.collective_calls),
            "comm_debug_calls": cost.comm_debug_calls,
        },
        "roofline": {
            "compute_s": compute_s, "memory_s": memory_s,
            "collective_s": collective_s,
            "collective_s_nvlink": cost.collective_bytes / NVLINK_BW,
            "dominant": dominant,
            "model_flops": mf,
            "useful_flops_ratio": mf / max(cost.flops * n_dev, 1.0),
            # compute-centric score (train/prefill): useful FLOPs over the
            # chip-seconds implied by the slowest roofline term
            "roofline_fraction":
                mf / max(n_dev * PEAK_FLOPS_BF16
                         * max(compute_s, memory_s, collective_s), 1e-30),
            # bandwidth-centric score (decode): ideal bytes / actual bytes
            "ideal_bytes_per_device": ideal_bytes,
            "bytes_efficiency": ideal_bytes / max(cost.bytes, 1.0),
            # attention-score traffic, which the flash kernel keeps on
            # chip: the memory term with it applied
            "score_traffic_bytes": cost.score_traffic,
            "memory_s_with_flash_kernel":
                max(cost.bytes - cost.score_traffic, 0.0) / HBM_BW,
        },
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{arch}__{shape_name}__{rec['mesh']}.json"
        with open(os.path.join(out_dir, tag), "w") as f:
            json.dump(rec, f, indent=1)
    if verbose:
        r = rec["roofline"]
        score = (r["bytes_efficiency"] if shape.kind == "decode"
                 else r["roofline_fraction"])
        print(f"[OK] {arch:18s} {shape_name:12s} {rec['mesh']:8s} "
              f"mem/dev={live / 2 ** 30:6.2f}GiB "
              f"C={r['compute_s'] * 1e3:8.2f}ms "
              f"M={r['memory_s'] * 1e3:8.2f}ms "
              f"X={r['collective_s'] * 1e3:8.2f}ms "
              f"dom={r['dominant']:10s} score={score:.3f} "
              f"({rec['seconds']}s)", flush=True)
    return rec


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    all_cells = shp.cells()
    if args.list:
        for a, s in all_cells:
            print(f"{a:20s} {s}")
        print(f"total: {len(all_cells)} cells")
        return 0

    todo = [(a, s) for a, s in all_cells
            if (args.arch in (None, a)) and (args.shape in (None, s))]
    if not todo:
        print("nothing matches the filters")
        return 1
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = []
    for arch, shape_name in todo:
        for mp in meshes:
            try:
                run_cell(arch, shape_name, mp, out_dir=args.out)
            except Exception as e:
                failures.append((arch, shape_name, mp, repr(e)))
                print(f"[FAIL] {arch} {shape_name} multi_pod={mp}: {e}",
                      flush=True)
                traceback.print_exc()
    print(f"\n{len(todo) * len(meshes) - len(failures)}/"
          f"{len(todo) * len(meshes)} cells ran")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
