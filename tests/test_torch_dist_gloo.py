"""The port's models and train step sharded over 4 CPU processes.

One spawn of 4 gloo processes on a 2 x 2 ``("data", "model")`` mesh runs
every case, and each rank holds its sharded results against the same
computation on plain tensors in its own process (the single-process
run), in float32:

* the deepseek-7b smoke model's forward logits with ``attn_sp`` off and
  on (on: attention sequence-parallel over ``model``, the ref core), with
  the blocked core sequence-parallel (each shard's query offset), and
  through the flash op's local shards (heads over ``model``: on the CPU
  its plain version), also sequence-parallel (each shard's query offset
  into the op); qwen3-32b's smoke model (GQA 8:2, qk-norm) with the ref core,
  its q and kv heads sharded over ``model`` in whole groups, and at 6:3
  heads, whose 3 kv heads do not divide ``model``: each device picks the
  kv heads of its own q heads; qwen1.5-32b's (QKV bias) at 3 heads,
  which do not divide ``model``: the weights and biases are gathered
  over head_dim;
* the SSM blocks on each device's rows and heads: zamba2-1.2b's smoke
  forward (Mamba2 heads over ``model``, B and C whole) and rwkv6-7b's
  (WKV6 heads over ``model``, ``ln_x`` over the whole width), and
  rwkv6-7b's decode steps;
* the deepseek-7b smoke model's decode steps (4 tokens into a zero
  cache laid out over ``data`` and its heads over ``model``, and with
  the int8 cache), each step's logits; and qwen3-32b's at 6:3 heads
  under the dry run's serving rules, whose 3 kv heads do not divide
  ``model``: the cache's head dim is sharded, each device takes partial
  scores over its slice and one all-reduce sums them (plain and int8
  caches);
* the qwen2-moe-a2.7b smoke forward, with its dense dispatch and with
  the grouped capacity dispatch (groups of 8, two blocks);
* one train step of the deepseek-7b smoke model in 2 microbatches with
  ``batch_axis`` and ``grad_shardings`` set: its loss, the gradients
  (read from AdamW's first moments, ``(1 - b1) * g`` after the clip) and
  the updated parameters; and the same with ``attn_sp`` over ``model``,
  whose k and v gradients are sums over the query shards, for qwen3-32b's
  smoke model at 4:1 heads (whole k and v, sharded q: their input's
  gradients partial and whole, summed by ``shard_ops.fan_out``), for
  qwen2-moe-a2.7b's with the grouped dispatch and for zamba2-1.2b's (the
  SSD scan's B and C gradients partial sums over the head shards);
* a sharded checkpoint: the deepseek-7b smoke parameters saved from the
  ``RULES_TRAIN`` layout by ``CheckpointManager.save`` (rank 0 writes)
  and restored into ``RULES_DECODE``'s layout and into plain tensors,
  bit-equal; the reference's ``restore_tree`` reads the same file.

The step uses AdamW's ``eps = 1e-3``: with the default ``1e-8`` the first
update is ``lr * sign(g)`` for every gradient above ~1e-8, so a gradient
within rounding of 0 may flip a parameter by ``2 * lr`` in either run;
a larger ``eps`` makes the update smooth in ``g`` and the comparison a
test of the sharded arithmetic.
"""
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
mp = pytest.importorskip("torch.multiprocessing")

TOL = 1e-5
WORLD = 4
SPAWN_SECONDS = 240


def _tree_max_err(a: dict, b: dict) -> float:
    from repro_torch.models.registry import leaves
    errs = [float((x.full_tensor() - y).abs().max())
            for x, y in zip(leaves(a), leaves(b))]
    return max(errs)


def _batch(cfg, B: int, S: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S + 1))
    return {"tokens": torch.tensor(tok[:, :-1], dtype=torch.int32),
            "labels": torch.tensor(tok[:, 1:], dtype=torch.int32)}


def _forward_case(cfg, mesh, rules, batch, sp_axis):
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist import sharding as shd
    from repro_torch.dist.context import (activation_batch_axis,
                                          attention_seq_axis)
    from repro_torch.models import transformer as T
    params = T.init_params(cfg, seed=3, device="cpu")
    want, _ = T.forward(params, cfg, batch)
    dparams = shd.distribute(params, T.param_specs(cfg), mesh, rules)
    bax = shd.batch_axis(mesh, batch["tokens"].shape[0], rules)
    with activation_batch_axis(bax, shd._mesh_extent(mesh, bax)), \
            attention_seq_axis(sp_axis, 2), implicit_replication():
        got, _ = T.forward(dparams, cfg, batch)
    return float((got.full_tensor() - want).abs().max())


def _decode_case(cfg, mesh, tokens, rules=None):
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist import sharding as shd
    from repro_torch.dist.context import activation_batch_axis
    from repro_torch.models import transformer as T
    rules = rules or shd.RULES_DECODE
    params = T.init_params(cfg, seed=3, device="cpu")
    B, n = tokens.shape
    cache = T.init_cache(cfg, B, 8, device="cpu")
    dparams = shd.distribute(params, T.param_specs(cfg), mesh, rules)
    dcache = shd.distribute(T.init_cache(cfg, B, 8, device="cpu"),
                            T.cache_specs(cfg, B, 8), mesh, rules)
    err = 0.0
    for i in range(n):
        want, _ = T.decode_step(params, cfg, cache, tokens[:, i:i + 1], i)
        with activation_batch_axis("data", 2), implicit_replication():
            got, _ = T.decode_step(dparams, cfg, dcache,
                                   tokens[:, i:i + 1], i)
        err = max(err, float((got.full_tensor() - want).abs().max()))
    return err


def _train_case(cfg, mesh, batch, sp_axis=None):
    import copy

    from repro_torch.dist import sharding as shd
    from repro_torch.dist.context import (activation_batch_axis,
                                          attention_seq_axis)
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.step import (init_train_state, make_train_step,
                                        train_state_shardings,
                                        train_state_specs)
    opt = AdamWConfig(lr=1e-3, eps=1e-3)
    state = init_train_state(cfg, opt, seed=5, device="cpu").tree()
    dstate = shd.distribute(copy.deepcopy(state), train_state_specs(cfg),
                            mesh, shd.RULES_TRAIN)
    want_state, want = make_train_step(cfg, opt, 2)(state, batch)
    specs = train_state_specs(cfg)
    sh = train_state_shardings(specs, dstate, mesh, shd.RULES_TRAIN)
    mb_axis = shd.batch_axis(mesh, batch["tokens"].shape[0] // 2)
    step = make_train_step(cfg, opt, 2, batch_axis=mb_axis,
                           grad_shardings=sh["params"])
    from torch.distributed.tensor.experimental import implicit_replication
    with activation_batch_axis(mb_axis, shd._mesh_extent(mesh, mb_axis)), \
            attention_seq_axis(sp_axis, 2), implicit_replication():
        got_state, got = step(dstate, batch)
    return {"loss": abs(float(got["loss"]) - float(want["loss"])),
            "grads": _tree_max_err(got_state["opt_state"]["m"],
                                   want_state["opt_state"]["m"]),
            "params": _tree_max_err(got_state["params"],
                                    want_state["params"]),
            "layouts": all(
                tuple(p.placements) == tuple(s.placements)
                for p, s in zip(_leaves(got_state["params"]),
                                _leaves(sh["params"])))}


def _leaves(tree):
    from repro_torch.models.registry import leaves
    return list(leaves(tree))


def _ckpt_case(cfg, mesh, directory: str) -> float:
    """The max |diff| of the smoke parameters saved sharded and restored
    into another layout and into plain tensors (0: bit-equal)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.dist import sharding as shd
    from repro_torch.models import transformer as T
    params = T.init_params(cfg, seed=3, device="cpu")
    specs = T.param_specs(cfg)
    mgr = CheckpointManager(directory)
    mgr.save(1, {"params": shd.distribute(params, specs, mesh,
                                          shd.RULES_TRAIN)}, blocking=True)
    mgr.save(2, {"params": shd.distribute(params, specs, mesh,
                                          shd.RULES_DECODE)})
    mgr.wait()
    sh = shd.tree_shardings(specs, params, mesh, shd.RULES_DECODE)
    got, meta = mgr.restore(1, {"params": params}, {"params": sh})
    plain, _ = mgr.restore_latest({"params": params})
    err = 0.0 if meta["step"] == 1 else float("inf")
    for g, p, w, s in zip(_leaves(got["params"]), _leaves(plain["params"]),
                          _leaves(params), _leaves(sh)):
        if tuple(g.placements) != tuple(s.placements):
            return float("inf")
        err = max(err, float((g.full_tensor() - w).abs().max()),
                  float((p - w).abs().max()))
    return err


def _worker(rank: int, store: str, out: str, ckpt: str) -> None:
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import sharding as shd
    from repro_torch.models import get_config
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        res = {}
        dense = get_config("deepseek-7b", smoke=True)
        batch = _batch(dense, 4, 16, seed=11)
        res["forward"] = _forward_case(dense, mesh, shd.RULES_TRAIN, batch,
                                       None)
        res["forward_sp"] = _forward_case(
            dense.replace(attn_sp=True), mesh, shd.RULES_TRAIN, batch,
            "model")
        res["forward_blocked_sp"] = _forward_case(
            dense.replace(attn_sp=True, attn_impl="blocked"), mesh,
            shd.RULES_TRAIN, batch, "model")
        res["forward_flash"] = _forward_case(
            dense.replace(attn_impl="flash"), mesh, shd.RULES_DECODE,
            batch, None)
        res["forward_flash_sp"] = _forward_case(
            dense.replace(attn_impl="flash", attn_sp=True), mesh,
            shd.RULES_DECODE, batch, "model")
        # zamba2-1.2b's Mamba2 layers alone: its shared attention block
        # (held by the dense cases) amplifies rounding, ~5e-5 in the
        # logits from a 1e-7 relative change of the embedding in one
        # process
        ssm = get_config("zamba2-1.2b", smoke=True).replace(block="mamba2",
                                                            n_layers=2)
        res["forward_ssm"] = _forward_case(ssm, mesh, shd.RULES_TRAIN,
                                           _batch(ssm, 4, 16, seed=21), None)
        rwkv = get_config("rwkv6-7b", smoke=True)
        res["forward_rwkv"] = _forward_case(
            rwkv, mesh, shd.RULES_TRAIN, _batch(rwkv, 4, 16, seed=22), None)
        res["decode_rwkv"] = _decode_case(rwkv, mesh, batch["tokens"][:, :4])
        gqa = get_config("qwen3-32b", smoke=True)
        res["forward_gqa"] = _forward_case(
            gqa, mesh, shd.RULES_DECODE.replace(kv_heads=(None,)),
            _batch(gqa, 4, 16, seed=14), None)
        res["forward_gqa_uneven"] = _forward_case(
            gqa.replace(n_heads=6, n_kv_heads=3), mesh, shd.RULES_DECODE,
            _batch(gqa, 4, 16, seed=15), None)
        bias = get_config("qwen1.5-32b", smoke=True)
        res["forward_bias_uneven"] = _forward_case(
            bias.replace(n_heads=3, n_kv_heads=3), mesh, shd.RULES_TRAIN,
            _batch(bias, 4, 16, seed=17), None)
        res["decode"] = _decode_case(dense, mesh, batch["tokens"][:, :4])
        res["decode_int8"] = _decode_case(dense.replace(kv_quant=True),
                                          mesh, batch["tokens"][:, :4])
        # the dry run's serving rules for kv heads that do not divide the
        # model axis: q and the cache over head_dim
        hd_rules = shd.RULES_DECODE.replace(heads=(None,),
                                            head_dim=("model", None))
        uneven = gqa.replace(n_heads=6, n_kv_heads=3)
        res["decode_hd"] = _decode_case(uneven, mesh, batch["tokens"][:, :4],
                                        hd_rules)
        res["decode_hd_int8"] = _decode_case(
            uneven.replace(kv_quant=True), mesh, batch["tokens"][:, :4],
            hd_rules)
        moe = get_config("qwen2-moe-a2.7b", smoke=True)
        mbatch = _batch(moe, 4, 16, seed=12)
        res["moe_dense"] = _forward_case(moe, mesh, shd.RULES_DECODE,
                                         mbatch, None)
        grouped = moe.replace(moe=dataclasses.replace(
            moe.moe, dense_dispatch=False, group_size=8, scan_groups=2))
        res["moe_grouped"] = _forward_case(grouped, mesh, shd.RULES_TRAIN,
                                           mbatch, None)
        res.update({f"train_{k}": v for k, v in _train_case(
            dense, mesh, _batch(dense, 8, 16, seed=13)).items()})
        res.update({f"train_sp_{k}": v for k, v in _train_case(
            dense.replace(attn_sp=True), mesh, _batch(dense, 8, 16, seed=16),
            "model").items()})
        res.update({f"train_gqa_{k}": v for k, v in _train_case(
            gqa.replace(n_heads=4, n_kv_heads=1), mesh,
            _batch(gqa, 8, 16, seed=18)).items()})
        res.update({f"train_moe_{k}": v for k, v in _train_case(
            grouped, mesh, _batch(moe, 8, 16, seed=19)).items()})
        res.update({f"train_ssm_{k}": v for k, v in _train_case(
            ssm, mesh, _batch(ssm, 8, 16, seed=23)).items()})
        res["ckpt_sharded"] = _ckpt_case(dense, mesh, ckpt)
        with open(f"{out}.{rank}", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The 4 ranks' readings, from one spawn bounded by SPAWN_SECONDS."""
    tmp = tmp_path_factory.mktemp("gloo")
    out = str(tmp / "result")
    ckpt = str(tmp / "ckpt")
    ctx = mp.start_processes(_worker, args=(str(tmp / "store"), out, ckpt),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_SECONDS
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"gloo ranks still running after "
                                   f"{SPAWN_SECONDS} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(5)
    results = []
    for rank in range(WORLD):
        with open(f"{out}.{rank}") as f:
            results.append(json.load(f))
    results[0]["ckpt_dir"] = ckpt
    return results


@pytest.mark.parametrize("case", ["forward", "forward_sp",
                                  "forward_blocked_sp", "forward_flash",
                                  "forward_flash_sp", "forward_ssm",
                                  "forward_rwkv", "decode_rwkv",
                                  "forward_gqa", "forward_gqa_uneven",
                                  "forward_bias_uneven", "decode",
                                  "decode_int8", "decode_hd",
                                  "decode_hd_int8", "ckpt_sharded",
                                  "moe_dense",
                                  "moe_grouped", "train_loss",
                                  "train_grads", "train_params",
                                  "train_sp_loss", "train_sp_grads",
                                  "train_sp_params", "train_gqa_loss",
                                  "train_gqa_grads", "train_gqa_params",
                                  "train_moe_loss", "train_moe_grads",
                                  "train_moe_params", "train_ssm_loss",
                                  "train_ssm_grads", "train_ssm_params"])
def test_sharded_run_equals_the_single_process_run(sharded, case):
    for rank, res in enumerate(sharded):
        assert res[case] <= TOL, (rank, case, res[case])


def test_train_step_leaves_parameters_on_their_layouts(sharded):
    assert all(res[f"train{k}_layouts"] for res in sharded
               for k in ("", "_sp", "_gqa", "_moe", "_ssm"))


def test_sharded_checkpoint_round_trip_is_bit_equal(sharded):
    assert all(res["ckpt_sharded"] == 0.0 for res in sharded)


def test_the_reference_reads_a_sharded_save(sharded):
    """The file rank 0 wrote from DTensors, read by the reference's
    ``restore_tree`` (JAX on the CPU): the port's parameters."""
    import os

    import jax.numpy as jnp

    from repro.checkpoint.manager import restore_tree
    from repro_torch.models import get_config
    from repro_torch.models import transformer as T
    params = T.init_params(get_config("deepseek-7b", smoke=True), seed=3,
                           device="cpu")
    like = {"params": _map(lambda t: jnp.zeros(tuple(t.shape),
                                               jnp.float32), params)}
    got = restore_tree(os.path.join(sharded[0]["ckpt_dir"],
                                    "step_00000001.npz"), like)
    want, read = _flat(params), _flat(got["params"])
    assert want.keys() == read.keys()
    assert all(np.array_equal(np.asarray(read[k]), w.numpy())
               for k, w in want.items())


def _map(fn, tree: dict) -> dict:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _flat(tree: dict, prefix: str = "") -> dict:
    """Path -> leaf (JAX orders a dict's keys, the port keeps them as
    made)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out

