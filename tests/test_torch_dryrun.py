"""The port's dry run (``repro_torch.launch.{mesh,op_cost,dryrun,
inspect_cell}``) on the CPU.

* ``op_cost``'s traffic model is the reference's (its four cases from
  ``tests/substrate/test_hlo_cost.py``), and its per-device counts hold
  on three products worked by hand on a 2 x 2 fake-group mesh: one
  sharded over the rows, one replicated, one ``Partial`` over the
  contraction (its all-reduce counted by the model), with the peak of
  their local storages; the same through ``dist.shard_ops.matmul``, and
  a column-parallel product's backward on the shards;
* ``model_flops`` equals the reference's formula with the reference's
  ``count_active_params`` and cell configuration, for all 32 cells;
* one cell (deepseek-7b decode_32k at full size) runs end to end on an
  8-device fake mesh in a fresh process, and its numbers extended from
  2 and 3 layers equal a run at the full 30;
* in scan cells and a head_dim-sharded decode cell on the 16 x 16 mesh,
  the scan, step and decode cores take plain local tensors only, and
  the decode gathers no cache tensor;
* the dry-run modules import with ``jax`` blocked.
"""
import importlib
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import dryrun, op_cost  # noqa: E402
from repro_torch.launch import shapes as shp  # noqa: E402
from repro_torch.models import get_config  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


def test_traffic_model():
    t = op_cost._TRAFFIC
    assert t["all-gather"](100, 4) == 75.0
    assert t["all-reduce"](100, 4) == 150.0
    assert t["reduce-scatter"](100, 4) == 300.0
    assert t["collective-permute"](100, 4) == 100.0
    assert set(t) == set(op_cost.COLLECTIVES)


@pytest.fixture(scope="module")
def mesh():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=4, store=FakeStore())
    try:
        yield init_device_mesh("cpu", (2, 2),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


M, K, N = 64, 128, 256
GLOBAL = 2 * M * K * N                     # 4,194,304


def _product(mesh, a_place, w_place):
    from torch.distributed.tensor import distribute_tensor
    a = distribute_tensor(torch.empty(M, K, device="meta"), mesh, a_place,
                          src_data_rank=None)
    w = distribute_tensor(torch.empty(K, N, device="meta"), mesh, w_place,
                          src_data_rank=None)
    return a, w


def _check_product(mesh, case, product):
    from torch.distributed.tensor import Partial, Replicate, Shard
    R = Replicate()
    if case == "sharded":              # rows over data: (32, 128) @ (128, 256)
        a, w = _product(mesh, [Shard(0), R], [R, R])
        want_flops, want_coll = 2 * 32 * K * N, 0.0
        want_bytes = 4 * (32 * K + K * N + 32 * N)
    elif case == "replicated":         # every device the whole product
        a, w = _product(mesh, [R, R], [R, R])
        want_flops, want_coll = GLOBAL, 0.0
        want_bytes = 4 * (M * K + K * N + M * N)
    else:                              # K over model: (64, 64) @ (64, 256)
        a, w = _product(mesh, [R, Shard(1)], [R, Shard(0)])
        want_flops = 2 * M * 64 * N
        # then the partial sums over model: one all-reduce of (64, 256)
        # fp32 among 2: 2 x 65536 x 1/2 bytes
        want_coll = 65536.0
        want_bytes = 4 * (M * 64 + 64 * N + M * N)

    def step():
        y = product(a, w)
        if case == "partial":
            assert y.placements[1] == Partial()
            y = y.redistribute(mesh, [R, R])
        return y
    _, cost, _, counter = op_cost.count(step, tracked={"Parameter": [a, w]})
    assert cost.flops == want_flops
    # the peak: the local inputs and the product's output, at least
    assert counter.peak >= want_bytes
    if case != "partial":
        assert counter.peak == want_bytes
    assert cost.collective_bytes == want_coll
    assert cost.bytes == want_bytes
    if case == "partial":
        assert dict(cost.collective_calls) == {"all-reduce": 1}
        assert sum(cost.comm_debug_calls.values()) == 1


@pytest.mark.parametrize("case", ["sharded", "replicated", "partial"])
def test_per_device_flops_of_hand_worked_products(mesh, case):
    _check_product(mesh, case, lambda a, w: a @ w)


@pytest.mark.parametrize("case", ["sharded", "replicated", "partial"])
def test_local_products_count_as_the_dtensor_products(mesh, case):
    from repro_torch.dist import shard_ops
    _check_product(mesh, case, shard_ops.matmul)


def test_local_product_gradients_by_hand(mesh):
    """A column-parallel product (rows over data, w's columns over
    model) on the shards: its backward is two local products of the
    forward's size, x's gradient a partial sum over model and w's over
    data, and no collective."""
    from torch.distributed.tensor import (Partial, Replicate, Shard,
                                          distribute_tensor)

    from repro_torch.dist import shard_ops
    R = Replicate()
    a, w = _product(mesh, [Shard(0), R], [R, Shard(1)])
    a.requires_grad_(), w.requires_grad_()
    y = shard_ops.matmul(a, w)
    assert tuple(y.placements) == (Shard(0), Shard(1))
    gy = distribute_tensor(torch.empty(M, N, device="meta"), mesh,
                           [Shard(0), Shard(1)], src_data_rank=None)
    _, cost, _, _ = op_cost.count(lambda: y.backward(gy))
    assert cost.flops == 2 * (2 * 32 * K * 128)
    assert cost.collective_bytes == 0.0
    assert tuple(a.grad.placements) == (Shard(0), Partial())
    assert tuple(w.grad.placements) == (Partial(), Shard(1))


# -------------------- model_flops against the reference's formula
def _is_reference(name: str) -> bool:
    return name == "repro" or name.startswith("repro.")


@pytest.fixture(scope="module")
def reference():
    """The reference's registry and cell table, imported through a stub
    of the missing ``repro.dist``, removed again afterwards."""
    before = {n for n in sys.modules if _is_reference(n)}
    dist = types.ModuleType("repro.dist")
    context = types.ModuleType("repro.dist.context")
    context.constrain_batch = lambda x, exact=False: x
    sharding = types.ModuleType("repro.dist.sharding")
    dist.context, dist.sharding = context, sharding
    sys.modules.update({"repro.dist": dist, "repro.dist.context": context,
                        "repro.dist.sharding": sharding})
    try:
        yield types.SimpleNamespace(
            registry=importlib.import_module("repro.models.registry"),
            shapes=importlib.import_module("repro.launch.shapes"))
    finally:
        for name in sorted(n for n in sys.modules
                           if _is_reference(n) and n not in before):
            mod = sys.modules.pop(name)
            parent, _, child = name.rpartition(".")
            if getattr(sys.modules.get(parent), child, None) is mod:
                delattr(sys.modules[parent], child)


@pytest.mark.parametrize("arch,shape", shp.cells())
def test_model_flops_is_the_reference_formula(reference, arch, shape):
    rs = reference.shapes
    rcfg = rs.configure_for_cell(reference.registry.get_config(arch),
                                 rs.SHAPES[shape])
    n = reference.registry.count_active_params(rcfg)
    s = rs.SHAPES[shape]
    tokens = s.global_batch * (s.seq_len if s.kind != "decode" else 1)
    want = (6.0 if s.kind == "train" else 2.0) * n * tokens
    cfg = shp.configure_for_cell(get_config(arch), shp.SHAPES[shape])
    assert dryrun.model_flops(cfg, shp.SHAPES[shape]) == want


def test_32_cells():
    assert len(shp.cells()) == 32


# -------------------- one cell end to end, in a fresh process
_CELL = r"""
import json
from repro_torch.launch import dryrun, mesh as MESH
mesh = MESH.make_fake_mesh((4, 2))
ext, cfg = dryrun.measure_cell("deepseek-7b", "decode_32k", mesh)
step, state, full_cfg = dryrun.build_cell("deepseek-7b", "decode_32k", mesh)
bax, _ = dryrun.cell_batch_axis("deepseek-7b", "decode_32k", mesh)
with dryrun.step_context(mesh, bax):
    cost, live, kinds, _ = dryrun.measure(step, state)
print(json.dumps({"ext": ext, "layers": full_cfg.n_layers, "full": {
    "flops": cost.flops, "bytes": cost.bytes, "live": live,
    "collective_bytes": cost.collective_bytes,
    }, "kinds": kinds}))
"""


def _run(code: str, timeout: float = 300) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_one_cell_end_to_end_on_an_8_device_mesh():
    proc = _run(_CELL)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    ext, full = out["ext"], out["full"]
    assert out["layers"] == 30
    for key in ("flops", "collective_bytes"):
        assert ext[key] == full[key], key
    assert abs(ext["bytes"] / full["bytes"] - 1) < 1e-9
    assert abs(ext["live"] / full["live"] - 1) < 1e-3
    # one device's share: the bf16 weights over the model axis (2) and
    # the bf16 KV cache over data (4) and model (2) at the least
    cfg = shp.configure_for_cell(get_config("deepseek-7b"),
                                 shp.SHAPES["decode_32k"])
    cache = 2 * 30 * 128 * 32768 * cfg.n_kv_heads * cfg.head_dim * 2
    assert full["live"] > cache / 8
    assert full["flops"] * 8 >= dryrun.model_flops(cfg,
                                                   shp.SHAPES["decode_32k"])


_LOCAL_CORES = r"""
import json
from repro_torch.dist.context import is_dtensor
from repro_torch.launch import dryrun, mesh as MESH
from repro_torch.models import attention, mamba2, rwkv6
seen = {}

def spy(mod, name):
    fn = getattr(mod, name)
    def wrapped(*args, **kwargs):
        key = f"{mod.__name__.rsplit('.', 1)[-1]}.{name}"
        got = [is_dtensor(a) for a in (*args, *kwargs.values())]
        seen.setdefault(key, set()).update(got)
        return fn(*args, **kwargs)
    setattr(mod, name, wrapped)
for mod, name in ((mamba2, "ssd_chunked"), (mamba2, "ssd_step"),
                  (rwkv6, "wkv6_chunked"), (rwkv6, "wkv6_step"),
                  (attention, "_ref_core")):
    spy(mod, name)
mesh = MESH.make_production_mesh(multi_pod=False)
rows = {}
for arch, shape in CELLS:
    ext, cfg = dryrun.measure_cell(arch, shape, mesh, record=True)
    rows[f"{arch} {shape}"] = [k for k in ext if k.startswith("rows/")]
print(json.dumps({"seen": {k: sorted(v) for k, v in seen.items()},
                  "rows": rows}))
"""


@pytest.mark.parametrize("cells,cores", [
    ([("rwkv6-7b", "prefill_32k"), ("zamba2-1.2b", "decode_32k")],
     {"rwkv6.wkv6_chunked", "mamba2.ssd_step"}),
    ([("mixtral-8x7b", "decode_32k")], {"attention._ref_core"})])
def test_scan_and_head_dim_decode_cores_take_local_tensors(cells, cores):
    """On the 16 x 16 mesh, in a scan cell and a head_dim-sharded decode
    cell, the scan, step and decode cores are handed each device's plain
    shards, never a DTensor (PyTorch 2.11's DTensor refuses the folds of
    sharded heads and head dims that their einsums make), and the decode
    cell gathers no cache tensor (an all-gather whose output has the
    cache's length)."""
    proc = _run(f"CELLS = {cells!r}\n" + _LOCAL_CORES, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert cores <= set(out["seen"]), out["seen"]
    assert all(v == [False] for v in out["seen"].values()), out["seen"]
    for (arch, shape), names in zip(cells, out["rows"].values()):
        if shape.startswith("decode") or shape == "long_500k":
            cfg = shp.configure_for_cell(get_config(arch),
                                         shp.SHAPES[shape])
            T = shp.decode_cache_len(cfg, shp.SHAPES[shape])
            gathers = [n for n in names
                       if "all_gather" in n and f", {T}, " in n]
            assert gathers == [], gathers


_BLOCKED = r"""
import sys
sys.modules["jax"] = None
import repro_torch.dist, repro_torch.launch.dryrun, repro_torch.launch.inspect_cell
import repro_torch.launch.mesh, repro_torch.launch.op_cost
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
from repro_torch.launch import dryrun
raise SystemExit(dryrun.main(["--list"]))
"""


def test_imports_without_jax_and_lists_the_cells():
    proc = _run(_BLOCKED, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "total: 32 cells"
