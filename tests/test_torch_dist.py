"""``repro_torch.dist`` against the reference's sharding specification.

The reference tree lacks ``repro.dist``; its API is fixed by its call
sites and by ``tests/substrate/test_sharding_rules.py`` and
``test_sharding_properties.py``.  Here every case of those two files runs
on the port's rules, over the properties' ``_FakeMesh`` (a dict
``shape``) and over a real ``DeviceMesh`` on PyTorch's fake process
group (4 and 8 devices; the multi-pod case on 2 x 2 x 2).  The port's
logical-axes trees (``param_specs``, ``cache_specs``,
``train_state_specs``) are held leaf by leaf against the reference's
``split_tree`` specs for the ten registered architectures at full size
(abstract init on both sides, the reference through a stub of the
missing package that this module removes again).  The activation
constraints are identities outside a mesh context, and a DTensor never
reaches a kernel's plain version.
"""
import importlib
import sys
import types

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.dist.context import (activation_batch_axis,  # noqa: E402
                                      attention_seq_axis, constrain_attn_seq,
                                      constrain_batch, constrain_seq,
                                      gather_weights, reduce_partial)
from repro_torch.models import get_config, transformer  # noqa: E402
from repro_torch.train.step import train_state_specs  # noqa: E402

AXES = [None, "embed", "mlp", "heads", "kv_heads", "head_dim", "vocab",
        "experts", "layers", "batch", "seq"]
ARCHS = ["deepseek-67b", "deepseek-7b", "hubert-xlarge", "mixtral-8x7b",
         "pixtral-12b", "qwen1.5-32b", "qwen2-moe-a2.7b", "qwen3-32b",
         "rwkv6-7b", "zamba2-1.2b"]


class _FakeMesh:
    """Just enough mesh for logical_to_pspec (shape lookup)."""
    def __init__(self, shape):
        self.shape = shape


MESHES = [
    _FakeMesh({"data": 16, "model": 16}),
    _FakeMesh({"pod": 2, "data": 16, "model": 16}),
    _FakeMesh({"data": 4, "model": 2}),
]


def _fake_world(n: int):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())


@pytest.fixture(scope="module")
def device_meshes():
    """name -> mesh builder on a fake group of that many devices; the
    group is destroyed after the module."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    def build(n: int, axes=("data", "model")):
        _fake_world(n)
        shape = (n // 2, 2) if len(axes) == 2 else (2, n // 4, 2)
        return init_device_mesh("cpu", shape, mesh_dim_names=axes)
    try:
        yield build
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture(params=["fake4", "fake8", "device4", "device8"])
def mesh(request, device_meshes):
    n = int(request.param[-1])
    if request.param.startswith("fake"):
        return _FakeMesh({"data": n // 2, "model": 2})
    return device_meshes(n)


# -------------------- tests/substrate/test_sharding_rules.py, ported
def test_basic_fsdp_tp(mesh):
    p = shd.logical_to_pspec(("embed", "mlp"), (64, 128), mesh,
                             shd.RULES_TRAIN)
    assert p == ("data", "model")


def test_heads_fallback_to_head_dim(mesh):
    # 3 heads % model(2) != 0 -> heads replicate, head_dim takes model
    p = shd.logical_to_pspec(("embed", "heads", "head_dim"), (64, 3, 128),
                             mesh, shd.RULES_TRAIN)
    assert p == ("data", None, "model")


def test_no_double_use_of_axis(mesh):
    p = shd.logical_to_pspec(("heads", "head_dim"), (8, 128), mesh,
                             shd.RULES_TRAIN)
    assert p == ("model", None)


def test_embed_twice(mesh):
    p = shd.logical_to_pspec(("embed", "embed"), (64, 64), mesh,
                             shd.RULES_TRAIN)
    assert p == ("data", None)


def test_uneven_vocab_replicates(mesh):
    p = shd.logical_to_pspec(("embed", "vocab"), (64, 503), mesh,
                             shd.RULES_TRAIN)
    assert p == ("data", None)


def test_batch_one_replicates(mesh):
    assert shd.batch_axis(mesh, 1) is None
    assert shd.batch_axis(mesh, 64) is not None


def test_pod_axis_only_when_present(mesh):
    p = shd.logical_to_pspec(("batch",), (32,), mesh, shd.RULES_TRAIN)
    assert p == ("data",)


@pytest.mark.parametrize("kind", ["fake", "device"])
def test_multipod_batch(device_meshes, kind):
    mesh3 = (_FakeMesh({"pod": 2, "data": 2, "model": 2}) if kind == "fake"
             else device_meshes(8, ("pod", "data", "model")))
    p = shd.logical_to_pspec(("batch",), (32,), mesh3, shd.RULES_TRAIN)
    assert p == (("pod", "data"),)
    assert shd._mesh_extent(mesh3, p[0]) == 4
    if kind == "device":
        from torch.distributed.tensor import Replicate, Shard
        assert shd.to_placements(p, mesh3) == [Shard(0), Shard(0),
                                               Replicate()]


@pytest.mark.parametrize("n", [4, 8])
def test_real_param_tree_end_to_end(device_meshes, n):
    mesh = device_meshes(n)
    cfg = get_config("deepseek-67b")
    params = transformer.init_params(cfg, device="meta")
    specs = transformer.param_specs(cfg)
    shardings = shd.tree_shardings(specs, params, mesh, shd.RULES_TRAIN)
    flat = [s for _, s in _flat(shardings)]
    assert flat and all(s.mesh is mesh for s in flat)
    ps = shd.tree_pspecs(specs, params, mesh, shd.RULES_TRAIN)
    assert ps["blocks"]["mlp"]["up"] == (None, "data", "model")
    # the DTensors laid out so: each local shard a (1/n)-th of the leaf
    dp = shd.distribute({"up": params["blocks"]["mlp"]["up"]},
                        {"up": specs["blocks"]["mlp"]["up"]}, mesh,
                        shd.RULES_TRAIN)
    local = dp["up"].to_local()
    assert local.shape == (95, 8192 // (n // 2), 22016 // 2)
    assert list(dp["up"].placements) == shd.to_placements(
        (None, "data", "model"), mesh)


# -------------------- tests/substrate/test_sharding_properties.py, ported
@settings(max_examples=200, deadline=None)
@given(
    mesh_i=st.integers(0, len(MESHES) - 1),
    rules_name=st.sampled_from(["train", "decode", "train_ep",
                                "prefill_sp"]),
    dims=st.lists(
        st.tuples(st.sampled_from(AXES), st.integers(1, 4096)),
        min_size=1, max_size=5),
)
def test_pspec_invariants(mesh_i, rules_name, dims):
    mesh = MESHES[mesh_i]
    rules = shd.get_rules(rules_name)
    logical = tuple(d[0] for d in dims)
    shape = tuple(d[1] for d in dims)
    spec = shd.logical_to_pspec(logical, shape, mesh, rules)

    used = []
    for entry, dim in zip(spec, shape):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        for a in axes:
            # (1) every mesh axis exists and is used at most once
            assert a in mesh.shape
            assert a not in used, f"axis {a} used twice in {spec}"
            used.append(a)
        # (2) the dim divides evenly
        extent = 1
        for a in axes:
            extent *= mesh.shape[a]
        assert dim % extent == 0, (dim, extent, spec)


@settings(max_examples=50, deadline=None)
@given(dims=st.lists(st.tuples(st.sampled_from(AXES),
                               st.sampled_from([1, 2, 3, 16, 128, 4096])),
                     min_size=1, max_size=4))
def test_pspec_deterministic(dims):
    mesh = MESHES[0]
    logical = tuple(d[0] for d in dims)
    shape = tuple(d[1] for d in dims)
    a = shd.logical_to_pspec(logical, shape, mesh, shd.RULES_TRAIN)
    b = shd.logical_to_pspec(logical, shape, mesh, shd.RULES_TRAIN)
    assert a == b


def test_rules_replace_and_lookup():
    r = shd.RULES_TRAIN.replace(mlp=(None,))
    assert r.mlp == (None,) and shd.RULES_TRAIN.mlp == ("model", None)
    assert shd.get_rules("train") is shd.RULES_TRAIN
    assert shd.get_rules("decode") is shd.RULES_DECODE
    with pytest.raises(KeyError):
        shd.get_rules("nope")


# -------------------- specs trees against the reference's
def _is_reference(name: str) -> bool:
    return name == "repro" or name.startswith("repro.")


@pytest.fixture(scope="module")
def reference():
    """The reference's models and train step, imported through a stub of
    the missing ``repro.dist`` (identity constraints, empty ``sharding``);
    ``sys.modules`` and the parent packages' attributes are restored
    afterwards."""
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
            transformer=importlib.import_module("repro.models.transformer"),
            step=importlib.import_module("repro.train.step"),
            optim=importlib.import_module("repro.optim"))
    finally:
        for name in sorted(n for n in sys.modules
                           if _is_reference(n) and n not in before):
            mod = sys.modules.pop(name)
            parent, _, child = name.rpartition(".")
            if getattr(sys.modules.get(parent), child, None) is mod:
                delattr(sys.modules[parent], child)


def _flat(tree, prefix=()):
    """(path, leaf) pairs of a nested dict whose leaves are anything but
    dicts (axes tuples, tensors), depth first."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, (*prefix, k))
        else:
            yield (*prefix, k), v


def _same_specs(got: dict, want: dict) -> None:
    g, w = dict(_flat(got)), dict(_flat(want))
    assert set(g) == set(w)
    for path in w:
        assert tuple(g[path]) == tuple(w[path]), path


@pytest.mark.parametrize("tree", ["params", "cache", "train_state"])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference(reference, arch, tree):
    rcfg = reference.registry.get_config(arch)
    cfg = get_config(arch)
    if tree == "params":
        _, want = reference.transformer.init_params(rcfg, None)
        got = transformer.param_specs(cfg)
    elif tree == "cache":
        _, want = reference.transformer.init_cache_arrays(
            rcfg, 4, 64, abstract=True)
        got = transformer.cache_specs(cfg, 4, 64)
        # the port's cache init makes leaves of the shapes the specs name
        shapes = transformer.init_cache(cfg, 4, 64, device="meta")
        for path, axes in _flat(got):
            leaf = shapes
            for k in path:
                leaf = leaf[k]
            assert len(axes) == leaf.dim(), path
    else:
        _, want = reference.step.init_train_state(
            rcfg, reference.optim.AdamWConfig(), None)
        got = train_state_specs(cfg)
    _same_specs(got, want)


# -------------------- constraints and the kernel boundary
@pytest.fixture
def dtensor(device_meshes):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = device_meshes(4)
    x = torch.arange(8 * 4 * 6, dtype=torch.float32).reshape(8, 4, 6)
    return distribute_tensor(x, mesh, [Shard(2), Replicate()],
                             src_data_rank=None)


@pytest.mark.parametrize("wrap", [False, True])
def test_constraints_are_identities_outside_a_context(dtensor, wrap):
    x = dtensor if wrap else torch.randn(8, 4, 6)
    assert constrain_batch(x) is x
    assert constrain_batch(x, exact=True) is x
    assert constrain_seq(x) is x
    q, k, v, axis = constrain_attn_seq(x, x, x)
    assert (q, k, v, axis) == (x, x, x, None)
    assert gather_weights({"w": x})["w"] is x


def test_constraints_leave_plain_tensors_alone_in_a_context():
    x = torch.randn(8, 4, 6)
    with activation_batch_axis("data", 2), attention_seq_axis("model", 2):
        assert constrain_batch(x, exact=True) is x
        assert constrain_seq(x) is x
        assert constrain_attn_seq(x, x, x)[:3] == (x, x, x)
        assert reduce_partial(x) is x


def test_constraints_lay_a_dtensor_out(dtensor):
    from torch.distributed.tensor import Replicate, Shard
    with activation_batch_axis("data", 2), attention_seq_axis("model", 2):
        b = constrain_batch(dtensor)
        assert tuple(b.placements) == (Shard(0), Replicate())
        s = constrain_seq(b)
        assert tuple(s.placements) == (Shard(0), Shard(1))
        q, k, v, axis = constrain_attn_seq(s, s, s)
        assert axis == "model"
        assert tuple(q.placements) == (Shard(0), Shard(1))
        assert tuple(k.placements) == (Shard(0), Replicate())
    # (values move only on a real group: tests/test_torch_dist_gloo.py)
    assert q.shape == dtensor.shape


def _kernel_calls():
    from repro_torch.core import kernels as acq
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mamba2_ssd import ssd
    from repro_torch.kernels.rwkv6_scan import wkv6
    return {
        "flash_attention": lambda t: flash_attention(t, t, t),
        "ssd": lambda t: ssd(t, t, t, t, t),
        "wkv6": lambda t: wkv6(t, t, t, t, t),
        "tpe_score": lambda t: acq.tpe_score(t, t, t, t, t, t, t),
        "parzen_log_density": lambda t: acq.parzen_log_density(t, t, t, t),
        "matern52_cross": lambda t: acq.matern52_cross(t, t, t),
        "matern52_masked": lambda t: acq.matern52_masked(t, t, t),
    }


@pytest.mark.parametrize("op", sorted(_kernel_calls()))
def test_a_dtensor_never_reaches_a_kernel_wrapper(dtensor, op):
    with pytest.raises(TypeError, match="local_map"):
        _kernel_calls()[op](dtensor)


def test_distribute_keeps_values(device_meshes):
    mesh = device_meshes(4)
    cfg = get_config("deepseek-7b", smoke=True)
    params = transformer.init_params(cfg, seed=1, device="cpu")
    dp = shd.distribute(params, transformer.param_specs(cfg), mesh,
                        shd.RULES_TRAIN)
    for (path, got), (_, want) in zip(_flat(dp), _flat(params)):
        # this process is rank 0 of the fake group: the first chunk along
        # every sharded dim, in mesh order
        for n, p in zip(mesh.shape, got.placements):
            if p.is_shard():
                want = want.chunk(n, dim=p.dim)[0]
        torch.testing.assert_close(got.to_local(), want, rtol=0, atol=0)
