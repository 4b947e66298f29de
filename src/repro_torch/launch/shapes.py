"""The assigned (architecture x input-shape) matrix (copied from the
reference, with torch dtypes).

4 shapes per LM arch:
  train_4k     seq 4096,   global_batch 256  -> train_step
  prefill_32k  seq 32768,  global_batch 32   -> prefill (forward, last-token
                                               logits)
  decode_32k   seq 32768,  global_batch 128  -> serve_step (1 new token, cache
                                               of seq_len)
  long_500k    seq 524288, global_batch 1    -> serve_step; requires a
                                               sub-quadratic path

Skips:
  * long_500k for pure full-attention archs (qwen1.5/deepseek/qwen3/pixtral/
    qwen2-moe): a 500k dense KV cache has no sub-quadratic path;
  * decode_32k + long_500k for hubert (encoder-only: no decode step).
=> 32 cells.

Nothing here runs a cell: it is the per-cell configuration (the one
caller of ``models.surgery``) and the inputs' shapes and types.

``configure_for_cell`` returns the reference's deployment on its
production mesh, which the dry run (``launch/dryrun.py``) runs on
DTensors: prefill cells get ``attn_impl="blocked"`` (plain PyTorch, not
the flash kernel), some train and prefill cells ``attn_sp=True``
(sequence-parallel attention over the mesh's model axis; outside a mesh
context it changes nothing), tuned decode_32k cells the int8
``kv_quant``, and heads padded for a 16-way model axis.  A runner of
these cells on one card sets ``attn_impl="flash"`` itself.
"""
from __future__ import annotations

import dataclasses

import torch

from ..data import BatchSpec, make_batch_specs
from ..models import registry, surgery, transformer
from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES = {
    "train_4k": Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}

# per-arch knobs for the *full-scale* cells
#   micro: gradient-accumulation microbatches for train_4k (activation fit)
#   kv_quant: int8 KV cache for the 32k decode cell (HBM fit)
#   pad_heads: TP head padding for the prefill cell (models/surgery.py)
#   attn_sp: sequence-parallel attention; no_tp: no feature-TP
ARCH_TUNING: dict[str, dict] = {
    "qwen1.5-32b":     {"micro": 16, "kv_quant": True, "pad_heads": True,
                        "attn_sp": True},
    "deepseek-67b":    {"micro": 16, "kv_quant": True,
                        "remat_policy": "dots"},
    "deepseek-7b":     {"micro": 8},
    "qwen3-32b":       {"micro": 16},
    "zamba2-1.2b":     {"micro": 4},
    "pixtral-12b":     {"micro": 8},
    "qwen2-moe-a2.7b": {"micro": 8},
    "mixtral-8x7b":    {"micro": 16, "remat_policy": "dots",
                        "train_capacity": 1.0},
    "rwkv6-7b":        {"micro": 8},
    # 1B-param encoder: feature-TP over 16 gives 80-column matmul shards
    # and all-reduces that dwarf the math; DP+SP instead
    "hubert-xlarge":   {"micro": 8, "attn_sp": True, "no_tp": True},
}


def cell_is_skipped(cfg: ModelConfig, shape: Shape) -> str | None:
    """-> reason string if this (arch, shape) cell is skipped, else None."""
    if shape.kind == "decode" and not cfg.supports_decode:
        return "encoder-only: no decode step"
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return "full attention: no sub-quadratic path at 500k"
    return None


def cells(archs: list[str] | None = None) -> list[tuple[str, str]]:
    """All non-skipped (arch, shape) pairs."""
    from ..configs import ARCHS
    out = []
    for arch in archs or ARCHS:
        cfg = registry.get_config(arch)
        for sname, shape in SHAPES.items():
            if cell_is_skipped(cfg, shape) is None:
                out.append((arch, sname))
    return out


def configure_for_cell(cfg: ModelConfig, shape: Shape) -> ModelConfig:
    """Cell-specific model settings: the reference's TPU deployment
    (see the module docstring for what one card cannot take of it)."""
    tune = ARCH_TUNING.get(cfg.name, {})
    if shape.kind == "train":
        cfg = cfg.replace(remat_policy=tune.get("remat_policy", "nothing"),
                          attn_sp=tune.get("attn_sp", False))
        if cfg.moe is not None and "train_capacity" in tune:
            cfg = cfg.replace(moe=dataclasses.replace(
                cfg.moe, capacity_factor=tune["train_capacity"]))
        return cfg
    # inference: serve in bf16 params
    cfg = cfg.replace(param_dtype=torch.bfloat16)
    if shape.kind == "prefill":
        # stream attention over kv blocks: never materialize 32k x 32k
        if cfg.block in ("attn", "zamba2"):
            cfg = cfg.replace(attn_impl="blocked")
        if tune.get("attn_sp"):
            cfg = cfg.replace(attn_sp=True)
        if tune.get("pad_heads"):
            # vLLM-style TP head padding: 40 heads -> 48, 3 a device
            cfg = surgery.pad_heads_config(cfg, divisor=16)
        if cfg.moe is not None:
            # bound live MoE dispatch buffers over the 1M-token batch
            cfg = cfg.replace(
                moe=dataclasses.replace(cfg.moe, scan_groups=8))
        return cfg
    if shape.name == "decode_32k" and tune.get("kv_quant"):
        cfg = cfg.replace(kv_quant=True)
    return cfg


def microbatches_for(arch: str) -> int:
    return ARCH_TUNING.get(arch, {}).get("micro", 8)


def no_tp(arch: str) -> bool:
    """Small-model cells that skip feature-TP (weights replicated over
    the model axis; the model axis serves sequence parallelism)."""
    return ARCH_TUNING.get(arch, {}).get("no_tp", False)


def decode_cache_len(cfg: ModelConfig, shape: Shape) -> int:
    """Physical cache length for decode cells (window-bounded for SWA)."""
    if cfg.sliding_window is not None:
        return min(shape.seq_len, cfg.sliding_window)
    return shape.seq_len


def input_specs(arch: str, shape_name: str) -> dict:
    """Shape and type stand-ins for every model input of one cell: the
    batch's ``BatchSpec``s, or for decode the cache on the ``meta``
    device (no allocation; the reference's logical specs have no
    counterpart) and ``BatchSpec``s of the new token and ``cache_len``."""
    shape = SHAPES[shape_name]
    cfg = configure_for_cell(registry.get_config(arch), shape)
    if shape.kind in ("train", "prefill"):
        specs = make_batch_specs(cfg, shape.global_batch, shape.seq_len)
        if shape.kind == "prefill":
            specs.pop("labels", None)
        return {"batch": specs}
    return {
        "cache": transformer.init_cache(
            cfg, shape.global_batch, decode_cache_len(cfg, shape),
            device="meta"),
        "tokens": BatchSpec((shape.global_batch, 1), torch.int32),
        "cache_len": BatchSpec((), torch.int32),
    }
