"""The plain reference, in float32: what every stack shares (the token
embedding, RMSNorm, rotary attention, the gated MLP, the final norm and
LM head, the loss), and the stack itself found by the configuration's
``block`` in ``reference/<block>.py``.

A block joins by that file alone: its ``stack(ref, x)`` runs the layers
on the embedded rows (``ref.run_block`` recomputes each in the backward)
and may leave a training term in ``ref.train_term``, a scalar tensor
computed in the same forward (a router's balance loss), which
``Reference.loss`` adds to the cross-entropy.  ``train.py`` takes the
loss a row at a time over the number of rows, so a per-sequence term is
split by row as the cross-entropy is.

Written from the published equations, not from the program.  The
parameters are a tree with the program's keys and layouts (the
benchmark makes them and hands the same tree to both sides); the
reference reads them as float32 and never writes them.

``control="fp8"`` computes the whole reference in float8 e4m3
(``Fp8Compute``: every operation's result and every gradient through it
rounded, a per-tensor scale), the control that must fail.  Matrix
products never use TF32: ``fp32_products`` turns it off.
"""
from __future__ import annotations

import contextlib
import importlib
import math

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode
from torch.utils.checkpoint import checkpoint

NEG_INF = float("-inf")


def fp32_products() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _to_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` through float8 e4m3 with a per-tensor scale; values that
    are not finite (a mask's -inf) pass as they are."""
    if t.numel() == 0:
        return t
    finite = torch.isfinite(t)
    scale = 448.0 / torch.where(finite, t.abs(), 0).amax().clamp(min=1e-30)
    r = (torch.where(finite, t, 0) * scale).to(torch.float8_e4m3fn)
    return torch.where(finite, r.to(t.dtype) / scale, t)


class _Fp8(torch.autograd.Function):
    """float8 on the way forward and on the gradient's way back."""

    @staticmethod
    def forward(ctx, t):
        return _to_fp8(t)

    @staticmethod
    def backward(ctx, g):
        return _to_fp8(g)


class Fp8Compute(TorchFunctionMode):
    """Every floating result of every operation, and every gradient
    that flows back through it, rounded to float8: the reference
    computed in fp8 (the control)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor) and out.is_floating_point():
            return _Fp8.apply(out)
        return out


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a tree stacked along its leading dim."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over positions 0..S-1, the two halves of the head
    dim rotated as pairs.  x (b,S,H,hd)."""
    S, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device,
                                         dtype=torch.float32) / hd)
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class Reference:
    """The forward of one configuration (``cfg``: the configuration file's
    sizes) over a parameter tree read as float32."""

    def __init__(self, cfg: dict, params: dict, control: str | None = None,
                 remat: bool = False):
        if control not in (None, "fp8"):
            raise ValueError(f"unknown control {control!r}")
        self.c, self.p = cfg, params
        self.low = control == "fp8"
        self.remat = remat
        self.eps = cfg.get("norm_eps", 1e-5)
        self.train_term: torch.Tensor | None = None

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x @ w.float().reshape(x.shape[-1], -1)

    def norm(self, x, w):
        return rmsnorm(x, w.float(), self.eps)

    # ---- blocks ------------------------------------------------------ #
    def attention(self, p: dict, x: torch.Tensor,
                  q_block: int = 1024) -> torch.Tensor:
        c = self.c
        b, S, _ = x.shape
        H, Hkv, hd = c["n_heads"], c["n_kv_heads"], c["head_dim"]
        theta = c.get("rope_theta", 10000.0)
        q = rope(self.mm(x, p["wq"]).reshape(b, S, H, hd), theta)
        k = rope(self.mm(x, p["wk"]).reshape(b, S, Hkv, hd), theta)
        v = self.mm(x, p["wv"]).reshape(b, S, Hkv, hd)
        k = k.repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
        v = v.repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
        q = q.transpose(1, 2)
        pos = torch.arange(S, device=x.device)
        outs = []
        for q0 in range(0, S, q_block):
            qb = q[:, :, q0: q0 + q_block]
            sc = qb @ k.transpose(-1, -2) / math.sqrt(hd)
            mask = pos[None, :] > pos[q0: q0 + q_block, None]
            outs.append(torch.softmax(sc.masked_fill(mask, NEG_INF), -1) @ v)
        o = torch.cat(outs, dim=2).transpose(1, 2).reshape(b, S, H * hd)
        return self.mm(o, p["wo"])

    def mlp(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        return self.mm(self.mm(x, p["up"]) * F.silu(self.mm(x, p["gate"])),
                       p["down"])

    def attn_block(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(p["attn"], self.norm(x, p["norm1"]))
        return x + self.mlp(p["mlp"], self.norm(x, p["norm2"]))

    # ---- the stack ----------------------------------------------------- #
    def run_block(self, fn, p, x):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(fn, p, x, use_reentrant=False)
        return fn(p, x)

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """The stack's output (b,S,d) before the final norm: the embedding,
        then ``reference/<block>.py``'s ``stack``.  Resets ``train_term``
        to zero (None) first: the stack may set it."""
        self.train_term = None
        x = self.p["embed"][tokens.long()].float()
        try:
            block = importlib.import_module(
                f"{__package__}.{self.c['block']}")
        except ModuleNotFoundError:
            raise ValueError(
                f"no reference for block {self.c['block']!r}") from None
        return block.stack(self, x)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.mm(self.norm(x, self.p["final_norm"]), self.p["lm_head"])

    def _compute(self):
        return Fp8Compute() if self.low else contextlib.nullcontext()

    def last_logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """(b, V) logits at each row's last position."""
        with self._compute():
            return self.logits(self.hidden(tokens)[:, -1])

    def loss(self, tokens: torch.Tensor, labels: torch.Tensor
             ) -> torch.Tensor:
        """Mean next-token cross-entropy over every position, plus the
        training term the stack left (``train_term``), under the same
        compute (the fp8 control rounds it too).  With no term the loss is
        the cross-entropy alone, op for op."""
        with self._compute():
            logits = self.logits(self.hidden(tokens))
            ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                 labels.reshape(-1).long())
            return ce if self.train_term is None else ce + self.train_term
