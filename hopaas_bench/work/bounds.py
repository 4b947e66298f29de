"""The least time of a kernel call, from its shapes: the larger of its
bytes at the HBM rate (each input read once, each output written once)
and its operations, products at the bf16 tensor-core rate and the
exponentials the algorithm needs at the SFU rate (the two units run side
by side, so the slower one bounds).  Copied from the formulas that
measured the port's kernels (``chip_smoke.py``'s ``bound``,
``scan_bound`` and ``visible_pairs``), with the scans' one exponential
for each decay element and not the kernels' own.
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def least_ms(nbytes: float, flops: float, exps: float = 0.0) -> float:
    t_bytes = nbytes / PEAKS["hbm_bytes_per_s"]
    t_ops = max(flops / PEAKS["bf16_flops_per_s"],
                exps / PEAKS["sfu_exp_per_s"])
    return max(t_bytes, t_ops) * 1e3


def visible_pairs(s: int) -> int:
    """(q, k) pairs a causal mask lets through, S = T: S(S+1)/2."""
    return s * (s + 1) // 2


def flash_ms(b: int, s: int, hq: int, hkv: int, hd: int, elt: int = 2
             ) -> float:
    """Causal flash attention, q (b, s, hq, hd), k and v (b, s, hkv, hd):
    q.k and p.v a multiply-add each for each visible pair (the softmax's
    exponentials overlap the products and bound less)."""
    pairs = b * hq * visible_pairs(s)
    nbytes = elt * b * s * hd * (2 * hq + 2 * hkv)
    return least_ms(nbytes, 4 * hd * pairs, pairs)


def ssd_ms(b: int, s: int, nh: int, hd: int, ds: int, q: int = 64,
           elt: int = 2) -> float:
    """The SSD scan, chunk ``q``: x, dt, B, C in and y out at ``elt``
    bytes, a_log in and the final state out in float32; the chunked
    products and one exponential a token and head."""
    n_ch = b * nh * (s // q)
    pairs = q * (q + 1) // 2
    flops = 2 * n_ch * (pairs * ds + pairs * hd + 2 * q * hd * ds)
    nbytes = (elt * (2 * b * s * nh * hd + b * s * nh + 2 * b * s * ds)
              + 4 * (nh + b * nh * hd * ds))
    return least_ms(nbytes, flops, b * s * nh)


def wkv6_ms(b: int, s: int, nh: int, hd: int, q: int = 64, elt: int = 2
            ) -> float:
    """The WKV6 scan, chunk ``q``: r, k, v, logw, u in and o out at
    ``elt`` bytes, the final state out in float32; the chunked products
    and one exponential a token and channel."""
    n_ch = b * nh * (s // q)
    strict = q * (q - 1) // 2
    pairs = strict + q
    flops = n_ch * (3 * strict * hd + 3 * q * hd + 2 * pairs * hd
                    + 4 * q * hd * hd)
    nbytes = elt * (5 * b * s * nh * hd + nh * hd) + 4 * b * nh * hd * hd
    return least_ms(nbytes, flops, b * s * nh * hd)
