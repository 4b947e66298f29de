"""Batched prefill in a closed loop, one request at a time.

Traffic parameters (``traffic/<mix>.json``): ``batch`` (prompts a
request), ``lengths`` and ``weights`` (the prompt lengths and how many
of each in every deck of ``sum(weights)`` requests; each deck is shuffled
from the seed, so every seed sends the same sizes in another order),
``max_rate`` (requests a second no run can pass, which sizes the pool of
prompts), ``sample`` (requests the reference checks).

Each request runs the port's ``make_prefill_step`` on the weights
``cast_params`` serves (the benchmark's bf16 weights, ``harness
.make_params``) and copies the argmax of each prompt's last position to
the host: the first token.  Token ids are uniform over the vocabulary,
drawn on the card from the seed.  After the window the reference runs a
sample of the finished requests, drawn from the seed with the longest
among them, and the number compared is the widest gap by which a served
first token's logit lies below the reference's best.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import harness
from ..harness import Outcome, Run, log
from ..reference import model as ref_model
from ..reference.compare import widest


def deck(seed: int, traffic: dict, n: int) -> list[int]:
    """The prompt lengths of the first ``n`` requests."""
    one = [L for L, w in zip(traffic["lengths"], traffic["weights"])
           for _ in range(w)]
    rng = np.random.default_rng([seed, 0x5eed])
    out: list[int] = []
    while len(out) < n:
        out.extend(int(x) for x in rng.permutation(one))
    return out[:n]


def prompts(seed: int, n: int, batch: int, length: int, vocab: int, device
            ) -> torch.Tensor:
    """(n, batch, length) int32 token ids: request i's prompts are its
    rows' first ``length_i`` ids."""
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    return torch.randint(0, vocab, (n, batch, length), generator=gen,
                         device=device, dtype=torch.int32)


def sample(seed: int, lengths: list[int], k: int) -> list[int]:
    """``k`` request indices drawn from the seed, the first of the longest
    among them."""
    longest = lengths.index(max(lengths))
    rng = np.random.default_rng([seed, 0x5a4d])
    rest = [i for i in rng.permutation(len(lengths)) if i != longest]
    return sorted([longest] + [int(i) for i in rest[: k - 1]])


def reference_gaps(run: Run, checks: list[tuple[torch.Tensor, list[int]]],
                   control: str | None = None, altered: list | None = None
                   ) -> tuple[list[float], int]:
    """For each (prompts, served first tokens), the reference's
    last-position logits and the gap of each served token below their
    best (``control``: the gap of the token the control puts first, the
    served tokens unused).  -> (gaps, rows with no answer).  ``altered``
    (a list) gets the gaps of each served token plus one, from the same
    logits."""
    conf = run.cell.config
    ref_model.fp32_products()
    params = harness.make_params(run.model_config("serve"), run.seed,
                                 run.device, conf["init"])
    ref = ref_model.Reference(conf, params)
    low = ref_model.Reference(conf, params, control) if control else None
    gaps, missing = [], 0
    with torch.no_grad():
        for toks, served in checks:
            want = ref.last_logits(toks)
            got = low.last_logits(toks).argmax(-1).tolist() if low else served
            for row, tok in enumerate(got[: want.shape[0]]):
                gaps.append(float(want[row].max() - want[row, tok]))
                if altered is not None:
                    other = (tok + 1) % want.shape[1]
                    altered.append(float(want[row].max() - want[row, other]))
            missing += want.shape[0] - len(got)
    return gaps, missing


def run(run: Run) -> Outcome:
    from repro_torch.serve.engine import cast_params, make_prefill_step

    T, spans, dev = run.cell.traffic, run.spans, run.device
    conf = run.cell.config
    mcfg = run.model_config("serve")
    B, vocab = T["batch"], conf["vocab_size"]
    n_max = int(T["max_rate"] * run.seconds) + sum(T["weights"])
    lengths = deck(run.seed, T, n_max)
    with spans.span("setup.weights"):
        params = harness.make_params(mcfg, run.seed, dev, conf["init"])
        served = cast_params(params, mcfg, dev)
        del params
        pool = prompts(run.seed, n_max, B, max(T["lengths"]), vocab, dev)
    prefill = make_prefill_step(mcfg)

    def request(i: int) -> list[int]:
        rows = B // 2 if "half_batch" in run.faults else B
        logits = prefill(served, {"tokens": pool[i, :rows, : lengths[i]]})
        first = logits[:, -1].argmax(-1).tolist()
        if "altered_token" in run.faults:
            first[0] = (first[0] + 1) % vocab
        return first

    with spans.span("setup.warmup"):
        for L in T["lengths"]:
            for _ in range(2):
                logits = prefill(served, {"tokens": pool[0, :, :L]})
        del logits
        if dev.type == "cuda":
            torch.cuda.synchronize()
    run.open_window()
    launches = harness.launch_counts(conf)
    done: list[dict] = []
    while True:
        i = len(done) % n_max
        t0 = time.time_ns()
        with spans.span("request", length=lengths[i]):
            first = request(i)
        t1 = time.time_ns()
        done.append({"i": i, "length": lengths[i], "start": t0, "end": t1,
                     "first": first})
        if (t1 - run.t_open) / 1e9 >= run.seconds:
            break
        if len(done) == n_max:
            log(f"prefill: {n_max} requests in the window; later ones "
                "reuse the pool's prompts")
    run.close_window()
    run.after_window()
    launches = {k: n - launches[k]
                for k, n in harness.launch_counts(conf).items()}
    del served, prefill
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    span_s = run.window_s
    tokens = sum(r["length"] for r in done) * B
    lat = sorted((r["end"] - r["start"]) / 1e6 for r in done)
    e2e = {"prefill_tokens_per_s": tokens / span_s,
           "prefill_p95_ms": float(np.percentile(lat, 95))}
    log(f"prefill: {len(done)} requests, {tokens} prompt tokens in "
        f"{span_s:.3f} s; latency p50 {np.percentile(lat, 50):.3f} ms, "
        f"p95 {e2e['prefill_p95_ms']:.3f} ms")

    picked = [done[j] for j in sample(run.seed, [r["length"] for r in done],
                                      T["sample"])]
    t0 = time.perf_counter()
    gaps, missing = reference_gaps(
        run, [(pool[r["i"], :, : r["length"]], r["first"]) for r in picked])
    log(f"reference: {len(picked)} requests, {len(gaps)} first tokens in "
        f"{time.perf_counter() - t0:.1f} s")
    numbers = {"first_token_gap": widest(gaps),
               "unanswered": float(missing)}
    record = {"run": run, "requests": done, "batch": B, "launches": launches}
    return Outcome(e2e, record, numbers, attempted=len(done), failed=0)
