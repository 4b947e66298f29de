"""The planted record of the DeepSeekMoE training cell's readers: the
training record (``planted.train_record``) with latent attention's core
and the MoE layer's spans inside each step's forward and again in its
backward's recompute, each over kernels of its own, and the trials'
``trainer.counts`` spans with their ``moe.pairs`` counters."""
from hopaas_bench.planted import MS, T0, kernel, stands_for, train_record
from repro_torch.spans import Span

# (span, its start ms in a step, its kernels' device ms): each span lasts
# 1 ms and launches its kernel half-way; a step reads mla.core 4 (2 in the
# forward, 2 in the recompute), route, dispatch and combine 3, experts and
# shared 5
FORWARD = (("mla.core", 12, 2), ("moe.route", 13, 1), ("moe.dispatch", 14, 1),
           ("moe.sync", 15, 0), ("moe.experts", 16, 3), ("moe.combine", 17, 1),
           ("moe.shared", 18, 1))
RECOMPUTE = (("mla.core", 22, 2), ("moe.shared", 24, 1))
# (start ms, pairs by layer and held expert): the window's two trials sum
# to [[40, 40], [40, 80]], whose largest over the mean is 80 / 50; the
# one before the window is left out
LOADS = ((-4, [[1000, 0], [0, 0]]), (46, [[10, 30], [20, 40]]),
         (96, [[30, 10], [20, 40]]))


@stands_for("hpo_train", clock_shift_ns=-1_310_000)
def moe_record():
    spans, kernels, extra = train_record()
    ids = 1000

    def add(name, start, end, thread=1, **attrs):
        nonlocal ids
        ids += 1
        spans.append(Span(name, ids, None, ids, thread,
                          int(T0 + start * MS), int(T0 + end * MS), attrs))
    for o in (0, 50):
        for thread, group in ((1, FORWARD), (2, RECOMPUTE)):
            for name, at, ms in group:
                add(name, o + at, o + at + 1, thread)
                if ms:
                    kernels.append(kernel(o + at + 0.5, o + at + 0.5,
                                          o + at + 0.5 + ms))
    for at, pairs in LOADS:
        add("trainer.counts", at, at + 1, **{"moe.pairs": pairs})
    kernels.sort(key=lambda k: k.start)
    return spans, kernels, extra
