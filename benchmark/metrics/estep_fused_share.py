"""The share of the window's E-steps that ran the fused kernel K6, in %:
the counter "estep.fused" over the counter "estep" (every E-step, those of
a retried align too). Where the dispatch rule puts every E-step on K6 it
reads 100; a change that takes E-steps off K6 lowers it."""


def read(run):
    s = [x for x in run["sessions"] if "estep" in x["timing"] and "estep.fused" in x["timing"]]
    n = sum(x["timing"]["estep"]["count"] for x in s)
    return 100.0 * sum(x["timing"]["estep.fused"]["count"] for x in s) / n if n else None
