"""Share of the profiled session's device idle time (the gaps between the
device's busy intervals) in which no host span was open, %: the idle time
no span of the program or the configuration names."""

from benchmark.trace import intervals


def read(run):
    p = run.get("profile")
    if not p or not p["device_ops"]:
        return None
    busy = intervals(p["device_ops"])
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    idle = sum(e - s for s, e in gaps)
    if idle <= 0.0:
        return None
    spans = intervals([(n, s, d) for n, s, d, user in p["host"] if user])
    covered, i = 0.0, 0
    for s, e in gaps:       # both sorted: one sweep
        while i < len(spans) and spans[i][1] <= s:
            i += 1
        j = i
        while j < len(spans) and spans[j][0] < e:
            covered += min(e, spans[j][1]) - max(s, spans[j][0])
            j += 1
    return 100.0 * (idle - covered) / idle
