"""Per-session records of the answers a SLAM session produces.

run_slam writes its final trajectory, but the answers the comparison needs
stay inside the driver: each frame's odometry align, each loop
verification and each pose-graph optimisation. The recorder wraps the calls
that return them (`record` in the configuration) and keeps what they
returned, a session at a time; it computes nothing. Its only work inside
the window is one list append per call (per frame for the odometry align,
under a microsecond against a frame of tens of milliseconds).

Kinds of `record` entries ({"module", "attr", "kind", "as"}):
* "factory": `attr` returns a function; each of that function's results
  is kept;
* "verify": LoopVerifier.verify(store, cands, j, poses); kept: keyframe
  j's frame and index and, for each candidate, its frame, index,
  whether it was accepted, and Z;
* "call": each call's first argument and result.
"""

from __future__ import annotations

import contextlib
import importlib


class Recorder:
    def __init__(self, specs: list):
        self.specs = specs
        self.current = None

    def begin(self) -> dict:
        """A fresh record for the session about to run."""
        self.current = {s["as"]: [] for s in self.specs}
        return self.current

    def _factory(self, fn, key):
        def factory(*a, **kw):
            inner = fn(*a, **kw)

            def call(*a2, **kw2):
                res = inner(*a2, **kw2)
                self.current[key].append(res)
                return res
            return call
        return factory

    def _verify(self, fn, key):
        def verify(obj, store, cands, j, poses):
            out = fn(obj, store, cands, j, poses)
            self.current[key].append({"j": store[j].frame, "ji": j,
                                      "c": [{"frame": store[c].frame, "index": c, "ok": ok,
                                             "Z": Z} for c, ok, Z, _, _ in out]})
            return out
        return verify

    def _call(self, fn, key):
        def call(arg, *a, **kw):
            res = fn(arg, *a, **kw)
            self.current[key].append((arg, res))
            return res
        return call

    def active(self):
        """While the block runs, the recorded calls are wrapped."""
        kinds = {"factory": self._factory, "verify": self._verify, "call": self._call}
        return swapped(self.specs, lambda spec, orig: kinds[spec["kind"]](orig, spec["as"]))


@contextlib.contextmanager
def swapped(specs: list, wrap):
    """Replace each `attr` ("name" or "Class.name") of each spec's `module`
    by wrap(spec, original) while the block runs; restore them after."""
    undo = []
    try:
        for s in specs:
            owner = importlib.import_module(s["module"])
            *path, attr = s["attr"].split(".")
            for p in path:
                owner = getattr(owner, p)
            orig = getattr(owner, attr)
            setattr(owner, attr, wrap(s, orig))
            undo.append((owner, attr, orig))
        yield
    finally:
        for owner, attr, orig in reversed(undo):
            setattr(owner, attr, orig)
