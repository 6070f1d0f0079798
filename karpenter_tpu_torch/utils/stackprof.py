"""Lightweight sampling profiler behind /debug/stacks and the threaded
Manager benchmarks.

Samples sys._current_frames() on an interval and aggregates per-thread
leaf frames plus whole-stack signatures, so we can see where wall-clock
goes across the watch pumps / selection loop / batcher / bind threads
without yappi (not in this image). Lives in the production package — the
/debug/stacks endpoint must not degrade when a deployment ships
karpenter_tpu without the repo's tools/ tree.
"""

from __future__ import annotations

import collections
import sys
import threading

from karpenter_tpu_torch.utils.clock import SYSTEM_CLOCK


class StackProf:
    def __init__(self, interval_s: float = 0.004):
        self.interval_s = interval_s
        self.leaf = collections.Counter()
        self.frames2 = collections.Counter()  # leaf + caller, per thread-name
        self.samples = 0
        self._stop = threading.Event()
        self._thread = None

    def _run(self):
        while not self._stop.is_set():
            names = {t.ident: t.name for t in threading.enumerate()}
            for ident, frame in sys._current_frames().items():
                if ident == self._thread.ident:
                    continue
                name = names.get(ident, str(ident))
                # collapse thread pools into one bucket
                base = name.rstrip("0123456789-_ ")
                f = frame
                leaf = f"{f.f_code.co_filename.split('/')[-1]}:{f.f_code.co_name}"
                caller = ""
                if f.f_back is not None:
                    b = f.f_back
                    caller = f"{b.f_code.co_filename.split('/')[-1]}:{b.f_code.co_name}"
                self.leaf[(base, leaf)] += 1
                self.frames2[(base, f"{caller} -> {leaf}")] += 1
            self.samples += 1
            SYSTEM_CLOCK.sleep(self.interval_s)

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True, name="stackprof")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join()

    def report(self, top=30):
        print(f"== {self.samples} samples ==")
        print("-- by (thread, caller -> leaf) --")
        for (tname, sig), n in self.frames2.most_common(top):
            print(f"{n:6d}  [{tname}] {sig}")
