"""GC tuning for processes that carry a large long-lived heap.

A copy of ``evergreen_tpu/utils/gctune.py``. The scheduling tick keeps
tens of thousands of task and host objects alive for the process's
lifetime (the store, the TickCache's views, the resident plane's slot
table); an untamed collection of the oldest generation scans all of them
inside a tick. Freezing the warmed-up heap out of the collector and
raising the first generation's threshold takes that scan out of the
ticks. A long-lived service calls it once, after its first tick.
"""
from __future__ import annotations

import gc


def tune_gc_for_long_lived_heap() -> None:
    """Call once after startup/warmup state is fully built."""
    gc.collect()
    gc.freeze()
    gc.set_threshold(50_000, 25, 25)
