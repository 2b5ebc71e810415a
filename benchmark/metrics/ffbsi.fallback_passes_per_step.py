"""Exact-fallback passes of rejection FFBSi (``ffbsi_smooth.fallback_passes``)
a backward step in the window: the targets no rejection round accepted."""


def read(run):
    passes = run.counters.get("fallback_passes")
    steps = run.counters.get("backward_steps")
    return None if passes is None or not steps else passes / steps
