"""APF corrections (``APF.corrections``: forward steps and re-filter steps)
an observation assimilated in the window."""


def read(run):
    steps = run.counters.get("apf_steps")
    return None if not steps or not run.observations else steps / run.observations
