"""Host reads of device values counted by SMC2 and its rejuvenation kernel
(``n_host_syncs`` of both) an observation assimilated in the window."""


def read(run):
    syncs = run.counters.get("host_syncs")
    return None if not syncs or not run.observations else syncs / run.observations
