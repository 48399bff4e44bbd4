"""build.rest_s: the traced run's build less its k-means fits: labels to
the host, the list storage, the PQ encode."""


def read(run):
    durs = run.trace.host_durations("build.kmeans")
    return run.build_s - sum(durs) if durs else None
