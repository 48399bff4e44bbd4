"""build.kmeans_s: seconds of every k-means fit of the build
(``kmeans_fit``, and ``kmeans_fit_batched`` for PQ codebooks), each timed
by the harness with the device synchronised on both sides."""


def read(run):
    durs = run.trace.host_durations("build.kmeans")
    return sum(durs) if durs else None
