"""search_roofline: the least time of the captured batch calls (the
yardstick's count from each batch's queries and the index's lists,
``roofline.search_counts``) over the device's busy time in the capture."""

from benchmark import roofline


def read(run):
    cap, ys = run.capture, run.yardstick
    if not cap or not ys or cap["busy_s"] <= 0 or not run.calls_in_capture:
        return None
    least = []
    for q in run.batch_queries:
        probes = roofline.probe(q, ys["centroids"], ys["n_probes"])
        least.append(roofline.least_time_s(*roofline.search_counts(
            probes, ys["list_sizes"], dim=ys["dim"], k=ys["k"],
            ops_per_row=ys["ops_per_row"], row_bytes=ys["row_bytes"])))
    per_call = sum(least) / len(least)
    return 100.0 * per_call * run.calls_in_capture / cap["busy_s"]
