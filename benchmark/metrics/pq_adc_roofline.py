"""pq_adc_roofline: the least time of the captured ``pq_adc_lists``
launches (``roofline.pq_adc_counts`` on each launch's inputs) over the
device time of the kernels launched inside the harness span around them."""

from benchmark import roofline


def read(run):
    cap = run.capture
    kept = run.trace.kept.get("bench.pq_adc")
    dev_s = cap["span_device_s"].get("bench.pq_adc", 0.0) if cap else 0.0
    if not kept or dev_s <= 0:
        return None
    least = sum(roofline.least_time_s(*roofline.pq_adc_counts(*k)) for k in kept)
    return 100.0 * least / dev_s
