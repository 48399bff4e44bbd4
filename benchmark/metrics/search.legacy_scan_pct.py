"""search.legacy_scan_pct: the share of the cell's grouped searches that
ran the legacy plain-PyTorch scan and not the CUDA kernel (the ``legacy``
series of the program's ``ivf_search_scan_form_total`` over all of its
series for the cell's engine). The counter counts every search of the
run, warm-up included; each search of a batch size takes the same form,
so the share is the window's. A program without the counter reads
nothing."""


def read(run):
    try:
        from raft_tpu_torch.obs.metrics import default_registry
    except ImportError:
        return None
    engine = run.cfg["engine"]
    by_form: dict = {}
    for c in default_registry().series("ivf_search_scan_form_total"):
        if c.labels.get("engine") == engine:
            form = c.labels.get("form")
            by_form[form] = by_form.get(form, 0) + c.value
    total = sum(by_form.values())
    if not total:
        return None
    return 100.0 * by_form.get("legacy", 0) / total
