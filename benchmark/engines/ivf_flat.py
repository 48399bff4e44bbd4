"""IVF-Flat through the port's public entry: ``ivf_flat_build``, then
``IVFFlatIndex.warmup`` and ``ivf_flat_search_grouped`` at the qcap the
warm-up returns for each batch size."""

from __future__ import annotations

from benchmark.engines import common

DISTANCE = "l2"          # the search returns sqrt of the squared L2 distance


def instrument(trace) -> None:
    """A traced run's spans: k-means in the build, the flat list scan."""
    from raft_tpu_torch.spatial.ann import flat_kernel, ivf_flat

    common.time_build_calls(trace, [(ivf_flat, "kmeans_fit")])
    common.span_launches(
        trace, flat_kernel, "flat_scan_lists", "bench.flat_scan",
        lambda queries, qmat, rows, origins, bounds, l_pad: (
            queries.shape[0] - 1, qmat, rows.shape[1], rows.element_size(),
            queries.element_size(), bounds, l_pad))


def build(x, cfg: dict, seed: int, device):
    from raft_tpu_torch.spatial.ann import IVFFlatParams, ivf_flat_build

    ix = cfg["index"]
    params = IVFFlatParams(n_lists=int(ix["n_lists"]),
                           kmeans_n_iters=int(ix["kmeans_n_iters"]),
                           kmeans_init=ix["kmeans_init"],
                           seed=int(ix["seed"]))
    return ivf_flat_build(x, params, device=device)


def search_fn(index, cfg: dict, nq: int):
    """The warmed search closure of batches of ``nq`` queries."""
    from raft_tpu_torch.spatial.ann import ivf_flat_search_grouped

    k, p = int(cfg["k"]), int(cfg["search"]["n_probes"])
    qcap = index.warmup(nq, k=k, n_probes=p)

    def search(q):
        return ivf_flat_search_grouped(index, q, k, n_probes=p, qcap=qcap)

    return search


def yardstick(index, cfg: dict) -> dict:
    d = int(cfg["dim"])
    return {"centroids": index.centroids, "list_sizes": index.storage.list_sizes,
            "n_probes": int(cfg["search"]["n_probes"]), "dim": d, "k": int(cfg["k"]),
            "ops_per_row": 2 * d, "row_bytes": 2 * d}
