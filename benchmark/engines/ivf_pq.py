"""IVF-PQ through the port's public entry: ``ivf_pq_build`` with the raw
rows kept for refinement, then ``IVFPQIndex.warmup`` and
``ivf_pq_search_grouped`` at the qcap the warm-up returns."""

from __future__ import annotations

from benchmark.engines import common

DISTANCE = "sqeuclidean"   # the refined search returns squared L2 distances


def instrument(trace) -> None:
    """A traced run's spans: both k-means fits of the build (the coarse
    quantizer, and the batched codebook fit), the ADC list scan."""
    from raft_tpu_torch.spatial.ann import ivf_pq, pq_kernel

    common.time_build_calls(trace, [(ivf_pq, "kmeans_fit"),
                                            (ivf_pq, "kmeans_fit_batched")])
    common.span_launches(
        trace, pq_kernel, "pq_adc_lists", "bench.pq_adc",
        lambda luts, lut_map, codes, origins, bounds, l_pad: (
            luts.shape[0], lut_map, codes.shape[1], codes.element_size(),
            bounds, l_pad))


def build(x, cfg: dict, seed: int, device):
    from raft_tpu_torch.spatial.ann import IVFPQParams, ivf_pq_build

    ix = cfg["index"]
    params = IVFPQParams(n_lists=int(ix["n_lists"]), pq_dim=int(ix["pq_dim"]),
                         pq_bits=int(ix["pq_bits"]),
                         kmeans_n_iters=int(ix["kmeans_n_iters"]),
                         pq_kmeans_n_iters=int(ix["pq_kmeans_n_iters"]),
                         kmeans_init=ix["kmeans_init"], store_raw=True,
                         seed=int(ix["seed"]))
    return ivf_pq_build(x, params, device=device)


def search_fn(index, cfg: dict, nq: int):
    """The warmed search closure of batches of ``nq`` queries."""
    from raft_tpu_torch.spatial.ann import ivf_pq_search_grouped

    s = cfg["search"]
    k, p, r = int(cfg["k"]), int(s["n_probes"]), float(s["refine_ratio"])
    qcap = index.warmup(nq, k=k, n_probes=p, refine_ratio=r)

    def search(q):
        return ivf_pq_search_grouped(index, q, k, n_probes=p, qcap=qcap,
                                     refine_ratio=r)

    return search


def yardstick(index, cfg: dict) -> dict:
    m = int(cfg["index"]["pq_dim"])
    return {"centroids": index.centroids, "list_sizes": index.storage.list_sizes,
            "n_probes": int(cfg["search"]["n_probes"]), "dim": int(cfg["dim"]),
            "k": int(cfg["k"]), "ops_per_row": m, "row_bytes": m}
