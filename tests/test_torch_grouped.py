"""The grouped IVF search's engine rule and its layering, on the CPU.

``grouped.resolve_kernel`` is the one ``use_kernel`` rule of the IVF-Flat,
IVF-SQ and IVF-PQ engines: the same answers, raised messages, fallback
counts and once-per-reason warnings for each (the check never touches a
card: a CUDA device is named, never used). The layering: the kernels'
modules and ``common`` import no module above them, at any scope.
"""

import ast
import pathlib

import pytest
import torch

from raft_tpu_torch.spatial.ann import grouped
from raft_tpu_torch.spatial.ann.ivf_pq import PQEngine
from raft_tpu_torch.spatial.ann.ivf_sq import SQEngine

CPU = torch.device("cpu")
CUDA = torch.device("cuda")

# per engine: its class, a shape the kernel serves, one it does not, one
# ``use_kernel=True`` raises at with the message's fragments, and the
# fallback reason's fragment
RULES = {
    "flat": (grouped.FlatEngine, (16, 64), (1 << 14, 64), (1 << 14, 64),
             ("use_kernel=True unsupported",), "d=16384"),
    "sq": (SQEngine, (16, 64), (1 << 12, 64), (1 << 20, 512),
           ("sq_scan_supported", "plan_l_tile"), "d=4096"),
    "pq": (PQEngine, (24, 8), (4096, 8), (4096, 8), ("unsupported",),
           "pq_dim=4096"),
}


@pytest.mark.parametrize("kind", list(RULES))
def test_engine_rule_answers_raises_and_counts(kind, caplog, monkeypatch):
    """None runs the kernel only on a Hopper card where it fits, True
    raises with the unmet requirement, False pins the legacy engine; a
    CUDA search the kernel cannot serve is counted under its engine and
    warned about once per reason; a CPU index, an explicit False and an
    unrefined PQ search are no fallback."""
    cls, ok, bad, raising, fragments, reason = RULES[kind]

    def rule(use_kernel, shape, device, refine=True):
        return grouped.resolve_kernel(use_kernel, cls, device, *shape,
                                      refine=refine)

    assert rule(None, ok, CPU) is False
    assert rule(True, ok, CPU) is True
    assert rule(False, ok, CPU) is False
    with pytest.raises(ValueError) as e:
        rule(True, raising, CPU)
    assert all(f in str(e.value) for f in fragments)
    if kind == "pq":
        with pytest.raises(ValueError, match="refine tail"):
            rule(True, ok, CPU, refine=False)
    before = grouped.ENGINE_FALLBACKS[cls.name]
    assert rule(None, ok, CPU) is False
    assert rule(False, bad, CUDA) is False
    if kind == "pq":
        # unrefined: the one-hot engine by rule, not counted
        assert rule(None, ok, CUDA, refine=False) is False
    assert grouped.ENGINE_FALLBACKS[cls.name] == before
    # a search on a Hopper card that fits takes the kernel, not counted
    monkeypatch.setattr(grouped, "hopper_device", lambda dev: True)
    assert rule(None, ok, CUDA) is True
    assert grouped.ENGINE_FALLBACKS[cls.name] == before
    grouped._fallback_reasons_warned.clear()
    with caplog.at_level("WARNING", logger="raft_tpu_torch"):
        for _ in range(3):
            assert rule(None, bad, CUDA) is False
    assert grouped.ENGINE_FALLBACKS[cls.name] == before + 3
    warned = [r.getMessage() for r in caplog.records
              if cls.label in r.getMessage()]
    assert len(warned) == 1
    assert "legacy" in warned[0] and reason in warned[0]


ANN = pathlib.Path(grouped.__file__).parent
PKG = "raft_tpu_torch.spatial.ann"
# the layers above the grouped body: the index modules, the mutation
# tier, the slab tiers and the sharded searches
ABOVE_GROUPED = ("ivf_flat", "ivf_sq", "ivf_pq", "mutation")
ABOVE_PACKAGES = ("raft_tpu_torch.tier", "raft_tpu_torch.comms")


def _imported(path: pathlib.Path) -> set:
    """Every module ``path`` imports, at any scope (a lazy import inside a
    function counts), names imported from a package as its modules."""
    out = set()
    pkg = PKG
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = pkg.split(".")[:len(pkg.split(".")) - node.level + 1]
                base = ".".join(parts + ([base] if base else []))
            out.add(base)
            out.update(f"{base}.{a.name}" for a in node.names)
    return out


def _above(name: str, forbidden) -> bool:
    return (name in {f"{PKG}.{m}" for m in forbidden}
            or name.startswith(ABOVE_PACKAGES))


@pytest.mark.parametrize("module,forbidden", [
    (m, ("grouped", "coarse") + ABOVE_GROUPED)
    for m in ("scan_core", "flat_kernel", "sq_kernel", "pq_kernel",
              "rerank", "common")
] + [
    ("grouped", ("coarse",) + ABOVE_GROUPED),
    ("coarse", ABOVE_GROUPED),
])
def test_lower_layers_import_no_higher_one(module, forbidden):
    """The kernels' modules and the storage-and-probe layer import
    neither the grouped body nor anything above it; the grouped body and
    the two-level probe's engines import no index module or the layers
    above them."""
    found = sorted(n for n in _imported(ANN / f"{module}.py")
                   if _above(n, forbidden))
    assert not found, f"{module} imports {found}"


WIDE = (768, 960, 1536)


def _integer_index(d, n=8192, n_lists=64, nq=256, seed=0):
    """Integer-valued rows and queries near 16 integer centres (every f32
    distance sum exact in any order, bf16 exact), and a CPU index of them
    (its list count the IVF build's over those rows)."""
    from raft_tpu_torch.spatial.ann import IVFFlatParams, ivf_flat_build

    g = torch.Generator().manual_seed(seed + d)
    centres = torch.randint(-4, 5, (16, d), generator=g).float()
    x = centres[torch.randint(0, 16, (n,), generator=g)]
    x = x + torch.randint(-3, 4, (n, d), generator=g).float()
    q = centres[torch.randint(0, 16, (nq,), generator=g)]
    q = q + torch.randint(-3, 4, (nq, d), generator=g).float()
    index = ivf_flat_build(x, IVFFlatParams(n_lists=n_lists, seed=0),
                           device="cpu")
    return index, x, q


def _ids_up_to_ties(dists, i0, i1):
    """ids equal except inside equal-distance runs, where each interior
    run holds the same id set (the run cut by the k-th place is checked
    by distance alone)."""
    for r in range(dists.shape[0]):
        start, k = 0, dists.shape[1]
        for end in range(1, k + 1):
            if end == k or dists[r, end] != dists[r, start]:
                if end < k or start == 0:
                    assert set(i0[r, start:end].tolist()) == \
                        set(i1[r, start:end].tolist()), r
                start = end


@pytest.mark.parametrize("d", WIDE)
def test_wide_rows_kernel_engine_equals_legacy_and_counts_forms(d):
    """At widths past the resident form's stages, ``use_kernel=True`` (on
    the CPU: the plain version of the scan, then the exact rerank) gives
    the legacy engine's distances bitwise and its ids up to ties on
    integer-valued data, and each call counts one search of its form in
    ``ivf_search_scan_form_total``."""
    from raft_tpu_torch.spatial.ann import ivf_flat_search_grouped, search_obs

    index, _, q = _integer_index(d)
    forms = {f: search_obs.scan_forms("ivf_flat", f) for f in
             ("kernel", "legacy")}
    dk, ik = ivf_flat_search_grouped(index, q, 10, n_probes=8, qcap=64,
                                     use_kernel=True)
    assert search_obs.scan_forms("ivf_flat", "kernel") == forms["kernel"] + 1
    dl, il = ivf_flat_search_grouped(index, q, 10, n_probes=8, qcap=64,
                                     use_kernel=False)
    assert search_obs.scan_forms("ivf_flat", "legacy") == forms["legacy"] + 1
    assert search_obs.scan_forms("ivf_flat", "kernel") == forms["kernel"] + 1
    assert search_obs.scan_forms("ivf_flat", "legacy", "pinned") >= 1
    assert torch.equal(dk, dl)
    _ids_up_to_ties(dk, ik, il)


@pytest.mark.parametrize("d", WIDE)
def test_wide_rows_every_list_probed_is_the_exact_top_k(d):
    """With every list probed and no pair dropped, the kernel engine at a
    wide width returns the exact top-10 of the benchmark's plain
    reference (``benchmark/reference/exact.py``): its distances bitwise
    (integer-valued data: every f32 sum exact), its ids up to ties."""
    from benchmark.reference import exact
    from raft_tpu_torch.spatial.ann import ivf_flat_search_grouped

    index, x, q = _integer_index(d, nq=64)
    dk, ik = ivf_flat_search_grouped(index, q, 10, n_probes=64, qcap=64,
                                     use_kernel=True)
    d2, ids = exact.topk(x, q, 10)
    # the search's sqrt is taken in f64 (correctly rounded), as here
    assert torch.equal(dk, torch.sqrt(d2.double()).float())
    _ids_up_to_ties(dk, ik, ids)


def test_fallbacks_are_the_fallback_part_of_the_legacy_series(monkeypatch):
    """``ENGINE_FALLBACKS`` is read from ``ivf_search_scan_form_total``:
    a fallback moves it and the legacy series together, a pinned or host
    legacy search and a kernel search move only their own series."""
    from raft_tpu_torch.spatial.ann import search_obs

    cls = grouped.FlatEngine

    def counts():
        return (grouped.ENGINE_FALLBACKS["ivf_flat"],
                search_obs.scan_forms("ivf_flat", "legacy"),
                search_obs.scan_forms("ivf_flat", "kernel"))

    f0, l0, k0 = counts()
    grouped.resolve_kernel(None, cls, CUDA, 1 << 14, 64)     # fallback
    assert counts() == (f0 + 1, l0 + 1, k0)
    grouped.resolve_kernel(False, cls, CUDA, 16, 64)         # pinned
    grouped.resolve_kernel(None, cls, CPU, 16, 64)           # host
    assert counts() == (f0 + 1, l0 + 3, k0)
    monkeypatch.setattr(grouped, "hopper_device", lambda dev: True)
    grouped.resolve_kernel(None, cls, CUDA, 960, 632)        # wide kernel
    assert counts() == (f0 + 1, l0 + 3, k0 + 1)
    assert dict(grouped.ENGINE_FALLBACKS) == {
        n: search_obs.scan_forms(n, "legacy", "fallback")
        for n in ("ivf_flat", "ivf_sq", "ivf_pq")}


def test_fallbacks_reset_moves_the_read_point_only():
    """Setting an ``ENGINE_FALLBACKS`` entry (the smoke's and the card
    tests' reset to 0) moves the point it reads from; the counter's
    fallback series keeps counting."""
    from raft_tpu_torch.spatial.ann import search_obs

    series = search_obs.scan_forms("ivf_sq", "legacy", "fallback")
    grouped.ENGINE_FALLBACKS["ivf_sq"] = 0
    assert grouped.ENGINE_FALLBACKS["ivf_sq"] == 0
    grouped.resolve_kernel(None, SQEngine, CUDA, 1 << 12, 64)
    assert grouped.ENGINE_FALLBACKS["ivf_sq"] == 1
    assert search_obs.scan_forms("ivf_sq", "legacy", "fallback") == series + 1
    with pytest.raises(KeyError):
        grouped.ENGINE_FALLBACKS["ivf_graph"]
