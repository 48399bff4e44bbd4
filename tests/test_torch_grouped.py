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
    "flat": (grouped.FlatEngine, (16, 64), (1 << 12, 64), (1 << 12, 64),
             ("use_kernel=True unsupported",), "d=4096"),
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
              "common")
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
