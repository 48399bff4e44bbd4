"""PyTorch port of the core runtime (raft_tpu_torch/core: resources,
logger, annotate, mdarray) and the lazy package root, held to the JAX
package's tests/test_core.py cases and behaviour, on the CPU.

A communicator of the port's comms layer stands in for the JAX mesh.
Entry points default to CUDA and raise without it, so the handles here
are made with ``device="cpu"``.
"""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from raft_tpu.core import logger as jlogger
from raft_tpu.core import mdarray as jmd
from raft_tpu.core.resources import Resources as JResources
import raft_tpu_torch
from raft_tpu_torch import _build
from raft_tpu_torch.comms import build_comms
from raft_tpu_torch.core import logger, mdarray
from raft_tpu_torch.core import resources as tres
from raft_tpu_torch.core.annotate import annotate, pop_range, push_range
from raft_tpu_torch.core.resources import Resources

# the module (the package exports the function of the same name)
tann = importlib.import_module("raft_tpu_torch.core.annotate")

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(prog, env=None):
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=120, cwd=REPO,
                         env=None if env is None else {**os.environ, **env})
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


class TestResources:
    def test_default_on_cpu(self):
        res = Resources(device="cpu")
        assert res.device == torch.device("cpu")
        assert not res.has_mesh and res.device_kind() == "cpu"
        assert not res.is_tpu() and not JResources().is_tpu()
        assert res.get_n_lanes() == 1 and res.dtype == torch.float32

    def test_mesh_slot_holds_a_communicator(self):
        comms = build_comms(["cpu"] * 2)
        res = Resources(device="cpu")
        res.set_mesh(comms)
        assert res.get_mesh() is comms and res.has_mesh
        res.set_sub_mesh("sub", comms)
        assert res.get_sub_mesh("sub") is comms

    def test_no_mesh_raises(self):
        with pytest.raises(RuntimeError):
            Resources(device="cpu").get_mesh()
        with pytest.raises(RuntimeError):
            JResources().get_mesh()

    def test_sync(self):
        Resources(device="cpu").sync()
        Resources(device="cpu").sync(torch.ones(3))

    def test_default_is_cuda_and_a_singleton(self, monkeypatch):
        """The default handle resolves CUDA: it raises without a card
        (nothing falls back to the CPU), and once made it is shared."""
        monkeypatch.setattr(tres, "_default_resources", None)
        if torch.cuda.is_available():
            assert raft_tpu_torch.get_default_resources() is \
                raft_tpu_torch.get_default_resources()
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                raft_tpu_torch.get_default_resources()
            with pytest.raises(RuntimeError, match="CUDA"):
                Resources()
        cpu = Resources(device="cpu")
        monkeypatch.setattr(tres, "_default_resources", cpu)
        assert tres.ensure_resources(None) is cpu
        assert raft_tpu_torch.get_default_resources() is cpu

    def test_lanes_and_precision_accepted(self):
        res = Resources(device="cpu", n_lanes=0, matmul_precision="default")
        assert res.get_n_lanes() == 1
        assert raft_tpu_torch.DeviceResources is Resources


class TestCompilationCache:
    def test_moves_the_kernel_build_root(self, monkeypatch, tmp_path):
        """enable_compilation_cache points the nvcc build's root at the
        path (no nvcc needed to see it), idempotently; a Resources with
        compilation_cache_dir enables it."""
        monkeypatch.setattr(tres, "_cache_dir_enabled", None)
        monkeypatch.setattr(_build, "_ROOT", [_build._BUILD_ROOT])
        assert _build._build_dir().parent == _build._BUILD_ROOT
        tres.enable_compilation_cache(str(tmp_path / "a"))
        assert tres.compilation_cache_dir() == str(tmp_path / "a")
        assert _build._build_dir().parent == tmp_path / "a"
        tres.enable_compilation_cache(str(tmp_path / "a"),
                                      min_compile_time_secs=1.0)
        Resources(device="cpu", compilation_cache_dir=str(tmp_path / "b"))
        assert _build._build_dir().parent == tmp_path / "b"
        _build.set_build_root(None)
        assert _build._build_dir().parent == _build._BUILD_ROOT


class TestLogger:
    def test_levels_and_callback(self):
        captured = []
        logger.set_callback(lambda lvl, msg: captured.append(msg))
        logger.set_level(logger.INFO)
        logger.info("hello %d", 42)
        logger.debug("not captured")
        assert any("hello 42" in m for m in captured)
        assert not any("not captured" in m for m in captured)
        logger.set_level(logger.DEBUG)
        logger.debug("now captured")
        assert any("now captured" in m for m in captured)
        logger.set_callback(None)
        logger.set_level(logger.INFO)

    def test_should_log_for(self):
        logger.set_level(logger.WARN)
        assert logger.should_log_for(logger.ERROR)
        assert not logger.should_log_for(logger.INFO)
        logger.set_level(logger.INFO)

    def test_flush_callback(self):
        flushed = []
        logger.set_flush(lambda: flushed.append(1))
        logger.flush()
        assert flushed
        logger.set_flush(None)

    def test_level_numbering_is_jax_s(self):
        for name in ("OFF", "CRITICAL", "ERROR", "WARN", "INFO", "DEBUG",
                     "TRACE"):
            assert getattr(logger, name) == getattr(jlogger, name)
        assert logger._TO_PY == jlogger._TO_PY

    def test_the_two_packages_loggers_do_not_collide(self):
        """Each package's records reach only its own callback, and one
        package's level leaves the other's alone."""
        mine, theirs = [], []
        logger.set_callback(lambda lvl, msg: mine.append((lvl, msg)))
        jlogger.set_callback(lambda lvl, msg: theirs.append((lvl, msg)))
        try:
            logger.set_level(logger.DEBUG)
            jlogger.set_level(jlogger.WARN)
            logger.debug("port %s", "debug")
            jlogger.debug("jax debug")
            jlogger.warn("jax warn")
            logger.set_pattern("%(message)s")
            logger.warn("port warn")
        finally:
            logger.set_callback(None)
            jlogger.set_callback(None)
            logger.set_level(logger.INFO)
            jlogger.set_level(jlogger.INFO)
            logger.set_pattern("[%(levelname)s] [%(asctime)s] %(message)s")
        assert [m for _, m in mine if "jax" in m] == []
        assert [m for _, m in theirs if "port" in m] == []
        assert (logger.DEBUG, ) == tuple(lvl for lvl, m in mine
                                         if "port debug" in m)
        assert any(m == "port warn" for _, m in mine)
        assert any("jax warn" in m for _, m in theirs)
        assert not any("jax debug" in m for _, m in theirs)
        assert logger._logger.name != jlogger._logger.name
        assert not logger._logger.propagate


class TestAnnotate:
    def test_context(self):
        with annotate("test %d", 1):
            pass

    def test_push_pop(self):
        push_range("r")
        pop_range()
        pop_range()  # extra pop is a no-op

    def test_disabled_ranges_stack_nothing(self):
        prev = tann.set_profiling(False)
        try:
            push_range("off")
            assert tann._stack == []
            with annotate("off %s", "ctx"):
                assert tann._stack == []
        finally:
            tann.set_profiling(prev)

    def test_enabled_ranges_stack_and_pop(self):
        prev = tann.set_profiling(True)
        try:
            push_range("on %d", 2)
            assert len(tann._stack) == 1
            pop_range()
            assert tann._stack == []
            with annotate("on"):
                pass
        finally:
            tann.set_profiling(prev)

    def test_trace_capture_writes_under_log_dir(self, tmp_path):
        """start_trace turns ranges on and stop_trace writes the trace
        under log_dir and restores the gate; a second start while one
        runs raises and leaves the gate alone."""
        prev = tann.profiling_enabled()
        tann.start_trace(str(tmp_path))
        try:
            assert tann.profiling_enabled()
            with pytest.raises(RuntimeError):
                tann.start_trace(str(tmp_path))
            with annotate("traced range"):
                torch.ones(8).sum()
        finally:
            tann.stop_trace()
        assert tann.profiling_enabled() == prev
        files = list(tmp_path.glob("trace_*.json"))
        assert len(files) == 1 and "traced range" in files[0].read_text()

    def test_env_switch(self):
        prog = ("import importlib\n"
                "a = importlib.import_module('raft_tpu_torch.core.annotate')\n"
                "print(a.profiling_enabled())")
        assert _run(prog, {"RAFT_TPU_PROFILE": "1"}) == "True"
        assert _run(prog, {"RAFT_TPU_PROFILE": "off"}) == "False"


class TestMdarray:
    def test_factories(self):
        res = Resources(device="cpu")
        m = mdarray.make_device_matrix(res, 4, 5)
        assert m.shape == (4, 5) and m.dtype == torch.float32
        v = mdarray.make_device_vector(res, 7, dtype=np.int32)
        assert v.shape == (7,) and v.dtype == torch.int32
        s = mdarray.make_device_scalar(res, 3.5)
        assert float(s) == 3.5
        jm = jmd.make_device_matrix(None, 4, 5)
        assert tuple(jm.shape) == tuple(m.shape)
        assert str(jm.dtype) == str(m.dtype).replace("torch.", "")
        np.testing.assert_array_equal(mdarray.make_host_matrix(2, 3),
                                      jmd.make_host_matrix(2, 3))
        np.testing.assert_array_equal(mdarray.make_host_vector(4),
                                      jmd.make_host_vector(4))

    def test_round_trip(self):
        res = Resources(device="cpu")
        x = np.arange(12, dtype=np.float32).reshape(3, 4)
        d = mdarray.to_device(res, x)
        assert d.device == torch.device("cpu")
        np.testing.assert_array_equal(mdarray.to_host(d), x)

    def test_validation(self):
        for mod in (mdarray, jmd):
            with pytest.raises(ValueError):
                mod.expect_matrix(np.zeros(3))
            with pytest.raises(ValueError):
                mod.expect_vector(np.zeros((3, 3)))
            with pytest.raises(TypeError):
                mod.expect_same_dtype(np.zeros(2, np.float32),
                                      np.zeros(2, np.float64))
            with pytest.raises(ValueError):
                mod.as_layout(np.zeros((2, 2)), "diagonal")
        with pytest.raises(TypeError):
            mdarray.expect_same_dtype(torch.zeros(2), torch.zeros(2).double())
        mdarray.expect_same_dtype(torch.zeros(2), np.zeros(2, np.float32))

    def test_col_major_layout(self):
        x = np.arange(12, dtype=np.float32).reshape(3, 4)
        col = mdarray.as_layout(x, mdarray.COL_MAJOR)
        row = mdarray.as_layout(x, mdarray.ROW_MAJOR)
        assert col.stride() == (1, 3) and row.stride() == (4, 1)
        assert col.shape == row.shape == (3, 4)
        np.testing.assert_array_equal(col.numpy(), x)
        np.testing.assert_array_equal(np.asarray(jmd.as_layout(
            x, jmd.COL_MAJOR)), col.numpy())


def test_import_pulls_in_no_torch_and_submodules_load_lazily():
    prog = (
        "import sys\n"
        "import raft_tpu_torch\n"
        "assert 'torch' not in sys.modules, 'torch imported'\n"
        "import raft_tpu_torch.testing.crash\n"
        "assert 'torch' not in sys.modules, 'torch imported by crash'\n"
        "assert raft_tpu_torch.utils.Pow2(8).value == 8\n"
        "assert 'torch' not in sys.modules\n"
        "res = raft_tpu_torch.Resources(device='cpu')\n"
        "assert raft_tpu_torch.logger.INFO == 4\n"
        "import raft_tpu_torch.pylibraft, raft_tpu_torch.core.mdarray\n"
        "import raft_tpu_torch.spatial.ann.approx\n"
        "import raft_tpu_torch.spatial.ann.ball_cover\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'raft_tpu', 'bench')]\n"
        "assert not bad, bad\n"
        "print('OK')\n"
    )
    assert _run(prog) == "OK"


def test_lazy_submodules():
    assert raft_tpu_torch.cluster.kmeans_fit is not None
    assert raft_tpu_torch.spatial.ann.rbc_build_index is not None
    assert raft_tpu_torch.core.Resources is Resources
    with pytest.raises(AttributeError):
        raft_tpu_torch.nonexistent_module
    # the random / stats / label / lap / matrix packages load lazily too
    assert raft_tpu_torch.stats.mean is not None
    # a JAX module the port has no target for (ROADMAP A6) is not reachable
    with pytest.raises(AttributeError):
        raft_tpu_torch.compat
