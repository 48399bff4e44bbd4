"""The PyTorch port's CUDA kernels against their plain versions, on a
Hopper card.

Marked ``gpu``: each test decides inside itself whether a card is
present and skips when none is. The file imports neither JAX nor the
JAX package, so it runs on a machine with the card alone:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from raft_tpu_torch.spatial.ann import flat_kernel as tfk


def _int_case(rng, lb, q, d, l_pad):
    # integers in [-64, 64): exact in bf16, every distance sum exact in f32
    qrows = rng.integers(-64, 64, (lb, q, d)).astype(np.float32)
    slabs_t = rng.integers(-64, 64, (lb, d, l_pad)).astype(np.float32)
    return qrows, slabs_t


def _bf16(a):
    return torch.as_tensor(a).to(torch.bfloat16)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    """On a Hopper card: the kernel against its plain version, bitwise on
    integer-exact inputs (ragged, empty and full ranges, odd Q, a ragged
    row tile, a transposed-view slab), within 1e-5 x (qn + yn) on
    Gaussian inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernel is built for sm_90a")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for lb, q, d, l_pad in ((4, 64, 96, 3072), (3, 13, 24, 136)):
        qrows, slabs_t = _int_case(rng, lb, q, d, l_pad)
        bounds = np.asarray(
            [[0, l_pad], [7, 7], [5, l_pad - 11], [1, 9]][:lb], np.int32)
        qt, st = _bf16(qrows).to(dev), _bf16(slabs_t).to(dev)
        bt = torch.as_tensor(bounds, device=dev)
        before = tfk.LAUNCHES
        got = tfk.flat_scan_subchunk_min(qt, st, bt)
        assert tfk.LAUNCHES == before + 1
        want = tfk.flat_scan_subchunk_min_plain(qt, st, bt)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        view = tfk.flat_scan_subchunk_min(
            qt, st.transpose(1, 2).contiguous().transpose(1, 2), bt)
        assert torch.equal(view, got)
        qg = torch.randn((lb, q, d), device=dev).to(torch.bfloat16)
        sg = torch.randn((lb, d, l_pad), device=dev).to(torch.bfloat16)
        got = tfk.flat_scan_subchunk_min(qg, sg, bt)
        want = tfk.flat_scan_subchunk_min_plain(qg, sg, bt)
        qn = (qg.float() ** 2).sum(-1)[:, :, None]
        yn = (sg.float() ** 2).sum(1).reshape(lb, 1, -1, 8).amax(-1)
        assert ((got - want).abs() <= 1e-5 * (qn + yn)).all()
