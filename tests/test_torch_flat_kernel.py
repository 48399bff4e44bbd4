"""PyTorch port of the flat sub-chunk-min scan (raft_tpu_torch
spatial/ann/flat_kernel + scan_core) against the JAX package.

On the CPU the wrapper runs its plain version, which must equal the JAX
kernel in interpret mode and its lax mirror bit for bit on the
integer-exact inputs of tests/test_flat_kernel.py (every f32 sum is then
exact in any order). The window plan that fixes ``l_pad`` must equal
JAX's. The CUDA kernel itself is checked against the plain version in
tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.spatial.ann import flat_kernel as jfk
from raft_tpu.spatial.ann import scan_core as jsc
from raft_tpu_torch.spatial.ann import flat_kernel as tfk
from raft_tpu_torch.spatial.ann import scan_core as tsc

torch.set_num_threads(1)


def _int_case(rng, lb, q, d, l_pad):
    # integers in [-64, 64): exact in bf16, every distance sum exact in f32
    qrows = rng.integers(-64, 64, (lb, q, d)).astype(np.float32)
    slabs_t = rng.integers(-64, 64, (lb, d, l_pad)).astype(np.float32)
    return qrows, slabs_t


def _bf16(a):
    return torch.as_tensor(a).to(torch.bfloat16)


@pytest.mark.parametrize(
    "lb,q,d,l_pad,l_tile,ranges",
    [
        (3, 32, 16, 256, 128, None),   # two slab tiles per list
        (2, 16, 24, 128, 128, None),   # single tile, ragged d
        (1, 48, 8, 512, 256, None),    # wider tiles
        (2, 16, 16, 256, 128, [[5, 5], [0, 256]]),   # empty and full
    ],
)
def test_plain_matches_jax_kernel_and_mirror_bitwise(rng_np, lb, q, d, l_pad,
                                                     l_tile, ranges):
    qrows, slabs_t = _int_case(rng_np, lb, q, d, l_pad)
    if ranges is None:
        ranges = [[i, max(i, l_pad - 7 * i)] for i in range(lb)]
    bounds = np.asarray(ranges, np.int32)
    ref_kernel = np.asarray(jfk.flat_scan_subchunk_min(
        jnp.asarray(qrows), jnp.asarray(slabs_t), jnp.asarray(bounds),
        interpret=True, l_tile=l_tile,
    ))
    ref_mirror = np.asarray(jfk.flat_scan_subchunk_min_lax(
        jnp.asarray(qrows), jnp.asarray(slabs_t), jnp.asarray(bounds)))
    tb = torch.as_tensor(bounds)
    got = tfk.flat_scan_subchunk_min(_bf16(qrows), _bf16(slabs_t), tb)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (lb, q, l_pad // tsc.SUBCHUNK)
    np.testing.assert_array_equal(got.numpy(), ref_kernel)
    np.testing.assert_array_equal(got.numpy(), ref_mirror)
    # a gathered row-major slab passed as a transposed view
    rows = _bf16(np.ascontiguousarray(slabs_t.transpose(0, 2, 1)))
    view = tfk.flat_scan_subchunk_min(_bf16(qrows), rows.transpose(1, 2), tb)
    assert not rows.transpose(1, 2).is_contiguous()
    np.testing.assert_array_equal(view.numpy(), got.numpy())
    if ranges == [[5, 5], [0, 256]]:
        assert (got[0] == tfk.BIG).all() and (got[1] < tfk.BIG).all()


def test_plain_rounds_operands_to_bf16_like_the_mirror(rng_np):
    """Generic f32 inputs: both sides round the operands to bf16 first;
    the sums then differ only in order (f32 tolerance)."""
    qrows = rng_np.standard_normal((2, 16, 24)).astype(np.float32)
    slabs_t = rng_np.standard_normal((2, 24, 128)).astype(np.float32)
    bounds = np.asarray([[0, 100], [3, 128]], np.int32)
    ref = np.asarray(jfk.flat_scan_subchunk_min_lax(
        jnp.asarray(qrows), jnp.asarray(slabs_t), jnp.asarray(bounds)))
    got = tfk.flat_scan_subchunk_min_plain(
        torch.as_tensor(qrows), torch.as_tensor(slabs_t),
        torch.as_tensor(bounds)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


def test_window_plan_matches_jax():
    """plan_l_tile (and so l_pad) equal to the JAX rule over a grid of
    (d, qcap, L), with the profile and the max_list cap the grouped
    search uses."""
    for d in (1, 8, 16, 96, 128, 960, 4096, 1 << 16):
        for qcap in (1, 8, 9, 48, 64, 512, 4096):
            for L in (1, 57, 128, 300, 1000, 3000):
                q_pad = jsc.pad_queries(qcap)
                assert tsc.pad_queries(qcap) == q_pad
                assert tsc.tile_profile(qcap) == jsc.tile_profile(qcap)
                cap = -(-L // 128) * 128
                want = jfk.plan_l_tile(d, q_pad, l_tile=cap,
                                       profile=jsc.tile_profile(qcap))
                got = tfk.plan_l_tile(d, q_pad, l_tile=cap,
                                      profile=tsc.tile_profile(qcap))
                assert got == want, (d, qcap, L)
                if want is not None:
                    assert tsc.round_up(L, got) == -(-L // want) * want


def test_supported_predicate_and_wrapper_checks():
    assert tfk.flat_scan_supported(96, 64)
    assert tfk.flat_scan_supported(96, 4096)
    assert not tfk.flat_scan_supported(0, 8)
    # the wide form serves rows past the resident form's stages; an
    # 8-slot query tile beside its ring bounds d
    assert tfk.flat_scan_supported(400, 8)
    assert tfk.flat_scan_supported(1000, 8)
    assert not tfk.flat_scan_supported(1 << 14, 8)
    q = torch.zeros((1, 5, 16), dtype=torch.bfloat16)
    s = torch.zeros((1, 16, 136), dtype=torch.bfloat16)
    b = torch.zeros((1, 2), dtype=torch.int32)
    # any Q and any Lpad on the 8-row granule
    assert tuple(tfk.flat_scan_subchunk_min(q, s, b).shape) == (1, 5, 17)
    with pytest.raises(ValueError, match="bfloat16"):
        tfk.flat_scan_subchunk_min(q.float(), s, b)
    with pytest.raises(ValueError, match="query dim"):
        tfk.flat_scan_subchunk_min(
            q, torch.zeros((1, 24, 136), dtype=torch.bfloat16), b)
    with pytest.raises(ValueError, match="multiple of 8"):
        tfk.flat_scan_subchunk_min(q, s[:, :, :130], b)
    with pytest.raises(ValueError, match="int32"):
        tfk.flat_scan_subchunk_min(q, s, b.long())


def test_cpu_wrapper_runs_plain_version_without_counting():
    before = tfk.LAUNCHES
    q = torch.ones((1, 3, 8), dtype=torch.bfloat16)
    s = torch.ones((1, 8, 16), dtype=torch.bfloat16)
    b = torch.tensor([[0, 16]], dtype=torch.int32)
    out = tfk.flat_scan_subchunk_min(q, s, b)
    assert torch.equal(out, tfk.flat_scan_subchunk_min_plain(q, s, b))
    assert tfk.LAUNCHES == before


@pytest.mark.parametrize("d", [768, 960, 1536])
def test_wide_width_rule_holds_at_every_qcap(d):
    """Past the resident form's whole-row stages the kernel takes the
    wide form, whose query tile is sized to fit a block: supported at
    every qcap the grouped search uses, and the window needs no plan of
    the JAX rule (where that rule has none, l_pad is max_list rounded up
    to the kernel's 64-row stage)."""
    for qcap in (8, 64, 640, 4096):
        assert tfk.flat_scan_supported(d, qcap), (d, qcap)
        wide, q_tile, smem = tfk.scan_form(d, qcap)
        resident = tfk._lists_smem_bytes(d, tfk._q_tile(qcap))
        assert wide == (resident > tsc.SMEM_LIMIT), (d, qcap)
        assert 8 <= q_tile <= 64 and q_tile % 8 == 0
        assert smem <= tsc.SMEM_LIMIT
        for L in (1, 300, 977, 3000):
            l_pad = tfk.window_l_pad(d, qcap, L)
            plan = tfk.plan_l_tile(d, tsc.pad_queries(qcap),
                                   l_tile=tsc.round_up(L, tsc.LANE),
                                   profile=tsc.tile_profile(qcap))
            assert l_pad == tsc.round_up(L, plan or 64), (d, qcap, L)
            assert l_pad >= L and l_pad % tsc.SUBCHUNK == 0
    # d = 960 takes the wide form even at 8 slots; a query tile of 64
    # where it fits beside the stages
    assert tfk.scan_form(960, 8)[0] and tfk.scan_form(960, 632)[1] == 64


@pytest.mark.parametrize("qcap", [1, 8, 64, 160, 632, 4096])
def test_resident_route_and_window_at_96_are_unchanged(qcap):
    """At d = 96 the resident form serves every qcap with its own query
    tile, and l_pad is the JAX window rule's, as before the wide form."""
    wide, q_tile, smem = tfk.scan_form(96, qcap)
    assert not wide and q_tile == tfk._q_tile(qcap)
    assert smem == tfk._lists_smem_bytes(96, q_tile)
    for L in (1, 57, 1000, 3500, 6656):
        want = tsc.round_up(L, jfk.plan_l_tile(
            96, jsc.pad_queries(qcap), l_tile=-(-L // 128) * 128,
            profile=jsc.tile_profile(qcap)))
        assert tfk.window_l_pad(96, qcap, L) == want
