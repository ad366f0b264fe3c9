"""The two kernel wrappers of the PyTorch port (``ops/fused.py`` K1,
``ops/fused_diffusion.py`` K2).

On CPU tensors a wrapper runs its plain torch version; those are held
bitwise against the JAX package's XLA tier (the JAX suite already pins
its Pallas kernels to that tier).  The CUDA kernels themselves are held
against the plain versions on the card in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereomatching_tpu.config import StereoParams
from stereomatching_tpu.ops.argmax import match_and_score as j_match_and_score
from stereomatching_tpu.ops.diffusion import fill_web_holes as j_fill_web_holes
from stereomatching_tpu.ops.edges import find_edges as j_find_edges
from stereomatching_tpu_torch.interop import params_from_jax
from stereomatching_tpu_torch.ops import fused, fused_diffusion, fused_sgm
from tests.test_torch_ops import MODES, brightness_batch


def jax_match_score_edges(left, right, params):
    """The XLA tier's phases 1-2 for one [H, W] pair."""
    el = j_find_edges(jnp.asarray(left), params.threshold, params.mode, "exact")
    er = j_find_edges(jnp.asarray(right), params.threshold, params.mode, "exact")
    best, winner = j_match_and_score(el, er, params)
    return [np.asarray(x) for x in (best, winner, el, er)]


@pytest.mark.parametrize("shifts_sw", [(8, 7), (16, 21)])
@pytest.mark.parametrize("mode", MODES)
def test_match_score_edges_cpu_matches_jax(mode, shifts_sw):
    d, sw = shifts_sw
    params = StereoParams(num_shifts=d, square_width=sw, mode=mode, edge_rule="exact")
    left, right = brightness_batch()
    before = fused.match_score_edges.launches
    got = fused.match_score_edges(torch.from_numpy(left), torch.from_numpy(right),
                                  params_from_jax(params))
    assert fused.match_score_edges.launches == before  # CPU: no kernel launch
    for i in range(left.shape[0]):
        for port, ref in zip(got, jax_match_score_edges(left[i], right[i], params)):
            assert port.dtype == torch.int32
            assert np.array_equal(port[i].numpy(), ref)
    # 2-D input gives 2-D planes.
    single = fused.match_score_edges(torch.from_numpy(left[0]), torch.from_numpy(right[0]),
                                     params_from_jax(params))
    for a, b in zip(single, got):
        assert torch.equal(a, b[0])


def test_match_score_edges_rejects_unported_options():
    """The sub-pixel plane, once unported, is the fifth output and equals
    the plain version's; the reference edge rule is still refused."""
    left, right = (torch.from_numpy(x) for x in brightness_batch(1))
    params = params_from_jax(StereoParams(num_shifts=8, square_width=7, edge_rule="exact"))
    got = fused.match_score_edges(left, right, params, subpixel=True)
    ref = fused.match_score_edges_reference(left, right, params, subpixel=True)
    assert len(got) == len(ref) == 5 and got[4].dtype == torch.float32
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        fused.match_score_edges(left, right, params.replace(edge_rule="reference"))


@pytest.mark.parametrize("times", [0, 1, 2, 8])
def test_fill_web_holes_range_cpu_matches_jax(times):
    rng = np.random.default_rng(5)
    web = rng.integers(1, 17, (3, 48, 64)).astype(np.int32)
    web[rng.random(web.shape) < 0.3] = 0
    before = fused_diffusion.fill_web_holes_range.launches
    out, mn, mx = fused_diffusion.fill_web_holes_range(torch.from_numpy(web), times)
    assert fused_diffusion.fill_web_holes_range.launches == before
    assert out.dtype == mn.dtype == mx.dtype == torch.int32
    assert mn.shape == mx.shape == (3,)
    for i in range(3):
        ref = np.asarray(j_fill_web_holes(jnp.asarray(web[i]), times))
        assert np.array_equal(out[i].numpy(), ref)
        assert mn[i].item() == ref.min() and mx[i].item() == ref.max()
    o2, mn2, mx2 = fused_diffusion.fill_web_holes_range(torch.from_numpy(web[1]), times)
    assert mn2.ndim == mx2.ndim == 0
    assert torch.equal(o2, out[1]) and mn2 == mn[1] and mx2 == mx[1]


@pytest.mark.parametrize("times", [0, 1, 2, 33])
@pytest.mark.parametrize("value_bound", [65, 256, None])
def test_fill_web_holes_range_value_bound_cpu_matches_jax(value_bound, times):
    """``value_bound`` (K2's storage on the card) leaves the function as it
    is: the CPU route equals the JAX XLA ``fill_web_holes`` on webs within
    the bound; with ``None`` also on negative and large values (a resumed
    web)."""
    rng = np.random.default_rng(6)
    hi = 2**20 if value_bound is None else value_bound
    web = rng.integers(0, hi, (2, 13, 29)).astype(np.int32)
    web[rng.random(web.shape) < 0.4] = 0
    if value_bound is None:
        web[0, :3] = -rng.integers(1, 2**20, (3, 29))
    out, mn, mx = fused_diffusion.fill_web_holes_range(torch.from_numpy(web), times, value_bound)
    for i in range(2):
        ref = np.asarray(j_fill_web_holes(jnp.asarray(web[i]), times))
        assert np.array_equal(out[i].numpy(), ref)
        assert mn[i].item() == ref.min() and mx[i].item() == ref.max()


@pytest.mark.parametrize("value_bound, times, want", [
    (1, 32, (1, 2, 31)), (65, 32, (1, 2, 31)), (255, 32, (1, 2, 31)), (256, 32, (1, 2, 31)),
    (257, 32, (2, 1, 31)), (65535, 32, (2, 1, 31)), (65536, 32, (2, 1, 31)),
    (65537, 32, (4, 2, 31)), (None, 32, (4, 2, 31)), (None, 17, (4, 1, 16)),
    (None, 18, (4, 2, 17)), (65, 0, (1, 1, 0)), (65, 1, (1, 1, 0)), (65, 2, (1, 1, 1)),
    (65, 17, (1, 1, 16)), (65, 18, (1, 2, 17)), (65, 33, (1, 2, 32)), (65, 34, (1, 3, 33)),
    (65, 100, (1, 7, 99)), (65536, 100, (2, 4, 99)), (None, 100, (4, 7, 99)),
])
def test_k2_plan_at_its_edges(value_bound, times, want):
    """K2's storage from the bound (1 byte up to 256, 2 up to 65536, else
    int32) and its launches, ceil(steps / steps a launch), at least one."""
    assert tuple(fused_diffusion.k2_plan(times, value_bound)) == want


@pytest.mark.parametrize("bad", [0, -5, True])
def test_k2_plan_refuses_bad_bounds(bad):
    with pytest.raises(ValueError):
        fused_diffusion.k2_plan(32, bad)
    with pytest.raises(ValueError):
        fused_diffusion.fill_web_holes_range(torch.zeros((4, 4), dtype=torch.int32), 3, bad)


def test_k2_smem_fits_a_block_at_every_storage():
    """Each storage's most steps a launch keep its two planes within a
    block's shared memory (the C entry's figure, pinned on the card)."""
    for nbytes, steps in fused_diffusion.K2_MAX_STEPS.items():
        assert fused_diffusion.k2_smem_bytes(nbytes, steps) <= 232448
    assert fused_diffusion.k2_smem_bytes(1, 16) == 2 * 160 * 168
    assert fused_diffusion.k2_smem_bytes(2, 31) == 2 * 126 * 192 * 2
    assert fused_diffusion.k2_smem_bytes(4, 0) == 2 * 64 * 64 * 4


@pytest.mark.parametrize("iterations, want", [
    (0, (5, 0, 0)), (1, (5, 1, 1)), (15, (5, 1, 15)), (16, (5, 1, 16)), (17, (5, 2, 9)),
    (32, (5, 2, 16)), (33, (5, 3, 11)), (100, (5, 7, 15)),
])
def test_k6_plan_at_its_edges(iterations, want):
    """K6's launches, ceil(sweeps / 16) (none at 0 sweeps), and the sweeps
    of its first launch, the sweeps split evenly (h = 16: 0, 1, h, h + 1,
    2h + 1 sweeps; the pipelines' 16 in one launch)."""
    assert fused_diffusion.K6_MAX_SWEEPS == 16
    assert tuple(fused_diffusion.k6_plan(iterations)) == want
    with pytest.raises(ValueError):
        fused_diffusion.k6_plan(-1)


def test_k6_smem_fits_a_block():
    """Every launch's tile, with its halo of up to K6_MAX_SWEEPS rows and
    columns, fits a block's shared memory (the C entry's figure, pinned
    on the card): 96 x 104 cells of 5 bytes at 16 sweeps."""
    for h in range(fused_diffusion.K6_MAX_SWEEPS + 1):
        assert fused_diffusion.k6_smem_bytes(h) <= 232448
    assert fused_diffusion.k6_smem_bytes(16) == 5 * 96 * 104
    assert fused_diffusion.k6_smem_bytes(8) == 5 * 80 * 88
    assert fused_diffusion.k6_smem_bytes(1) == 5 * 66 * 72


@pytest.mark.parametrize("w, d, dtype, want", [
    (1024, 64, torch.int8, "pixels"), (1024, 256, torch.int8, "pixels"),
    (45, 32, torch.int8, "pixels"), (45, 64, torch.int16, "pixels"), (45, 96, torch.int32, "pixels"),
    (45, 16, torch.int8, "vectors"), (45, 8, torch.int16, "vectors"), (45, 4, torch.int32, "vectors"),
    (1024, 37, torch.int8, "vectors"), (1024, 100, torch.int16, "vectors"),
    (16, 1, torch.int8, "vectors"), (4, 3, torch.int32, "vectors"),
    (1021, 37, torch.int8, "elements"), (45, 15, torch.int8, "elements"),
    (45, 1, torch.int32, "elements"), (1023, 100, torch.int16, "elements"),
    (1024, 11776, torch.int8, "pixels"), (1024, 11792, torch.int8, "elements"),
])
def test_k3_route_at_aligned_and_unaligned_shapes(w, d, dtype, want):
    """K3's route from (W, D, dtype) alone: the pixels where D is a
    multiple of 32, the vectors where a row's W * D costs fill whole
    16-byte vectors, the element kernel for the rest and past 48 KB of
    staged codes."""
    assert fused_sgm.k3_route((2, 3, w, d), dtype) == want
    assert fused_sgm.k3_smem_bytes(d) == 4 * (2 * 256 + d - 1)


def test_wrappers_refuse_other_devices():
    params = params_from_jax(StereoParams(num_shifts=8, square_width=7, edge_rule="exact"))
    meta = torch.empty((1, 8, 8), device="meta")
    with pytest.raises(ValueError):
        fused.match_score_edges(meta, meta, params)
    with pytest.raises(ValueError):
        fused_diffusion.fill_web_holes_range(meta.to(torch.int32), 4)


# A short `cuobjdump -sass` excerpt: a step loop (0x0100-0x01b0) whose
# body loads ahead, reduces, shuffles and stores, nested in an outer loop
# (0x0080-0x01d0), and an LDGSTS that must not count as an LDG.
CANNED_SASS = """
	code for sm_90a
		Function : _Z6kernelPKaPs
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                         /* 0x00000a00ff017b82 */
                                                                                  /* 0x000fe40000000800 */
        /*0010*/                   LDGSTS.E.BYPASS.128 [R3], desc[UR4][R4.64] ;   /* 0x0000000004037fae */
        /*0080*/                   IADD3 R2, R2, 0x1, RZ ;                        /* 0x0000000102027810 */
        /*0100*/               @P0 LDG.E.U16.CONSTANT R6, desc[UR4][R4.64] ;      /* 0x0000000404060981 */
        /*0110*/              @!P0 LDG.E R7, desc[UR4][R8.64] ;                   /* 0x0000000408078981 */
        /*0120*/                   REDUX.MIN.S32 UR6, R10 ;                       /* 0x000000000a0673c4 */
        /*0130*/                   SHFL.UP PT, R11, R12, 0x1, RZ ;                /* 0x04200000ff0b7389 */
        /*0140*/                   SHFL.DOWN PT, R13, R14, 0x1, 0x1f ;            /* 0x0420000000ff7389 */
        /*0150*/                   STG.E desc[UR4][R8.64], R15 ;                  /* 0x0000000f08007986 */
        /*01b0*/               @P1 BRA 0x100 ;                                    /* 0xfffffffc00001947 */
        /*01c0*/                   STG.E.U16 desc[UR4][R8.64], R15 ;              /* 0x0000000f08007986 */
        /*01d0*/               @P2 BRA 0x80 ;                                     /* 0xfffffffc00002947 */
        /*01e0*/                   BRA 0x1e0 ;                                    /* 0xfffffffc00007947 */
        /*01f0*/                   EXIT ;                                         /* 0x000000000000794d */
"""


@pytest.mark.parametrize("ops, total, step_loop", [
    (("LDG", "STG", "LDGSTS", "REDUX", "SHFL", "ALL"),
     {"LDG": 2, "STG": 2, "LDGSTS": 1, "REDUX": 1, "SHFL": 2, "ALL": 14},
     {"LDG": 2, "STG": 1, "LDGSTS": 0, "REDUX": 1, "SHFL": 2, "ALL": 7,
      "order": "LDG LDG REDUX SHFL SHFL STG"}),
    (("LDS", "STS", "BAR"), {"LDS": 0, "STS": 0, "BAR": 0},
     {"LDS": 0, "STS": 0, "BAR": 0, "order": ""}),
])
def test_parse_sass_counts_ops_per_loop(ops, total, step_loop):
    """``parse_sass`` counts the asked op names by mnemonic, in total and
    in each loop (a backward branch's range, nested loops inside their
    outer one, a branch to itself a loop of one instruction), and lists
    each loop's ops in address order."""
    from stereomatching_tpu_torch.utils.build import parse_sass

    got = parse_sass(CANNED_SASS, ops, order=True, names={"_Z6kernelPKaPs": "kernel"})
    assert list(got) == ["kernel"]
    assert got["kernel"]["total"] == total
    loops = got["kernel"]["loops"]
    assert [(a, b) for a, b, _ in loops] == [(0x100, 0x1B0), (0x80, 0x1D0), (0x1E0, 0x1E0)]
    assert loops[0][2] == step_loop
    outer = {k: v for k, v in loops[1][2].items() if k != "order"}
    # The outer loop holds all but the two instructions before it (the
    # LDGSTS among them) and the two after it.
    assert outer == {k: v - (k == "LDGSTS") - 4 * (k == "ALL") for k, v in total.items()}
    assert "order" not in parse_sass(CANNED_SASS, ops)["_Z6kernelPKaPs"]["loops"][0][2]
