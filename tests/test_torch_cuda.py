"""The port's CUDA kernels held bitwise against their plain torch
versions on the card (tolerance 0: every plane is an integer).

The kernels have no CPU mode, so every test here is marked ``cuda`` and
skips without a GPU.  The file imports no jax (the GPU host need not
have it); run it there without the JAX test configuration:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from stereomatching_tpu.config import BoundaryMode, StereoParams
from stereomatching_tpu_torch.ops import fused, fused_diffusion

MODES = [BoundaryMode.WRAP, BoundaryMode.GHOST]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape_shifts_sw",
    [((3, 48, 64), 16, 21), ((2, 37, 45), 80, 5), ((1, 96, 128), 64, 21), ((2, 33, 70), 12, 3)],
)
@pytest.mark.parametrize("mode", MODES)
def test_match_score_edges_kernel_matches_plain(cuda_device, mode, shape_shifts_sw):
    shape, d, sw = shape_shifts_sw
    params = StereoParams(num_shifts=d, square_width=sw, mode=mode, edge_rule="exact")
    rng = np.random.default_rng(11)
    left, right = (torch.from_numpy(rng.integers(0, 256, shape).astype(np.float32) / 256.0)
                   .to(cuda_device) for _ in range(2))
    before = fused.match_score_edges.launches
    got = fused.match_score_edges(left, right, params)
    torch.cuda.synchronize()
    assert fused.match_score_edges.launches == before + 1
    ref = fused.match_score_edges_reference(left, right, params)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("times", [0, 1, 2, 3, 4, 32])
def test_fill_web_holes_range_kernel_matches_plain(cuda_device, times):
    rng = np.random.default_rng(12)
    web = rng.integers(1, 65, (3, 61, 97)).astype(np.int32)
    web[rng.random(web.shape) < 0.4] = 0
    web_t = torch.from_numpy(web).to(cuda_device)
    before = fused_diffusion.fill_web_holes_range.launches
    got = fused_diffusion.fill_web_holes_range(web_t, times)
    torch.cuda.synchronize()
    # One diffuse_step launch per Jacobi step, then one image_range.
    assert fused_diffusion.fill_web_holes_range.launches == before + max(times - 1, 0) + 1
    assert torch.equal(web_t.cpu(), torch.from_numpy(web))  # input untouched
    for a, b in zip(got, fused_diffusion.fill_web_holes_range_reference(web_t, times)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_wrappers_check_inputs(cuda_device):
    params = StereoParams(num_shifts=8, square_width=7, edge_rule="exact")
    x = torch.zeros((2, 16, 16), device=cuda_device)
    with pytest.raises(ValueError):
        fused.match_score_edges(x.double(), x.double(), params)
    with pytest.raises(ValueError):
        fused.match_score_edges(x, x[:1], params)
    with pytest.raises(ValueError):
        fused.match_score_edges(x.transpose(1, 2), x.transpose(1, 2), params)
    with pytest.raises(ValueError):
        fused_diffusion.fill_web_holes_range(x, 4)  # float32, not int32
