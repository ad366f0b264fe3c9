"""The route each config takes on the CUDA device, chosen from the config
alone before any launch (the port's counterpart of the JAX package's
``modern_pallas_supported``): ``classic_kernels_supported`` and
``modern_kernels_supported`` at each kernel limit, the stages each config
runs as plain torch ops, the matchers' ``plain_stages``, and the CLI at a
square width past the kernels' limit, byte-identical to the JAX CLI.  No
library is built and no kernel runs here."""

import os

import pytest

from stereomatching_tpu import cli as j_cli
from stereomatching_tpu.utils import imageio as j_imageio
from stereomatching_tpu_torch import cli
from stereomatching_tpu_torch.config import BoundaryMode, ModernParams, StereoParams
from stereomatching_tpu_torch.models import classic, modern
from stereomatching_tpu_torch.ops import fused, fused_diffusion, fused_modern, fused_sgm
from stereomatching_tpu_torch.serving import Matcher, ModernMatcher
from tests.util import synthetic_pair

# (edge_rule, sharded) -> the matching stage's kernel.
STAGES = {("exact", False): "match_score_edges", ("reference", False): "match_and_score",
          ("exact", True): "match_and_score_prehalo",
          ("reference", True): "match_and_score_prehalo"}


@pytest.mark.parametrize("rule_sharded", list(STAGES), ids=lambda k: f"{k[0]}-{k[1]}")
def test_classic_predicate_square_width_limit(rule_sharded):
    rule, sharded = rule_sharded
    ok, why = classic.classic_kernels_supported(
        StereoParams(square_width=255, num_shifts=8, edge_rule=rule), sharded)
    assert ok and why == ""
    ok, why = classic.classic_kernels_supported(
        StereoParams(square_width=257, num_shifts=8, edge_rule=rule), sharded)
    assert not ok and why == f"{STAGES[rule_sharded]}: square_width 257 > 255"


# The largest D whose tile fits the 232448 B of shared memory at
# square_width 255: K1, K8 and K9 share the bit-row layout of
# csrc/match_loop.cuh (4 * 382 * (6 * 13 + 13 + (D-1)//32 + 1) bytes), so
# the limit is the same for all three.
@pytest.mark.parametrize("rule_sharded_dmax", [("exact", False, 1952), ("reference", False, 1952),
                                               ("exact", True, 1952)])
def test_classic_predicate_shared_memory_boundary(rule_sharded_dmax):
    rule, sharded, d_max = rule_sharded_dmax
    stage = STAGES[(rule, sharded)]
    mirror = fused.match_score_edges_smem_bytes
    assert mirror(127, d_max) <= fused.MAX_SMEM_BYTES < mirror(127, d_max + 1)
    assert classic.classic_kernels_supported(
        StereoParams(square_width=255, num_shifts=d_max, edge_rule=rule), sharded) == (True, "")
    ok, why = classic.classic_kernels_supported(
        StereoParams(square_width=255, num_shifts=d_max + 1, edge_rule=rule), sharded)
    assert not ok and why.startswith(f"{stage}: square_width 255 with {d_max + 1} shifts needs")


@pytest.mark.parametrize("sharded", [False, True])
def test_classic_predicate_sends_sw255_d200_to_the_kernel(sharded):
    """sw 255 with D 200 goes to K8 on the reference rule and to K9 on
    the sharded tier; sw 301 still goes to the plain version."""
    params = StereoParams(square_width=255, num_shifts=200)
    assert params.edge_rule == "reference"
    assert classic.classic_kernels_supported(params, sharded) == (True, "")
    assert classic.plain_stages(params, sharded) == {}
    wide = StereoParams(square_width=301, num_shifts=200)
    stage = STAGES[("reference", sharded)]
    assert classic.classic_kernels_supported(wide, sharded) == (
        False, f"{stage}: square_width 301 > 255")
    assert classic.plain_stages(wide, sharded) == {stage: f"{stage}: square_width 301 > 255"}
    if not sharded:
        assert classic._match_fn(params) is fused.match_and_score
        assert classic._match_fn(wide) is fused.match_and_score_reference


def test_kernel_refusal_packed_winner_limit():
    """More than 65535 shifts cannot be packed beside the score; at sw 1
    the shared memory refuses first, at 13409 shifts."""
    assert fused.kernel_refusal(StereoParams(square_width=1, num_shifts=13408)) == ""
    assert fused.kernel_refusal(StereoParams(square_width=1, num_shifts=13409)).startswith(
        "square_width 1 with 13409 shifts needs")
    assert fused.kernel_refusal(StereoParams(square_width=1, num_shifts=65536)) == (
        "num_shifts 65536 > 65535")


def test_modern_predicate_limits():
    def verdict(**kw):
        return {s: ok for s, (ok, _) in modern.modern_kernels_supported(ModernParams(**kw)).items()}

    every = {"disparity": True, "volume": True, "aggregate": True, "tail": True,
             "fill_invalid": True}
    assert verdict(window=255, num_disparities=256) == every
    assert verdict(window=257) == {**every, "disparity": False}
    assert verdict(num_disparities=257) == {**every, "disparity": False, "aggregate": False}
    sup = modern.modern_kernels_supported(ModernParams(window=257, num_disparities=300))
    assert sup["disparity"] == (False, "disparity: window 257 > 255")
    assert sup["aggregate"] == (False, "sgm_directional: num_disparities 300 > 256")


def test_routes_select_plain_stages():
    """Each config's route, stage by stage, and the matchers' plain_stages."""
    k, p = modern._KERNELS, modern._PLAIN
    assert modern._route(ModernParams()) == k
    assert modern._route(ModernParams(num_disparities=320)) == k._replace(
        disparity=p.disparity, aggregate=p.aggregate)
    assert modern._route(ModernParams(window=301)) == k._replace(disparity=p.disparity)
    assert modern.plain_stages(ModernParams(num_disparities=320)) == {
        "disparity": "disparity: num_disparities 320 > 256"}
    assert modern.plain_stages(ModernParams(num_disparities=320, aggregation="sgm")) == {
        "aggregate": "sgm_directional: num_disparities 320 > 256"}
    assert modern.plain_stages(ModernParams(window=301, aggregation="sgm")) == {}
    assert ModernMatcher(ModernParams(num_disparities=320), device="cpu").plain_stages == {
        "disparity": "disparity: num_disparities 320 > 256"}

    exact = StereoParams(edge_rule="exact", num_shifts=64)
    assert classic._match_fn(exact) is fused.match_score_edges
    assert classic._match_fn(StereoParams(num_shifts=64)) is fused.match_and_score
    wide = StereoParams(square_width=301, num_shifts=64)
    assert classic._match_fn(wide) is fused.match_and_score_reference
    assert classic._match_fn(StereoParams(square_width=301, edge_rule="exact")) is (
        fused.match_score_edges_reference)
    assert Matcher(exact, device="cpu").plain_stages == {}
    assert Matcher(wide, device="cpu").plain_stages == {
        "match_and_score": "match_and_score: square_width 301 > 255"}
    assert classic.plain_stages(StereoParams(square_width=255, num_shifts=2000),
                                sharded=True) == {
        "match_and_score_prehalo": "match_and_score_prehalo: square_width 255 with 2000 "
                                   "shifts needs 235312 B of shared memory per block "
                                   "(limit 232448)"}


def test_cli_square_width_301_writes_the_jax_clis_ppms(tmp_path, capsys):
    """The reference CLI's run at square width 301 (past K8's 255): the
    port's CLI writes the JAX CLI's PPMs and exits 0; the CPU tier prints
    no note (every stage is plain there), the GPU tiers one note line."""
    left, right = synthetic_pair(h=304, w=304, seed=3)
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    j_imageio.write_png_gray(a, left)
    j_imageio.write_png_gray(b, right)
    argv = [a, b, "0.15", "301", "--shifts", "4"]
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    assert cli.main([*argv, "--tier", "cpu", "--outdir", port_dir]) == 0
    assert "note:" not in capsys.readouterr().err
    assert j_cli.main([*argv, "--tier", "jax", "--outdir", jax_dir]) == 0
    ppms = sorted(f for f in os.listdir(jax_dir) if f.endswith(".ppm"))
    assert len(ppms) == 6 and sorted(os.listdir(port_dir)) == ppms
    for f in ppms:
        with open(os.path.join(port_dir, f), "rb") as x, open(os.path.join(jax_dir, f), "rb") as y:
            assert x.read() == y.read(), f
    cli._note_plain_stages(classic.plain_stages(StereoParams(square_width=301)), "cuda")
    assert capsys.readouterr().err == (
        "note: plain torch on the GPU for match_and_score: square_width 301 > 255\n")
