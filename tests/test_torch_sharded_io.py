"""The port's sharded tier fed and read block by block
(``parallel.Sharded``), held bitwise against the JAX sharded tier on the
8-device CPU mesh (``tests/conftest.py``): each output shard of the port
at the index of a JAX ``addressable_shards`` entry equals that shard, for
the classic pipeline (ghost and wrap) and the modern SGM and box routes
on data 2 x rows 4, rows 4 and rows 2 x cols 2 meshes.  The port's
inputs are built from the JAX inputs' shards by ``Sharded.from_callback``
(here, since the port imports no jax).  Also: ``from_global`` against
``jax.device_put`` with a ``NamedSharding`` shard by shard, the
mesh-placed ``BatchLoader`` against the JAX loader, the matchers fed a
sharded batch, two blocks in one process, and the refusals.

Inputs: seeded random pairs of 2 x 32 x 48 (classic brightness, modern
0..255 pixels), D 6 (classic) and 8 (modern).  Every JAX pipeline is
built and run once per module (``functools.cache``).
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from stereomatching_tpu.config import BoundaryMode as JBoundaryMode
from stereomatching_tpu.config import ModernParams as JModernParams
from stereomatching_tpu.config import StereoParams as JStereoParams
from stereomatching_tpu.data import BatchLoader as JBatchLoader
from stereomatching_tpu.data import StereoPairDataset as JStereoPairDataset
from stereomatching_tpu.parallel import build_sharded_modern_pipeline as j_build_modern
from stereomatching_tpu.parallel import build_sharded_pipeline as j_build
from stereomatching_tpu.parallel import make_mesh as j_make_mesh
from stereomatching_tpu_torch import interop
from stereomatching_tpu_torch.config import BoundaryMode, ModernParams, StereoParams
from stereomatching_tpu_torch.data import BatchLoader, StereoPairDataset
from stereomatching_tpu_torch.models.classic import classic_forward_batched
from stereomatching_tpu_torch.parallel import (
    PER_IMAGE, PLANE, Sharded, build_sharded_modern_pipeline, build_sharded_pipeline,
    make_mesh, outputs_to_global, sharded_classic_forward)
from stereomatching_tpu_torch.serving import Matcher, ModernMatcher
from stereomatching_tpu_torch.utils.imageio import write_png_gray

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device CPU mesh (conftest)")

SHAPE = (2, 32, 48)
MESHES = [(2, 4, None), (1, 4, None), (1, 2, 2)]
MESH_IDS = ["data2xrows4", "rows4", "rows2xcols2"]


def _n(shape):
    return shape[0] * shape[1] * (shape[2] or 1)


def cpu_mesh(shape):
    return make_mesh(*shape, devices=["cpu"] * _n(shape))


@functools.cache
def jax_mesh(shape):
    kw = dict(data=shape[0], rows=shape[1], devices=jax.devices()[:_n(shape)])
    if shape[2]:
        kw["cols"] = shape[2]
    return j_make_mesh(**kw)


def plane_spec(shape):
    return P("data", "rows", "cols" if shape[2] else None)


@functools.cache
def pair(kind):
    """The seeded pair: float32 brightness (classic) or int32 pixels."""
    rng = np.random.default_rng(16)
    u8 = [rng.integers(0, 256, SHAPE, dtype=np.uint8) for _ in range(2)]
    if kind == "classic":
        return tuple(x.astype(np.float32) / np.float32(256.0) for x in u8)
    return tuple(x.astype(np.int32) for x in u8)


CONFIGS = {
    "classic-ghost": ("classic", JStereoParams(square_width=5, times=4, lines=4, num_shifts=6,
                                               mode=JBoundaryMode.GHOST, edge_rule="exact")),
    "classic-wrap": ("classic", JStereoParams(square_width=5, times=4, lines=4, num_shifts=6,
                                              mode=JBoundaryMode.WRAP, edge_rule="reference")),
    "sgm": ("modern", JModernParams(num_disparities=8, aggregation="sgm", cost="census",
                                    sgm_directions=8, median_filter=True, uniqueness=True)),
    "box": ("modern", JModernParams(num_disparities=8, window=5, median_filter=True)),
}
CASES = [(c, m) for c in CONFIGS for m in MESHES if not (c == "sgm" and m[2])]


def _shards(arr):
    """A JAX array's addressable shards -> {index: numpy}."""
    return {s.index: np.asarray(s.data) for s in arr.addressable_shards}


@functools.cache
def jax_run(config, shape):
    """The JAX sharded tier on the pair placed with its in_specs ->
    (the placed inputs, {output: {index: shard}})."""
    kind, jp = CONFIGS[config]
    mesh = jax_mesh(shape)
    build = j_build if kind == "classic" else j_build_modern
    ins = [jax.device_put(x, NamedSharding(mesh, plane_spec(shape))) for x in pair(kind)]
    out = build(jp, mesh)(*ins)
    return ins, {k: _shards(v) for k, v in out.items()}


@pytest.mark.parametrize("config,shape", CASES,
                         ids=[f"{c}-{MESH_IDS[MESHES.index(m)]}" for c, m in CASES])
def test_output_blocks_equal_jax_addressable_shards(config, shape):
    kind, jp = CONFIGS[config]
    (jl, jr), want = jax_run(config, shape)
    mesh = cpu_mesh(shape)
    left, right = (Sharded.from_callback(x.shape, mesh, lambda i, x=x: np.asarray(x[i]))
                   for x in (jl, jr))
    params = interop.params_from_jax(jp)
    build = build_sharded_pipeline if kind == "classic" else build_sharded_modern_pipeline
    got = build(params, mesh)(left, right)
    assert sorted(got) == sorted(want)
    for k, out in got.items():
        assert isinstance(out, Sharded) and out.mesh == mesh
        assert out.layout == (PER_IMAGE if k.endswith("_elevation") else PLANE), k
        shards = out.addressable_shards
        assert {i for i, _ in shards} == set(want[k]), k
        for index, t in shards:
            w = want[k][index]
            assert t.numpy().dtype == w.dtype and np.array_equal(t.numpy(), w), (k, index)


@pytest.mark.parametrize("layout", [PLANE, PER_IMAGE])
@pytest.mark.parametrize("shape", MESHES + [(2, 2, 2), (8, 1, None)],
                         ids=MESH_IDS + ["data2xrows2xcols2", "data8"])
def test_from_global_equals_jax_device_put(shape, layout):
    rng = np.random.default_rng(3)
    b = 8 if shape[0] == 8 else 2
    x = rng.random((b, 32, 48), dtype=np.float32) if layout == PLANE else \
        rng.integers(0, 99, (b,)).astype(np.int32)
    spec = plane_spec(shape) if layout == PLANE else P("data")
    want = _shards(jax.device_put(x, NamedSharding(jax_mesh(shape), spec)))
    got = Sharded.from_global(torch.from_numpy(x), cpu_mesh(shape), layout)
    assert got.shape == x.shape and got.dtype == torch.from_numpy(x).dtype
    assert {i for i, _ in got.addressable_shards} == set(want)
    for index, t in got.addressable_shards:
        assert np.array_equal(t.numpy(), want[index]), index
    assert np.array_equal(np.asarray(got), x) and np.array_equal(got.to_global().numpy(), x)
    # The reductions read the held blocks, each image of a per-image array once.
    assert got.reduce().item() == x.astype(np.float64).sum()
    assert got.reduce("min").item() == x.min() and got.reduce("max").item() == x.max()
    # The same from a callback, asked once for each shard of the mesh.
    asked = []
    back = Sharded.from_callback(x.shape, cpu_mesh(shape),
                                 lambda i: asked.append(i) or x[i], layout)
    assert len(asked) == _n(shape) and set(asked) == set(want)
    assert all(torch.equal(a, b) for a, b in zip(back.blocks, got.blocks))


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("pairs")
    rng = np.random.default_rng(7)
    for i in range(7):
        (root / f"s{i}").mkdir()
        for name in ("a.png", "b.png"):
            write_png_gray(str(root / f"s{i}" / name),
                           rng.integers(0, 256, (32, 48), dtype=np.uint8))
    return str(root)


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_loader_batches_equal_the_jax_loaders(dataset_root, shape):
    """BatchLoader(mesh=...) yields sharded planes whose shards equal the
    JAX loader's ``NamedSharding`` batches shard by shard, and whose
    ``to_global`` equals their ``np.asarray``, with the same ``kept``."""
    mesh = cpu_mesh(shape)
    jbatches = list(JBatchLoader(JStereoPairDataset.from_root(dataset_root), 4,
                                 mesh=jax_mesh(shape)))
    batches = list(BatchLoader(StereoPairDataset.from_root(dataset_root), 4, mesh=mesh))
    assert [k for *_, k in batches] == [k for *_, k in jbatches] == [4, 3]
    for (lb, rb, _), (jl, jr, _) in zip(batches, jbatches):
        for x, jx in ((lb, jl), (rb, jr)):
            assert isinstance(x, Sharded) and x.mesh == mesh and x.layout == PLANE
            assert np.array_equal(x.to_global().numpy(), np.asarray(jx))
            want = _shards(jx)
            for index, t in x.addressable_shards:
                assert np.array_equal(t.numpy(), want[index]), index


def test_matchers_take_a_sharded_batch(dataset_root):
    """A sharded batch on the matcher's mesh goes straight in; one on
    another mesh is gathered first; either equals the numpy call."""
    mesh = cpu_mesh((2, 4, None))
    params = StereoParams(square_width=5, times=3, num_shifts=6, edge_rule="exact")
    matcher = Matcher(params, mesh=mesh)
    lb, rb, _ = next(iter(BatchLoader(StereoPairDataset.from_root(dataset_root), 4, mesh=mesh)))
    want = matcher(np.asarray(lb), np.asarray(rb))
    other = cpu_mesh((1, 4, None))
    for got in (matcher(lb, rb),
                matcher(*(Sharded.from_global(np.asarray(x), other) for x in (lb, rb)))):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    li, ri = pair("modern")
    mm = ModernMatcher(ModernParams(num_disparities=8, aggregation="sgm", cost="census"),
                       mesh=mesh)
    want = mm(li, ri)
    got = mm(*(Sharded.from_global(x, mesh) for x in (li, ri)))
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_two_device_blocks_in_one_process_block_fed():
    """Two blocks in one process (``cpu`` and ``cpu:0``): the inputs are
    built block by block on their devices, each block's body runs in its
    own thread, and every output block equals the single-device result."""
    devices = ["cpu", "cpu", torch.device("cpu", 0), torch.device("cpu", 0)]
    params = StereoParams(square_width=5, times=4, lines=4, num_shifts=6,
                          mode=BoundaryMode.GHOST)
    lf, rf = pair("classic")
    want = classic_forward_batched(torch.from_numpy(lf), torch.from_numpy(rf), params)
    for shape in ((1, 4, None), (1, 2, 2), (2, 2, None)):
        mesh = make_mesh(*shape, devices=devices)
        assert len(mesh.blocks[2]) == 2
        left, right = (Sharded.from_callback(x.shape, mesh, lambda i, x=x: x[i]) for x in (lf, rf))
        got = build_sharded_pipeline(params, mesh)(left, right)
        for k, v in want.items():
            for index, t in got[k].addressable_shards:
                assert torch.equal(t, v[index]), (shape, k, index)
        assert all(torch.equal(g, want[k]) for k, g in outputs_to_global(got).items())


def test_sharded_inputs_refused_off_their_mesh():
    lf, rf = pair("classic")
    params = StereoParams(square_width=5, num_shifts=6, edge_rule="exact")
    mesh, other = cpu_mesh((2, 4, None)), cpu_mesh((1, 4, None))
    left = Sharded.from_global(lf, mesh)
    with pytest.raises(ValueError, match="another mesh"):
        sharded_classic_forward(left, Sharded.from_global(rf, other), params, mesh)
    with pytest.raises(ValueError, match="equal"):
        sharded_classic_forward(left, Sharded.from_global(rf[:, :16], mesh), params, mesh)
    with pytest.raises(ValueError, match="plane"):
        sharded_classic_forward(Sharded.from_global(lf[:, 0, 0], mesh, PER_IMAGE), left,
                                params, mesh)
    with pytest.raises(ValueError, match="integer"):
        build_sharded_modern_pipeline(ModernParams(num_disparities=8), mesh)(left, left)
    with pytest.raises(ValueError, match="divide"):
        Sharded.from_global(lf[:1], mesh)
    with pytest.raises(ValueError, match="want"):
        Sharded.from_callback(lf.shape, mesh, lambda i: lf)
    with pytest.raises(ValueError, match="several dtypes"):
        Sharded.from_callback(lf.shape, mesh, lambda i: lf[i] if i[1].start else lf[i].astype(np.float64))
    with pytest.raises(ValueError, match="op must be"):
        left.reduce("mean")
    li, ri = pair("modern")
    li[1, -1, -1] = 256  # in the last block only
    with pytest.raises(ValueError, match="0..255"):
        build_sharded_modern_pipeline(ModernParams(num_disparities=8), mesh)(
            Sharded.from_global(li, mesh), ri)
