"""PyTorch port: the sharded wrappers and the training step across
processes (`parallel/collectives.py`), on the CPU over gloo.

`utils/ranks.py` starts 2 ranks (the 2x1 mesh, one device per rank, and
the explicit 2x2 list in which each rank holds its device twice) and 4
ranks (the 4x1 mesh), each a process of its own that renders its own
cells of `tests/test_torch_parallel.py`'s cube (16x16, batch 4) and
sphere (16x16, batch 2; batch 4 on the 4x1 mesh) and takes three eager
Adam steps of the cow fit (16x16, sphere resolution 8). This process
holds what they return to the port's unsharded renders (bit for bit; the
gradients within rtol 1e-4, atol 1e-6; the steps' offsets within 1e-4 of
max |offsets|) and to the JAX package's sharded renders on the conftest's
8 virtual CPU devices (1e-5 hard, 1e-4 soft, as tests/test_parallel.py;
tests/test_torch_parallel.py holds the port's gradients to JAX's). The
ranks' outputs, gradients and parameters are bit for bit equal, and two
runs in each rank repeat bit for bit.
"""

import concurrent.futures

import jax
import numpy as np
import pytest
import torch

from pytorch_mesh_renderer_tpu import parallel as jparallel
from pytorch_mesh_renderer_tpu.ops import mesh as jmesh_ops
from pytorch_mesh_renderer_tpu_torch.parallel import mesh
from pytorch_mesh_renderer_tpu_torch.utils import ranks

CPU = torch.device("cpu")
WORLDS = (2, 4)
KEYS = [(world, case, mesh) for world in WORLDS
        for case, meshes in ranks.PLAN[("small", world)].items()
        if case != "steps" for mesh in meshes]
MESH_SHAPES = {"2x1": (2, 1), "2x2list": (2, 2), "4x1": (4, 1)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(results, unsharded, jax): {world: [each rank's results]} of both
    starts at once; meanwhile, in this process, {(world, case): (output,
    gradient)} of the port without a mesh and {key: output} of the JAX
    package's sharded wrappers."""
    root = tmp_path_factory.mktemp("ranks")
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        started = {world: pool.submit(ranks.run, world,
                                      str(root / f"world{world}"), "cpu",
                                      "small", "gloo", 240.0)
                   for world in WORLDS}
        unsharded = {}
        for world in WORLDS:
            for case, (start, render) in ranks.case_fns(
                    "small", CPU, world).items():
                unsharded[(world, case)] = ranks.output_and_grad(
                    start, render, None, case)
        theirs = {(world, case, mesh): _jax_render(case, world,
                                                   *MESH_SHAPES[mesh])
                  for world, case, mesh in KEYS}
        results = {world: run.result() for world, run in started.items()}
    return results, unsharded, theirs


def _jax_render(case, world, data, space):
    """The JAX package's sharded wrapper's output on a (data, space) mesh
    of virtual devices."""
    jmesh = jparallel.make_mesh(data=data, space=space)
    if case == "hard":
        verts, tris, attrs, cams = ranks.cube_scene()
        background = np.zeros([3], np.float32)

        def render(v):
            return jparallel.sharded_rasterize(jmesh, v, attrs, tris, cams,
                                               16, 16, background)
    else:
        verts, tris, colors, lights, intensities, cams = ranks.sphere_scene(
            batch=max(2, world))

        def render(v):
            if case == "silhouette":
                return jparallel.sharded_soft_silhouette(jmesh, v, tris, cams,
                                                         16, 16, 1e-4)
            normals = jmesh_ops.compute_vertex_normals(v, tris)
            return jparallel.sharded_soft_rasterize(
                jmesh, v, tris, normals, colors, lights, intensities, cams,
                16, 16, 1e-4, 1e-4)

    return np.asarray(jax.jit(render)(verts))


@pytest.mark.parametrize("world,case,mesh", KEYS)
def test_sharded_wrapper_across_ranks_matches_unsharded_and_jax(
        runs, world, case, mesh):
    results, unsharded, jax_runs = runs
    per_rank = [r[f"{case}/{mesh}"] for r in results[world]]
    first = per_rank[0]
    for other in per_rank:
        assert other["repeat"] and other["spread"] == 0.0
        assert torch.equal(other["out"], first["out"])
        assert torch.equal(other["grad"], first["grad"])
    want, want_grad = unsharded[(world, case)]
    assert torch.equal(first["out"], want)
    np.testing.assert_allclose(first["grad"].numpy(), want_grad.numpy(),
                               rtol=1e-4, atol=1e-6)
    tol = 1e-5 if case == "hard" else 1e-4
    np.testing.assert_allclose(first["out"].numpy(),
                               jax_runs[(world, case, mesh)], rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("world", WORLDS)
def test_eager_steps_across_ranks_match_unsharded_steps(runs, world):
    """Three eager Adam steps of the cow fit on the mesh: the ranks'
    offsets bit for bit equal, two runs equal, within 1e-4 of max |offsets|
    of three unsharded steps; a capture on the mesh raises, naming
    step.run_eager."""
    (mesh,) = ranks.PLAN[("small", world)]["steps"]
    per_rank = [r[f"steps/{mesh}"] for r in runs[0][world]]
    for entry in per_rank:
        assert entry["repeat"] and entry["spread"] == 0.0
        assert torch.equal(entry["offsets"], per_rank[0]["offsets"])
        assert torch.equal(entry["losses"], per_rank[0]["losses"])
        assert "step.run_eager" in entry["capture_error"]
    losses, offsets = ranks.eager_steps(ranks.fit_problem("small", CPU, None),
                                        CPU, ranks.STEPS["small"])
    np.testing.assert_allclose(per_rank[0]["losses"].numpy(),
                               losses.numpy(), rtol=1e-4)
    scale = float(offsets.abs().max())
    assert scale > 0.0
    assert float((per_rank[0]["offsets"] - offsets).abs().max()) <= (
        1e-4 * scale)


@pytest.mark.parametrize("world", WORLDS)
def test_a_mesh_naming_a_rank_outside_the_group_raises(runs, world):
    for r in runs[0][world]:
        assert f"outside the group of {world} ranks" in r["outside_group"]


def test_shared_cards_names_each_card_two_ranks_hold():
    """init_distributed's check under NCCL: ranks 0 and 1 hold one card of
    host a; rank 2 holds another card; the CPU is no card."""
    gathered = [("a", [("cuda:0", "GPU-1")]), ("a", [("cuda:0", "GPU-1")]),
                ("a", [("cuda:1", "GPU-2")]), ("b", [("cuda:0", "GPU-1")]),
                ("a", [("cpu", None)]), ("a", [("cpu", None)])]
    assert mesh.shared_cards(gathered) == {("a", "GPU-1"): [0, 1]}
    assert mesh.shared_cards(gathered[2:]) == {}


def test_a_rank_that_does_not_end_in_time_fails_the_run(tmp_path):
    """`ranks.run` stops every rank at its timeout and raises with their
    logs (chip_smoke.py phase 17 fails on it)."""
    with pytest.raises(RuntimeError, match=r"ranks \[0, 1\] did not end"):
        ranks.run(2, str(tmp_path), timeout=0.5)
