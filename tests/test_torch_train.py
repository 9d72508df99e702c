"""PyTorch port: the training step and loop (`parallel.make_train_step`,
`make_train_loop`) vs the JAX package's, and the capture-safe forms of
the renderers' constants (`utils/capture.py`).

On the CPU both run eagerly (on a card the step is captured into a CUDA
graph: chip_smoke.py's phase 14 and tests/test_torch_cuda.py). The same
scenes, made with numpy, go through `scene_to_torch` and through the JAX
package; `torch.optim.Adam` stands against `optax.adam`. Tolerances:

  * losses within 1e-4 relative at each of 5 steps: the renders agree to
    ~1e-6 (tests/test_torch_mesh_renderer.py) and the soft silhouette to
    ~1e-5 at sigma 1e-4 (tests/test_torch_soft_renderer.py; the pose fit
    against the JAX package's XLA route from angles 0, and against its
    Pallas route away from the ties, see `_jax_pose_loss`), and
    Adam's first steps move each parameter by about its learning rate
    whatever the gradient's size, so the losses stay as close as the
    renders;
  * parameters within 1e-3 of the learning rate, at each step: the
    gradients agree to ~1e-4 of their size, which moves Adam's
    normalised update g / sqrt(g^2) by less than that;
  * the loop and the step: bit for bit, the same function (the twin of
    tests/test_parallel.py::test_spmd_train_loop_matches_steps).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import __graft_entry__
from pytorch_mesh_renderer_tpu import config as jconfig
from pytorch_mesh_renderer_tpu import parallel as jparallel
from pytorch_mesh_renderer_tpu.models import mesh_renderer as jhard
from pytorch_mesh_renderer_tpu.models import soft_mesh_renderer as jsoft
from pytorch_mesh_renderer_tpu.ops import camera as jcamera
from pytorch_mesh_renderer_tpu.ops import losses as jlosses
from pytorch_mesh_renderer_tpu_torch import parallel
from pytorch_mesh_renderer_tpu_torch.parallel import sharded
from pytorch_mesh_renderer_tpu_torch.models import (mesh_renderer, shapes,
                                                    soft_mesh_renderer)
from pytorch_mesh_renderer_tpu_torch.ops import camera, losses
from pytorch_mesh_renderer_tpu_torch.utils import capture
from pytorch_mesh_renderer_tpu_torch.utils.convert import (SCENE_KEYS,
                                                           scene_to_torch)

SIZE, STEPS = 32, 5
HARD_LR, POSE_LR = 5e-3, 5e-2
OFFSET0 = np.float32([[[0.05, -0.04, 0.03]]])
POSE_TARGET = np.float32([-0.35, 0.0, 1.05])


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes on one machine; the plain
    versions' large elementwise ops would otherwise take a thread per core
    in every worker at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _hard_scene():
    """__graft_entry__'s two rotated cubes at 32x32 and the render of the
    cubes moved by OFFSET0 as the target: the fit recovers the offset."""
    scene = __graft_entry__._cube_scene(batch=2, image_size=SIZE)
    target = jhard.render(scene["vertices"] + OFFSET0,
                          *[scene[k] for k in SCENE_KEYS[1:]], SIZE, SIZE)
    return scene, np.asarray(target)


def _jax_hard_loss(scene):
    rest = [scene[k] for k in SCENE_KEYS[1:]]

    def loss_fn(params, batch):
        images = jhard.render(scene["vertices"] + params["offset"], *rest,
                              SIZE, SIZE)
        return jlosses.image_l1_loss(images, batch["target"])
    return loss_fn


def _port_hard_loss(scene):
    ts = scene_to_torch(scene, "cpu")
    rest = [ts[k] for k in SCENE_KEYS[1:]]

    def loss_fn(params, batch):
        images = mesh_renderer.render(ts["vertices"] + params[0], *rest,
                                      SIZE, SIZE)
        return losses.image_l1_loss(images, batch["target"])
    return loss_fn


def _jax_pose_loss(backend):
    """JAX's pose loss through `backend`: "xla" (JAX's own derivative of
    the model's math) or "pallas" (its kernels in interpret mode, the route
    bench.py's pose fit runs on its chip). From angles 0 the cube's square
    faces put pixel centres at exactly equal distance from two edges of a
    triangle: the XLA route's jnp.min splits the squared distance's
    gradient evenly between them, as the port does, while the Pallas
    kernels give it all to the first nearest edge (ROADMAP Queue 3)."""
    v, t, _ = shapes.cube(2.0)
    v, t = v.numpy(), t.numpy()
    cam = (np.float32([[0.0, 0.0, 6.0]]), np.zeros((1, 3), np.float32),
           np.float32([[0.0, 1.0, 0.0]]))
    config = jconfig.SoftRasterizerConfig(backend=backend,
                                          interpret=backend == "pallas")

    def render_alpha(angles):
        rot = jcamera.euler_matrices(angles[None])[0, :3, :3]
        return jsoft.render_silhouette((v @ rot.T)[None], t, *cam, SIZE,
                                       SIZE, sigma_val=1e-4,
                                       config=config)[0]

    def loss_fn(params, batch):
        return 1.0 - jlosses.silhouette_iou(render_alpha(params["angles"]),
                                            batch["target"])
    return loss_fn, render_alpha


def _port_pose_loss():
    v, t, _ = shapes.cube(2.0)
    cam = (torch.tensor([[0.0, 0.0, 6.0]]), torch.zeros(1, 3),
           torch.tensor([[0.0, 1.0, 0.0]]))

    def render_alpha(angles):
        rot = camera.euler_matrices(angles[None])[0, :3, :3]
        return soft_mesh_renderer.render_silhouette(
            (v @ rot.T)[None], t, *cam, SIZE, SIZE, sigma_val=1e-4)[0]

    def loss_fn(params, batch):
        return 1.0 - losses.silhouette_iou(render_alpha(params[0]),
                                           batch["target"])
    return loss_fn, render_alpha


def _jax_steps(loss_fn, params, batch, lr):
    """(losses, parameters after each step) of JAX's make_train_step."""
    opt = optax.adam(lr)
    step = jparallel.make_train_step(loss_fn, opt, donate=False)
    state = opt.init(params)
    out_losses, out_params = [], []
    for _ in range(STEPS):
        params, state, loss = step(params, state, batch)
        out_losses.append(float(loss))
        out_params.append(np.asarray(next(iter(params.values()))))
    return out_losses, out_params


def _port_steps(loss_fn, param, batch, lr):
    param = torch.from_numpy(np.array(param)).requires_grad_(True)
    step = parallel.make_train_step(loss_fn,
                                    torch.optim.Adam([param], lr=lr))
    out_losses, out_params = [], []
    for _ in range(STEPS):
        loss = step(batch)
        assert loss.dim() == 0 and not loss.requires_grad
        out_losses.append(loss.item())
        out_params.append(param.detach().numpy().copy())
    return out_losses, out_params


def _assert_steps_match(port, jax_steps, lr):
    np.testing.assert_allclose(port[0], jax_steps[0], rtol=1e-4)
    for ours, theirs in zip(port[1], jax_steps[1]):
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-3 * lr)
    assert port[0][-1] < port[0][0]


def test_hard_cube_fit_steps_match_jax():
    """5 Adam steps of a 32x32 hard-render fit of a vertex offset, loss
    image_l1_loss: the port's make_train_step vs JAX's with optax.adam."""
    scene, target = _hard_scene()
    want = _jax_steps(_jax_hard_loss(scene),
                      {"offset": jnp.zeros([1, 1, 3])}, {"target": target},
                      HARD_LR)
    got = _port_steps(_port_hard_loss(scene), np.zeros([1, 1, 3],
                                                       np.float32),
                      {"target": torch.from_numpy(target)}, HARD_LR)
    _assert_steps_match(got, want, HARD_LR)


@pytest.mark.parametrize("backend, angles0", [
    ("xla", (0.0, 0.0, 0.0)), ("pallas", (0.03, -0.02, 0.04))])
def test_silhouette_pose_fit_steps_match_jax(backend, angles0):
    """5 Adam steps of bench.py's pose fit (a cube's rotation from its
    soft silhouette, loss 1 - IoU) at 32x32: the port's make_train_step vs
    JAX's with optax.adam, through its XLA route from angles 0 (bench.py's
    start, where nearest-edge distances tie) and through its Pallas kernels
    from angles (0.03, -0.02, 0.04), where no distance ties on the five
    steps' path (from (0.05, -0.05, 0.05) Adam's first step, which moves
    each angle by about its learning rate, lands on angles 0)."""
    jax_loss, render_alpha = _jax_pose_loss(backend)
    target = np.asarray(render_alpha(jnp.asarray(POSE_TARGET)))
    angles0 = np.float32(angles0)
    want = _jax_steps(jax_loss, {"angles": jnp.asarray(angles0)},
                      {"target": target}, POSE_LR)
    got = _port_steps(_port_pose_loss()[0], angles0.copy(),
                      {"target": torch.from_numpy(target)}, POSE_LR)
    _assert_steps_match(got, want, POSE_LR)


def test_pose_gradient_at_nearest_edge_ties_matches_jax_xla_route():
    """d loss / d angles of the pose fit at angles 0, where 10 of the 342
    valid (pixel, triangle) pairs lie at exactly equal distance from two
    edges: the port's plain route splits the squared distance's gradient
    between the tied edges (torch.amin) as JAX's XLA route does (jnp.min;
    z: 0.11963), not all to the first edge as the Pallas kernels do
    (0.09431). Within 1e-4 of the gradient's max |value|, the gradients'
    agreement elsewhere (module docstring)."""
    jax_loss, render_alpha = _jax_pose_loss("xla")
    target = np.asarray(render_alpha(jnp.asarray(POSE_TARGET)))
    want = np.asarray(jax.grad(lambda a: jax_loss(
        {"angles": a}, {"target": target}))(jnp.zeros(3)))
    angles = torch.zeros(3, requires_grad=True)
    _port_pose_loss()[0]([angles], {"target": torch.from_numpy(target)}
                         ).backward()
    got = angles.grad.numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(want[2], 0.11963, atol=1e-5)


@pytest.mark.parametrize("fit", ["hard", "pose"])
def test_train_loop_equals_steps_bit_for_bit(fit):
    """K = 3 steps of make_train_loop equal 3 calls of make_train_step:
    the losses in order and the parameters, bit for bit."""
    if fit == "hard":
        scene, target = _hard_scene()
        loss_fn, param0 = _port_hard_loss(scene), OFFSET0 * 0.0
    else:
        loss_fn, render_alpha = _port_pose_loss()
        with torch.no_grad():
            target = render_alpha(torch.from_numpy(POSE_TARGET)).numpy()
        param0 = np.zeros(3, np.float32)
    batch = {"target": torch.from_numpy(target)}

    def fresh():
        param = torch.from_numpy(param0.copy()).requires_grad_(True)
        return param, torch.optim.Adam([param], lr=POSE_LR)

    param_a, opt_a = fresh()
    step = parallel.make_train_step(loss_fn, opt_a)
    step_losses = torch.stack([step(batch) for _ in range(3)])
    param_b, opt_b = fresh()
    loop = parallel.make_train_loop(loss_fn, opt_b, steps_per_call=3)
    loop_losses = loop(batch)
    assert loop_losses.shape == (3,)
    assert torch.equal(loop_losses, step_losses)
    assert torch.equal(param_b, param_a)
    assert not torch.equal(param_b, torch.from_numpy(param0))
    # A second call goes on from where the first stopped.
    assert torch.equal(loop(batch)[0], step(batch))


def test_train_step_argument_checks():
    param = torch.zeros(3, requires_grad=True)
    with pytest.raises(ValueError, match="optimizer"):
        parallel.make_train_step(lambda p, b: p[0].sum(), None)
    with pytest.raises(ValueError, match="steps_per_call"):
        parallel.make_train_loop(lambda p, b: p[0].sum(),
                                 torch.optim.Adam([param]), 0)


def test_look_at_still_raises_eagerly_through_render():
    """The degeneracy check is skipped only under CUDA graph capture: an
    eager render with eye == center still raises."""
    v, t, n = shapes.cube(2.0)
    assert not capture.capturing(v)
    with pytest.raises(AssertionError, match="eye and center"):
        mesh_renderer.render(v[None], t, n[None], torch.ones(1, 8, 3),
                             torch.zeros(3), torch.zeros(3),
                             torch.tensor([0.0, 1.0, 0.0]),
                             torch.ones(1, 1, 3), torch.ones(1, 1, 3), 8, 8)


@pytest.mark.parametrize("value", [3, 0.1, np.float32(2.5), np.float64(1e-3),
                                   [0.0, 1.0, 6.0], [[1, 2, 3]],
                                   np.arange(6.0).reshape(2, 3)])
def test_constant_equals_as_tensor(value):
    """capture.constant gives torch.as_tensor's f32 values (a number by a
    device fill, an array copied once per device and reused)."""
    want = torch.as_tensor(value, dtype=torch.float32)
    got = capture.constant(value, "cpu")
    assert got.dtype == torch.float32 and torch.equal(got, want)
    if not np.isscalar(value):
        assert capture.constant(np.array(value), "cpu") is got
    ints = capture.constant(np.int64([[0, 2, 1]]), "cpu", torch.int32)
    assert ints.dtype == torch.int32 and ints.tolist() == [[0, 2, 1]]


def test_hold_keeps_the_array_constants_made_in_its_block():
    """`capture.hold` lists each array tensor that `constant` returns in
    its block, cached ones too (a captured step keeps the list beside its
    graph), and no number's."""
    before = capture.constant(np.array([1.0, 2.0]), "cpu")
    with capture.hold() as held:
        made = capture.constant([[3.0, 4.0]], "cpu")
        capture.constant(2.5, "cpu")
        again = capture.constant(np.array([1.0, 2.0]), "cpu")
    capture.constant(np.array([6.0]), "cpu")
    assert again is before
    assert len(held) == 2 and held[0] is made and held[1] is before


def test_a_capture_fixes_the_hyperparameters_that_are_not_tensors():
    """What a captured step compares before each replay: every entry of
    each param group but the parameters and the tensors."""
    param = torch.zeros(3, requires_grad=True)
    optimizer = torch.optim.Adam([param], lr=0.1, betas=(0.8, 0.9),
                                 weight_decay=1e-3)
    (fixed,) = sharded._hyperparameters(optimizer)
    assert "params" not in fixed
    assert (fixed["lr"], fixed["betas"], fixed["weight_decay"]) == (
        0.1, (0.8, 0.9), 1e-3)
    optimizer = torch.optim.Adam([param], lr=torch.tensor(0.1),
                                 betas=(torch.tensor(0.8), torch.tensor(0.9)))
    (fixed,) = sharded._hyperparameters(optimizer)
    assert "lr" not in fixed and "betas" not in fixed and "eps" in fixed
