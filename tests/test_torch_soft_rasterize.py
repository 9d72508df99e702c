"""PyTorch port: the soft (SoftRas) rasterizer's plain versions of K5-K8 vs
the JAX package. The CUDA kernels themselves are held against these plain
versions on the card by tests/test_torch_cuda.py.

All inputs are made from seeds with numpy and handed to both packages; the
port runs on the CPU, so every call takes the plain versions.
Tolerances, with their reasons:
  * geometry helpers, single-triangle exact values and the translation
    recovery: the gates of their JAX twins (tests/test_soft_rasterize.py).
  * forward vs the JAX XLA scan and the Pallas kernels in interpret mode at
    16x16: atol 2e-5 / rtol 1e-4, the JAX suite's Pallas-vs-XLA gate
    (tests/test_soft_pallas.py:62). The port aggregates the softmax in
    other chunks than either, so the last bits differ.
  * the vendored reference oracle: atol 2e-4 / rtol 1e-3, its JAX twin's.
  * the six input gradients vs `jax.grad` of both JAX backends: 1e-4 of the
    JAX gradient's max |value|, per tensor, the JAX suite's CPU gate
    (tests/test_soft_pallas.py:81). sigma rtol 1e-3 and gamma rtol 1e-2
    against both, the JAX suite's gates (tests/test_soft_pallas.py:155-184):
    dgamma sums terms W (shade - rgb) z / gamma^2 that cancel, so the f32
    rounding of rgb, which differs among the three implementations, moves
    it by a few parts in 1e3 (measured: XLA, Pallas and the port differ by
    up to 3.5e-3 of it on this scene).
  * silhouette alpha equals the full render's alpha bit for bit (same
    geometry, same triangle-order product); its gradients match `jax.grad`
    of the Pallas full alpha within 1e-4 of the max |value| (clip) and rtol
    1e-3 (sigma).
  * row strips reassemble the full image exactly (each pixel's loop is the
    same); the zero-triangle mesh is background, exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_mesh_renderer_tpu.ops import soft_rasterize as jsoft
from pytorch_mesh_renderer_tpu.ops import soft_rasterize_pallas as jpallas
from pytorch_mesh_renderer_tpu_torch import config as config_lib
from pytorch_mesh_renderer_tpu_torch.ops import soft_rasterize as soft
from pytorch_mesh_renderer_tpu_torch.ops import soft_rasterize_cuda as sc

from conftest import ORACLE_DIR

SIGMA, GAMMA, BLUR, SIZE = 1e-3, 1e-2, 0.08, 16
NAMES = ("clip", "world", "normals", "colors", "lights", "intens")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes on one machine; the plain
    soft versions' large elementwise ops would otherwise take a thread per
    core in every worker at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _two_triangle_scene(seed=0, normal=(0.0, 0.3, 1.0), two_lights=True):
    """tests/test_soft_pallas.py's scene (seed 0), or the oracle's (seed 7,
    normal +z, one light)."""
    rng = np.random.RandomState(seed)
    world = np.array([[-0.6, -0.5, 0.1], [0.7, -0.4, -0.2], [0.0, 0.8, 0.0],
                      [0.9, 0.6, 0.4]], np.float32)
    tris = np.array([[0, 1, 2], [1, 3, 2]], np.int32)
    normals = np.tile(np.array([normal], np.float32), [4, 1])
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    colors = rng.uniform(0.2, 1.0, [4, 3]).astype(np.float32)
    lights = np.array([[0.5, 1.0, 3.0], [-1.0, 0.5, 2.0]], np.float32)
    intens = np.array([1.3, 0.7], np.float32)
    if not two_lights:
        lights, intens = lights[:1], intens[:1]
    w = np.array([1.0, 1.3, 0.9, 1.1], np.float32)
    clip = np.concatenate(
        [world * w[:, None], np.full([4, 1], 0.25, np.float32) * w[:, None]],
        axis=1)
    clip[:, 3] = w
    return (clip, world, normals, colors, lights, intens), tris


def _torch(arrays, grad=False):
    return [torch.from_numpy(np.array(a)).requires_grad_(grad)
            for a in arrays]


def _port(args, tris, sigma=SIGMA, gamma=GAMMA, blur=BLUR, size=SIZE,
          **kwargs):
    clip, world, normals, colors, lights, intens = args
    return soft.rasterize_batch(clip, torch.from_numpy(tris), world, normals,
                                colors, lights, intens, size, size, sigma,
                                gamma, blur_radius=blur, **kwargs)


def _jax(backend, args, tris, sigma=SIGMA, gamma=GAMMA):
    clip, world, normals, colors, lights, intens = args
    if backend == "pallas":
        return jpallas.rasterize_batch_pallas(
            clip, tris, world, normals, colors, lights, intens, SIZE, SIZE,
            sigma, gamma, BLUR, interpret=True)
    return jsoft.rasterize_batch(clip, tris, world, normals, colors, lights,
                                 intens, SIZE, SIZE, sigma, gamma,
                                 blur_radius=BLUR)


def test_point_to_segment_nearest():
    cases = (([1.0, -1.0], [1.0, 1.0], [-1.0, -1.0], [0.0, 0.0], 0.5),
             ([0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [1.0, 0.0], 0.0),
             ([0.0, 1.0], [1.0, 0.0], [1.0, 1.0], [1.0, 1.0], 1.0))
    for p, a, b, want_nearest, want_t in cases:
        nearest, t = soft.point_to_segment_nearest(
            torch.tensor(p), torch.tensor(a), torch.tensor(b))
        np.testing.assert_allclose(nearest.numpy(), want_nearest, atol=1e-6)
        np.testing.assert_allclose(float(t), want_t, atol=1e-6)


def test_edge_function_sign():
    p = torch.tensor([1.0, 0.0])
    v0, v1 = torch.tensor([0.0, -1.0]), torch.tensor([0.0, 1.0])
    assert float(soft.edge_function(p, v0, v1)) > 0.0  # p right of v0->v1
    assert float(soft.edge_function(-p, v0, v1)) < 0.0


def _single_triangle_scene():
    """tests/test_soft_rasterize.py's right triangle over the lower-right
    half of the NDC square (hypotenuse along y = x)."""
    clip = np.array([[1.0, -1.0, 0.25, 1.0], [1.0, 1.0, 0.25, 1.0],
                     [-1.0, -1.0, 0.25, 1.0]], np.float32)
    world = np.array([[1.0, -1.0, 0.0], [1.0, 1.0, 0.0], [-1.0, -1.0, 0.0]],
                     np.float32)
    normals = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), [3, 1])
    colors = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), [3, 1])
    lights = np.array([[0.0, 0.0, 1e5]], np.float32)
    intens = np.array([1.0], np.float32)
    return (clip, world, normals, colors, lights, intens), np.array(
        [[0, 1, 2]], np.int32)


def _lower_right_matrix(diag, fill, above=0.0):
    m = np.full([10, 10], above, np.float32)
    for r in range(10):
        m[r, 9 - r] = diag
        m[r, 10 - r:] = fill
    return m


def test_single_triangle_forward_sharp():
    args, tris = _single_triangle_scene()
    out = _port(_torch(args), tris, 1e-5, 1e-4, 0.01, 10).numpy()
    np.testing.assert_allclose(out[..., 0], _lower_right_matrix(1.0, 1.0),
                               atol=1e-5)
    np.testing.assert_allclose(out[..., 1:3], 0.0, atol=1e-6)
    np.testing.assert_allclose(out[..., 3], _lower_right_matrix(0.5, 1.0),
                               atol=1e-5)


def test_single_triangle_forward_blurred():
    args, tris = _single_triangle_scene()
    blur = 0.1 * np.sqrt(2.0) + 1e-6
    sigma = -blur ** 2 / np.log(1e-3 / (1 - 1e-3))
    out = _port(_torch(args), tris, float(sigma), 1e-4, float(blur),
                10).numpy()
    np.testing.assert_allclose(out[..., 1:3], 0.0, atol=1e-6)
    alpha = out[..., 3]
    for r in range(9):
        c = 9 - r
        np.testing.assert_allclose(alpha[r, c], 0.5, atol=1e-4)
        if c - 1 >= 0:
            np.testing.assert_allclose(alpha[r, c - 1], 1e-3, atol=1e-4)
        if c + 1 <= 9:
            assert alpha[r, c + 1] > 0.96
    np.testing.assert_allclose(alpha[0, :8], 0.0, atol=1e-6)


def test_matches_reference_oracle_rgba_and_silhouette():
    """tests/oracle/soft_two_triangle_16x16.npz, the reference kernel's
    render, for the full RGBA and for the silhouette entry's alpha."""
    args, tris = _two_triangle_scene(7, normal=(0.0, 0.0, 1.0),
                                     two_lights=False)
    with np.load(f"{ORACLE_DIR}/soft_two_triangle_16x16.npz") as data:
        want = data["image"]
    ours = _port(_torch(args), tris, 1e-4, 1e-3, 0.05).numpy()
    np.testing.assert_allclose(ours, want, atol=2e-4, rtol=1e-3)
    sil = soft.rasterize_silhouette_clip_space_batch(
        torch.from_numpy(args[0])[None], torch.from_numpy(tris), 16, 16,
        1e-4, blur_radius=0.05)[0].numpy()
    np.testing.assert_allclose(sil, want[..., 3], atol=2e-4, rtol=1e-3)


def test_optimize_single_triangle_translation():
    """Recover a 0.25-NDC x-translation by SGD (tests/test_soft_rasterize.py
    :171; torch's SGD(0.7, momentum=0.1) is optax.sgd(0.7, momentum=0.1))."""
    args, tris = _single_triangle_scene()
    _, _, normals, colors, lights, intens = _torch(args)
    clip = torch.tensor([[-0.5, 0.0, 0.25, 1.0], [0.5, 1.0, 0.25, 1.0],
                         [-0.5, 1.0, 0.25, 1.0]])
    world = torch.tensor([[-0.5, 0.0, 0.0], [0.5, 1.0, 0.0],
                          [-0.5, 1.0, 0.0]])
    target_tx, gamma = 0.25, 1e-1
    shift4, shift3 = torch.tensor([1.0, 0, 0, 0]), torch.tensor([1.0, 0, 0])

    def render(tx, sigma, blur):
        scene = (clip + tx * shift4, world + tx * shift3, normals, colors,
                 lights, intens)
        return _port(scene, tris, sigma, gamma, blur, 10)

    target = render(torch.tensor(target_tx), 1e-5, 0.01)
    sigma = -0.5 ** 2 / float(np.log(1e-5 / (1 - 1e-5)))
    tx = torch.zeros((), requires_grad=True)
    opt = torch.optim.SGD([tx], lr=0.7, momentum=0.1)
    for _ in range(50):
        opt.zero_grad()
        torch.mean(torch.abs(render(tx, sigma, 0.0) - target)).backward()
        opt.step()
    assert abs(float(tx.detach()) - target_tx) < 0.1


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_forward_matches_jax(backend):
    args, tris = _two_triangle_scene()
    want = np.asarray(_jax(backend, [jnp.asarray(a) for a in args], tris))
    got = _port(_torch(args), tris).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    assert want[..., 3].max() > 0.5  # the scene is covered


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_gradients_match_jax(backend):
    """All six input gradients plus sigma and gamma vs `jax.grad`."""
    args, tris = _two_triangle_scene()
    cot = np.random.RandomState(1).randn(SIZE, SIZE, 4).astype(np.float32)

    def loss(*a):
        return jnp.sum(_jax(backend, a[:6], tris, a[6], a[7]) * cot)

    want = jax.grad(loss, argnums=tuple(range(8)))(
        *[jnp.asarray(a) for a in args], jnp.float32(SIGMA),
        jnp.float32(GAMMA))
    inputs = _torch(args, grad=True) + [
        torch.tensor(v, requires_grad=True) for v in (SIGMA, GAMMA)]
    out = _port(inputs[:6], tris, inputs[6], inputs[7])
    (out * torch.from_numpy(cot)).sum().backward()
    for name, t, w in zip(NAMES, inputs, want):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-6)
        err = float(np.abs(t.grad.numpy() - w).max())
        assert err <= 1e-4 * scale, f"{name}: {err} vs scale {scale}"
    np.testing.assert_allclose(float(inputs[6].grad), float(want[6]),
                               rtol=1e-3)
    np.testing.assert_allclose(float(inputs[7].grad), float(want[7]),
                               rtol=1e-2)


def test_silhouette_alpha_and_gradients_match_full_render():
    """The silhouette entry's alpha is the full render's, bit for bit, and
    its clip and sigma gradients are `jax.grad` of the Pallas full alpha."""
    args, tris = _two_triangle_scene()
    clip, world, normals, colors, lights, intens = _torch(args)
    full = _port(_torch(args), tris)
    c = clip[None].clone().requires_grad_(True)
    s = torch.tensor(SIGMA, requires_grad=True)
    sil = soft.rasterize_silhouette_clip_space_batch(
        c, torch.from_numpy(tris), SIZE, SIZE, s, blur_radius=BLUR)
    assert torch.equal(sil[0], full[..., 3])
    (sil ** 2).sum().backward()

    def loss(cv, sigma):
        out = jpallas.soft_rasterize_pallas_batched(
            cv, tris, *[jnp.asarray(a)[None] for a in args[1:]], SIZE, SIZE,
            sigma, GAMMA, BLUR, interpret=True)
        return jnp.sum(out[..., 3] ** 2)

    gc, gs = jax.grad(loss, argnums=(0, 1))(jnp.asarray(args[0])[None],
                                            jnp.float32(SIGMA))
    gc = np.asarray(gc)
    scale = float(np.abs(gc).max())
    assert scale > 0.0
    assert float(np.abs(c.grad.numpy() - gc).max()) <= 1e-4 * scale
    np.testing.assert_allclose(float(s.grad), float(gs), rtol=1e-3)


def _random_scene(seed=0, batch=2, vertex_count=24, tri_count=30, width=48,
                  height=40):
    """tests/test_soft_pallas.py's multi-tile scene, built in numpy."""
    from pytorch_mesh_renderer_tpu_torch.ops import camera

    rng = np.random.RandomState(seed)
    world = (rng.randn(batch, vertex_count, 3) * 0.5).astype(np.float32)
    tris = rng.randint(0, vertex_count, (tri_count, 3)).astype(np.int32)
    normals = rng.randn(batch, vertex_count, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    colors = rng.uniform(0.2, 1.0, (batch, vertex_count, 3))
    lights = rng.randn(batch, 2, 3) * 2.0
    intens = rng.uniform(0.5, 1.5, (batch, 2))
    f32 = dict(dtype=torch.float32)
    cam = camera.clip_space_transforms(
        torch.tensor([[0.0, 0.0, 3.0]] * batch), torch.zeros(batch, 3),
        torch.tensor([[0.0, 1.0, 0.0]] * batch), torch.full((batch,), 40.0),
        torch.full((batch,), 0.01), torch.full((batch,), 10.0), width,
        height)
    world_t = torch.from_numpy(world)
    return (camera.transform_homogeneous(cam, world_t), world_t,
            torch.from_numpy(normals), torch.tensor(colors, **f32),
            torch.tensor(lights, **f32), torch.tensor(intens, **f32),
            torch.from_numpy(tris))


def test_row_strips_reassemble_and_empty_mesh_is_background():
    clip, world, normals, colors, lights, intens, tris = _random_scene()

    def render(triangles, height, row_offset):
        return soft.rasterize_clip_space_batch(
            clip, triangles, world, normals, colors, lights, intens, 48,
            height, SIGMA, GAMMA, blur_radius=BLUR, row_offset=row_offset,
            full_height=40)

    full = render(tris, 40, 0)
    assert float(full[..., 3].max()) > 0.5
    strips = torch.cat([render(tris, 20, 0), render(tris, 20, 20)], dim=1)
    assert torch.equal(strips, full)
    sil = torch.cat([soft.rasterize_silhouette_clip_space_batch(
        clip, tris, 48, 20, SIGMA, blur_radius=BLUR, row_offset=20 * i,
        full_height=40) for i in range(2)], dim=1)
    assert torch.equal(sil, full[..., 3])
    c = clip.clone().requires_grad_(True)
    empty = soft.rasterize_clip_space_batch(
        c, tris[:0], world, normals, colors, lights, intens, 48, 40, SIGMA,
        GAMMA, blur_radius=BLUR)
    assert torch.equal(empty, torch.zeros_like(empty))
    empty.sum().backward()
    assert torch.equal(c.grad, torch.zeros_like(c))


def test_table_gradient_matches_pallas_pack_layout():
    """The plain backward's table gradient: cols 18-25 and 56-58 take none,
    and it reaches the clip vertices as the JAX pack's VJP does."""
    args, tris = _two_triangle_scene()
    clip, world, normals, colors, lights, intens = _torch(args)
    table = sc.pack_triangle_data(clip[None], torch.from_numpy(tris),
                                  world[None], normals[None], colors[None],
                                  BLUR)
    want = np.asarray(jpallas._pack_triangle_data(
        *[jnp.asarray(a) for a in (args[0], tris, args[1], args[2],
                                   args[3])], BLUR))[:2]
    np.testing.assert_allclose(table[0].numpy(), want, rtol=1e-6, atol=1e-7)
    lights4 = torch.cat([lights, intens[:, None]], -1)[None]
    params = sc.make_params(SIGMA, GAMMA, BLUR, 0, "cpu")
    cot = torch.from_numpy(
        np.random.RandomState(2).randn(1, SIZE, SIZE, 4).astype(np.float32))
    dtable, dlights, dsigma, dgamma = sc.soft_backward_torch_packed(
        table, lights4, params[0], params[1], params[2], SIZE, SIZE, 0, SIZE,
        cot)
    assert dtable.shape == table.shape and dlights.shape == lights4.shape
    for cols in (slice(18, 26), slice(56, 59)):
        assert torch.equal(dtable[..., cols],
                           torch.zeros_like(dtable[..., cols]))
    assert float(dtable[..., 9:15].abs().max()) > 0.0


def test_config_and_argument_checks():
    args, tris = _two_triangle_scene()
    t = _torch(args)
    with pytest.raises(ValueError, match="backend='cuda'"):
        _port(t, tris, config=config_lib.SoftRasterizerConfig(
            backend="cuda"))
    with pytest.raises(TypeError, match="blur_radius"):
        _port(t, tris, blur=torch.tensor(BLUR))
    with pytest.raises(ValueError):
        config_lib.SoftRasterizerConfig(backend="pallas")
    with pytest.raises(ValueError):
        config_lib.SoftRasterizerConfig(triangle_chunk=0)
    forced = _port(t, tris, config=config_lib.SoftRasterizerConfig(
        backend="torch", triangle_chunk=1))
    torch.testing.assert_close(forced, _port(t, tris), atol=1e-6, rtol=1e-5)


def _numpy_pixel_centers(width, height, row_offset, full_height):
    """The kernels' pixel centres: float32 IEEE operations, in order."""
    f = np.float32
    cols = np.arange(width, dtype=f)
    rows = np.arange(height, dtype=f) + f(row_offset)
    return (f(2.0) * (cols + f(0.5)) / f(width) - f(1.0),
            f(-2.0) * (rows + f(0.5)) / f(full_height) + f(1.0))


@pytest.mark.parametrize("width,height,row_offset,full_height", [
    (128, 128, 0, 128), (100, 100, 0, 100), (45, 31, 0, 31),
    (640, 17, 231, 480), (333, 7, 5, 29)])
def test_pixel_centers_are_the_kernels_bit_for_bit(width, height, row_offset,
                                                   full_height):
    """The plain version's pixel centres, computed on the device (so that
    a captured step can render through it), equal the float32 IEEE
    quotients the kernels compute."""
    px, py = sc.pixel_centers(width, height, row_offset, full_height, "cpu")
    want_x, want_y = _numpy_pixel_centers(width, height, row_offset,
                                          full_height)
    assert px.dtype == py.dtype == torch.float32
    np.testing.assert_array_equal(px.numpy(), want_x)
    np.testing.assert_array_equal(py.numpy(), want_y)
