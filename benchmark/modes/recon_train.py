"""Single-view mesh reconstruction training (SoftRas's `examples/recon`):
one captured `parallel.make_train_step` call a step of the port's
`examples/recon.Reconstruction`, each on a fresh batch that the port's
`Loader` draws from a data set in pinned host memory, with no sync
between steps.

The set-up renders the data set from the seed (`recon_scene.py`), builds
the network from the configuration's starting weights (drawn from its own
`weights.seed`, the same in every run: the start decides whether the
meshes grow over the window, and with them the renderer's work a step),
takes the first three steps on the loader's first three batches (the
first captures the step) and reads them, runs the warm-up steps, then
sets the weights, BatchNorm's statistics, Adam's state and the loader's
generator back to the start, once: every window trains the first steps
of a run from the same weights on the seed's batches, which the traced
steps continue. The reference (`reference/recon.py`) follows the three
steps on the same batches, drawn again by the loader's rule (see
`Cell.numbers`).

`train_images_per_s` counts the rendered silhouettes, 4 a batch object.
"""

from __future__ import annotations

import time

import torch

from .. import compare, program, recon_scene
from ..reference import recon as ref

KIND = "train"
FAULTS = ("state_unchanged", "half_batch", "altered")


def _norm(tensors):
    return float(torch.sqrt(sum((t.double() ** 2).sum() for t in tensors)))


def relative_gap(program_tensors, reference_tensors):
    """|program - reference| / |reference| over a list of tensors taken as
    one vector; inf where a shape differs or a value is not finite."""
    diffs = []
    for p, r in zip(program_tensors, reference_tensors):
        if p is None or tuple(p.shape) != tuple(r.shape):
            return compare.INF
        diffs.append(p.double() - r.double())
    gap = _norm(diffs) / max(_norm(reference_tensors), 1e-30)
    return gap if gap == gap else compare.INF


class Cell:
    def __init__(self, env):
        # A program without the module fails here, before the set-up.
        from pytorch_mesh_renderer_tpu_torch.examples import recon
        self.recon = recon
        self.env = env
        ref.strict_float32()
        cfg = env.config
        self.net_cfg, self.loss_cfg = cfg["network"], cfg["loss"]
        self.objects = env.traffic["objects"]
        self.views_per_step = 4 * self.objects
        self.steps_per_unit = 1
        sc = env.scene
        self.template, self.faces = recon_scene.icosphere(
            sc["template"]["subdivisions"])
        self.template = self.template.to(env.device)
        self.faces = self.faces.to(env.device)
        images = recon_scene.render_dataset(cfg, env.seed, env.device)
        self.eyes = recon_scene.viewpoints(sc, env.device)
        pinned = env.device.type == "cuda"
        self.images = torch.empty(images.shape, dtype=torch.uint8,
                                  pin_memory=pinned)
        self.images.copy_(images)
        del images
        self.start = recon_scene.weights(
            self.net_cfg, self.template.shape[0], env.size,
            cfg["weights"]["seed"], env.device)
        self.batches = [recon_scene.gather_batch(
            self.images, self.eyes, ids, views, env.device)
            for ids, views in recon_scene.draws(
                self.images.shape[0], self.eyes.shape[0], self.objects,
                env.seed, 3)]
        self.want = None
        self.trace_state = []

    def _check_settings(self):
        """The configuration's renderer, loss and optimizer settings are
        the program's (`examples/recon.py`'s constants)."""
        recon, sc = self.recon, self.env.scene
        opt = self.env.config["optimizer"]
        pairs = {"sigma": (sc["sigma"], recon.SIGMA),
                 "blur_radius": (sc["blur_radius"], recon.BLUR_RADIUS),
                 "fov_y": (sc["fov_y"], recon.FOV_Y),
                 "near_clip": (sc["near_clip"], recon.NEAR_CLIP),
                 "far_clip": (sc["far_clip"], recon.FAR_CLIP),
                 "laplacian": (self.loss_cfg["laplacian"],
                               recon.LAMBDA_LAPLACIAN),
                 "flatten": (self.loss_cfg["flatten"], recon.LAMBDA_FLATTEN),
                 "lr": (opt["lr"], recon.LEARNING_RATE),
                 "betas": (tuple(opt["betas"]), tuple(recon.ADAM_BETAS)),
                 "eps": (opt["eps"], recon.ADAM_EPS)}
        differ = {k: v for k, v in pairs.items() if v[0] != v[1]}
        if differ:
            raise ValueError("the configuration's settings differ from the "
                             f"program's (config, program): {differ}")

    def build(self):
        recon = self.recon
        enc, dec = self.net_cfg["encoder"], self.net_cfg["decoder"]
        self._check_settings()
        self.model = recon.ReconstructionNet(
            (self.template, self.faces.to(torch.int32)),
            image_size=self.env.size, dim1=enc["dim1"], dim2=enc["dim2"],
            dim_features=enc["dim_out"],
            dim_hidden=tuple(dec["dim_hidden"])).to(self.env.device)
        missing, unexpected = self.model.load_state_dict(self.start,
                                                         strict=False)
        named = dict(self.model.named_parameters())
        if unexpected or any(k in named for k in missing):
            raise KeyError(f"weights not in the model: {unexpected}; "
                           f"parameters without weights: {missing}")
        self.initial = {k: v.detach().clone()
                        for k, v in self.model.state_dict().items()}
        self.trainer = recon.Reconstruction(self.model)
        self.loader = recon.Loader(self.images, self.eyes.cpu(),
                                   self.objects, self.env.seed,
                                   self.env.device)
        self.loader_start = self.loader.generator.get_state()

    def _params(self):
        return {k: v.detach() for k, v in self.model.named_parameters()}

    def restart(self):
        """The weights, BatchNorm's statistics, Adam's state and the
        loader's generator set back to the seed's start, in place."""
        with torch.no_grad():
            for k, v in self.model.state_dict().items():
                v.copy_(self.initial[k])
            for state in self.trainer.optimizer.state.values():
                for value in state.values():
                    if torch.is_tensor(value):
                        value.zero_()
        self.loader.generator.set_state(self.loader_start)

    def warm(self):
        """Set-up: the first three steps on the loader's batches (the
        first captures the step), read as the program's readings: each
        step's loss and the parameters after it, the first gradient from
        Adam's first moment, the silhouettes of the third step; then the
        warm-up steps and a restart."""
        beta1 = self.env.config["optimizer"]["betas"][0]
        losses, params, grad = [], [], None
        for k in range(3):
            losses.append(self.trainer(self.loader()))
            if k == 0:
                state = self.trainer.optimizer.state
                grad = {n: torch.zeros_like(p) if "exp_avg" not in state[p]
                        else (state[p]["exp_avg"] / (1.0 - beta1)).clone()
                        for n, p in self.model.named_parameters()}
            params.append({k2: v.clone() for k2, v in self._params().items()})
        self.readings = {"losses": [float(x) for x in losses], "grad": grad,
                         "params": params,
                         "images": self.trainer.silhouettes.detach().clone()}
        for _ in range(self.env.traffic["warmup_calls"]):
            self.trainer(self.loader())
        self.restart()
        self.env.sync()

    def window(self, seconds):
        """Steps back to back for `seconds`, each on a fresh batch, the
        training run going on from where it stands, then a wait for the
        card.
        `failed` counts the window's steps where the last loss or the
        parameters are not finite."""
        counts = program.counters()
        host, n = 0.0, 0
        self.env.sync()
        t0 = time.perf_counter()
        end = t0 + seconds
        while True:
            a = time.perf_counter()
            loss = self.trainer(self.loader())
            b = time.perf_counter()
            host += b - a
            n += 1
            if b >= end:
                break
        self.env.sync()
        elapsed = time.perf_counter() - t0
        finite = bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(p).all()) for p in self._params().values())
        return {"units": n, "steps": n, "seconds": elapsed,
                "failed": 0 if finite else n, "host_s": host,
                "counters_at_start": counts,
                "metrics": {"train_images_per_s":
                            n * self.views_per_step / elapsed}}

    def traced(self, count, span):
        """`count` more steps of the training run (those that follow the
        window); the parameters and batch of the first and last are kept
        for the roofline's counts."""
        self.env.sync()
        self.trace_state = []
        for k in range(count):
            with span("bench.step"):
                batch = self.loader()
                if k in (0, count - 1):
                    self.trace_state.append(
                        ({n: v.clone() for n, v in self._params().items()},
                         {n: v.clone() for n, v in batch.items()}))
                self.trainer(batch)
        self.env.sync()
        return count

    def finish(self):
        del self.trainer, self.loader, self.model

    def _step(self, params, batch, grad=True, tf32=False, counts=None):
        return ref.step(params, batch, self.template, self.faces,
                        self.env.config, grad=grad, tf32=tf32,
                        counts=counts)

    def reference(self, tf32=False, fault=None):
        """The reference put in the program's place: its readings over the
        first three steps, as the program's. `half_batch` leaves out the
        second half of the objects; `altered` changes one silhouette
        pixel; `state_unchanged` takes no step."""
        opt = self.env.config["optimizer"]
        adam = ref.Adam(opt["lr"], opt["betas"], opt["eps"])
        x = dict(self.start)
        losses, params, grad, images = [], [], None, None
        for batch in self.batches:
            if fault == "half_batch":
                n = batch["eyes"].shape[0] // 2
                keep = torch.cat([torch.arange(n // 2),
                                  n + torch.arange(n // 2)]).to(
                    batch["eyes"].device)
                batch = {k: v[keep] for k, v in batch.items()}
            loss, g, alpha = self._step(x, batch, tf32=tf32)
            losses.append(loss)
            grad = g if grad is None else grad
            images = alpha
            if fault != "state_unchanged":
                x = adam.step(x, g)
            params.append(x)
        if fault == "state_unchanged":
            grad = {k: torch.zeros_like(v) for k, v in grad.items()}
        if fault == "altered":
            images = images.clone()
            images[0, self.env.size // 2, self.env.size // 2] += 1.0
        return {"losses": losses, "grad": grad, "params": params,
                "images": images}

    def numbers(self, got):
        """The numbers of the check. The reference follows the program's
        own state for what each step renders and loses: the loss of step k
        and the silhouettes of step 3 are the reference's at the
        parameters the program held before that step, on the same batch.
        The first gradient (at the seed's start) and the parameters'
        change after three steps are held to the reference's own
        trajectory, each as one vector over every parameter but the
        convolutions' biases ahead of BatchNorm, whose gradient is 0 in
        exact arithmetic (BatchNorm takes the batch's mean out) and
        round-off in float32. Their first gradients' norms, over that of
        the reference's whole first gradient, come out beside the checked
        numbers in `calibrate.py`'s readings (`conv_bias_grad_norm`,
        `conv_bias_grad_norm_reference`); no limit holds them."""
        if self.want is None:
            self.want = self.reference()
        want = self.want
        follow = [want["losses"][0]]
        images = None
        for params, batch in zip(got["params"][:2], self.batches[1:]):
            loss, _, alpha = self._step(params, batch, grad=False)
            follow.append(loss)
            images = alpha
        mean_gap, max_gap = compare.image_gaps(got["images"], images)
        names = [k for k in self.start if k not in ref.CONV_BIASES]
        whole = max(_norm(want["grad"].values()), 1e-30)

        def change(params):
            return [params[-1][k] - self.start[k] for k in names]

        return {
            "loss_gap": max(compare.relative_gap(a, b) for a, b in
                            zip(got["losses"], follow)),
            "grad_gap": relative_gap([got["grad"][k] for k in names],
                                     [want["grad"][k] for k in names]),
            "change_gap": relative_gap(change(got["params"]),
                                       change(want["params"])),
            "image_mean_gap": mean_gap,
            "image_max_gap": max_gap,
            "conv_bias_grad_norm": _norm(
                [got["grad"][k] for k in ref.CONV_BIASES]) / whole,
            "conv_bias_grad_norm_reference": _norm(
                [want["grad"][k] for k in ref.CONV_BIASES]) / whole,
            "loss_gap_own_trajectory": max(
                compare.relative_gap(a, b) for a, b in
                zip(got["losses"], want["losses"])),
        }

    def work_inputs(self):
        """(shapes, counts of a step, 1) for the soft roofline: the
        reference's pair counts over the 4n distinct meshes of the first
        and of the last traced step, the smaller of the two."""
        per = []
        for params, batch in self.trace_state:
            counts = {}
            with torch.no_grad():
                self._step(params, batch, grad=False, counts=counts)
            per.append(counts)
        if not per:
            return None
        counts = {k: min(c[k] for c in per) for k in per[0]}
        size = self.env.size
        shape = dict(B=self.views_per_step, V=self.template.shape[0],
                     T=self.faces.shape[0], H=size, W=size, A=0, L=0)
        return shape, counts, 1
