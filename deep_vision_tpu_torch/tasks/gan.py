"""GAN tasks for the adversarial trainer (``core/adversarial.py``).

Port of ``deep_vision_tpu/tasks/gan.py`` (``ImagePool``, ``DCGANTask``,
``CycleGANTask``):

- ``DCGANTask``: the simultaneous G/D step with BCE from logits.  Both
  gradients come from the current parameters: G's through
  ``torch.autograd.grad`` over G's parameters only, D's on
  ``fake.detach()``.  Its randomness, the latent ``z`` and the three
  dropout draws of the discriminator (on the fake for G's loss, on the
  real and on the fake for D's), goes through :meth:`DCGANTask.draw`, so
  a caller may feed any draws, the reference's included.
- ``CycleGANTask``: one gradient over both generators (LSGAN loss, L1
  cycle λ=10 and identity λ=5), then one over both discriminators fed
  the 50-image ``ImagePool``'s replays, a host-side numpy buffer applied
  between steps (``host_prepare``/``host_update``).

Every reference forward starts from the step's old BatchNorm running
statistics and each network keeps the update of exactly one of them, so
here exactly that forward updates them (``stats_updates``) and every
other training forward normalizes by its batch and updates nothing:

    gen_a2b  its call on fake_b2a (the reconstruction of real_b)
    gen_b2a  its call on real_b
    disc_a   its call on real_a in the discriminator step
    disc_b   its call on real_b in the discriminator step

A task's ``train_step`` returns each network's gradients, the host
outputs and the metrics (0-d device tensors); the trainer applies the
gradients under one joint guard.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from deep_vision_tpu_torch.core.optim import OptimizerConfig
from deep_vision_tpu_torch.models.common import BatchNorm2d


def bce_logits(logits: torch.Tensor, target_ones: bool) -> torch.Tensor:
    """optax ``sigmoid_binary_cross_entropy`` against all-ones or
    all-zeros labels, averaged."""
    return -(F.logsigmoid(logits) if target_ones
             else F.logsigmoid(-logits)).mean()


def mse(pred: torch.Tensor, target_ones: bool) -> torch.Tensor:
    return torch.square(pred - 1.0).mean() if target_ones \
        else torch.square(pred).mean()


@contextlib.contextmanager
def stats_updates(model: torch.nn.Module, update: bool):
    """Within the block, training forwards of ``model`` update their
    BatchNorm running statistics only if ``update``."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.update_stats = update
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True


def _call(model, x, update: bool):
    with stats_updates(model, update):
        return model(x)


def _grads(loss: torch.Tensor, models) -> list[list[torch.Tensor]]:
    """d loss / d every parameter of each of ``models`` (zeros where a
    parameter does not reach the loss), nothing accumulated in
    ``.grad``."""
    params = [list(m.parameters()) for m in models]
    flat = [p for ps in params for p in ps]
    got = torch.autograd.grad(loss, flat, allow_unused=True)
    got = [torch.zeros_like(p) if g is None else g
           for p, g in zip(flat, got)]
    out, i = [], 0
    for ps in params:
        out.append(got[i:i + len(ps)])
        i += len(ps)
    return out


class ImagePool:
    """50-image replay buffer: each fake is stored; once full, with p 0.5
    an older stored fake is returned (and replaced) instead.  Host-side
    numpy with the reference's ``default_rng(seed)`` and draw order, so
    the replay sequence is the reference's."""

    def __init__(self, pool_size: int = 50, seed: int = 0):
        self.pool_size = pool_size
        self.pool: list[np.ndarray] = []
        self.rng = np.random.default_rng(seed)

    def query(self, images: np.ndarray) -> np.ndarray:
        if self.pool_size == 0:
            return images
        out = []
        for img in np.asarray(images):
            if len(self.pool) < self.pool_size:
                self.pool.append(img)
                out.append(img)
            elif self.rng.random() > 0.5:
                i = int(self.rng.integers(0, self.pool_size))
                out.append(self.pool[i])
                self.pool[i] = img
            else:
                out.append(img)
        return np.stack(out)


class DCGANTask:
    """Networks ``generator`` (latent → image) and ``discriminator``
    (image → logit)."""

    #: host_prepare is stateless: batches may be staged ahead
    prefetch_safe = True
    #: no host state between steps: scan_steps may group them
    scan_safe = True

    def __init__(self, make_generator, make_discriminator,
                 latent_dim: int = 100, opt: OptimizerConfig | None = None):
        self.make_generator = make_generator
        self.make_discriminator = make_discriminator
        self.latent_dim = latent_dim
        # the reference: Adam(1e-4) for both
        self.opt = opt or OptimizerConfig(name="adam", learning_rate=1e-4)

    def init_models(self, generator: torch.Generator) -> dict:
        """The two networks at flax's default init, G then D."""
        return {"generator": self.make_generator().reset_parameters(
                    generator),
                "discriminator": self.make_discriminator().reset_parameters(
                    generator)}

    def host_prepare(self, batch: dict) -> dict:
        return batch

    def host_update(self, outputs: dict) -> None:
        pass

    def draw(self, batch_size: int, generator: torch.Generator,
             device) -> dict:
        """One step's draws: ``z`` (B, latent_dim) standard normal and
        the keep masks (NHWC bools, keep probability 0.7) of the three
        discriminator forwards, ``drop_g``, ``drop_real``, ``drop_fake``,
        two each."""
        from deep_vision_tpu_torch.models.gan import DCGANDiscriminator

        keep = 1.0 - DCGANDiscriminator.DROPOUT
        z = torch.randn((batch_size, self.latent_dim), generator=generator,
                        device=device)
        out = {"z": z}
        for name in ("drop_g", "drop_real", "drop_fake"):
            out[name] = [torch.rand((batch_size, *s), generator=generator,
                                    device=device) < keep
                         for s in DCGANDiscriminator.MASK_SHAPES]
        return out

    def train_step(self, states: dict, batch: dict, draws: dict):
        """(grads by network, host outputs, metrics)."""
        g = states["generator"].model
        d = states["discriminator"].model
        real = batch["image"]
        fake = g(draws["z"])
        g_loss = bce_logits(d(fake, masks=draws["drop_g"]), True)
        (g_grads,) = _grads(g_loss, [g])
        fake = fake.detach()
        d_loss = bce_logits(d(real, masks=draws["drop_real"]), True) + \
            bce_logits(d(fake, masks=draws["drop_fake"]), False)
        (d_grads,) = _grads(d_loss, [d])
        return ({"generator": g_grads, "discriminator": d_grads}, {},
                {"g_loss": g_loss.detach(), "d_loss": d_loss.detach()})

    @torch.no_grad()
    def sample(self, states: dict, n: int,
               generator: torch.Generator) -> np.ndarray:
        """``n`` images (N, 28, 28, 1) in [-1, 1] from standard-normal
        latents drawn from ``generator``."""
        g = states["generator"].model.eval()
        z = torch.randn((n, self.latent_dim), generator=generator,
                        device=generator.device)
        return g(z).cpu().numpy()


class CycleGANTask:
    """Networks ``gen_a2b``, ``gen_b2a``, ``disc_a``, ``disc_b``."""

    #: host_prepare reads the pool the previous step filled: no staging,
    #: and every step is dispatched on its own
    prefetch_safe = False
    scan_safe = False
    names = ("gen_a2b", "gen_b2a", "disc_a", "disc_b")
    LAMBDA_CYCLE = 10.0
    LAMBDA_ID = 5.0

    def __init__(self, make_generator, make_discriminator,
                 opt: OptimizerConfig | None = None, pool_size: int = 50):
        self.make_generator = make_generator
        self.make_discriminator = make_discriminator
        # the reference: Adam(2e-4, b1 0.5) for both pairs
        self.opt = opt or OptimizerConfig(name="adam", learning_rate=2e-4,
                                          b1=0.5)
        self.pool_a2b = ImagePool(pool_size)
        self.pool_b2a = ImagePool(pool_size, seed=1)
        self._pending_fakes = None

    def init_models(self, generator: torch.Generator) -> dict:
        """The four networks at flax's default init, in ``names`` order."""
        make = {"gen_a2b": self.make_generator,
                "gen_b2a": self.make_generator,
                "disc_a": self.make_discriminator,
                "disc_b": self.make_discriminator}
        return {k: make[k]().reset_parameters(generator) for k in self.names}

    def host_prepare(self, batch: dict) -> dict:
        """Add the pooled fakes of the PREVIOUS step (``pool_valid`` 0 on
        the first, when the step falls back to its own fakes)."""
        batch = dict(batch)
        if self._pending_fakes is not None:
            fake_a2b, fake_b2a = self._pending_fakes
            batch["pool_a2b"] = self.pool_a2b.query(fake_a2b)
            batch["pool_b2a"] = self.pool_b2a.query(fake_b2a)
            batch["pool_valid"] = np.ones((), np.float32)
        else:
            shape = (len(batch["image_b"]), *batch["image_b"].shape[1:])
            batch["pool_a2b"] = np.zeros(shape, np.float32)
            batch["pool_b2a"] = np.zeros(shape, np.float32)
            batch["pool_valid"] = np.zeros((), np.float32)
        return batch

    def host_update(self, outputs: dict) -> None:
        self._pending_fakes = (outputs["fake_a2b"].cpu().numpy(),
                               outputs["fake_b2a"].cpu().numpy())

    def train_step(self, states: dict, batch: dict, draws=None):
        """(grads by network, host outputs, metrics)."""
        real_a, real_b = batch["image_a"], batch["image_b"]
        g_ab, g_ba = states["gen_a2b"].model, states["gen_b2a"].model
        d_a, d_b = states["disc_a"].model, states["disc_b"].model

        # generator step: one gradient over both generators
        fake_a2b = _call(g_ab, real_a, False)
        recon_a = _call(g_ba, fake_a2b, False)
        fake_b2a = _call(g_ba, real_b, True)
        recon_b = _call(g_ab, fake_b2a, True)
        ident_b = _call(g_ab, real_b, False)
        ident_a = _call(g_ba, real_a, False)
        logit_fake_b = _call(d_b, fake_a2b, False)
        logit_fake_a = _call(d_a, fake_b2a, False)
        gan = mse(logit_fake_b, True) + mse(logit_fake_a, True)
        cycle = (recon_a - real_a).abs().mean() + \
            (recon_b - real_b).abs().mean()
        ident = (ident_b - real_b).abs().mean() + \
            (ident_a - real_a).abs().mean()
        g_loss = gan + self.LAMBDA_CYCLE * cycle + self.LAMBDA_ID * ident
        g_grads = _grads(g_loss, [g_ab, g_ba])

        # discriminator step on pooled fakes; on the first step (empty
        # pool) this step's own
        fake_a2b, fake_b2a = fake_a2b.detach(), fake_b2a.detach()
        use_pool = batch["pool_valid"] > 0
        pool_a2b = torch.where(use_pool, batch["pool_a2b"], fake_a2b)
        pool_b2a = torch.where(use_pool, batch["pool_b2a"], fake_b2a)
        loss_a = (mse(_call(d_a, real_a, True), True)
                  + mse(_call(d_a, pool_b2a, False), False)) / 2
        loss_b = (mse(_call(d_b, real_b, True), True)
                  + mse(_call(d_b, pool_a2b, False), False)) / 2
        d_loss = loss_a + loss_b
        d_grads = _grads(d_loss, [d_a, d_b])
        grads = dict(zip(self.names, g_grads + d_grads))
        metrics = {"g_loss": g_loss, "d_loss": d_loss, "gen_gan": gan,
                   "cycle": cycle, "ident": ident, "disc_a": loss_a,
                   "disc_b": loss_b}
        return (grads, {"fake_a2b": fake_a2b, "fake_b2a": fake_b2a},
                {k: v.detach() for k, v in metrics.items()})

    @torch.no_grad()
    def translate(self, states: dict, images,
                  direction: str = "a2b") -> np.ndarray:
        """NHWC [-1, 1] images of one domain → the other's."""
        g = states["gen_a2b" if direction == "a2b" else "gen_b2a"].model
        g.eval()
        p = next(g.parameters())
        x = torch.as_tensor(np.asarray(images, np.float32)).to(p.device)
        return g(x).cpu().numpy()
