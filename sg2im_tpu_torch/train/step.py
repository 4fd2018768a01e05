"""The GAN train step: generator, both discriminators and three gated Adam
updates (counterpart of ``sg2im_tpu/train/step.py``, upstream
``scripts/train.py:502-592``).

One step, in order:

0. the state's threefry key splits into the next step's key and the key
   of this step's layout noise (``jax.random.split``, on every step, as
   the JAX step does; one launch of the split kernel on the card), and
   the noise is ``jax.random.normal(noise_key,
   (N_global, H, W, D))`` at the images' dtype, drawn on the device by the
   threefry kernel (``ops/prng_kernel.py``); a data-parallel rank draws
   only its own rows, by offset;
1. G forward in train mode (eval mode after ``eval_mode_after``) from the
   ground-truth boxes and masks, so the layout compose runs on the
   ground truth (the Hopper kernel for CUDA tensors);
2. the L1, bbox-MSE, optional predicate-CE and mask-BCE losses, then D_obj
   and D_img score the fakes (the AC loss and the GAN G-losses); those
   discriminator passes run in train mode and move the D BatchNorm stats;
3. G's gradients with ``torch.autograd.grad`` on G's parameters only, and
   the NaN guard: ``good`` = the total is finite and so is every
   gradient;
4. Adam on G gated by ``good`` (:class:`SkippableAdam`);
5. D_obj on the detached pre-update fakes, then on the real images, Adam
   gated by its own ``d_good`` = ``good`` and its gradients finite, then
   the optional ``d_clip``;
6. D_img the same way.

The D BatchNorm statistics move G-pass, fake, real, in that order.  The
G-pass update merges only when ``good``; the D-step updates stay only when
``d_good``; on a skipped step G's statistics revert too, so a skipped step
changes nothing but ``step``.  The modules write their BatchNorm buffers
during the forward (eager), so every pass runs on copies of the buffers
and the step selects between old and new with ``torch.where`` on the
device: ``good`` stays a device tensor, and the step never waits on the
card.

The modules are templates run with ``torch.func.functional_call`` on the
tensors of a :class:`TrainState`; a step returns a new state and never
writes into the one it was given.

``train_step.phase_fns`` holds one probe per section of the step (G
forward, G forward and backward, each discriminator's step) for
``Trainer.step_breakdown``; the probes change no state.

``train_step.marker``, None by default, may be set to a callable: the
step then calls it with the name of each phase as the phase's work has
been issued (``g_forward``, ``g_backward``, ``g_optimizer`` and
``<d>_forward``, ``<d>_backward``, ``<d>_optimizer`` for each
discriminator), so that a profiler can put an event on the stream there.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.func import functional_call

from sg2im_tpu_torch import losses as L
from sg2im_tpu_torch.ops.prng_kernel import threefry_normal, threefry_split
from sg2im_tpu_torch.parallel import collectives
from sg2im_tpu_torch.train.state import AdamState, TrainState


def all_finite(tensors) -> torch.Tensor:
    """Device bool: every element of every tensor is finite.  Each tensor
    times 0 is 0 where finite and NaN elsewhere, and its sum of magnitudes
    is NaN exactly when one element is: two fused multi-tensor kernels,
    and no overflow of large finite values."""
    tensors = list(tensors)
    if not tensors:
        return torch.ones((), dtype=torch.bool)
    sums = torch._foreach_norm(torch._foreach_mul(tensors, 0.0), 1)
    return torch.isfinite(torch.stack(sums)).all()


class SkippableAdam:
    """Adam whose whole update (moments, count and the step) is gated by a
    device bool, with optax's ``adam`` operation order (``b1 * m + (1 - b1)
    * g``; ``-lr * ((m / c1) / (sqrt(v / c2) + eps))`` with ``c = 1 -
    b ** count``), which differs from ``torch.optim.Adam``'s in round-off.
    When ``good`` is false the moments and count keep their values and the
    update is 0, so the parameters stay bit-identical; ``torch.where``, not
    a product with 0, so that a non-finite gradient cannot leak in."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-8):
        self.lr = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: dict) -> AdamState:
        device = next(iter(params.values())).device if params else None
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()})

    def update(self, grads: dict, state: AdamState, good=None):
        """-> (updates, new state); apply with :func:`apply_updates`.  The
        arithmetic runs as multi-tensor (``_foreach``) kernels over every
        parameter at once, each element rounded as optax rounds it; the
        gate is one ``torch.where`` per tensor and moment."""
        if good is None:
            good = torch.ones((), dtype=torch.bool,
                              device=state.count.device)
        names = list(grads)
        g = [grads[k] for k in names]
        m = [state.mu[k] for k in names]
        v = [state.nu[k] for k in names]
        count = state.count + good.to(state.count.dtype)
        cf = count.to(torch.float32)
        c1 = 1.0 - torch.pow(self.b1, cf)
        c2 = 1.0 - torch.pow(self.b2, cf)
        m_new = torch._foreach_add(torch._foreach_mul(m, self.b1),
                                   torch._foreach_mul(g, 1.0 - self.b1))
        v_new = torch._foreach_add(
            torch._foreach_mul(v, self.b2),
            torch._foreach_mul(torch._foreach_mul(g, 1.0 - self.b2), g))
        m_new = [torch.where(good, a, b) for a, b in zip(m_new, m)]
        v_new = [torch.where(good, a, b) for a, b in zip(v_new, v)]
        den = torch._foreach_add(torch._foreach_sqrt(
            torch._foreach_div(v_new, c2)), self.eps)
        u = torch._foreach_mul(torch._foreach_div(
            torch._foreach_div(m_new, c1), den), -self.lr)
        zero = torch.zeros((), dtype=u[0].dtype, device=u[0].device) \
            if u else None
        updates = {k: torch.where(good, a, zero) for k, a in zip(names, u)}
        return updates, AdamState(count=count, mu=dict(zip(names, m_new)),
                                  nu=dict(zip(names, v_new)))


def global_norm(tensors: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax's
    ``global_norm``)."""
    norms = torch._foreach_norm(list(tensors.values()), 2)
    return torch.linalg.vector_norm(torch.stack(norms))


def apply_updates(params: dict, updates: dict) -> dict:
    names = list(params)
    return dict(zip(names, torch._foreach_add(
        [params[k] for k in names], [updates[k] for k in names])))


def make_optimizers(config) -> dict:
    """Three independent Adams (upstream ``train.py:426-444``; torch's
    defaults: betas (0.9, 0.999), eps 1e-8)."""
    return {name: SkippableAdam(config.learning_rate)
            for name in ("g", "d_obj", "d_img")}


def model_losses(config, batch, imgs_pred, boxes_pred, masks_pred,
                 rel_scores) -> dict:
    """The generator's own weighted losses (upstream
    ``calculate_model_losses``, ``train.py:387-412``): L1 pixel, bbox MSE
    over real objects, and when weighted the predicate cross-entropy and
    the mask BCE."""
    losses = {
        "L1_pixel_loss": (L.l1_loss(imgs_pred, batch["imgs"])
                          * config.l1_pixel_loss_weight),
        "bbox_pred": (L.mse_loss(boxes_pred, batch["boxes"],
                                 batch["obj_mask"])
                      * config.bbox_pred_loss_weight)}
    if config.predicate_pred_loss_weight > 0:
        losses["predicate_pred"] = L.cross_entropy(
            rel_scores, batch["triples"][..., 1],
            batch["triple_mask"]) * config.predicate_pred_loss_weight
    if (config.mask_loss_weight > 0 and batch.get("masks") is not None
            and masks_pred is not None):
        losses["mask_loss"] = L.binary_cross_entropy(
            masks_pred, batch["masks"],
            batch["obj_mask"]) * config.mask_loss_weight
    return losses


class _Template:
    """A module's parameter and buffer names, to split a state dict for
    ``functional_call``."""

    def __init__(self, module):
        self.module = module
        self.params = [n for n, _ in module.named_parameters()]
        self.buffers = [n for n, _ in module.named_buffers()]

    def split(self, sd):
        return ({n: sd[n] for n in self.params},
                {n: sd[n] for n in self.buffers})

    def __call__(self, params, buffers, *args, **kwargs):
        return functional_call(self.module, (params, buffers), args, kwargs,
                               strict=True)


def _where(good, new: dict, old: dict) -> dict:
    return {k: torch.where(good, new[k], old[k]) for k in old}


def _copies(buffers: dict) -> dict:
    """Buffers for a forward to write into, leaving ``buffers`` as they
    are."""
    return {k: v.clone() for k, v in buffers.items()}


def _leaves(params: dict) -> dict:
    return {k: p.detach().requires_grad_(True) for k, p in params.items()}


def _grads(total, leaves: dict) -> dict:
    """d total / d leaves; a parameter outside the loss gets zeros (its
    Adam count and moments still advance, as the JAX step's do)."""
    gs = torch.autograd.grad(total, list(leaves.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(leaves.items(), gs)}


def _reduce(pg, grads: dict, losses: dict):
    """(grads, losses) summed across the ranks of ``pg`` in one all-reduce
    of their concatenation: the gradients of the global loss, and the
    global losses, the same on every rank.  Without a group, the inputs
    as they are."""
    if pg is None:
        return grads, losses
    names, lnames = list(grads), list(losses)
    out = collectives.sum_flat([grads[k] for k in names]
                               + [losses[k] for k in lnames], pg)
    return (dict(zip(names, out[:len(names)])),
            dict(zip(lnames, out[len(names):])))


def make_train_step(generator, d_obj, d_img, config, optimizers=None,
                    group=None):
    """The train step of ``config`` over the port's modules (discriminators
    may be None).

    ``group``: a ``torch.distributed`` process group, for one rank of a
    data-parallel step; ``batch`` (and ``noise``) then hold this rank's
    rows of the global batch, every rank holding as many.  The step
    computes what the one-process step computes on the global batch
    (``sg2im_tpu/parallel/mesh.py``'s GSPMD semantics): BatchNorm
    statistics and loss means over the global batch, the layout noise of
    the global batch drawn from the replicated key (this rank draws its
    own rows by offset), each model's gradients and losses summed across
    the ranks by one all-reduce before the NaN guard, so that every rank takes
    the same branch and applies the same update.

    Returns ``train_step(state, batch, eval_mode=False, noise=None) ->
    (new state, metrics)``.  ``batch`` holds tensors on the modules'
    device: imgs (N, 3, H, W), objs (N, O), boxes (N, O, 4), masks (N, O,
    M, M) or absent, triples (N, T, 3), obj_mask (N, O), triple_mask (N,
    T).  ``noise`` (N, layout_noise_dim, H, W) is the layout noise; when
    None it is drawn from the step's noise key.  The key advances either
    way.  The metrics are 0-dim device tensors.
    """
    opts = optimizers or make_optimizers(config)
    gan_g_loss, gan_d_loss = L.get_gan_losses(config.gan_loss_type)
    G = _Template(generator)
    DO = _Template(d_obj) if d_obj is not None else None
    DI = _Template(d_img) if d_img is not None else None
    d_clip = config.d_clip

    def draw_noise(key, N, dtype, device):
        """This rank's N rows of the global batch's noise drawn from
        ``key``."""
        H, W = config.image_size
        D = config.layout_noise_dim
        rank = 0 if group is None else dist.get_rank(group)
        return threefry_normal(key, (N, D, H, W), dtype=dtype,
                               offset=rank * N * H * W * D, device=device)

    def generator_losses(g_params, g_bufs, d_obj_sd, d_img_sd, batch, noise,
                         eval_mode):
        generator.train(not eval_mode)
        imgs_pred, boxes_pred, masks_pred, rel_scores = G(
            g_params, g_bufs, batch["objs"], batch["triples"],
            batch["obj_mask"], batch["triple_mask"], layout_noise=noise,
            boxes_gt=batch["boxes"], masks_gt=batch.get("masks"))
        losses = model_losses(config, batch, imgs_pred, boxes_pred,
                              masks_pred, rel_scores)
        d_bufs = {}
        if DO is not None:
            # D's parameters enter detached: G's gradients flow through D
            # to the images and never to D's weights.
            p, b = DO.split(d_obj_sd)
            d_bufs["d_obj"] = _copies(b)
            scores_fake, obj_logits = DO(
                {k: v.detach() for k, v in p.items()}, d_bufs["d_obj"],
                imgs_pred, batch["boxes"], obj_mask=batch["obj_mask"])
            losses["ac_loss"] = L.cross_entropy(
                obj_logits, batch["objs"],
                batch["obj_mask"]) * config.ac_loss_weight
            w = config.discriminator_loss_weight * config.d_obj_weight
            losses["g_gan_obj_loss"] = gan_g_loss(scores_fake,
                                                  batch["obj_mask"]) * w
        if DI is not None:
            p, b = DI.split(d_img_sd)
            d_bufs["d_img"] = _copies(b)
            scores_fake_img = DI({k: v.detach() for k, v in p.items()},
                                 d_bufs["d_img"], imgs_pred)
            w = config.discriminator_loss_weight * config.d_img_weight
            losses["g_gan_img_loss"] = gan_g_loss(scores_fake_img) * w
        total = sum(losses.values())
        losses["total_loss"] = total
        return total, losses, imgs_pred, d_bufs

    def d_obj_losses(params, bufs, imgs_fake, batch):
        """Fake pass then real pass, chaining the BatchNorm stats."""
        om = batch["obj_mask"]
        scores_fake, logits_fake = DO(params, bufs, imgs_fake,
                                      batch["boxes"], obj_mask=om)
        scores_real, logits_real = DO(params, bufs, batch["imgs"],
                                      batch["boxes"], obj_mask=om)
        gan = gan_d_loss(scores_real, scores_fake, om)
        ac_real = L.cross_entropy(logits_real, batch["objs"], om)
        ac_fake = L.cross_entropy(logits_fake, batch["objs"], om)
        return gan + ac_real + ac_fake, {"d_obj_gan_loss": gan,
                                         "d_ac_loss_real": ac_real,
                                         "d_ac_loss_fake": ac_fake}

    def d_img_losses(params, bufs, imgs_fake, batch):
        scores_fake = DI(params, bufs, imgs_fake)
        scores_real = DI(params, bufs, batch["imgs"])
        gan = gan_d_loss(scores_real, scores_fake)
        return gan, {"d_img_gan_loss": gan}

    def mark(name):
        if train_step.marker is not None:
            train_step.marker(name)

    def d_step(name, tpl, losses_fn, state, gpass_bufs, good, imgs_fake,
               batch, metrics):
        params, bufs = tpl.split(getattr(state, name))
        if bufs:
            # The G-pass scoring moved these stats from imgs_pred, which
            # may be NaN on a skipped step: the merge is gated too.
            bufs = _where(good, gpass_bufs, bufs)
        leaves = _leaves(params)
        run_bufs = _copies(bufs)
        total, losses = losses_fn(leaves, run_bufs, imgs_fake, batch)
        mark(name + "_forward")
        grads = _grads(total, leaves)
        grads, losses = _reduce(group, grads, {**losses,
                                               name + "_total": total})
        total = losses.pop(name + "_total")
        mark(name + "_backward")
        d_good = good & all_finite(grads.values())
        updates, opt = opts[name].update(grads, getattr(state, name + "_opt"),
                                         d_good)
        new_params = apply_updates(params, updates)
        if d_clip is not None:
            # WGAN weight clip (upstream parses --d_clip and never applies
            # it; the JAX package applies it), gated by d_good.
            new_params = {k: torch.where(d_good, p.clamp(-d_clip, d_clip), p)
                          for k, p in new_params.items()}
        metrics.update({k: v.detach() for k, v in losses.items()})
        metrics[name + "_total"] = total.detach()
        new_sd = {**new_params, **_where(d_good, run_bufs, bufs)}
        mark(name + "_optimizer")
        return new_sd, opt

    def train_step(state: TrainState, batch: dict, eval_mode: bool = False,
                   noise=None):
        with collectives.global_batch(group):
            return _train_step(state, batch, eval_mode, noise)

    def _train_step(state, batch, eval_mode, noise):
        N = batch["imgs"].shape[0]
        rng, noise_key = threefry_split(state.rng)
        if config.layout_noise_dim > 0 and noise is None:
            noise = draw_noise(noise_key, N, batch["imgs"].dtype,
                               batch["imgs"].device)

        params, bufs = G.split(state.g)
        leaves = _leaves(params)
        run_bufs = _copies(bufs)
        total, losses, imgs_pred, d_bufs = generator_losses(
            leaves, run_bufs, state.d_obj, state.d_img, batch, noise,
            eval_mode)
        mark("g_forward")
        grads = _grads(total, leaves)
        grads, losses = _reduce(group, grads, losses)
        mark("g_backward")
        good = (torch.isfinite(losses["total_loss"].detach())
                & all_finite(grads.values()))
        metrics = {k: v.detach() for k, v in losses.items()}

        updates, g_opt = opts["g"].update(grads, state.g_opt, good)
        new = dict(
            step=state.step + 1, rng=rng,
            g={**apply_updates(params, updates),
               **(bufs if eval_mode else _where(good, run_bufs, bufs))},
            g_opt=g_opt)
        mark("g_optimizer")
        imgs_fake = imgs_pred.detach()
        del leaves, total, losses, imgs_pred, grads
        if DO is not None:
            new["d_obj"], new["d_obj_opt"] = d_step(
                "d_obj", DO, d_obj_losses, state, d_bufs["d_obj"], good,
                imgs_fake, batch, metrics)
        if DI is not None:
            new["d_img"], new["d_img_opt"] = d_step(
                "d_img", DI, d_img_losses, state, d_bufs["d_img"], good,
                imgs_fake, batch, metrics)
        metrics["skipped_nonfinite"] = ~good
        return state.replace(**new), metrics

    # Per-section probes for --timing (upstream's forward / loss /
    # backward sections, train.py:524-560; the JAX package's
    # ``phase_fns``).  Each runs one section of the step on the inputs it
    # is given, on copies of the BatchNorm buffers, and returns a fence:
    # a 0-dim tensor that depends on all of the section's output, the
    # gradients' global norm included.  None changes the state.  They
    # time this rank's work alone: no collective runs in them.
    def phase_g_forward(state, batch, noise):
        """G's train-mode forward -> (the fakes, their sum)."""
        params, bufs = G.split(state.g)
        generator.train(True)
        with torch.no_grad():
            imgs_pred = G(params, _copies(bufs), batch["objs"],
                          batch["triples"], batch["obj_mask"],
                          batch["triple_mask"], layout_noise=noise,
                          boxes_gt=batch["boxes"],
                          masks_gt=batch.get("masks"))[0]
        return imgs_pred, imgs_pred.sum()

    def phase_g_forward_backward(state, batch, noise):
        """G's losses and their gradients -> total + gradient norm."""
        params, bufs = G.split(state.g)
        leaves = _leaves(params)
        total = generator_losses(leaves, _copies(bufs), state.d_obj,
                                 state.d_img, batch, noise, False)[0]
        return total.detach() + global_norm(_grads(total, leaves))

    def phase_d_step(name, tpl, losses_fn):
        def phase(state, batch, imgs_fake):
            """The discriminator's losses on the fakes and the real images
            and their gradients -> total + gradient norm."""
            params, bufs = tpl.split(getattr(state, name))
            leaves = _leaves(params)
            total = losses_fn(leaves, _copies(bufs), imgs_fake, batch)[0]
            return total.detach() + global_norm(_grads(total, leaves))
        return phase

    train_step.phase_fns = {"g_forward": phase_g_forward,
                            "g_forward_backward": phase_g_forward_backward}
    if DO is not None:
        train_step.phase_fns["d_obj_step"] = phase_d_step(
            "d_obj", DO, d_obj_losses)
    if DI is not None:
        train_step.phase_fns["d_img_step"] = phase_d_step(
            "d_img", DI, d_img_losses)
    train_step.marker = None
    return train_step
