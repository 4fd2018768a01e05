"""GAN training: back-to-back ``Trainer.step(state, batch)`` on a pool of
distinct synthetic COCO-like batches staged on the device, so the loader
is left out.

Set-up builds the Trainer and its state from the seed's weights and drives
the first ``ref_steps`` steps through the same ``Trainer.step`` on the
pool's first batches; those steps' losses, the first gradients (read back
from Adam's first moments) and the parameters' change are what the
reference checks, and the same state goes on into the window.

Traffic keys: ``batch_size``, ``pool``, ``min_objects``, ``max_objects``,
``pad_objects``,
``pad_triples``, ``min_box``, ``ref_steps``, ``trace_units`` (steps in the
traced slice).
"""

from __future__ import annotations

import gc
import time

import torch

from benchmark.harness import checks, device, inputs, peaks
from benchmark.reference import generator as gen
from benchmark.reference import threefry
from benchmark.reference import training as ref

MODELS = ("g", "d_obj", "d_img")
LOSSES = ("total_loss", "d_obj_total", "d_img_total")
B1 = 0.9  # Adam's first-moment decay: m after one step is (1 - B1) g


def train_config(cfg, traffic):
    """The port's TrainConfig for a configuration."""
    from sg2im_tpu_torch.train.config import TrainConfig

    m, t = cfg["model"], cfg["train"]
    return TrainConfig(
        dataset="coco", batch_size=traffic["batch_size"],
        image_size=tuple(m["image_size"]),
        embedding_dim=m["embedding_dim"], gconv_dim=m["gconv_dim"],
        gconv_hidden_dim=m["gconv_hidden_dim"],
        gconv_num_layers=m["gconv_num_layers"],
        mlp_normalization=m["mlp_normalization"],
        refinement_network_dims=tuple(m["refinement_dims"]),
        normalization=m["normalization"], activation=m["activation"],
        mask_size=m["mask_size"], layout_noise_dim=m["layout_noise_dim"],
        learning_rate=t["learning_rate"],
        l1_pixel_loss_weight=t["l1_pixel_loss_weight"],
        bbox_pred_loss_weight=t["bbox_pred_loss_weight"],
        mask_loss_weight=0.0, predicate_pred_loss_weight=0.0,
        discriminator_loss_weight=t["discriminator_loss_weight"],
        d_obj_weight=t["d_obj_weight"], d_img_weight=t["d_img_weight"],
        ac_loss_weight=t["ac_loss_weight"], d_obj_arch=t["d_obj_arch"],
        d_img_arch=t["d_img_arch"], crop_size=t["crop_size"],
        d_normalization="batch", d_padding="valid",
        d_activation=m["activation"], gan_loss_type="gan",
        pad_objects_to=traffic["pad_objects"],
        pad_triples_to=traffic["pad_triples"],
        bf16_compute=t["compute_dtype"] == "bfloat16",
        crn_mode=t["crn_mode"])


def weights(cfg, seed, device) -> dict:
    return {"g": inputs.make_weights(gen.spec(cfg), seed, "g", device),
            "d_obj": inputs.make_weights(ref.d_obj_spec(cfg), seed, "d_obj",
                                         device),
            "d_img": inputs.make_weights(ref.d_img_spec(cfg), seed, "d_img",
                                         device)}


def batches(cfg, traffic, seed, device) -> list:
    r = inputs.rng(seed, "batches")
    g = torch.Generator(device=device)
    g.manual_seed(inputs.stream_seed(seed, "batches"))
    return [inputs.train_batch(cfg, traffic, r, g, device)
            for _ in range(traffic["pool"])]


def noise_key(seed) -> tuple[int, int]:
    return threefry.key(inputs.call_seeds(seed, 1)[0])


def step_unit(cfg, b) -> dict:
    m = cfg["model"]
    H, W = m["image_size"]
    N = b["imgs"].shape[0]
    return {"images": N, "objects": int(b["obj_mask"].sum()),
            "layout_elem": 4, "splits": 1,
            "noise_values": N * H * W * m["layout_noise_dim"]}


def step_peak_seconds(cfg, b) -> float:
    """Seconds at the float32 peak of the reference's matmuls and
    convolutions in one step (the generator's forward and backward through
    both discriminators, each discriminator's two passes and backward),
    counted on the meta device at the batch's shapes."""
    def meta(spec):
        return {n: torch.empty(s, device="meta") for n, s, _ in spec}

    Wg, Wo, Wi = (meta(gen.spec(cfg)), meta(ref.d_obj_spec(cfg)),
                  meta(ref.d_img_spec(cfg)))
    mb = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
          for k, v in b.items()}
    m = cfg["model"]
    H, W = m["image_size"]
    noise = torch.empty(b["imgs"].shape[0], m["layout_noise_dim"], H, W,
                        device="meta")
    fc = peaks.FlopCount()
    with fc.section("f32"):
        leaves = {k: v.requires_grad_(True) for k, v in Wg.items()
                  if ref.is_param(k)}
        total, imgs = ref.g_losses(Wg, Wo, Wi, cfg, mb, noise)
        torch.autograd.grad(total, list(leaves.values()), allow_unused=True)
        for W_, fn in ((Wo, ref.d_obj_loss), (Wi, ref.d_img_loss)):
            d = {k: v.requires_grad_(True) for k, v in W_.items()
                 if ref.is_param(k)}
            torch.autograd.grad(fn(W_, cfg, imgs.detach(), mb),
                                list(d.values()), allow_unused=True)
    return fc.seconds_at_peak()


def compare(prog: dict, refr: dict) -> dict:
    """loss_gap: the largest relative gap of the three totals (G, D_obj,
    D_img) at the first step; grad_gap and update_gap: the worst leaf's gap
    between the norms of the first gradient and of the parameters' change
    over the checked steps (:func:`checks.worst_leaf_gap`), over the leaves
    that count by the reference's first gradient.

    The later steps' losses are not compared: Adam moves every element of
    a leaf by about its learning rate whatever the gradient's size, so
    round-off in elements whose gradient is near zero moves the parameters
    by whole steps, and the second and third losses of two float32 runs,
    of the reference against itself as of the program, differ by 1e-5 to
    1e-3 (PERF.md)."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"][0],
                                                   refr["losses"][0]))
    grad = update = 0.0
    for m in MODELS:
        keep = checks.kept_leaves(refr["grads"][m])
        grad = max(grad, checks.worst_leaf_gap(prog["grads"][m],
                                               refr["grads"][m], keep))
        update = max(update, checks.worst_leaf_gap(prog["updates"][m],
                                                   refr["updates"][m], keep))
    return {"loss_gap": loss, "grad_gap": grad, "update_gap": update}


def reference_readings(cfg, traffic, seed, device, tf32=False,
                       rows=None) -> dict:
    """The reference's losses, first-gradient norms and update norms from
    the seed's weights over the first ``ref_steps`` batches; ``rows`` keeps
    only the first rows of each batch (a fault: half the batch)."""
    W = weights(cfg, seed, device)
    bs = batches(cfg, traffic, seed, device)[:traffic["ref_steps"]]
    if rows is not None:
        bs = [{k: v[:rows] for k, v in b.items()} for b in bs]
    with gen.precision(tf32):
        out = ref.train_steps(W, cfg, bs, noise_key(seed),
                              traffic["ref_steps"])
    return {"losses": out["losses"],
            "grads": {m: checks.norms(out["grads"][m]) for m in MODELS},
            "updates": {m: checks.norms({k: v - W[m][k] for k, v in
                                         out["params"][m].items()})
                        for m in MODELS}}


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.traffic = ctx.cfg, ctx.traffic
        self.device = ctx.device

    def setup(self):
        from sg2im_tpu_torch.train.state import TrainState
        from sg2im_tpu_torch.train.trainer import Trainer

        cfg, tr, seed = self.cfg, self.traffic, self.ctx.seed
        self.trainer = Trainer(train_config(cfg, tr), inputs.vocab(cfg),
                               device=self.device)
        W = weights(cfg, seed, self.device)
        fields = {"step": torch.zeros((), dtype=torch.int32,
                                      device=self.device),
                  "rng": torch.tensor(noise_key(seed), dtype=torch.int64,
                                      device=self.device).to(torch.uint32)}
        for m in MODELS:
            fields[m] = dict(W[m])
            fields[m + "_opt"] = self.trainer.optimizers[m].init(
                {k: v for k, v in W[m].items() if ref.is_param(k)})
        state = TrainState(**fields)
        self.pool = batches(cfg, tr, seed, self.device)
        losses = []
        for i in range(tr["ref_steps"]):
            state, met = self.trainer.step(state, self.pool[i])
            losses.append(torch.stack([met[k] for k in LOSSES]))
            if i == 0:
                first = {m: checks.norms({
                    k: v / (1.0 - B1) for k, v in
                    getattr(state, m + "_opt").mu.items()}) for m in MODELS}
        self.readings = {
            "losses": [tuple(x) for x in torch.stack(losses).tolist()],
            "grads": first,
            "updates": {m: checks.norms({
                k: getattr(state, m)[k] - W[m][k] for k in W[m]
                if ref.is_param(k)}) for m in MODELS}}
        del W
        self.state = state
        self.steps = tr["ref_steps"]
        device.sync(self.device)

    def _step(self):
        b = self.pool[self.steps % len(self.pool)]
        self.state, met = self.trainer.step(self.state, b)
        self.steps += 1
        return b, met

    def window(self, seconds: float) -> dict:
        skipped = torch.zeros((), dtype=torch.int32, device=self.device)
        first = self.steps
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            b, met = self._step()
            skipped += met["skipped_nonfinite"].to(torch.int32)
        device.sync(self.device)
        t = time.perf_counter() - t0
        n = self.steps - first
        self.window_steps = n
        batch = self.pool[0]["imgs"].shape[0]
        return {"seconds": t, "units": n, "images": n * batch,
                "attempted": n, "failed": int(skipped)}

    def trace_slice(self, sl) -> None:
        from torch.profiler import record_function

        for _ in range(self.traffic["trace_units"]):
            with record_function("benchmark.train_step"):
                b, _ = self._step()
            sl.units.append(step_unit(self.cfg, b))

    def peak_seconds(self) -> float:
        return self.window_steps * step_peak_seconds(self.cfg, self.pool[0])

    def release(self) -> None:
        del self.state, self.trainer, self.pool
        gc.collect()
        torch.cuda.empty_cache()

    def check(self) -> dict:
        return compare(self.readings, reference_readings(
            self.cfg, self.traffic, self.ctx.seed, self.device))
