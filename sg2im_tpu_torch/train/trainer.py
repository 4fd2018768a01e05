"""Trainer: the modules, state initialisation, stepping, validation and
checkpoints (counterpart of ``sg2im_tpu/train/trainer.py``, upstream
``scripts/train.py main()`` without the command line).

Its device is the card unless the caller asks for another
(``Trainer(config, vocab, device="cpu")``).  A batch is a dict of numpy
arrays in the JAX package's layout (imgs (N, H, W, 3)), as
``data.loader.PaddedLoader``, ``bench.py`` and the tests make them, or of
tensors in the port's (imgs (N, 3, H, W)), as ``data.loader.
prefetch_to_device`` puts them on the card; :meth:`Trainer.to_device`
stages either, and copies nothing that is already on the device in the
step's types.

Data parallelism: in a process that has joined a ``torch.distributed``
group (``parallel.mesh.init_multihost``, or the train CLI's
``--data_parallel N``), the Trainer is one rank of a data-parallel run
whose world size must be ``config.data_parallel``.  Each rank hands
:meth:`Trainer.step` and :meth:`Trainer.check_model` its own rows of the
global batch (``PaddedLoader(shard=(rank, world))`` with
``batch_size / world`` rows); the step computes the one-process step on
the global batch (``train.step.make_train_step``) and the validation sweep
the global figures.  Rank 0 alone writes checkpoints; every rank restores.

Random numbers are the JAX Trainer's (``ops.prng``): the state's key is
``split(PRNGKey(seed), 5)[0]``, each step splits it, ``check_model`` draws
batch k's layout noise from the k-th split of ``PRNGKey(step)``, the
triptych from ``PRNGKey(seed)`` and ``step_breakdown`` from
``PRNGKey(0)``.  So are the fresh weights: flax's init of the JAX models
from the keys the JAX Trainer splits off (``nn/init.py``).
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from sg2im_tpu_torch.data.transforms import imagenet_deprocess_batch_torch
from sg2im_tpu_torch.inference import full_fp32
from sg2im_tpu_torch.models import (
    AcCropDiscriminator,
    PatchDiscriminator,
    Sg2ImGenerator,
)
from sg2im_tpu_torch.nn.init import init_draws, init_state_dict
from sg2im_tpu_torch.ops.prng import prng_key, split
from sg2im_tpu_torch.ops.prng_kernel import threefry_normal, threefry_split
from sg2im_tpu_torch.parallel import collectives
from sg2im_tpu_torch.parallel.mesh import replicate_state
from sg2im_tpu_torch.train.config import TrainConfig
from sg2im_tpu_torch.train.state import TrainState
from sg2im_tpu_torch.train.step import (
    make_optimizers,
    make_train_step,
    model_losses,
)
from sg2im_tpu_torch.utils.metrics import jaccard

_INT_KEYS = ("objs", "triples")


class Trainer:
    def __init__(self, config: TrainConfig, vocab, device="cuda"):
        self.group, self.rank, self.world = None, 0, 1
        if dist.is_available() and dist.is_initialized():
            self.group = dist.group.WORLD
            self.rank, self.world = dist.get_rank(), dist.get_world_size()
            if self.world != config.data_parallel:
                raise ValueError(
                    f"config.data_parallel={config.data_parallel}, but this "
                    f"process is one of {self.world} ranks of its "
                    "torch.distributed group: set data_parallel to the "
                    "world size")
        elif config.data_parallel > 1:
            raise RuntimeError(
                f"data_parallel={config.data_parallel} needs a "
                "torch.distributed group of that many ranks, one per card: "
                "launch `python -m sg2im_tpu_torch.cli.train "
                "--data_parallel N` (it starts the ranks), or `torchrun "
                "--nproc_per_node N -m sg2im_tpu_torch.cli.train "
                "--multihost true`, or call sg2im_tpu_torch.parallel.mesh."
                "init_multihost() in every rank before the Trainer")
        self.config = config
        self.vocab = vocab
        self.device = torch.device(device)
        # The modules are templates on the CPU: a step runs them on the
        # state's tensors (functional_call), and init_state seeds them from
        # a CPU generator, so a seed gives the same weights on any device.
        self.generator = Sg2ImGenerator(vocab, **config.generator_kwargs())
        self.d_obj = (AcCropDiscriminator(vocab, **config.d_obj_kwargs())
                      if config.use_obj_discriminator else None)
        self.d_img = (PatchDiscriminator(**config.d_img_kwargs())
                      if config.use_img_discriminator else None)
        self.optimizers = make_optimizers(config)
        self.train_step = make_train_step(self.generator, self.d_obj,
                                          self.d_img, config, self.optimizers,
                                          group=self.group)
        # Host mirror of state.step, read from the device once per
        # (re)start: it selects the eval-mode regime without a sync per
        # step.
        self._host_step: int | None = None

    # -- batches and initialisation ---------------------------------------

    def to_device(self, batch: dict) -> dict:
        """A batch as the step takes it: tensors on the trainer's device,
        imgs NCHW float32, objs and triples int64.  numpy imgs are read as
        NHWC (the JAX package's layout), tensors as NCHW."""
        out = {}
        for k, v in batch.items():
            if v is None:
                continue
            if isinstance(v, np.ndarray):
                if k == "imgs":
                    v = v.transpose(0, 3, 1, 2)
                v = torch.from_numpy(np.ascontiguousarray(v))
            v = v.to(self.device, non_blocking=True)
            out[k] = v.long() if k in _INT_KEYS else v.float()
        return out

    def dummy_batch(self, n: int | None = None) -> dict:
        """An all-trivial numpy batch of ``n`` (default batch_size) images
        in the JAX package's layout."""
        c = self.config
        N = n or c.batch_size
        H, W = c.image_size
        O, T = c.pad_objects_to, c.pad_triples_to
        batch = {
            "imgs": np.zeros((N, H, W, 3), np.float32),
            "objs": np.zeros((N, O), np.int32),
            "boxes": np.tile(np.array([0.0, 0.0, 1.0, 1.0], np.float32),
                             (N, O, 1)),
            "triples": np.zeros((N, T, 3), np.int32),
            "obj_mask": np.ones((N, O), np.float32),
            "triple_mask": np.ones((N, T), np.float32),
        }
        if c.mask_size and c.dataset == "coco":
            batch["masks"] = np.zeros((N, O, c.mask_size, c.mask_size),
                                      np.float32)
        return batch

    def init_state(self, seed: int | None = None) -> TrainState:
        """The JAX Trainer's fresh state for ``seed`` (default config.seed;
        ``sg2im_tpu/train/trainer.py:83-122``), drawn on the device:
        ``split(PRNGKey(seed), 5)`` gives the state's key and the keys of
        G, D_obj and D_img, whose weights are flax's init of the JAX
        models for those keys (``nn/init.py``); fresh Adams.  On the card
        the split is one launch and each drawn leaf one threefry launch
        (:meth:`init_launches`).  In a data-parallel run every rank then
        holds rank 0's state (one broadcast per dtype)."""
        seed = self.config.seed if seed is None else seed
        keys = threefry_split(prng_key(seed), 5, device=self.device)
        fields = {"step": torch.zeros((), dtype=torch.int32,
                                      device=self.device),
                  "rng": keys[0].clone()}
        for i, name in enumerate(("g", "d_obj", "d_img"), start=1):
            module = self.modules()[name]
            if module is None:
                continue
            drawn = init_state_dict(module, name, keys[i], self.device)
            sd = {k: drawn[k] for k in module.state_dict()}
            fields[name] = sd
            fields[name + "_opt"] = self.optimizers[name].init(
                {k: sd[k] for k, _ in module.named_parameters()})
        self._host_step = 0
        state = TrainState(**fields)
        if self.group is not None:
            state = replicate_state(state, self.group)
        return state

    def init_launches(self) -> dict[str, int]:
        """The kernel launches of :meth:`init_state` on the card: the key's
        split and one threefry draw a drawn leaf."""
        total = {"threefry_split": 1}
        for name, module in self.modules().items():
            if module is not None:
                for k, n in init_draws(module, name).items():
                    total[k] = total.get(k, 0) + n
        return total

    def modules(self) -> dict:
        return {"g": self.generator, "d_obj": self.d_obj,
                "d_img": self.d_img}

    def reset_g_optimizer(self, state: TrainState) -> TrainState:
        """A fresh Adam for the generator, at the eval_mode_after switch
        (upstream ``train.py:509-512``)."""
        params = {k: state.g[k] for k, _ in self.generator.named_parameters()}
        return state.replace(g_opt=self.optimizers["g"].init(params))

    # -- stepping ----------------------------------------------------------

    def eval_mode(self) -> bool:
        """Whether the next step runs G in eval mode: from step
        ``eval_mode_after`` on; a negative value never switches (upstream
        ``train.py:466``)."""
        return 0 <= self.config.eval_mode_after <= self._host_step

    def step(self, state: TrainState, batch: dict, noise=None):
        """One train step -> (new state, metrics as 0-dim device tensors).
        TF32 is off for every f32 matmul and convolution of the step."""
        if self._host_step is None:
            self._host_step = int(state.step)  # one sync at (re)start
        eval_mode = self.eval_mode()
        with full_fp32():
            out = self.train_step(state, self.to_device(batch),
                                  eval_mode=eval_mode, noise=noise)
        self._host_step += 1
        return out

    def step_breakdown(self, state: TrainState, batch: dict) -> dict:
        """Device ms of each section of a train step (upstream ``--timing``,
        ``train.py:524-560``): G forward, G forward + losses + backward,
        each discriminator's forward + backward, run by the step's
        ``phase_fns`` on ``batch`` after one warm-up call each, timed on
        the host clock up to a read of the section's fence scalar (which
        waits for the card).  The state is not changed.  The layout noise
        is drawn from ``PRNGKey(0)``, the fakes of the D sections from the
        G forward."""
        b = self.to_device(batch)
        noise = self._layout_noise(prng_key(0), b["imgs"].shape[0])
        times: dict[str, float] = {}
        imgs_fake = None
        with full_fp32():
            for name, fn in self.train_step.phase_fns.items():
                arg = imgs_fake if name.startswith("d_") else noise
                for _ in range(2):  # a warm-up call, then the timed one
                    t0 = time.perf_counter()
                    out = fn(state, b, arg)
                    if name == "g_forward":
                        imgs_fake, out = out
                    float(out)
                times[name] = (time.perf_counter() - t0) * 1000.0
        return times

    def _layout_noise(self, key, N: int, row: int = 0):
        """Rows ``row`` ... ``row + N - 1`` of ``jax.random.normal(key,
        (., H, W, layout_noise_dim))`` as (N, layout_noise_dim, H, W) on
        the device; None when the generator takes no noise."""
        c = self.config
        if c.layout_noise_dim <= 0:
            return None
        H, W = c.image_size
        D = c.layout_noise_dim
        return threefry_normal(key, (N, D, H, W), offset=row * H * W * D,
                               device=self.device)

    # -- validation (upstream check_model, train.py:309-384) ---------------

    def _generate(self, state: TrainState, b: dict, noise, boxes_gt,
                  masks_gt):
        """G in eval mode on the device batch ``b``: (imgs, boxes, masks,
        rel_scores)."""
        G = self.generator.eval()
        with full_fp32():
            return torch.func.functional_call(
                G, state.g, (b["objs"], b["triples"], b["obj_mask"],
                            b["triple_mask"]),
                dict(layout_noise=noise, boxes_gt=boxes_gt,
                     masks_gt=masks_gt))

    @torch.no_grad()
    def check_model(self, state: TrainState, batches, num_samples=None,
                    return_samples: bool = False):
        """Validation sweep in eval mode: (mean losses, mean box IoU).  The
        layout noise of batch k is drawn from the k-th split of
        ``PRNGKey(step)``, as in the JAX Trainer.  In a data-parallel run
        each rank sweeps its own rows of every batch (as many batches on
        every rank; its rows of the noise by offset), and the figures are
        the global batches': the loss means over the global batch, the sums
        of losses, IoU and objects summed across the ranks; ``num_samples``
        counts global rows, and the samples are not gathered ({} and {}, as
        the JAX package's multi-process sweep gives).

        With ``return_samples=True``: (mean losses, samples, batch_data,
        mean IoU), the JAX package's tuple.  ``samples`` is the last
        batch's :meth:`sample_triptych` deprocessed to (N, H, W, 3) uint8;
        ``batch_data`` that batch's padded tensors and predictions as
        numpy (objs, boxes_gt, triples, obj_mask, triple_mask, boxes_pred,
        and masks_gt / masks_pred where there are masks).  Both are {} when
        no batch was swept."""
        c = self.config
        tot_losses: dict[str, float] = {}
        tot_iou, tot_objs, seen = 0.0, 0.0, 0
        rng = prng_key(int(state.step))
        last = None
        for batch in batches:
            if num_samples is not None and seen >= num_samples:
                break
            b = self.to_device(batch)
            n = b["imgs"].shape[0]
            N = n * self.world
            rng, k = split(rng)
            noise = self._layout_noise(k, n, row=self.rank * n)
            with collectives.global_batch(self.group):
                imgs, boxes, masks, rel_scores = self._generate(
                    state, b, noise, b["boxes"], b.get("masks"))
                losses = model_losses(c, b, imgs, boxes, masks, rel_scores)
            losses["total_loss"] = sum(losses.values())
            for k, v in losses.items():
                tot_losses[k] = tot_losses.get(k, 0.0) + float(v) * N
            tot_iou += float(jaccard(boxes, b["boxes"], b["obj_mask"]))
            tot_objs += float(b["obj_mask"].sum())
            seen += N
            last = (b, boxes, masks)
        if self.group is not None:
            names = sorted(tot_losses)
            sums = collectives.all_reduce(torch.tensor(
                [tot_losses[k] for k in names] + [tot_iou, tot_objs],
                dtype=torch.float64, device=self.device), self.group)
            sums = sums.tolist()
            tot_losses = dict(zip(names, sums[:len(names)]))
            tot_iou, tot_objs = sums[len(names):]
        mean_losses = {k: v / max(seen, 1) for k, v in tot_losses.items()}
        avg_iou = tot_iou / max(tot_objs, 1.0)
        if not return_samples:
            return mean_losses, avg_iou
        if last is None or self.world > 1:
            return mean_losses, {}, {}, avg_iou
        b, boxes_pred, masks_pred = last
        samples = {k: imagenet_deprocess_batch_torch(
            v.permute(0, 2, 3, 1)).cpu().numpy()
            for k, v in self.sample_triptych(state, b,
                                             seed=int(state.step)).items()}

        def host(t, key):
            a = t.detach().cpu().numpy()
            return a.astype(np.int32) if key in _INT_KEYS else a

        batch_data = {"objs": host(b["objs"], "objs"),
                      "boxes_gt": host(b["boxes"], "boxes"),
                      "triples": host(b["triples"], "triples"),
                      "obj_mask": host(b["obj_mask"], "obj_mask"),
                      "triple_mask": host(b["triple_mask"], "triple_mask"),
                      "boxes_pred": host(boxes_pred, "boxes_pred")}
        if b.get("masks") is not None:
            batch_data["masks_gt"] = host(b["masks"], "masks")
        if masks_pred is not None:
            batch_data["masks_pred"] = host(masks_pred, "masks_pred")
        return mean_losses, samples, batch_data, avg_iou

    @torch.no_grad()
    def sample_triptych(self, state: TrainState, batch: dict,
                        seed: int = 0) -> dict:
        """G in eval mode on ``batch`` three ways (upstream
        ``train.py:346-356``): ground-truth boxes and masks, ground-truth
        boxes with predicted masks, predicted boxes and masks; with the
        real images under ``gt_img``.  (N, 3, H, W) float tensors on the
        device, imagenet-normalised; the layout noise, the same for all
        three, drawn from ``PRNGKey(seed)``."""
        b = self.to_device(batch)
        noise = self._layout_noise(prng_key(seed), b["imgs"].shape[0])

        def run(boxes_gt, masks_gt):
            return self._generate(state, b, noise, boxes_gt, masks_gt)[0]

        return {"gt_img": b["imgs"],
                "gt_box_gt_mask": run(b["boxes"], b.get("masks")),
                "gt_box_pred_mask": run(b["boxes"], None),
                "pred_box_pred_mask": run(None, None)}

    # -- checkpoints -------------------------------------------------------

    def save_checkpoint(self, state: TrainState, path: str, extra=None,
                        arrays=None, wait: bool = True,
                        backend: str | None = None):
        """Write ``state`` under ``path`` (rank 0 alone in a data-parallel
        run, where every rank calls this: with ``wait`` no rank returns
        before the files are written).  ``backend``: 'torch', or 'msgpack'
        for the JAX package's format; None keeps the directory's
        (``ckpt.store``)."""
        from sg2im_tpu_torch.ckpt.store import save_checkpoint

        if self.rank == 0:
            save_checkpoint(path, state, config=self.config,
                            vocab=self.vocab, extra=extra, arrays=arrays,
                            wait=wait, backend=backend)
        if self.group is not None and wait:
            # A barrier of the collectives this package uses.
            collectives.all_reduce(torch.zeros(1, device=self.device),
                                   self.group)

    def load_checkpoint(self, path: str):
        """-> (state, meta) from either format of ``ckpt.store``; tensors
        land on the trainer's device.  A checkpoint that holds no key
        (``ckpt.store``'s module docstring) restarts the noise stream, and
        this says so once."""
        from sg2im_tpu_torch.ckpt.store import load_checkpoint

        restored, meta = load_checkpoint(path, self.device)
        if meta.get("rng_restarted"):
            print(f"WARNING: {path} holds a torch.Generator state, not a "
                  "threefry key: the layout-noise stream restarts from the "
                  "key of a fresh run of its seed")
        self._host_step = None  # re-read from the restored counter
        return restored, meta
