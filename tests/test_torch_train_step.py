"""The port's GAN train step and Trainer against the JAX package's
``make_train_step`` / ``Trainer`` on the CPU, and the step's own
guarantees.

Each mode builds one JAX trainer per module (its step compiles once) and
one port trainer on the CPU.  The port's seeded initial state goes into
the JAX ``TrainState`` through the JAX package's own converter
(``sg2im_tpu.ckpt.torch_convert``) and comes back through
``train_state_from_jax``, bit for bit, the threefry key included; then
both take two steps on ``tests/test_train.py``'s ``_rand_batch``, each
drawing its layout noise from its own copy of the key (the port's normals
within 1e-6 of JAX's, ``tests/test_torch_prng.py``), and the keys after
each step are equal.  Sizes: ``TINY`` for 'legacy', and a variant with
layout noise, BatchNorm in the MLPs and in both discriminators at 32x32 for
'split', 'packed' and 'phase' (whose last stage runs packed there).

Bars:

- losses after one and two steps: 2e-4 relative, 2e-5 absolute (the JAX
  suite's loss-assembly bar; measured: 8.0e-7 relative);
- parameters after k steps: 1e-6 + 0.05 * lr * k absolute (measured: up to
  0.034 * lr * k), well under the +-lr that Adam moves an element by on
  each step, so a missing update (lr), a wrong sign (2 * lr) or an update
  applied to another tensor fails it.  Left out are the elements whose
  reference gradient is at round-off, where Adam, which scales each step
  to about lr whatever the gradient's size, takes the sign from the order
  of the sums (measured: up to 1.98 * lr per step):
  - every element of a bias that feeds a train-mode BatchNorm (the next
    layer of its Sequential), whose exact gradient is 0: 4 leaves in
    'legacy', 18 in the variant;
  - an element whose JAX first moment after any step so far is nonzero
    and at most ROUNDOFF_MU (a gradient of at most ten times Adam's eps,
    where the size of the update follows the gradient's round-off).
  Together they leave out 41 (360) of 27432 elements in 'legacy' after
  one (two) steps, 273 (274) of 29782 in the variant; the test asserts
  that at least 90% are held.
- Adam moments: 1e-4 of the model's largest first (second) moment
  (measured: 1.8e-5), the gradients' round-off through sums in another
  order;
- BatchNorm statistics: 1e-5 + lr * (k - 1).  After one step the same
  parameters ran the forward (measured: 2.4e-7); after that a statistic
  moves by 0.1 of a batch mean per pass, at most three passes per step,
  and the +-lr differences of the elements left out above shift a batch
  mean by up to 2 * lr (measured: 4.3e-5 after two steps).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sg2im_tpu.ckpt.torch_convert import (
    convert_ac_discriminator_state,
    convert_generator_state,
    convert_patch_discriminator_state,
)
from sg2im_tpu.train.config import TrainConfig as JaxConfig
from sg2im_tpu.train.state import TrainState as JaxState
from sg2im_tpu.train.trainer import Trainer as JaxTrainer
from sg2im_tpu_torch.ckpt import store, train_state_from_jax
from sg2im_tpu_torch.ops.prng import split
from sg2im_tpu_torch.train.config import TrainConfig
from sg2im_tpu_torch.train.state import tensors
from sg2im_tpu_torch.train.step import (
    SkippableAdam,
    all_finite,
    apply_updates,
)
from sg2im_tpu_torch.train.trainer import Trainer
from test_train import TINY, VOCAB, _rand_batch

VARIANT = dict(TINY, image_size=(32, 32), layout_noise_dim=4,
               mlp_normalization="batch", d_obj_arch="C3-8-2,C3-8-1",
               d_img_arch="C3-8-2,C3-8-1")
MODES = {"legacy": TINY,
         "split": dict(VARIANT, crn_mode="split"),
         "packed": dict(VARIANT, crn_mode="packed"),
         "phase": dict(VARIANT, crn_mode="phase")}
LOSS_RTOL, LOSS_ATOL = 2e-4, 2e-5
ROUNDOFF_MU = 1e-8


def _jax_state(jt, ts):
    """The port's state as the JAX package's TrainState, its step and key
    too."""
    fields = {"step": jnp.asarray(int(ts.step), jnp.int32),
              "rng": jnp.asarray(ts.rng.numpy())}
    for name, convert in (("g", convert_generator_state),
                          ("d_obj", convert_ac_discriminator_state),
                          ("d_img", convert_patch_discriminator_state)):
        v = convert(getattr(ts, name))
        fields["g_vars" if name == "g" else name + "_vars"] = v
        fields[name + "_opt"] = jt.optimizers[name].init(v["params"])
    return JaxState(**fields)


def _flat(state):
    """{name: float64 numpy} of a port state (the key's words exact)."""
    return {k: v.double().numpy() for k, v in tensors(state).items()}


class _Run:
    """Two steps of one mode on both sides: the port's and the JAX
    package's losses per step and states (in the port's layout)."""

    def __init__(self, kw):
        self.config = TrainConfig(**kw)
        jc = JaxConfig(**kw)
        self.batch = _rand_batch(np.random.RandomState(0), jc)
        self.trainer = Trainer(self.config, VOCAB, device="cpu")
        self.init = self.trainer.init_state(seed=0)
        jt = JaxTrainer(jc, VOCAB)
        js = _jax_state(jt, self.init)
        self.carried = train_state_from_jax(js)
        ts = self.carried
        self.port, self.jax = [], []
        for _ in range(2):
            js, jm = jt.step(js, dict(self.batch))
            ts, tm = self.trainer.step(ts, dict(self.batch))
            self.jax.append(({k: float(v) for k, v in jm.items()},
                             _flat(train_state_from_jax(js))))
            self.port.append(({k: float(v) for k, v in tm.items()},
                              _flat(ts)))
        self.last = ts


_RUNS = {}


@pytest.fixture(scope="module")
def runs():
    def get(mode):
        if mode not in _RUNS:
            _RUNS[mode] = _Run(MODES[mode])
        return _RUNS[mode]
    return get


@pytest.mark.parametrize("mode", sorted(MODES))
def test_carried_state_round_trips(runs, mode):
    """train_state_from_jax of the JAX state made from the port's seeded
    init is that init, bit for bit, under the same names."""
    r = runs(mode)
    a, b = _flat(r.init), _flat(r.carried)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for name, module in r.trainer.modules().items():
        assert set(getattr(r.init, name)) == set(module.state_dict())


def _check_losses(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg=k)
    assert want["skipped_nonfinite"] == 0.0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_first_step_losses_match_jax(runs, mode):
    r = runs(mode)
    _check_losses(r.port[0][0], r.jax[0][0])


@pytest.mark.parametrize("mode", sorted(MODES))
def test_second_step_losses_match_jax(runs, mode):
    """Step 2's losses come from the parameters step 1 updated."""
    r = runs(mode)
    _check_losses(r.port[1][0], r.jax[1][0])


def _feeds_batchnorm(key, keys):
    """A bias whose layer's output goes straight into a BatchNorm (the next
    layer of its Sequential): its exact gradient in train mode is 0."""
    if not key.endswith(".bias"):
        return False
    head, idx = key[:-len(".bias")].rsplit(".", 1)
    return idx.isdigit() and f"{head}.{int(idx) + 1}.running_mean" in keys


def _kept(r, key, step):
    """The elements of parameter ``key`` held to the tight bar after
    ``step`` steps (see the module docstring), or None for a leaf left
    out."""
    want = r.jax[step - 1][1]
    if _feeds_batchnorm(key, want):
        return None
    model, name = key.split(".", 1)
    keep = np.ones(want[key].shape, bool)
    for j in range(step):
        mu = np.abs(r.jax[j][1][f"{model}_opt.mu.{name}"])
        keep &= ~((mu > 0) & (mu <= ROUNDOFF_MU))
    return keep


@pytest.mark.parametrize("step", [1, 2])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_state_after_steps_matches_jax(runs, mode, step):
    """Parameters, Adam counts and moments and the BatchNorm statistics of
    all three models after one and two steps (bars in the module
    docstring)."""
    r = runs(mode)
    got, want = r.port[step - 1][1], r.jax[step - 1][1]
    assert set(got) == set(want)
    lr = r.config.learning_rate
    held = 0
    for k, w in want.items():
        diff = np.abs(got[k] - w)
        if ".mu." in k or ".nu." in k:
            group = k[:k.index(".", k.index("_opt.") + 5)]
            peak = max(np.abs(v).max() for n, v in want.items()
                       if n.startswith(group + "."))
            bar = 1e-4 * peak
        elif k.endswith(("running_mean", "running_var")):
            bar = 1e-5 + lr * (step - 1)
        elif k in ("step", "rng") or k.endswith(".count"):
            bar = 0.0
        else:
            keep = _kept(r, k, step)
            if keep is None:
                continue
            diff = diff[keep]
            held += diff.size
            bar = 1e-6 + 0.05 * lr * step
        err = float(diff.max()) if diff.size else 0.0
        assert err <= bar, (k, err, bar)
    # The rule leaves out a few leaves and elements, not the parameters.
    total = sum(want[k].size for k in want if k.split(".", 1)[0]
                in ("g", "d_obj", "d_img") and "running" not in k)
    assert held >= 0.9 * total, (held, total)
    if mode != "legacy":  # a train-mode step moves every BatchNorm
        stats = [k for k in want if k.endswith("running_mean")]
        assert any(k.startswith("d_obj.") for k in stats)
        assert all(not np.array_equal(r.port[0][1][k], _flat(r.init)[k])
                   for k in stats)


def test_step_writes_nothing_into_its_input_and_leaves_no_grads(runs):
    """A step returns a new state: the one given is untouched, no tensor
    of either needs a gradient or holds one (G's gradients were taken
    with autograd.grad on G's parameters only)."""
    r = runs("packed")
    init = _flat(r.trainer.init_state(seed=0))
    for k, v in _flat(r.init).items():
        np.testing.assert_array_equal(v, init[k], err_msg=k)
    for t in list(tensors(r.init).values()) + list(tensors(r.last).values()):
        assert not t.requires_grad and t.grad is None
    assert int(r.last.step) == 2


def test_zero_weight_losses_give_zero_gradients(runs):
    """mask_net (mask_loss_weight 0) and rel_aux_net (predicate weight 0)
    lie outside the loss: zero gradients, so zero moments, unchanged
    parameters, while the count advances for all, as in the JAX step."""
    kw = dict(TINY, mask_loss_weight=0.0)
    tr = Trainer(TrainConfig(**kw), VOCAB, device="cpu")
    s0 = tr.init_state(seed=1)
    s1, _ = tr.step(s0, _rand_batch(np.random.RandomState(1),
                                    JaxConfig(**kw)))
    assert int(s1.g_opt.count) == 1
    for head in ("mask_net.", "rel_aux_net."):
        names = [k for k in s1.g_opt.mu if k.startswith(head)]
        assert names
        for k in names:
            assert not s1.g_opt.mu[k].any() and not s1.g_opt.nu[k].any()
            assert torch.equal(s1.g[k], s0.g[k])
    assert not torch.equal(s1.g["box_net.0.weight"], s0.g["box_net.0.weight"])


def test_skippable_adam_matches_optax():
    """SkippableAdam and apply_updates against optax.adam and
    optax.apply_updates on good steps, in optax's operation order; a
    skipped step is an exact no-op."""
    import optax

    rng = np.random.RandomState(0)
    params = {"w": (np.arange(6, dtype=np.float32).reshape(2, 3) / 7.0),
              "b": np.full((1,), -0.3, np.float32)}
    ref = optax.adam(1e-2, b1=0.9, b2=0.999, eps=1e-8)
    mine = SkippableAdam(1e-2)
    s_ref = ref.init(jax.tree.map(jnp.asarray, params))
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    s_mine = mine.init(tp)
    jp = jax.tree.map(jnp.asarray, params)
    for _ in range(5):
        grads = {k: rng.randn(*v.shape).astype(np.float32)
                 for k, v in params.items()}
        u_ref, s_ref = ref.update(jax.tree.map(jnp.asarray, grads), s_ref, jp)
        jp = optax.apply_updates(jp, u_ref)
        u, s_mine = mine.update({k: torch.from_numpy(v) for k, v in
                                 grads.items()}, s_mine, torch.tensor(True))
        tp = apply_updates(tp, u)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=1e-7)
            np.testing.assert_allclose(u[k].numpy(), np.asarray(u_ref[k]),
                                       rtol=0, atol=1e-7)
            np.testing.assert_allclose(s_mine.mu[k].numpy(),
                                       np.asarray(s_ref[0].mu[k]), atol=1e-7)
            np.testing.assert_allclose(s_mine.nu[k].numpy(),
                                       np.asarray(s_ref[0].nu[k]), atol=1e-7)
        assert int(s_mine.count) == int(s_ref[0].count)
    bad = {"w": torch.full((2, 3), float("nan")),
           "b": torch.tensor([float("inf")])}
    good = all_finite(bad.values())
    assert not bool(good)
    u, s_skip = mine.update(bad, s_mine, good)
    assert all(not v.any() for v in u.values())
    assert int(s_skip.count) == int(s_mine.count)
    for k in params:
        assert torch.equal(s_skip.mu[k], s_mine.mu[k])
        assert torch.equal(s_skip.nu[k], s_mine.nu[k])
    assert bool(all_finite([torch.ones(3), torch.full((2,), 3e38)]))
    for bad in (float("nan"), float("inf"), -float("inf")):
        t = torch.ones(4, 5)
        t[2, 3] = bad
        assert not bool(all_finite([torch.ones(2), t]))


def _snapshot(state):
    return {k: v.clone() for k, v in tensors(state).items() if k != "step"}


def _skipped(before, after):
    """``after`` is ``before`` bit for bit but for the key, which a skipped
    step splits all the same (as the JAX step does)."""
    before, after = dict(before), dict(after)
    assert torch.equal(after.pop("rng"), split(before.pop("rng"))[0])
    return _same(before, after)


def _same(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("mode", ["legacy", "packed"])
def test_nan_batch_is_a_bitexact_noop_and_recovers(mode):
    """One NaN image: every parameter, moment, count and BatchNorm buffer
    of the three models stays bit-identical, the step advances, and the
    next good step trains normally."""
    cfg = TrainConfig(**MODES[mode])
    tr = Trainer(cfg, VOCAB, device="cpu")
    batch = _rand_batch(np.random.RandomState(3), JaxConfig(**MODES[mode]))
    state, _ = tr.step(tr.init_state(seed=0), dict(batch))
    before = _snapshot(state)
    bad = dict(batch, imgs=batch["imgs"].copy())
    bad["imgs"][0, 0, 0, 0] = np.nan
    state2, m = tr.step(state, bad)
    assert bool(m["skipped_nonfinite"])
    assert int(state2.step) == 2
    assert _skipped(before, _snapshot(state2))
    state3, m3 = tr.step(state2, dict(batch))
    assert not bool(m3["skipped_nonfinite"])
    assert np.isfinite(float(m3["total_loss"]))
    after = _snapshot(state3)
    assert not torch.equal(after["g.box_net.0.weight"],
                           before["g.box_net.0.weight"])
    assert int(state3.g_opt.count) == 2


def test_nonfinite_gradients_skip_the_step(monkeypatch):
    """A finite loss whose gradients are not finite skips the update: an
    inf planted into G's gradients through the loss's backward."""
    from sg2im_tpu_torch.train import step as step_mod

    real_grads = step_mod._grads
    calls = []

    def poisoned(total, leaves):
        grads = real_grads(total, leaves)
        if not calls:  # G's gradients, the first call of the step
            k = next(iter(grads))
            grads[k] = grads[k] + float("inf")
        calls.append(1)
        return grads

    monkeypatch.setattr(step_mod, "_grads", poisoned)
    tr = Trainer(TrainConfig(**TINY), VOCAB, device="cpu")
    state = tr.init_state(seed=0)
    before = _snapshot(state)
    state2, m = tr.step(state, _rand_batch(np.random.RandomState(4),
                                           JaxConfig(**TINY)))
    assert np.isfinite(float(m["total_loss"]))
    assert bool(m["skipped_nonfinite"])
    assert _skipped(before, _snapshot(state2))


def test_eval_mode_after_freezes_g_batchnorm_and_resets_optimizer():
    cfg = TrainConfig(**dict(TINY, eval_mode_after=2,
                             d_img_arch="C3-8-2,C3-8-1"))
    tr = Trainer(cfg, VOCAB, device="cpu")
    batch = _rand_batch(np.random.RandomState(2), JaxConfig(**TINY))
    state = tr.init_state(seed=0)
    for _ in range(2):
        assert not tr.eval_mode()
        state, _ = tr.step(state, dict(batch))
    assert tr.eval_mode()
    state = tr.reset_g_optimizer(state)
    assert int(state.g_opt.count) == 0
    assert all(not v.any() for v in state.g_opt.mu.values())
    stats = {k: v.clone() for k, v in state.g.items() if "running" in k}
    d_stats = {k: v.clone() for k, v in state.d_img.items()
               if "running" in k}
    state, m = tr.step(state, dict(batch))
    assert np.isfinite(float(m["total_loss"]))
    assert stats and all(torch.equal(state.g[k], v) for k, v in stats.items())
    assert int(state.g_opt.count) == 1
    # D stays in train mode: its statistics move.
    assert d_stats and all(not torch.equal(state.d_img[k], v)
                           for k, v in d_stats.items())


def test_negative_eval_mode_after_never_switches():
    cfg = TrainConfig(**dict(TINY, eval_mode_after=-1))
    tr = Trainer(cfg, VOCAB, device="cpu")
    state = tr.init_state(seed=0)
    tr._host_step = 10 ** 9
    assert not tr.eval_mode()
    before = {k: v.clone() for k, v in state.g.items() if "running" in k}
    state, _ = tr.step(state, _rand_batch(np.random.RandomState(7),
                                          JaxConfig(**TINY)))
    assert any(not torch.equal(state.g[k], v) for k, v in before.items())


def test_d_clip_bounds_discriminator_parameters():
    kw = dict(TINY, gan_loss_type="wgan", d_clip=0.01)
    tr = Trainer(TrainConfig(**kw), VOCAB, device="cpu")
    state = tr.init_state(seed=0)
    rng = np.random.RandomState(2)
    g_before = state.g["box_net.0.weight"].clone()
    for _ in range(2):
        state, m = tr.step(state, _rand_batch(rng, JaxConfig(**kw)))
        assert np.isfinite(float(m["total_loss"]))
    for name, module in (("d_obj", tr.d_obj), ("d_img", tr.d_img)):
        for k, _ in module.named_parameters():
            assert float(getattr(state, name)[k].abs().max()) <= 0.01
    assert float(state.g["box_net.0.weight"].abs().max()) > 0.01
    assert not torch.equal(state.g["box_net.0.weight"], g_before)


@pytest.mark.parametrize("gan_type", ["gan", "wgan", "lsgan"])
def test_gan_types_train(gan_type):
    kw = dict(TINY, gan_loss_type=gan_type)
    tr = Trainer(TrainConfig(**kw), VOCAB, device="cpu")
    state = tr.init_state(seed=0)
    batch = _rand_batch(np.random.RandomState(5), JaxConfig(**kw))
    for _ in range(2):
        state, m = tr.step(state, dict(batch))
        assert np.isfinite(float(m["total_loss"])), m
    assert {"d_obj_gan_loss", "d_img_gan_loss", "g_gan_obj_loss",
            "g_gan_img_loss"} <= set(m)
    assert not bool(m["skipped_nonfinite"])


def test_bf16_compute_keeps_batchnorm_statistics_f32():
    """The fast configuration (bf16, 'split'): the CRN runs in bf16, the
    BatchNorm statistics and every parameter and moment stay f32, and the
    losses stay near the f32 step's."""
    kw = dict(VARIANT, crn_mode="split")
    batch = _rand_batch(np.random.RandomState(0), JaxConfig(**kw))
    losses = {}
    for bf16 in (False, True):
        tr = Trainer(TrainConfig(**dict(kw, bf16_compute=bf16)), VOCAB,
                     device="cpu")
        if bf16:
            assert tr.generator.compute_dtype == torch.bfloat16
        state, m = tr.step(tr.init_state(seed=0), dict(batch))
        losses[bf16] = float(m["total_loss"])
        assert all(v.dtype == torch.float32
                   for v in tensors(state).values() if v.is_floating_point())
        assert all(torch.isfinite(v).all() for k, v in state.g.items()
                   if "running" in k)
    np.testing.assert_allclose(losses[True], losses[False], rtol=2e-2)


@pytest.mark.parametrize("wait", [True, False], ids=["sync", "async"])
def test_save_and_resume_gives_the_same_next_step(tmp_path, wait):
    """A native save after a step, loaded into a fresh Trainer, takes the
    same next step as the uninterrupted run, the layout noise included
    (drawn from the restored key)."""
    kw = dict(VARIANT, crn_mode="packed")
    cfg = TrainConfig(**kw)
    batch = _rand_batch(np.random.RandomState(8), JaxConfig(**kw))
    tr = Trainer(cfg, VOCAB, device="cpu")
    state, _ = tr.step(tr.init_state(seed=3), dict(batch))
    path = os.path.join(tmp_path, "ckpt")
    tr.save_checkpoint(state, path, extra={"t": 1},
                       arrays={"losses": np.arange(3.0)}, wait=wait)
    cont, m_cont = tr.step(state, dict(batch))
    tr2 = Trainer(cfg, VOCAB, device="cpu")
    restored, meta = tr2.load_checkpoint(path)
    assert meta["extra"] == {"t": 1} and meta["config"]["crn_mode"] == "packed"
    np.testing.assert_array_equal(meta["arrays"]["losses"], np.arange(3.0))
    assert _same(_snapshot(state), _snapshot(restored))
    assert torch.equal(restored.rng, state.rng)
    res, m_res = tr2.step(restored, dict(batch))
    for k in m_cont:
        assert float(m_cont[k]) == float(m_res[k]), k
    assert _same(_snapshot(cont), _snapshot(res))
    store.wait_pending()


def test_check_model_matches_jax():
    """check_model's mean losses and IoU against the JAX Trainer's on the
    same carried weights and batches, with the layout noise of each batch
    drawn from the splits of PRNGKey(step) on both sides."""
    kw = dict(TINY, predicate_pred_loss_weight=0.5, layout_noise_dim=4)
    tr = Trainer(TrainConfig(**kw), VOCAB, device="cpu")
    jt = JaxTrainer(JaxConfig(**kw), VOCAB)
    state, _ = tr.step(tr.init_state(seed=0),
                       _rand_batch(np.random.RandomState(9), JaxConfig(**kw)))
    rng = np.random.RandomState(10)
    batches = [_rand_batch(rng, JaxConfig(**kw)) for _ in range(2)]
    js = _jax_state(jt, state)
    want_losses, want_iou = jt.check_model(js, batches)
    got_losses, got_iou = tr.check_model(state, batches)
    assert set(got_losses) == set(want_losses)
    for k in want_losses:
        np.testing.assert_allclose(got_losses[k], want_losses[k],
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL, err_msg=k)
    np.testing.assert_allclose(got_iou, want_iou, rtol=1e-5, atol=1e-6)
    assert 0.0 <= got_iou <= 1.0


def test_trainer_refuses_data_parallel():
    """data_parallel > 1 without a process group of that size."""
    with pytest.raises(RuntimeError, match="torch.distributed group"):
        Trainer(TrainConfig(**dict(TINY, data_parallel=2)), VOCAB,
                device="cpu")
