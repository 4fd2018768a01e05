"""The port's training CLI (``sg2im_tpu_torch.cli.train``) and the Trainer
methods it calls, against the JAX package's on the CPU.

The runs use ``tests/test_cli.py``'s tiny flags (16x16 images, narrow
widths) on ``tests/test_data.py``'s synthetic COCO fixture, with
``--device cpu``:

- the parser (every JAX flag, its default, choices and type, plus
  ``--device`` and ``--dist_backend``) and ``config_from_args``;
- a run checkpointed mid-epoch and resumed gives the losses of a run that
  was never stopped, bit for bit (``PaddedLoader.start_at``); its
  snapshot loads through the JAX package's ``convert_checkpoint`` with the
  port's weights; ``--timing`` and ``--profile_dir`` write their records;
- both CLIs from one reference-layout ``.pt`` with both discriminators'
  states, at ``--layout_noise_dim 0`` (no noise stream to differ): their
  ``log.jsonl`` losses over the first two printed steps agree within
  2e-4 relative, 2e-5 absolute (``tests/test_torch_train_step.py``'s
  bars);
- ``check_model(return_samples=True)`` gives the JAX method's keys, shapes
  and types, its triptych images agree with the JAX Trainer's within the
  generator parity bar of ``tests/test_torch_generator.py`` (1e-4), and
  the step's ``phase_fns`` give the JAX ones' fences within 2e-4 without
  changing the state.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from sg2im_tpu.cli import train as jax_cli
from sg2im_tpu.ckpt.torch_convert import convert_checkpoint
from sg2im_tpu.train.config import TrainConfig as JaxConfig
from sg2im_tpu.train.trainer import Trainer as JaxTrainer
from sg2im_tpu_torch.ckpt import load_reference_bundle, state_dict_from_jax
from sg2im_tpu_torch.ckpt.store import load_checkpoint
from sg2im_tpu_torch.cli import train as cli
from sg2im_tpu_torch.data.loader import PaddedLoader
from sg2im_tpu_torch.train.state import tensors
from sg2im_tpu_torch.train.trainer import Trainer
from test_cli import TINY_FLAGS
from test_data import _fake_coco, _fake_vg
from test_torch_train_step import LOSS_ATOL, LOSS_RTOL, _jax_state

CONV = 1e-4  # tests/test_torch_generator.py's bar for conv outputs


def _coco_flags(root):
    img_dir, inst, stuff = _fake_coco(str(root))
    return TINY_FLAGS + [
        "--coco_train_image_dir", img_dir, "--coco_val_image_dir", img_dir,
        "--coco_train_instances_json", inst,
        "--coco_val_instances_json", inst,
        "--coco_train_stuff_json", stuff, "--coco_val_stuff_json", stuff]


def _records(out_dir, kind="train"):
    with open(os.path.join(out_dir, "log.jsonl")) as f:
        return {r["t"]: r for r in map(json.loads, f) if r["kind"] == kind}


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_parser_has_every_jax_flag_with_its_default():
    port = _actions(cli.build_parser())
    ref = _actions(jax_cli.build_parser())
    assert set(port) - set(ref) == {"device", "dist_backend"}
    assert set(ref) <= set(port)
    for dest, a in ref.items():
        b = port[dest]
        assert b.option_strings == a.option_strings, dest
        assert b.default == a.default, dest
        assert b.choices == a.choices, dest
        assert getattr(b.type, "__name__", b.type) == \
            getattr(a.type, "__name__", a.type), dest
    assert port["device"].default == "cuda"


@pytest.mark.parametrize("argv", [
    [],
    ["--dataset", "vg"],
    ["--dataset", "vg", "--max_objects_per_image", "6", "--pad_objects_to",
     "12"],
    ["--image_size", "128,128", "--pad_triples_to", "40",
     "--instance_whitelist", "cat,dog", "--bf16_compute", "1",
     "--crn_mode", "split", "--d_clip", "0.5", "--cache_dir", "c"],
])
def test_config_from_args_matches_jax(argv):
    port = cli.config_from_args(cli.build_parser().parse_args(argv))
    ref = jax_cli.config_from_args(jax_cli.build_parser().parse_args(argv))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("argv", [["--multihost", "true",
                                   "--data_parallel", "2"],
                                  ["--data_parallel", "2",
                                   "--batch_size", "3"]])
def test_multihost_and_data_parallel_name_item_12(argv):
    """The launch refusals of the data-parallel flags (the test's name is
    older than them): --multihost joins a group, --data_parallel starts
    one, and the global batch must split over the ranks."""
    match = "give one" if argv[0] == "--multihost" else "must divide"
    with pytest.raises(SystemExit, match=match):
        cli.main(argv + ["--device", "cpu"])


@pytest.fixture(scope="module")
def resumed_runs(tmp_path_factory):
    """An uninterrupted 5-step run and one stopped at step 3 (mid-epoch:
    the fixture's 4 images make 2 batches an epoch; its checkpoint
    written asynchronously) and resumed to 5."""
    root = tmp_path_factory.mktemp("cli")
    flags = _coco_flags(root) + [
        "--device", "cpu", "--checkpoint_every", "3", "--snapshot_every",
        "3"]
    full = str(root / "full")
    assert cli.main(flags + ["--num_iterations", "5", "--output_dir", full,
                             "--timing", "true", "--profile_dir",
                             str(root / "prof")]) == 0
    part = str(root / "part")
    assert cli.main(flags + ["--num_iterations", "3", "--output_dir",
                             part, "--async_checkpoint", "true"]) == 0
    assert cli.main(flags + ["--num_iterations", "5", "--output_dir", part,
                             "--restore_from_checkpoint", "true"]) == 0
    return root, full, part


def test_resume_gives_the_uninterrupted_losses(resumed_runs):
    _, full, part = resumed_runs
    want, got = _records(full), _records(part)
    assert sorted(want) == sorted(got) == [1, 2, 3, 4, 5]
    for t in (4, 5):
        assert got[t] == want[t], t
    assert _records(full, "eval") == _records(part, "eval")
    assert want[4]["total_loss"] != want[2]["total_loss"]
    state, meta = load_checkpoint(os.path.join(part, "checkpoint_state"))
    assert int(state.step) == 3
    assert meta["extra"]["checkpoint_ts"] == [3]
    arrays = cli.unflatten_samples(meta["arrays"])
    assert [len(arrays[k]) for k in cli.SAMPLE_KINDS] == [1, 1, 1, 1]
    for key in ("gt_img", "gt_box_gt_mask", "gt_box_pred_mask",
                "pred_box_pred_mask"):
        img = arrays["val_samples"][0][key]
        assert img.dtype == np.uint8 and img.shape == (2, 16, 16, 3)


def test_timing_and_profile_records(resumed_runs):
    root, full, _ = resumed_runs
    timing = _records(full, "timing")
    assert sorted(timing) == [1, 2, 3, 4, 5]
    for rec in timing.values():
        assert rec["step_ms"] > 0 and rec["iter_ms"] >= rec["step_ms"]
        assert rec["loader_wait_ms"] >= 0
    # The first step waits for the loader's first batch.
    assert timing[1]["loader_wait_ms"] > 0
    with open(root / "prof" / "trace.json") as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "train_step" in names


def test_snapshot_loads_in_the_jax_package_with_the_ports_weights(
        resumed_runs):
    _, full, _ = resumed_runs
    snap = os.path.join(full, "snapshot_0000003.pt")
    bundle = convert_checkpoint(snap)
    assert "compute_dtype" not in bundle["model_kwargs"]
    assert "crn_mode" not in bundle["model_kwargs"]
    state, _ = load_checkpoint(os.path.join(full, "checkpoint_state"))
    assert int(state.step) == 3
    got = state_dict_from_jax(bundle["generator"])
    assert set(got) <= set(state.g)
    for k, v in got.items():
        assert torch.equal(v, state.g[k]), k
    ours = load_reference_bundle(snap)
    assert ours["d_obj"] is None and ours["d_img"] is None
    assert set(ours["generator"]) == set(state.g)


def test_vg_through_the_cli(tmp_path, capsys):
    vocab, h5_path, img_dir = _fake_vg(str(tmp_path))
    vocab_json = os.path.join(tmp_path, "vocab.json")
    with open(vocab_json, "w") as f:
        json.dump(vocab, f)
    out_dir = os.path.join(tmp_path, "vgrun")
    flags = TINY_FLAGS + [
        "--dataset", "vg", "--train_h5", h5_path, "--val_h5", h5_path,
        "--vocab_json", vocab_json, "--vg_image_dir", img_dir,
        "--max_objects_per_image", "6", "--num_iterations", "2",
        "--checkpoint_every", "2", "--output_dir", out_dir, "--device", "cpu",
        "--decoder", "pil", "--eval_mode_after", "1"]
    assert cli.main(flags) == 0
    out = capsys.readouterr().out
    assert "t = 2 / 2" in out and "val iou:" in out
    assert out.count("switching to eval mode") == 1
    assert "Image decoder: pil (--decoder pil)" in out
    assert os.path.exists(os.path.join(out_dir, "checkpoint_state",
                                       "state.pt"))


def _warm_start_file(root, flags):
    """A reference-layout .pt from the port's seeded init: the generator
    and both discriminators with their kwargs."""
    args = cli.build_parser().parse_args(flags)
    config = cli.config_from_args(args)
    vocab, _, _ = cli.build_datasets(config)
    state = Trainer(config, vocab, device="cpu").init_state(seed=4)
    kw = dict(config.generator_kwargs(), vocab=vocab)
    path = os.path.join(root, "warm.pt")
    torch.save({"model_state": state.g, "model_kwargs": kw,
                "d_obj_state": state.d_obj,
                "d_obj_kwargs": config.d_obj_kwargs(),
                "d_img_state": state.d_img,
                "d_img_kwargs": config.d_img_kwargs(), "args": {}}, path)
    return path, state


def test_both_clis_from_one_warm_start_agree(tmp_path):
    flags = _coco_flags(tmp_path) + [
        "--layout_noise_dim", "0", "--num_iterations", "2",
        "--print_every", "1", "--checkpoint_every", "100"]
    warm, init = _warm_start_file(tmp_path, flags)
    bundle = load_reference_bundle(warm)
    for name in ("d_obj", "d_img"):
        assert all(torch.equal(v, getattr(init, name)[k])
                   for k, v in bundle[name].items())
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    assert cli.main(flags + ["--checkpoint_start_from", warm,
                             "--output_dir", port_dir,
                             "--device", "cpu"]) == 0
    assert jax_cli.main(flags + ["--checkpoint_start_from", warm,
                                 "--output_dir", jax_dir]) == 0
    got, want = _records(port_dir), _records(jax_dir)
    assert sorted(got) == sorted(want) == [1, 2]
    for t in (1, 2):
        assert set(got[t]) == set(want[t])
        for k in sorted(set(want[t]) - {"kind"}):
            np.testing.assert_allclose(got[t][k], want[t][k], rtol=LOSS_RTOL,
                                       atol=LOSS_ATOL, err_msg=f"{t} {k}")


@pytest.fixture(scope="module")
def eval_pair(tmp_path_factory):
    """The port's and the JAX package's Trainers on one state (one port
    step from the seeded init, carried across), with loader batches."""
    root = tmp_path_factory.mktemp("eval")
    flags = _coco_flags(root) + ["--layout_noise_dim", "0",
                                 "--mlp_normalization", "batch"]
    config = cli.config_from_args(cli.build_parser().parse_args(flags))
    vocab, train_ds, _ = cli.build_datasets(config)
    batches = list(PaddedLoader(train_ds, batch_size=2,
                                O_max=config.pad_objects_to,
                                T_max=config.pad_triples_to, num_workers=1))
    tr = Trainer(config, vocab, device="cpu")
    state, _ = tr.step(tr.init_state(seed=1), batches[0])
    jt = JaxTrainer(JaxConfig(**dataclasses.asdict(config)), vocab)
    return tr, state, jt, _jax_state(jt, state), batches


def test_check_model_samples_match_jax(eval_pair):
    tr, state, jt, js, batches = eval_pair
    got = tr.check_model(state, iter(batches), return_samples=True)
    want = jt.check_model(js, iter(batches), return_samples=True)
    assert len(got) == len(want) == 4
    for g, w in zip(got[1:3], want[1:3]):
        assert set(g) == set(w)
        for k in w:
            assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
    for k in want[0]:
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg=k)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[2]["boxes_pred"], want[2]["boxes_pred"],
                               atol=2e-5)
    # No batch swept: ({}, {}) as the JAX method gives.
    losses, samples, batch_data, iou = tr.check_model(
        state, iter(()), return_samples=True)
    assert (losses, samples, batch_data, iou) == ({}, {}, {}, 0.0)


def test_triptych_matches_jax(eval_pair):
    tr, state, jt, js, batches = eval_pair
    for batch in batches:
        got = tr.sample_triptych(state, batch)
        want = jt.sample_triptych(js, batch)
        assert set(got) == set(want) == {
            "gt_img", "gt_box_gt_mask", "gt_box_pred_mask",
            "pred_box_pred_mask"}
        for k in want:
            np.testing.assert_allclose(
                got[k].permute(0, 2, 3, 1).numpy(), np.asarray(want[k]),
                atol=CONV, rtol=CONV, err_msg=k)


def test_phase_fns_match_jax_and_change_no_state(eval_pair):
    tr, state, jt, js, batches = eval_pair
    before = {k: v.clone() for k, v in tensors(state).items()}
    times = tr.step_breakdown(state, batches[1])
    assert list(times) == list(jt.train_step.phase_fns)
    assert all(ms > 0 for ms in times.values())
    for k, v in tensors(state).items():
        assert torch.equal(v, before[k]), k
    b = tr.to_device(batches[1])
    fakes, fence = tr.train_step.phase_fns["g_forward"](state, b, None)
    j_fakes, j_fence = jt.train_step.phase_fns["g_forward"](js, batches[1],
                                                            None)
    np.testing.assert_allclose(fakes.permute(0, 2, 3, 1).numpy(),
                               np.asarray(j_fakes), atol=CONV, rtol=CONV)
    fences = {"g_forward": (float(fence), float(j_fence))}
    fences["g_forward_backward"] = (
        float(tr.train_step.phase_fns["g_forward_backward"](state, b, None)),
        float(jt.train_step.phase_fns["g_forward_backward"](js, batches[1],
                                                            None)))
    for name in ("d_obj_step", "d_img_step"):
        fences[name] = (
            float(tr.train_step.phase_fns[name](state, b, fakes)),
            float(jt.train_step.phase_fns[name](js, batches[1], j_fakes)))
    for name, (g, w) in fences.items():
        np.testing.assert_allclose(g, w, rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                   err_msg=name)
    for k, v in tensors(state).items():
        assert torch.equal(v, before[k]), k


def test_timing_utils(capsys):
    from sg2im_tpu.utils.timing import LossManager as JaxLossManager
    from sg2im_tpu_torch.utils.timing import (
        LossManager,
        get_device_memory,
        timeit,
    )

    with timeit("block") as box:
        pass
    assert box["ms"] >= 0 and "block: " in capsys.readouterr().out
    with timeit("off", should_time=False) as box:
        pass
    assert box == {} and capsys.readouterr().out == ""
    if not torch.cuda.is_available():
        assert get_device_memory() == {}
    port, ref = LossManager(), JaxLossManager()
    for m in (port, ref):
        m.add_loss(torch.tensor(2.0), "a", 0.5)
        m.add_loss(torch.tensor(3.0), "b")
    assert dict(port.items()) == dict(ref.items()) == {"a": 1.0, "b": 3.0}
    assert float(port.total_loss) == float(ref.total_loss) == 4.0
