"""The port's checkpoint store in the JAX store's format, against the JAX
package on the CPU: a run crosses between the two systems both ways.

- ``sg2im_tpu_torch.ckpt.msgpack``, flax's wire format in plain Python and
  numpy: its reader equals ``flax.serialization.msgpack_restore`` leaf for
  leaf on the JAX ``Trainer.save_checkpoint`` output (``TINY`` and
  ``tests/test_torch_train_step.py``'s ``VARIANT``) and on a tree of every
  kind of leaf, flax's chunked arrays included; its writer gives flax's
  bytes, which flax reads back to an equal tree.
- JAX -> port: ``store.load_checkpoint`` of a directory the JAX package
  wrote is bit-equal to ``train_state_from_jax`` of the JAX state, and one
  port step from it matches one JAX step within
  ``tests/test_torch_train_step.py``'s bars (2e-4 relative, 2e-5
  absolute).
- port -> JAX: ``save_checkpoint(..., backend='msgpack')`` writes what the
  JAX package's ``load_checkpoint`` restores against its own
  ``init_state``, bit-equal, the threefry key included: the key crosses
  both ways unchanged.
- The CLIs both ways (``tests/test_cli.py``'s tiny flags on the synthetic
  COCO, layout noise on at its ``--layout_noise_dim 4``): the port's CLI
  resumes a JAX CLI run's directory, continues its noise stream from the
  checkpoint's key, and gives the losses of a JAX run that was never
  stopped and never checkpointed (the JAX CLI's own resume restarts its
  loader at the first epoch, and its train-set check at a checkpoint moves
  its training loader to the next epoch, so either JAX run trains on other
  batches after step 4); the port keeps writing ``state.msgpack``, which
  the JAX CLI resumes; the histories survive both hops.
  ``checkpoint_tools export`` of a JAX directory gives the JAX package's
  own export; Orbax-only and empty directories are refused.
- ``tests/fixtures/jax_ckpt_tiny/``, the JAX-written checkpoint that
  ``chip_smoke.py`` resumes on the card: :func:`make_fixture` makes it
  again with the JAX package and it equals the committed files (arrays to
  1e-6); the port's CPU step on it gives its expected losses.
"""

import copy
import json
import os
import shutil

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sg2im_tpu.ckpt import store as jax_store
from sg2im_tpu.cli import checkpoint_tools as jax_tools
from sg2im_tpu.cli import train as jax_cli
from sg2im_tpu.train.config import TrainConfig as JaxConfig
from sg2im_tpu.train.trainer import Trainer as JaxTrainer
from sg2im_tpu_torch.ckpt import (
    jax_tree_from_train_state,
    state_dict_from_jax,
    train_state_from_jax,
)
from sg2im_tpu_torch.ckpt import store
from sg2im_tpu_torch.ckpt.msgpack import msgpack_restore, msgpack_serialize
from sg2im_tpu_torch.cli import checkpoint_tools as tools
from sg2im_tpu_torch.cli import sample_images
from sg2im_tpu_torch.cli import train as cli
from sg2im_tpu_torch.train.config import TrainConfig
from sg2im_tpu_torch.train.state import tensors
from sg2im_tpu_torch.train.trainer import Trainer
from test_torch_train_cli import _coco_flags, _records
from test_torch_train_step import LOSS_ATOL, LOSS_RTOL, VARIANT
from test_train import TINY, VOCAB, _rand_batch

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "jax_ckpt_tiny")
FIXTURE_TOL = 1e-6  # a regenerated fixture against the committed one
CONFIGS = {"tiny": TINY, "variant": VARIANT}


def _same_tree(got, want, path=""):
    """``got`` (the port's reader) leaf for leaf against ``want`` (flax's):
    the same keys in the same order, arrays of the same dtype, shape and
    bits (a numpy scalar of flax's is a 0-d array here), other leaves of
    the same type and value."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _same_tree(a, b, f"{path}/{i}")
    elif getattr(want, "dtype", None) == jnp.bfloat16:
        assert isinstance(got, torch.Tensor), path
        assert got.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy(),
            np.asarray(want).view(np.int16), err_msg=path)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == np.shape(want), path
        assert got.flags.writeable, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def _same_state(got, want):
    a, b = tensors(got), tensors(want)
    assert set(a) == set(b)
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k].cpu(), b[k].cpu()), k


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _perturbed(state, seed):
    """A JAX TrainState whose counters, moments and key are not an
    init's: every optimizer count 3, the moments random, step 5."""
    rng = np.random.RandomState(seed)

    def opt(o):
        adam = o[0]
        rand = jax.tree.map(lambda x: rng.randn(*x.shape).astype(np.float32),
                            adam.mu)
        sq = jax.tree.map(lambda x: rng.rand(*x.shape).astype(np.float32),
                          adam.nu)
        return (adam._replace(count=jnp.asarray(3, jnp.int32), mu=rand,
                              nu=sq),) + tuple(o[1:])

    return state.replace(step=jnp.asarray(5, jnp.int32),
                         rng=jax.random.PRNGKey(seed),
                         g_opt=opt(state.g_opt),
                         d_obj_opt=opt(state.d_obj_opt),
                         d_img_opt=opt(state.d_img_opt))


class _Jax:
    """One configuration's JAX Trainer and a state it saved at ``path``."""

    def __init__(self, name, path):
        self.config = JaxConfig(**CONFIGS[name])
        self.trainer = JaxTrainer(self.config, VOCAB)
        # On the host: the JAX step donates the state it is given.
        self.init = jax.device_get(self.trainer.init_state(seed=0))
        if name == "tiny":  # one real step: the fixture's state
            batch = _rand_batch(np.random.RandomState(0), self.config)
            self.state = jax.device_get(self.trainer.step(self.init,
                                                          batch)[0])
        else:
            self.state = jax.device_get(_perturbed(self.init, seed=3))
        self.path = path
        self.arrays = {"train_samples": [
            {"gt_img": np.full((2, 4, 4, 3), 7, np.uint8)},
            {"gt_img": np.zeros((2, 4, 4, 3), np.uint8)}],
            "val_batch_data": [{"objs": np.arange(6, dtype=np.int32)}],
            "val_samples": []}
        self.extra = {"checkpoint_ts": [1], "losses": {"L1_pixel_loss": [
            0.5]}}
        self.trainer.save_checkpoint(self.state, self.path, extra=self.extra,
                                     arrays=self.arrays)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    root = tmp_path_factory.mktemp("jaxckpt")
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _Jax(name, str(root / name))
        return cache[name]
    return get


# -- the codec ----------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("file", ["state.msgpack", "history.msgpack"])
def test_reader_equals_flax_on_the_jax_stores_files(saved, name, file):
    data = _read(os.path.join(saved(name).path, file))
    _same_tree(msgpack_restore(data), fser.msgpack_restore(data))


def _edge_tree():
    rng = np.random.RandomState(0)
    return {
        "scalar_f32": np.float32(2.5), "scalar_u32": np.uint32(7),
        "scalar_bool": np.bool_(True), "zero_d": np.zeros((), np.int32),
        "nil": None, "empty": {}, "true": True, "false": False,
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
                 2**63, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
                 -2**31 - 1, -2**63],
        "float": 1.5, "complex": 1 - 2j, "bytes": b"\x00\x01" * 200,
        "str": {"fix": "x" * 31, "s8": "y" * 200, "s16": "z" * 70000,
                "utf8": "π"},
        "wide_map": {f"k{i:02d}": np.full((i % 3,), i, np.float64)
                     for i in range(20)},
        "long_list": list(range(20)),
        "big": rng.randn(300, 300).astype(np.float32),
        "dtypes": {str(t): (rng.randn(3, 2) * 100).astype(t)
                   for t in (np.float16, np.float64, np.int8, np.uint8,
                             np.int16, np.uint16, np.int64, np.bool_)},
        "empty_array": np.zeros((2, 0, 3), np.float32),
        "bf16": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3) / 3,
    }


def test_reader_on_every_kind_of_leaf_and_chunked_arrays(monkeypatch):
    """flax's chunked arrays, made by lowering flax's MAX_CHUNK_SIZE for
    the write (the port's reader needs no limit)."""
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 4096)
    tree = _edge_tree()
    tree["nested"] = {"chunked": tree["big"], "inner": {"too": tree["big"]}}
    data = fser.msgpack_serialize(tree)
    assert data.count(b"__msgpack_chunked_array__") == 3
    got, want = msgpack_restore(data), fser.msgpack_restore(data)
    _same_tree(got, want)
    np.testing.assert_array_equal(got["nested"]["chunked"], tree["big"])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_writer_gives_flaxs_bytes_on_the_jax_state(saved, name):
    tree = fser.msgpack_restore(_read(os.path.join(saved(name).path,
                                                   "state.msgpack")))
    data = msgpack_serialize(tree)
    assert data == fser.msgpack_serialize(copy.deepcopy(tree), in_place=True)
    assert data == _read(os.path.join(saved(name).path, "state.msgpack"))


def test_writer_on_every_kind_of_leaf():
    tree = _edge_tree()
    tree["bf16"] = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3) / 3
    tree["strided"] = np.arange(24, dtype=np.int32).reshape(4, 6)[:, ::2]
    tree["torch_f32"] = torch.linspace(0, 1, 5)
    data = msgpack_serialize(tree)
    want = dict(tree, bf16=np.asarray(jnp.asarray(tree["bf16"].float(),
                                                  jnp.bfloat16)),
                strided=np.ascontiguousarray(tree["strided"]),
                torch_f32=tree["torch_f32"].numpy())
    assert data == fser.msgpack_serialize(want, in_place=True)
    _same_tree(msgpack_restore(data), fser.msgpack_restore(data))


@pytest.mark.parametrize("data, match", [
    (b"\x92\x01", "truncated"), (b"\xc1", "unknown marker"),
    (b"\x01\x02", "bytes after"), (b"\xd4\x05\x00", "ext type 5"),
    (b"\xc7\x02\x01\x92\x90", "not a 3-array")])
def test_reader_refuses_malformed_bytes(data, match):
    with pytest.raises(ValueError, match=match):
        msgpack_restore(data)


# -- JAX -> port --------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_jax_checkpoint_loads_bit_equal(saved, name):
    j = saved(name)
    state, meta = store.load_checkpoint(j.path)
    _same_state(state, train_state_from_jax(j.state))
    assert int(state.step) == int(j.state.step)
    assert meta["vocab"] == VOCAB and meta["extra"] == j.extra
    assert TrainConfig.from_dict(meta["config"]) == TrainConfig(
        **CONFIGS[name])
    assert sorted(meta["arrays"]) == ["train_samples/0/gt_img",
                                      "train_samples/1/gt_img",
                                      "val_batch_data/0/objs"]
    samples = cli.unflatten_samples(meta["arrays"])
    np.testing.assert_array_equal(samples["train_samples"][0]["gt_img"],
                                  j.arrays["train_samples"][0]["gt_img"])
    assert samples["val_samples"] == []


def test_noise_seed_is_the_keys_words(saved, tmp_path):
    """The JAX key crosses both ways unchanged: a JAX checkpoint's key is
    the loaded state's ``rng``, and the port's msgpack save writes it back
    as it is.  A ``state.pt`` from before the key (a generator state under
    ``noise_rng``) loads with the key of a fresh run of its seed and says
    so."""
    j = saved("tiny")  # its key is a split's: both words in use
    k = np.asarray(j.state.rng)
    assert k[0] != 0 and k[1] != 0
    state, meta = store.load_checkpoint(j.path)
    assert state.rng.dtype == torch.uint32
    np.testing.assert_array_equal(state.rng.numpy(), k)
    assert "rng_restarted" not in meta
    np.testing.assert_array_equal(jax_tree_from_train_state(state)["rng"], k)
    path = str(tmp_path / "again")
    store.save_checkpoint(path, state, backend="msgpack")
    again = msgpack_restore(_read(os.path.join(path, "state.msgpack")))
    np.testing.assert_array_equal(again["rng"], k)
    with pytest.raises(ValueError, match="shape"):
        train_state_from_jax({**fser.to_state_dict(j.state),
                              "rng": np.zeros(4, np.uint32)})
    old = str(tmp_path / "old")
    store.save_checkpoint(old, state, config=TrainConfig(**TINY, seed=5))
    flat = torch.load(os.path.join(old, "state.pt"), weights_only=True)
    flat["noise_rng"] = torch.Generator().manual_seed(5).get_state()
    del flat["rng"]
    torch.save(flat, os.path.join(old, "state.pt"))
    restarted, meta = store.load_checkpoint(old)
    assert meta["rng_restarted"] is True
    np.testing.assert_array_equal(
        restarted.rng.numpy(),
        np.asarray(jax.random.split(jax.random.PRNGKey(5), 5)[0]))


def _losses(metrics):
    return {k: float(v) for k, v in metrics.items()}


def test_port_step_from_jax_checkpoint_matches_jax_step(saved):
    j = saved("tiny")
    batch = _rand_batch(np.random.RandomState(1), j.config)
    _, want = j.trainer.step(j.state, dict(batch))
    trainer = Trainer(TrainConfig(**TINY), VOCAB, device="cpu")
    state, _ = trainer.load_checkpoint(j.path)
    _, got = trainer.step(state, dict(batch))
    got, want = _losses(got), _losses(want)
    assert set(got) == set(want) and want["skipped_nonfinite"] == 0.0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg=k)


# -- port -> JAX --------------------------------------------------------------

@pytest.fixture(scope="module")
def port_states():
    """Each configuration's port Trainer (seed 7) and its state after one
    port step: moments and counts that are not an init's."""
    out = {}
    for name, kw in CONFIGS.items():
        trainer = Trainer(TrainConfig(**kw, seed=7), VOCAB, device="cpu")
        batch = _rand_batch(np.random.RandomState(2), JaxConfig(**kw))
        state, _ = trainer.step(trainer.init_state(), batch)
        out[name] = trainer, state
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_port_checkpoint_restores_in_the_jax_package(saved, port_states,
                                                     tmp_path, name):
    j = saved(name)
    trainer, state = port_states[name]
    path = str(tmp_path / "ckpt")
    arrays = {"val_samples/0/img": np.ones((2, 4, 4, 3), np.uint8),
              "val_samples/1/img": np.zeros((2, 4, 4, 3), np.uint8)}
    trainer.save_checkpoint(state, path, extra={"checkpoint_ts": [1]},
                            arrays=arrays, backend="msgpack")
    assert sorted(os.listdir(path)) == ["history.msgpack", "meta.json",
                                        "state.msgpack"]
    restored, meta = j.trainer.load_checkpoint(path, j.init)
    _same_state(train_state_from_jax(jax.device_get(restored)), state)
    np.testing.assert_array_equal(np.asarray(restored.rng),
                                  state.rng.numpy())
    assert meta["extra"] == {"checkpoint_ts": [1]}
    assert [r["img"].min() for r in meta["arrays"]["val_samples"]] == [1, 0]
    assert meta["config"]["seed"] == 7
    # The tree is that of the JAX Trainer's init_state, key for key.
    want = jax.tree_util.tree_structure(fser.to_state_dict(j.init))
    got = jax_tree_from_train_state(state)
    assert jax.tree_util.tree_structure(got) == want


def test_restored_port_checkpoint_steps_in_the_jax_package(saved,
                                                           port_states,
                                                           tmp_path):
    """A JAX step from the port's checkpoint matches the port's step from
    its own state."""
    j = saved("tiny")
    trainer, state = port_states["tiny"]
    path = str(tmp_path / "ckpt")
    trainer.save_checkpoint(state, path, backend="msgpack")
    restored, _ = j.trainer.load_checkpoint(path, j.init)
    batch = _rand_batch(np.random.RandomState(5), j.config)
    _, want = j.trainer.step(restored, dict(batch))
    _, got = trainer.step(state, dict(batch))
    got, want = _losses(got), _losses(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg=k)


@pytest.mark.parametrize("wait", [True, False])
def test_backend_follows_the_directory(port_states, tmp_path, wait):
    """None keeps the format the directory holds ('torch' in a new one);
    writing one format removes the other's state and history; async
    writes of either format load back."""
    trainer, state = port_states["tiny"]
    path = str(tmp_path / "ckpt")
    arrays = {"val_samples/0/img": np.ones(3, np.uint8)}

    def save(backend=None):
        trainer.save_checkpoint(state, path, arrays=arrays, wait=wait,
                                backend=backend)
        store.wait_pending()
        return sorted(os.listdir(path))

    assert save() == ["history.npz", "meta.json", "state.pt"]
    assert save("msgpack") == ["history.msgpack", "meta.json",
                               "state.msgpack"]
    assert save() == ["history.msgpack", "meta.json", "state.msgpack"]
    loaded, meta = store.load_checkpoint(path)
    _same_state(loaded, state)
    assert list(meta["arrays"]) == list(arrays)
    assert save("torch") == ["history.npz", "meta.json", "state.pt"]
    loaded, _ = store.load_checkpoint(path)
    _same_state(loaded, state)
    os.makedirs(os.path.join(path, "state_orbax"))
    assert save("msgpack") == ["history.msgpack", "meta.json",
                               "state.msgpack"]
    with pytest.raises(ValueError, match="orbax"):
        save("orbax")


# -- refusals and the tools ---------------------------------------------------

def test_orbax_only_and_empty_directories_are_refused(tmp_path, capsys):
    orbax = tmp_path / "orbax"
    (orbax / "state_orbax").mkdir(parents=True)
    (orbax / "meta.json").write_text("{}")
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "notes.txt").write_text("")
    for path, match in ((orbax, r"Orbax checkpoint \(state_orbax/\).*"
                                r"msgpack backend"),
                        (empty, "no state.pt or state.msgpack; it holds "
                                "notes.txt"),
                        (tmp_path / "none", "no checkpoint directory")):
        with pytest.raises(ValueError, match=match):
            store.load_checkpoint(str(path))
        if path.exists():  # else sample_images reads a .pt
            with pytest.raises(SystemExit, match=match):
                sample_images.load_bundle(str(path))
        assert tools.main(["export", str(path), str(tmp_path / "x.pt")]) == 1
        assert "ERROR: not a checkpoint directory" in capsys.readouterr().out
        assert not os.path.exists(tmp_path / "x.pt")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_export_of_a_jax_directory_is_the_jax_packages(saved, tmp_path,
                                                       name):
    j = saved(name)
    mine, ref = str(tmp_path / "mine.pt"), str(tmp_path / "ref.pt")
    assert tools.main(["export", j.path, mine]) == 0
    assert jax_tools.main(["export", j.path, ref]) == 0
    a = torch.load(mine, weights_only=True)
    b = torch.load(ref, weights_only=False)
    assert a["model_kwargs"] == b["model_kwargs"] and a["args"] == b["args"]
    assert set(a["model_state"]) == set(b["model_state"])
    for k, v in b["model_state"].items():
        assert torch.equal(a["model_state"][k], v), k
    bundle = sample_images.load_bundle(j.path)
    want = state_dict_from_jax(j.state.g_vars)
    assert set(bundle["generator"]) == set(want)
    for k, v in want.items():
        assert torch.equal(bundle["generator"][k], v), k


# -- the CLIs both ways -------------------------------------------------------

@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The JAX CLI's 3-step run, checkpointed at t=3 (eval samples there),
    and its 5-step run that never checkpoints (the reference: the JAX CLI
    sweeps its training loader for the train-set check, which moves that
    loader to its next epoch, where the port's check has a loader of its
    own); the port's CLI resuming a copy of the first directory to t=5
    (checkpoint at 5); the JAX CLI resuming the port's directory to t=6."""
    root = tmp_path_factory.mktemp("clis")
    flags = _coco_flags(root) + ["--print_every", "1"]
    jax_dir, port_dir = str(root / "jax"), str(root / "port")
    ref_dir = str(root / "ref")
    assert jax_cli.main(flags + ["--num_iterations", "3", "--checkpoint_every",
                                 "3", "--output_dir", jax_dir]) == 0
    assert jax_cli.main(flags + ["--num_iterations", "5", "--checkpoint_every",
                                 "100", "--output_dir", ref_dir]) == 0
    ckpt = os.path.join(jax_dir, "checkpoint_state")
    with open(os.path.join(ckpt, "meta.json")) as f:
        vocab = json.load(f)["vocab"]
    config = jax_cli.config_from_args(jax_cli.build_parser().parse_args(flags))
    at3 = jax_store.load_checkpoint(
        ckpt, JaxTrainer(config, vocab).init_state())
    shutil.copytree(ckpt, os.path.join(port_dir, "checkpoint_state"))
    assert cli.main(flags + ["--num_iterations", "5", "--checkpoint_every",
                             "5", "--output_dir", port_dir, "--device", "cpu",
                             "--restore_from_checkpoint", "1"]) == 0
    after_port = store.load_checkpoint(
        os.path.join(port_dir, "checkpoint_state"))[1]
    back_dir = str(root / "back")
    shutil.copytree(port_dir, back_dir)
    assert jax_cli.main(flags + ["--num_iterations", "6", "--checkpoint_every",
                                 "3", "--output_dir", back_dir,
                                 "--restore_from_checkpoint", "1"]) == 0
    return {"jax": jax_dir, "ref": ref_dir, "port": port_dir,
            "back": back_dir, "at3": at3, "after_port": after_port}


def test_port_cli_resumes_a_jax_cli_run(cli_runs):
    want, got = _records(cli_runs["ref"]), _records(cli_runs["port"])
    assert sorted(want) == [1, 2, 3, 4, 5]
    first = _records(cli_runs["jax"])
    assert [first[t] for t in (1, 2, 3)] == [want[t] for t in (1, 2, 3)]
    assert sorted(got) == [4, 5]  # the copy holds the checkpoint alone
    for t in (4, 5):
        assert set(got[t]) == set(want[t])
        for k in sorted(set(want[t]) - {"kind", "t"}):
            np.testing.assert_allclose(got[t][k], want[t][k], rtol=LOSS_RTOL,
                                       atol=LOSS_ATOL, err_msg=f"{t} {k}")


def test_port_cli_keeps_writing_the_jax_format(cli_runs):
    files = os.listdir(os.path.join(cli_runs["port"], "checkpoint_state"))
    assert "state.msgpack" in files and "history.msgpack" in files
    assert "state.pt" not in files and "history.npz" not in files
    state, _ = store.load_checkpoint(os.path.join(cli_runs["port"],
                                                  "checkpoint_state"))
    assert int(state.step) == 5


def test_histories_survive_both_hops(cli_runs):
    _, jax_meta = cli_runs["at3"]
    port_meta = cli_runs["after_port"]
    assert jax_meta["extra"]["checkpoint_ts"] == [3]
    assert port_meta["extra"]["checkpoint_ts"] == [3, 5]
    for k, v in jax_meta["extra"]["losses"].items():
        assert port_meta["extra"]["losses"][k][:3] == v
    port = cli.unflatten_samples(port_meta["arrays"])
    for kind in cli.SAMPLE_KINDS:
        assert len(port[kind]) == 2, kind
        first = jax_meta["arrays"][kind][0]
        assert set(port[kind][0]) == set(first), kind
        for key, arr in first.items():
            np.testing.assert_array_equal(port[kind][0][key], arr)
    _, back_meta = jax_store.load_checkpoint(
        os.path.join(cli_runs["back"], "checkpoint_state"),
        cli_runs["at3"][0])
    assert back_meta["extra"]["checkpoint_ts"] == [3, 5, 6]
    for kind in cli.SAMPLE_KINDS:
        assert len(back_meta["arrays"][kind]) == 3, kind
        for key, arr in port[kind][1].items():
            np.testing.assert_array_equal(back_meta["arrays"][kind][1][key],
                                          arr)


def test_jax_cli_resumes_the_ports_run(cli_runs):
    recs = _records(cli_runs["back"])
    assert sorted(recs) == [4, 5, 6]  # the port's two, then the JAX one
    assert all(np.isfinite(v) for k, v in recs[6].items()
               if k not in ("kind", "t"))
    state, _ = jax_store.load_checkpoint(
        os.path.join(cli_runs["back"], "checkpoint_state"),
        cli_runs["at3"][0])
    assert int(state.step) == 6


# -- the card's fixture -------------------------------------------------------

def make_fixture(out_dir, jax_run=None):
    """Write the card's JAX checkpoint with the JAX package: ``TINY`` from
    the JAX ``init_state(seed=0)`` after one step on ``_rand_batch
    (RandomState(0))``, saved by the JAX ``Trainer.save_checkpoint``
    (``state.msgpack``, ``meta.json``, ``history.msgpack``), and
    ``expected.npz``: the next batch (``batch/<key>``, ``_rand_batch
    (RandomState(1))``) and the JAX step's losses on it (``loss/<name>``).
    From the repository root::

        JAX_PLATFORMS=cpu python -c "import sys; sys.path.insert(0, 'tests');
        import test_torch_ckpt_jax as t; t.make_fixture(t.FIXTURE)"
    """
    j = jax_run or _Jax("tiny", out_dir)
    if j.path != out_dir:
        os.makedirs(out_dir, exist_ok=True)
        for name in ("state.msgpack", "meta.json", "history.msgpack"):
            shutil.copy(os.path.join(j.path, name), out_dir)
    batch = _rand_batch(np.random.RandomState(1), j.config)
    _, metrics = j.trainer.step(j.state, dict(batch))
    np.savez(os.path.join(out_dir, "expected.npz"),
             **{f"batch/{k}": v for k, v in batch.items()},
             **{f"loss/{k}": np.float32(v) for k, v in metrics.items()})


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_committed_fixture_is_the_jax_packages_output(saved, tmp_path):
    out = str(tmp_path / "fixture")
    make_fixture(out, saved("tiny"))
    assert sorted(os.listdir(out)) == sorted(os.listdir(FIXTURE)) == [
        "expected.npz", "history.msgpack", "meta.json", "state.msgpack"]
    with open(os.path.join(out, "meta.json")) as f, \
            open(os.path.join(FIXTURE, "meta.json")) as g:
        assert json.load(f) == json.load(g)
    for name in ("state.msgpack", "history.msgpack"):
        got = fser.msgpack_restore(_read(os.path.join(out, name)))
        want = fser.msgpack_restore(_read(os.path.join(FIXTURE, name)))
        assert (jax.tree_util.tree_structure(got)
                == jax.tree_util.tree_structure(want)), name
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_allclose(a, b, rtol=0, atol=FIXTURE_TOL,
                                       err_msg=name)
    got, want = _npz(os.path.join(out, "expected.npz")), _npz(
        os.path.join(FIXTURE, "expected.npz"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=FIXTURE_TOL,
                                   err_msg=k)
    assert os.path.getsize(os.path.join(FIXTURE, "state.msgpack")) < 2**20


def test_port_step_on_the_fixture_gives_its_expected_losses():
    """What chip_smoke.py checks on the card, on the CPU."""
    state, meta = store.load_checkpoint(FIXTURE)
    trainer = Trainer(TrainConfig.from_dict(meta["config"]), meta["vocab"],
                      device="cpu")
    expected = _npz(os.path.join(FIXTURE, "expected.npz"))
    batch = {k[len("batch/"):]: v for k, v in expected.items()
             if k.startswith("batch/")}
    _, got = trainer.step(state, batch)
    for k, v in expected.items():
        if k.startswith("loss/"):
            np.testing.assert_allclose(float(got[k[len("loss/"):]]), v,
                                       rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                       err_msg=k)
