"""The port's data and tensor parallelism (``sg2im_tpu_torch.parallel``)
on the CPU, against the port's one-process step and the JAX package's
mesh-sharded one.

Every rank runs in a process of its own with Gloo, joins its group with a
timeout and is joined with one (``parallel.dryrun.spawn_ranks``), so that
nothing can hang the suite.

Bars:

- a 2-rank step against the one-process step on the same global batch
  (``tests/test_train.py``'s ``TINY`` at 4 rows, random object and triple
  masks, so that masked BatchNorm statistics and loss denominators are
  global): losses of both steps and of ``check_model`` within 2e-4
  relative, 2e-5 absolute; every rank reports the same losses and holds
  the same state, bit for bit; parameters after one step within
  ``tests/test_torch_train_step.py``'s bar (1e-6 + 0.05 lr), with its rule
  for the elements whose reference gradient is at round-off, BatchNorm
  statistics within 1e-5, Adam moments within 1e-4 of each model's peak;
- two ranks of ``tests/test_torch_train_step.py``'s 32x32 'packed'
  variant (layout noise drawn for the global batch, BatchNorm in the MLPs
  and discriminators, phases=4 statistics): losses within the same bars,
  the ranks bit-identical, every BatchNorm statistic within 1e-5;
- the same 2-rank step against the JAX ``Trainer`` on
  ``make_mesh(n_data=2)`` from the same initial state:
  ``tests/test_parallel.py``'s bars (metrics rtol 5e-2, atol 5e-4;
  parameters atol 2e-4);
- without a group, BatchNorm and the losses bit-identical to their
  one-process formulas;
- the mesh engine (2 data rows) against the one-device engine: float32
  within 1e-5, bf16 within 1 u8 level, the int8 tier within 1 u8 level
  at shared scales; the tensor-parallel engine (2 model columns) against
  the replicated one at ``tests/test_parallel.py``'s rtol 1e-4, atol 1e-5.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from sg2im_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sg2im_tpu.parallel.mesh import replicate_state as jax_replicate
from sg2im_tpu.train.config import TrainConfig as JaxConfig
from sg2im_tpu.train.trainer import Trainer as JaxTrainer
from sg2im_tpu_torch import losses as L
from sg2im_tpu_torch.ckpt import load_reference_bundle, train_state_from_jax
from sg2im_tpu_torch.cli import train as cli
from sg2im_tpu_torch.inference import InferenceEngine
from sg2im_tpu_torch.nn.layers import BatchNorm
from sg2im_tpu_torch.parallel import collectives, dryrun
from sg2im_tpu_torch.parallel.mesh import (
    TensorParallelMLP,
    free_port,
    init_multihost,
    launch_config,
    make_mesh,
    shard_batch,
    tp_generator_sharding,
)
from sg2im_tpu_torch.train.config import TrainConfig
from sg2im_tpu_torch.train.trainer import Trainer
from test_torch_train_cli import _coco_flags
from test_train import TINY, VOCAB, _rand_batch
from test_torch_train_step import (
    ROUNDOFF_MU,
    VARIANT,
    _feeds_batchnorm,
    _jax_state,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "artifacts", "trained_coco64.pt")
GRAPHS = os.path.join(REPO, "artifacts", "trained_scene_graphs.json")
DP = dict(TINY, batch_size=4)
RANK_TIMEOUT = 120.0
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "SG2IM_COORDINATOR", "SG2IM_NUM_PROCESSES",
              "SG2IM_PROCESS_ID")


def tiny_masked(world):
    """TINY at 4 global rows with _rand_batch's random masks."""
    config = TrainConfig(**DP)
    return VOCAB, config, _rand_batch(np.random.RandomState(0), config)


def variant_packed(world):
    """tests/test_torch_train_step.py's 32x32 variant in 'packed' mode
    (layout noise, BatchNorm in the MLPs and both discriminators, the
    packed stages' phases=4 statistics) at 4 global rows."""
    config = TrainConfig(**dict(VARIANT, crn_mode="packed", batch_size=4))
    return VOCAB, config, _rand_batch(np.random.RandomState(1), config)


def _env(**kw):
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, os.path.join(REPO, "tests"), env.get("PYTHONPATH", "")])
    return dict(env, **kw)


# -- the mesh and the launch -------------------------------------------------

def test_make_mesh_shapes():
    cpu = ["cpu"] * 8
    assert make_mesh(n_data=4, n_model=2, devices=cpu).shape == {
        "data": 4, "model": 2}
    assert make_mesh(devices=cpu).shape == {"data": 8, "model": 1}
    assert make_mesh(n_model=2, devices=cpu).shape == {"data": 4, "model": 2}
    mesh = make_mesh(2, 2, devices=["cpu", "meta", "cpu", "meta"])
    assert mesh.devices[1][1] == torch.device("meta")
    with pytest.raises(ValueError, match="needs 6 devices"):
        make_mesh(n_data=3, n_model=2, devices=["cpu"] * 4)


def test_replicate_without_a_group_is_the_identity():
    from sg2im_tpu_torch.parallel.mesh import (
        replicate_host_array,
        replicate_tensors,
    )

    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    assert torch.equal(replicate_host_array(x), torch.from_numpy(x))
    t = {"a": torch.ones(2), "b": None}
    assert replicate_tensors(t) == t


def test_shard_batch_slices_rows():
    batch = {"a": np.arange(8).reshape(4, 2), "b": None}
    out = shard_batch(batch, 1, 2)
    np.testing.assert_array_equal(out["a"], [[4, 5], [6, 7]])
    assert out["b"] is None
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(batch, 0, 3)


def test_init_multihost_unconfigured_runs_one_process(monkeypatch, capsys):
    for k in LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    assert launch_config() is None
    assert init_multihost() == (0, 1)
    assert "running single-process" in capsys.readouterr().out
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("env", [{"RANK": "0"},
                                 {"SG2IM_COORDINATOR": "127.0.0.1:1"}])
def test_init_multihost_refuses_a_partial_launch(monkeypatch, env):
    for k in LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="are not"):
        init_multihost()


_UNREACHABLE = """
import os, sys
from sg2im_tpu_torch.parallel.mesh import init_multihost
port = sys.argv[1]
for style, env in (
        ("torchrun", dict(RANK="1", WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=port)),
        ("sg2im", dict(SG2IM_COORDINATOR="127.0.0.1:" + port,
                       SG2IM_NUM_PROCESSES="2", SG2IM_PROCESS_ID="1"))):
    os.environ.update(env)
    try:
        init_multihost("gloo", timeout_s=1)
        print(style, "JOINED")
    except RuntimeError as e:
        print(style, "RAISED", e)
    for k in env:
        del os.environ[k]
"""


@pytest.fixture(scope="module")
def unreachable():
    out = subprocess.run(
        [sys.executable, "-c", _UNREACHABLE, str(free_port())],
        env=_env(), capture_output=True, text=True, timeout=120)
    return {line.split()[0]: line for line in out.stdout.splitlines()
            if line.split()[:1] in (["torchrun"], ["sg2im"])}, out.stderr


@pytest.mark.parametrize("style", ["torchrun", "sg2im"])
def test_init_multihost_raises_when_configured_but_unreachable(
        unreachable, style):
    """Rank 1 of 2 whose rank 0 never comes: a RuntimeError within the
    join timeout, not a one-process run."""
    lines, err = unreachable
    assert lines.get(style, "").startswith(
        f"{style} RAISED multihost: rank 1 of 2 could not join"), (lines,
                                                                   err)


# -- without a group: the one-process formulas, bit for bit -----------------

def test_batchnorm_and_losses_without_a_group_are_unchanged():
    rng = np.random.RandomState(0)
    bn = BatchNorm(6).train()
    x4 = torch.from_numpy(rng.randn(5, 6, 3, 4).astype(np.float32))
    rows = torch.from_numpy(rng.randn(5, 7, 6).astype(np.float32))
    mask = torch.from_numpy((rng.rand(5, 7) < 0.6).astype(np.float32))
    assert collectives.group() is None
    with collectives.global_batch(None):
        y4 = bn(x4)
        yr = bn(rows, mask=mask)
    # The formulas the layer has run since its port, written out.
    var, mean = torch.var_mean(x4, dim=(0, 2, 3), correction=0,
                               keepdim=True)
    ref4 = (x4 - mean) * torch.rsqrt(var + 1e-5)
    w = mask[..., None]
    n = (mask.sum() * 1).clamp_min(1.0)
    m = (rows * w).sum(dim=(0, 1), keepdim=True) / n
    v = (((rows - m) ** 2) * w).sum(dim=(0, 1), keepdim=True) / n
    refr = (rows - m) * torch.rsqrt(v + 1e-5)
    assert torch.equal(y4, ref4.reshape(x4.shape)) and torch.equal(yr, refr)
    p, t = rows[..., 0], rows[..., 1]
    assert torch.equal(L.l1_loss(p, t), (p - t).abs().mean())
    assert torch.equal(L.masked_mean(rows), rows.mean())
    mm = mask[..., None].expand(rows.shape)
    assert torch.equal(L.masked_mean(rows, mask),
                       (torch.where(mm > 0, rows, torch.zeros_like(rows))
                        * mm).sum() / mm.sum().clamp_min(1.0))
    assert collectives.all_reduce.calls == 0  # no collective in this process


# -- the data-parallel step ---------------------------------------------------

@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Two ranks and the one-process run of parallel.dryrun's sequence on
    tiny_masked, with the states after step 1."""
    work = str(tmp_path_factory.mktemp("dp"))
    summary = dryrun.run(2, "gloo", "cpu", tiny_masked, RANK_TIMEOUT,
                         work_dir=work, keep_states=True)
    states = {name: torch.load(os.path.join(work, f"{name}_step1.pt"))
              for name in ("rank0", "rank1", "single")}
    return summary, states


def test_dp_step_losses_equal_the_one_process_step(dp):
    summary, _ = dp
    assert summary["ok"], summary
    single = summary["single"]
    for res in summary["ranks"]:
        for leg in ("step1", "step2", "val_losses"):
            assert set(res[leg]) == set(single[leg])
            for k, want in single[leg].items():
                np.testing.assert_allclose(res[leg][k], want, rtol=2e-4,
                                           atol=2e-5, err_msg=(leg, k))
        assert res["step1"] == summary["ranks"][0]["step1"]
        np.testing.assert_allclose(res["val_iou"], single["val_iou"],
                                   rtol=1e-5, atol=1e-6)
    assert single["step1"]["skipped_nonfinite"] == 0.0
    # Both steps issued collectives: BatchNorm, denominators, gradients.
    assert summary["ranks"][0]["launches"]["collectives"] > 20


def test_dp_ranks_hold_the_same_state(dp):
    _, states = dp
    for k, v in states["rank0"].items():
        assert torch.equal(v, states["rank1"][k]), k


def test_dp_step_state_matches_the_one_process_step(dp):
    _, states = dp
    got = {k: v.double().numpy() for k, v in states["rank0"].items()}
    want = {k: v.double().numpy() for k, v in states["single"].items()}
    assert set(got) == set(want)
    lr, held, total = TrainConfig(**DP).learning_rate, 0, 0
    for k, w in want.items():
        diff = np.abs(got[k] - w)
        if ".mu." in k or ".nu." in k:
            group = k[:k.index(".", k.index("_opt.") + 5)]
            bar = 1e-4 * max(np.abs(v).max() for n, v in want.items()
                             if n.startswith(group + "."))
        elif k.endswith(("running_mean", "running_var")):
            bar = 1e-5
        elif k in ("step", "rng") or k.endswith(".count"):
            bar = 0.0
        else:
            total += w.size
            if _feeds_batchnorm(k, want):
                continue
            model, name = k.split(".", 1)
            mu = np.abs(want[f"{model}_opt.mu.{name}"])
            diff = diff[~((mu > 0) & (mu <= ROUNDOFF_MU))]
            held += diff.size
            bar = 1e-6 + 0.05 * lr
        err = float(diff.max()) if diff.size else 0.0
        assert err <= bar, (k, err, bar)
    assert held >= 0.9 * total, (held, total)


def test_dp_step_matches_the_jax_mesh_step(dp):
    """The JAX Trainer on make_mesh(n_data=2) from the same initial state
    (the port's seeded init, carried into a JAX TrainState)."""
    summary, states = dp
    jc = JaxConfig(**DP)
    vocab, config, batch = tiny_masked(2)
    init = Trainer(config, vocab, device="cpu").init_state(seed=0)
    mesh = jax_make_mesh(n_data=2)
    jt = JaxTrainer(jc, VOCAB, mesh=mesh)
    js = jax_replicate(_jax_state(jt, init), mesh)
    js, jm = jt.step(js, dict(batch))
    got = summary["ranks"][0]["step1"]
    for k, v in jm.items():
        np.testing.assert_allclose(got[k], np.float64(v), rtol=5e-2,
                                   atol=5e-4, err_msg=k)
    want = train_state_from_jax(jax.device_get(js))
    for name in ("g", "d_obj", "d_img"):
        for k, v in getattr(want, name).items():
            np.testing.assert_allclose(
                states["rank0"][f"{name}.{k}"].numpy(), v.numpy(),
                atol=2e-4, err_msg=(name, k))


def test_dp_step_with_noise_and_batchnorm_everywhere(tmp_path):
    """Two ranks of the packed variant: the global batch's layout noise
    (each rank keeps its rows), row BatchNorm in the MLPs, phases=4
    statistics; losses of both steps and check_model against one
    process, every rank the same."""
    summary = dryrun.run(2, "gloo", "cpu", variant_packed, RANK_TIMEOUT,
                         work_dir=str(tmp_path), keep_states=True)
    assert summary["ok"], summary
    a, b = (torch.load(tmp_path / f"rank{r}_step1.pt") for r in (0, 1))
    assert all(torch.equal(v, b[k]) for k, v in a.items())
    single = torch.load(tmp_path / "single_step1.pt")
    stats = [k for k in single if k.endswith("running_mean")]
    assert len(stats) > 10
    for k in stats:
        np.testing.assert_allclose(a[k].numpy(), single[k].numpy(),
                                   atol=1e-5, err_msg=k)


def test_dryrun_module():
    out = subprocess.run(
        [sys.executable, "-m", "sg2im_tpu_torch.parallel.dryrun", "--world",
         "2", "--backend", "gloo", "--device", "cpu", "--timeout",
         str(RANK_TIMEOUT)], env=_env(), capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-2])
    assert line["ok"] and line["max_rel_loss_diff"] < 2e-4, line
    assert "dryrun OK: 2 ranks" in out.stdout


# -- the train CLI across processes ------------------------------------------

_RANK_SCRIPT = """
import json, os, sys
from sg2im_tpu_torch.cli import train as cli

base = cli.make_scalar_logger

def logger(config, rank=0):
    # The CLI's own logger (rank 0 alone writes log.jsonl), and every
    # rank's records into a file of its own for the test to compare.
    own = os.path.join(config.output_dir, f"trace_rank{rank}.jsonl")
    inner = base(config, rank)
    def write(record):
        inner(record)
        with open(own, "a") as f:
            f.write(json.dumps(record) + "\\n")
    return write

cli.make_scalar_logger = logger
raise SystemExit(cli.main(sys.argv[1:]))
"""


def _launch(flags, world=2):
    """Start ``world`` ranks of the CLI with torchrun's variables."""
    port = free_port()
    return [subprocess.Popen(
        [sys.executable, "-c", _RANK_SCRIPT] + flags,
        env=_env(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _wait(procs):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def _trace(out_dir, name):
    with open(os.path.join(out_dir, name)) as f:
        return {r["t"]: r for r in map(json.loads, f)
                if r["kind"] == "train"}


def test_train_cli_multihost_two_ranks(tmp_path):
    """Two ranks of `cli.train --multihost true` (4 global rows, 2 per
    rank): identical loss traces on both ranks, rank 0 alone prints and
    writes log.jsonl and the one checkpoint, and a run stopped at step 2
    and resumed (every rank restores) takes the uninterrupted run's steps
    3 and 4; `--data_parallel 2`, which spawns its ranks, logs the same
    steps 1 and 2."""
    flags = _coco_flags(tmp_path) + [
        "--device", "cpu", "--multihost", "true", "--batch_size", "4",
        "--num_val_samples", "4"]
    full, part = str(tmp_path / "full"), str(tmp_path / "part")
    procs = (_launch(flags + ["--num_iterations", "4", "--output_dir", full])
             + _launch(flags + ["--num_iterations", "2", "--output_dir",
                                part]))
    outs = _wait(procs)
    assert "t = 4 / 4" in outs[0] and "t = " not in outs[1]
    assert "multihost: rank 1/2 on cpu (gloo)" in outs[1]
    r0, r1 = (_trace(full, f"trace_rank{r}.jsonl") for r in (0, 1))
    assert sorted(r0) == [1, 2, 3, 4] and r0 == r1
    assert _trace(full, "log.jsonl") == r0
    assert sorted(os.listdir(full)) == sorted(
        ["checkpoint_state", "log.jsonl", "trace_rank0.jsonl",
         "trace_rank1.jsonl"])
    resume = _launch(flags + ["--num_iterations", "4", "--output_dir", part,
                              "--restore_from_checkpoint", "true"])
    # Meanwhile --data_parallel 2 starts the same two ranks itself.
    spawned = str(tmp_path / "spawned")
    try:
        rc = cli.main([f for f in flags if f not in ("--multihost", "true")]
                      + ["--data_parallel", "2", "--num_iterations", "2",
                         "--output_dir", spawned])
    finally:
        _wait(resume)
    assert rc == 0
    resumed = _trace(part, "trace_rank1.jsonl")
    assert sorted(resumed) == [1, 2, 3, 4]
    for t in (3, 4):
        assert resumed[t] == r0[t], t
    logged = _trace(spawned, "log.jsonl")
    assert sorted(logged) == [1, 2]
    for t in (1, 2):
        assert logged[t] == r0[t], t


# -- the mesh and tensor-parallel engines -----------------------------------

@pytest.fixture(scope="module")
def bundle():
    return (load_reference_bundle(CKPT),
            json.load(open(GRAPHS))[:3])


def _engine(bundle, **kw):
    b = bundle[0]
    return InferenceEngine(b["vocab"], b["model_kwargs"], b["generator"],
                           **kw)


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_mesh_engine_matches_the_single_engine(bundle, mode):
    kw = {"bf16": dict(compute_dtype=torch.bfloat16, crn_mode="split"),
          "int8": dict(quantize="int8")}.get(mode, {})
    one = _engine(bundle, device="cpu", **kw)
    mesh = _engine(bundle, mesh=make_mesh(2, devices=["cpu", "cpu"]), **kw)
    try:
        if mode == "int8":
            one.calibrate(bundle[1])
            mesh.calibrate(bundle[1])  # row 0, on the whole batch
            assert mesh.scales() == one.scales()
        for noise in ("zeros", None):
            a, oa = one.generate(bundle[1], noise=noise, seed=5)
            b, ob = mesh.generate(bundle[1], noise=noise, seed=5)
            assert b.shape == a.shape == (3, 64, 64, 3)
            assert np.abs(a.astype(int) - b).max() <= 1
            if mode == "f32":
                np.testing.assert_allclose(ob["imgs"].numpy(),
                                           oa["imgs"].numpy(), atol=1e-5)
                np.testing.assert_allclose(ob["boxes"].numpy(),
                                           oa["boxes"].numpy(), atol=1e-5)
        if mode == "int8":
            for rep in mesh.replicas:
                assert rep.refinement_net.act_scales.values is not None
        assert mesh.pad_rows(3) == 4 and mesh.pad_rows(1) == 2
        assert mesh.warmup((1,))[0][0] == 2
    finally:
        mesh.close()


def test_tensor_parallel_engine_splits_the_gcn_and_matches(bundle):
    """tests/test_parallel.py's case: TINY's seeded generator, 4 copies of
    a two-object graph, seeded noise, on a (2, 2) mesh."""
    b = bundle[0]
    mesh = make_mesh(n_data=2, n_model=2, devices=["cpu"] * 4)
    spec = tp_generator_sharding(mesh, b["generator"])
    assert spec["gconv.net1.0.weight"] == 0
    assert spec["gconv.net1.0.bias"] == 0
    assert spec["gconv_net.gconvs.0.net2.2.weight"] == 1
    assert spec["gconv.net1.2.bias"] is None
    assert spec["box_net.0.weight"] is None
    assert all(v is None for v in tp_generator_sharding(
        make_mesh(2, devices=["cpu"] * 2), b["generator"]).values())
    config = TrainConfig(**dict(TINY, batch_size=8))
    g = Trainer(config, VOCAB, device="cpu").init_state(seed=0).g
    kw = dict(vocab=VOCAB, model_kwargs=config.generator_kwargs(),
              state_dict=g, mesh=mesh)
    rep = InferenceEngine(**kw)
    tp = InferenceEngine(**kw, tensor_parallel=True)
    try:
        net = tp.replicas[1].gconv.net1
        assert isinstance(net, TensorParallelMLP)
        H = g["gconv.net1.0.weight"].shape[0]
        assert [c[0].weight.shape[0] for c in net.cols] == [H // 2] * 2
        assert [w.shape[1] for w in net.weights2] == [H // 2] * 2
        sg = {"objects": ["cat", "dog"], "relationships": [[0, "left of", 1]]}
        _, o_rep = rep.generate([sg] * 4, noise=None, seed=3)
        _, o_tp = tp.generate([sg] * 4, noise=None, seed=3)
        np.testing.assert_allclose(o_tp["imgs"].double().numpy(),
                                   o_rep["imgs"].double().numpy(),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(o_tp["boxes"].numpy(),
                                   o_rep["boxes"].numpy(), rtol=1e-4,
                                   atol=1e-6)
    finally:
        rep.close()
        tp.close()


def test_tensor_parallel_with_batchnorm_in_the_gcn_mlps():
    """mlp_normalization='batch': the BatchNorm between the two Linears
    splits its channels with the first's outputs."""
    config = TrainConfig(**dict(VARIANT, batch_size=4))
    g = Trainer(config, VOCAB, device="cpu").init_state(seed=1).g
    g = {k: (v + 0.1 * torch.rand_like(v) if "running" in k else v)
         for k, v in g.items()}  # statistics other than the defaults
    mesh = make_mesh(1, 2, devices=["cpu"] * 2)
    assert tp_generator_sharding(mesh, g)["gconv.net1.1.running_var"] == 0
    kw = dict(vocab=VOCAB, model_kwargs=config.generator_kwargs(),
              state_dict=g)
    one = InferenceEngine(**kw, device="cpu")
    tp = InferenceEngine(**kw, mesh=mesh, tensor_parallel=True)
    try:
        sg = {"objects": ["cat", "dog", "sky"],
              "relationships": [[0, "left of", 1], [2, "above", 0]]}
        _, a = one.generate([sg] * 2, noise=None, seed=3)
        _, b = tp.generate([sg] * 2, noise=None, seed=3)
        for k in ("imgs", "boxes"):
            np.testing.assert_allclose(b[k].numpy(), a[k].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
    finally:
        tp.close()


def test_engine_refuses_mesh_with_device_and_tp_without_mesh(bundle):
    with pytest.raises(ValueError, match="mutually exclusive"):
        _engine(bundle, device="cpu", mesh=make_mesh(1, devices=["cpu"]))
    with pytest.raises(ValueError, match="requires a mesh"):
        _engine(bundle, device="cpu", tensor_parallel=True)


# -- serve --data_parallel ---------------------------------------------------

@pytest.mark.parametrize("flags,match", [
    (["--data_parallel", "2", "--replicas", "2"], "mutually exclusive"),
    (["--device", "cuda", "--data_parallel", "64"], "exceeds"),
])
def test_serve_data_parallel_refusals(flags, match):
    from sg2im_tpu_torch.cli.serve import build_engines, build_parser

    argv = ["--checkpoint", CKPT, "--device", "cpu"] + flags
    with pytest.raises(SystemExit, match=match):
        build_engines(build_parser().parse_args(argv))


def test_serve_data_parallel_builds_one_mesh_engine():
    from sg2im_tpu_torch.cli.serve import build_engines, build_parser

    engines = build_engines(build_parser().parse_args(
        ["--checkpoint", CKPT, "--device", "cpu", "--data_parallel", "2"]))
    try:
        assert len(engines) == 1
        assert engines[0].mesh.shape == {"data": 2, "model": 1}
        assert len(engines[0].replicas) == 2
    finally:
        for e in engines:
            e.close()
