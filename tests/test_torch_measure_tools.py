"""The measurement tools (``sg2im_tpu_torch.tools``) on the CPU, at small
sizes: their times here are the host's, so these tests hold what the tools
compute and write, not how fast anything is.

- ``tools.roofline``'s sections are the generator's forward: chained, they
  reproduce ``Sg2ImGenerator``'s outputs bit for bit in every CRN mode,
  and each recorded CRN stage call reproduces what the network computed;
- every tool's ``main`` returns 0 with ``--device cpu`` and a small
  configuration and writes its ``<tool>.json`` (the roofline rows with the
  keys of a ``PERF.json`` row); with ``--device cuda`` and no card it
  returns 1 and writes nothing;
- the two repairs of ROADMAP Queue 3: ``trained_fidelity``'s box-head probe
  refuses seed 0's init at ``MODEL_FLAGS`` and passes the documented
  ``SEED``'s, and a run at seed 0 exits 1 before training with the cause;
  ``train_proof.stage_batch`` packs a batch into the one buffer that
  ``h2d_copy`` times.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from sg2im_tpu_torch.inference import InferenceEngine
from sg2im_tpu_torch.tools import _measure as M
from sg2im_tpu_torch.utils.roofline import layout_bounds
from sg2im_tpu_torch.tools import (
    bw_probe,
    profile_crn,
    profile_seeded_noise,
    profile_turbo_frontier,
    roofline,
    roofline_train,
    train_proof,
    trained_fidelity,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOOLS = {
    "bw_probe": (bw_probe, ["--shape", "4,16,16", "--crn_shape", "2,4,4,8",
                            "--iters", "1"]),
    "roofline": (roofline, ["--config", "tiny", "--batch", "2", "--iters",
                            "1", "--modes", "f32,bf16/packed",
                            "--peak_size", "16", "--stream_shape", "2,8,8"]),
    "profile_crn": (profile_crn, ["--batch", "2", "--image", "16", "--dims",
                                  "8,4,4", "--iters", "1"]),
    "roofline_train": (roofline_train, ["--config", "tiny", "--iters", "1",
                                        "--configs", "baseline",
                                        "--peak_size", "16",
                                        "--stream_shape", "2,8,8"]),
    "profile_seeded_noise": (profile_seeded_noise, [
        "--config", "tiny", "--batch", "2", "--iters", "1", "--windows",
        "1"]),
    "profile_turbo_frontier": (profile_turbo_frontier, [
        "--config", "tiny", "--batch", "2", "--iters", "1", "--windows",
        "1"]),
}
MODES = ["f32", "bf16/split", "bf16/phase", "bf16/packed",
         "bf16/split_noise"]


def _tiny_engine(mode):
    vocab, kwargs = M.tiny_config()
    return InferenceEngine(vocab, kwargs, M.random_state(vocab, kwargs),
                           device="cpu", **roofline.engine_kwargs(mode))


@pytest.mark.parametrize("mode", MODES)
def test_roofline_sections_chain_to_the_forward(mode):
    model = _tiny_engine(mode).model
    vocab, _ = M.tiny_config()
    inputs = M.device_batch(M.bench_inputs(3, vocab), "cpu")
    noise = torch.randn(3, model.layout_noise_dim, *model.image_size,
                        generator=torch.Generator().manual_seed(2))
    env = dict(zip(("objs", "triples", "obj_mask", "triple_mask"), inputs),
               noise=noise)
    with torch.inference_mode():
        want = model(*inputs, noise)
        with roofline.capture_stages(model.refinement_net) as calls:
            for sec in roofline.forward_sections(model):
                env.update(sec.fn(*[env[k] for k in sec.reads]))
        stages = roofline.stage_sections(model.refinement_net, calls)
        for name, got in zip(("imgs", "boxes", "masks", "rel_scores"),
                             want):
            assert torch.equal(env[name], got), name
        assert [s[0] for s in stages] == [
            f"crn_stage{i}_prod" for i in range(1, 4)]
        for name, fn, _, _, out in stages:
            assert torch.equal(fn(), out), name
    # The patches come off: the stages are the modules' own methods again.
    assert "forward" not in vars(model.refinement_net.refinement_modules[0])
    if mode == "bf16/packed":
        assert [c[1] for c in calls] == ["forward", "forward", "packed"]


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_runs_on_the_cpu_and_writes_its_report(tool, tmp_path):
    mod, argv = TOOLS[tool]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv + ["--device", "cpu", "--out", str(tmp_path)])
    assert rc == 0
    with open(tmp_path / f"{tool}.json") as f:
        report = json.load(f)
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()
             if ln.startswith("{")]
    assert lines and buf.getvalue().splitlines()[0] == "cpu"
    if tool in ("roofline", "roofline_train"):
        with open(os.path.join(REPO, "PERF.json")) as f:
            keys = set(json.load(f)["sections"][0])
        for res in report:
            for row in res["sections"]:
                assert keys <= set(row), row["section"]
                assert np.isfinite([row["ms"], row["gflops"],
                                    row["mbytes"]]).all()
        names = [r["section"] for r in report[0]["sections"]]
        if tool == "roofline":
            assert [r["mode"] for r in report] == ["f32", "bf16/packed"]
            assert names[:3] == ["peak_bf16_matmul", "peak_f32_matmul",
                                 "peak_scale_add"]
            assert {"gcn_x5", "box+rel_heads", "mask_head",
                    "layout_compose", "noise+concat", "crn_total",
                    "crn_s3_conv1", "crn_stage3_prod",
                    "e2e_forward"} <= set(names)
        else:
            assert names == ["g_forward", "g_forward_backward",
                             "d_obj_step", "d_img_step", "crop_kernel", "adam_updates",
                "full_step"]
    elif tool == "bw_probe":
        assert len(report["rows"]) == 11 and report["sheet_gb_s"] == 3350.0
    elif tool == "profile_crn":
        assert report["modes_agree"] and len(report["stages"]) == 3
        assert set(report["total_ms"]) == set(profile_crn.MODES)
    elif tool == "profile_seeded_noise":
        assert report["bit_identical"] and report["finite"]
        assert len(report["eager_ms_b2_runs"]) == 1
    else:
        assert [r["config"] for r in report] == [
            name for name, _, _ in profile_turbo_frontier.rows()]
        by = {r["config"]: r for r in report}
        assert by["prod_nd2"]["psnr_u8_db"] == by["production"]["psnr_u8_db"]
        # At 32 x 32 the int8 tier quantizes the last stage: below the
        # unquantized production row.
        assert by["turbo_r4"]["psnr_u8_db"] < by["production"]["psnr_u8_db"]


def test_roofline_counts_the_same_flops_as_the_sections_it_chains(tmp_path):
    """A section's FLOPs do not depend on where they are counted: the
    forward's total, type by type, equals its sections' sum; in a bf16
    mode the GCN, heads and layout compose count as f32 and the CRN as
    bf16; the layout compose counts K1's closed form."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert roofline.main([
            "--config", "tiny", "--batch", "2", "--iters", "1", "--modes",
            "bf16/split", "--peak_size", "16", "--stream_shape", "2,8,8",
            "--device", "cpu", "--out", str(tmp_path)]) == 0
    with open(tmp_path / "roofline.json") as f:
        rows = {r["section"]: r for r in json.load(f)[0]["sections"]}
    parts = ("gcn_x5", "box+rel_heads", "mask_head", "layout_compose",
             "noise+concat", "crn_total")
    assert sum(rows[p]["gflops"] for p in parts) == pytest.approx(
        rows["e2e_forward"]["gflops"], rel=1e-12)
    e2e = rows["e2e_forward"]["gflops_by_type"]
    assert set(e2e) == {"bf16", "f32"}
    for kind in e2e:
        assert sum(rows[p]["gflops_by_type"].get(kind, 0.0)
                   for p in parts) == pytest.approx(e2e[kind], rel=1e-12)
    for p in parts[:4]:
        assert set(rows[p]["gflops_by_type"]) == {"f32"}, p
    # The CRN's convolutions are bf16 but for the f32 1 x 1 output conv.
    crn = rows["crn_total"]["gflops_by_type"]
    assert crn["f32"] * 1e9 == 2 * 2 * 32 * 32 * 8 * 3
    assert sum(rows[f"crn_stage{s}_prod"]["gflops"] for s in (1, 2, 3)) < \
        rows["crn_total"]["gflops"]
    # The CPU's plain compose counts the closed form the card adds per
    # launch (b2, O 16, masks 4, 32 x 32, D 16), and launches nothing.
    assert rows["layout_compose"]["gflops"] * 1e9 == pytest.approx(
        layout_bounds(2, 16, 4, 32, 32, 16, weights=False)[1], rel=1e-12)
    assert rows["layout_compose"]["hand_kernel_flops"] == {}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_exits_1_without_a_card(tool, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this holds the no-card exit")
    mod, argv = TOOLS[tool]
    assert mod.main(argv + ["--out", str(tmp_path)]) == 1
    assert "no CUDA card" in capsys.readouterr().err
    assert not os.listdir(tmp_path)


@pytest.fixture(scope="module")
def proof_dataset(tmp_path_factory):
    return train_proof.build_dataset(str(tmp_path_factory.mktemp("ds")), 48)


def test_box_head_probe_refuses_seed_0_and_passes_the_documented_seed(
        proof_dataset):
    shares = {seed: trained_fidelity.box_head_probe(
        trained_fidelity.train_flags(proof_dataset, 1, 8, 0, seed, "cpu"))
        for seed in range(trained_fidelity.SEED + 1)}
    assert shares[0] == [0.0] * 4  # every box output 0 for every object
    # SEED is the smallest seed >= 0 whose init is alive: each output is
    # non-zero for some object.
    assert min(shares[trained_fidelity.SEED]) > 0.0
    assert all(min(shares[s]) == 0.0 for s in range(trained_fidelity.SEED))


def test_trained_fidelity_at_seed_0_fails_before_training(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(trained_fidelity, "SEED", 0)
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = trained_fidelity.main([
            "--device", "cpu", "--images", "48", "--iters", "20",
            "--batch_size", "8", "--workers", "2", "--out", str(tmp_path)])
    assert rc == 1
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert result["pass"] is False and result["seed"] == 0
    assert result["box_nonzero_share_init"] == [0.0] * 4
    assert "box head is dead" in result["cause"]
    assert "box head is dead" in err.getvalue()
    with open(tmp_path / "TRAINED_FIDELITY.md") as f:
        assert "box head is dead" in f.read()
    assert not (tmp_path / "run").exists()  # no training ran


def test_h2d_copy_stages_the_batch_into_one_buffer():
    rng = np.random.RandomState(0)
    batch = {"imgs": rng.randn(2, 4, 4, 3).astype(np.float32),
             "objs": rng.randint(0, 9, (2, 5)).astype(np.int32),
             "masks": rng.rand(2, 5, 2, 2).astype(np.float32)[..., ::-1]}
    host = train_proof.stage_batch(batch)
    assert host.dtype == torch.uint8 and host.is_contiguous()
    assert host.numel() == sum(v.nbytes for v in batch.values())
    back, at = [], 0
    for v in batch.values():
        n = v.nbytes
        back.append(host[at:at + n].numpy().view(v.dtype).reshape(v.shape))
        at += n
    for a, b in zip(back, batch.values()):
        assert np.array_equal(a, b)
    assert train_proof.h2d_copy(batch, "cpu") is None


def test_profile_window_on_the_cpu():
    """utils/timing.profile_window on the CPU: the block's host records
    (its own marker left out), no device records, no warm-up; kernel_table
    is None there."""
    from sg2im_tpu_torch.utils.timing import profile_window

    with profile_window("cpu") as window:
        torch.ones(4).sum()
    names = {e.name for e in window.host_events}
    assert "aten::sum" in names and "profile_window.block" not in names
    assert window.device_events == [] and window.warmup_lost == 0
    assert M.kernel_table(lambda: None, "cpu") is None
