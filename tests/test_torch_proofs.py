"""The port's training proofs (``sg2im_tpu_torch.tools.train_proof``,
``trained_fidelity``, ``loader_bench``) against the JAX scripts they port,
on the CPU.

- ``build_dataset`` writes the JAX script's bytes: every JPEG and both
  JSONs, at the proof's 64 px and at another source size;
- ``make_scene_graphs`` and ``MODEL_FLAGS`` equal the JAX script's, and
  the graphs the committed ``artifacts/trained_scene_graphs.json``;
- a tiny ``trained_fidelity`` run goes end to end on the CPU (train,
  export, goldens, gate), writes nothing outside ``--out``, and its gate
  passes; the JAX package loads the ``.pt`` the port trained and exported,
  and its engine's zero-noise images of the gate graphs are >= 40 dB u8
  against the port's CPU engine (the bar of ``tests/test_torch_engine.py``),
  through the JAX engine and through the JAX ``verify_pretrained`` on the
  port's goldens;
- ``train_proof.main`` end to end on ``tests/test_cli.py``'s tiny model
  (the proof's COCO-64 widths are for the card): the L1 trace from
  ``log.jsonl``, the logged records' times, the report and its JSON;
- ``loader_bench`` with ``--step_rate`` and with a train_proof report.
"""

import contextlib
import hashlib
import io
import json
import os

import numpy as np
import pytest

from scripts import train_proof as jax_proof
from scripts import trained_fidelity as jax_fidelity
from sg2im_tpu_torch.tools import loader_bench, train_proof, trained_fidelity
from test_cli import TINY_FLAGS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The JAX engine's images against the port's, u8 (tests/test_torch_engine.py).
PSNR_BAR = 40.0


def _tree(root):
    """{relative path: sha256} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


def _psnr_u8(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(255.0 ** 2 / mse))


@pytest.mark.parametrize("hw, seed", [(64, 0), (96, 3)])
def test_build_dataset_writes_the_jax_scripts_bytes(tmp_path, hw, seed):
    port = train_proof.build_dataset(str(tmp_path / "port"), 16, hw=hw,
                                     seed=seed)
    ref = jax_proof.build_dataset(str(tmp_path / "jax"), 16, hw=hw,
                                  seed=seed)
    assert [os.path.relpath(p, tmp_path / "port") for p in port] == [
        os.path.relpath(p, tmp_path / "jax") for p in ref]
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert len(got) == 16 + 2 and got == want


def test_make_scene_graphs_and_model_flags_match_the_jax_script():
    graphs = trained_fidelity.make_scene_graphs()
    assert graphs == jax_fidelity.make_scene_graphs()
    with open(os.path.join(REPO, "artifacts",
                           "trained_scene_graphs.json")) as f:
        assert graphs == json.load(f)
    assert trained_fidelity.make_scene_graphs(3, 5) == (
        jax_fidelity.make_scene_graphs(3, 5))
    assert trained_fidelity.MODEL_FLAGS == jax_fidelity.MODEL_FLAGS
    assert train_proof.CATEGORY_COLORS == jax_proof.CATEGORY_COLORS
    assert train_proof.STUFF_COLOR == jax_proof.STUFF_COLOR


def _repo_outputs():
    """The repo files the JAX scripts write, and what the tools might."""
    names = ["TRAIN_PROOF.md", "TRAINED_FIDELITY.md"]
    out = {n: os.path.getmtime(os.path.join(REPO, n)) for n in names
           if os.path.exists(os.path.join(REPO, n))}
    out["artifacts"] = _tree(os.path.join(REPO, "artifacts"))
    return out


@pytest.fixture(scope="module")
def fidelity_run(tmp_path_factory):
    """A tiny trained_fidelity run on the CPU from an empty working
    directory: (working dir, --out, exit code, stdout, repo outputs
    before)."""
    cwd = tmp_path_factory.mktemp("cwd")
    out = str(cwd / "out")
    before = _repo_outputs()
    old = os.getcwd()
    os.chdir(cwd)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = trained_fidelity.main([
                "--device", "cpu", "--images", "48", "--iters", "20",
                "--batch_size", "8", "--workers", "2", "--out", out])
    finally:
        os.chdir(old)
    return cwd, out, rc, buf.getvalue(), before


def test_trained_fidelity_runs_end_to_end_on_the_cpu(fidelity_run):
    cwd, out, rc, stdout, before = fidelity_run
    assert rc == 0
    result = json.loads(stdout.strip().splitlines()[-1])
    # The gate holds the CPU against the CPU: the same bytes.
    assert result["pass"] and result["psnr_u8_db_trained"] == float("inf")
    assert set(result["iou"]) == {"train_iou", "val_iou"}
    assert sorted(os.listdir(cwd)) == ["out"]
    for name in ("trained_coco64.pt", "trained_scene_graphs.json",
                 "TRAINED_FIDELITY.md", "run/checkpoint_state/state.pt",
                 "run/log.jsonl", "golden/img000007.png",
                 "gate_out/img000007.png"):
        assert os.path.exists(os.path.join(out, name)), name
    assert _repo_outputs() == before
    with open(os.path.join(out, "trained_scene_graphs.json")) as f:
        assert json.load(f) == trained_fidelity.make_scene_graphs()


def test_the_jax_package_scores_the_port_trained_checkpoint(fidelity_run,
                                                            tmp_path):
    from PIL import Image

    from sg2im_tpu.cli import verify_pretrained as jax_verify
    from sg2im_tpu.inference import InferenceEngine as JaxEngine
    from sg2im_tpu_torch.inference import InferenceEngine

    _, out, rc, _, _ = fidelity_run
    assert rc == 0
    pt = os.path.join(out, "trained_coco64.pt")
    graphs = trained_fidelity.make_scene_graphs()
    want, _ = JaxEngine.from_torch_checkpoint(pt).generate(graphs,
                                                           noise="zeros")
    got, _ = InferenceEngine.from_torch_checkpoint(pt, device="cpu").generate(
        graphs, noise="zeros")
    golden = np.stack([np.asarray(Image.open(os.path.join(
        out, "golden", f"img{i:06d}.png"))) for i in range(len(graphs))])
    assert want.shape == got.shape == golden.shape == (8, 64, 64, 3)
    assert np.array_equal(got, golden)
    assert _psnr_u8(want, got) >= PSNR_BAR
    # The JAX package's own gate CLI on the port's goldens.
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jrc = jax_verify.main([
            "--checkpoint", pt, "--scene_graphs_json",
            os.path.join(out, "trained_scene_graphs.json"),
            "--golden_dir", os.path.join(out, "golden"), "--run_reference",
            "0", "--output_dir", str(tmp_path / "jax_gate"),
            "--min_psnr", str(PSNR_BAR)])
    result = json.loads([ln for ln in buf.getvalue().splitlines()
                         if ln.startswith("{")][-1])
    assert jrc == 0 and result["pass"], result


# tests/test_cli.py's tiny model; the proof sets the run's own flags.
RUN_FLAGS = {"--dataset", "--batch_size", "--print_every",
             "--checkpoint_every", "--loader_num_workers", "--num_val_samples"}
TINY_MODEL = [x for k, v in zip(TINY_FLAGS[::2], TINY_FLAGS[1::2])
              if k not in RUN_FLAGS for x in (k, v)]


def test_train_proof_end_to_end_on_a_tiny_model(tmp_path, monkeypatch,
                                                capsys):
    """train_proof.main with the tiny model's flags after the proof's own
    (argparse keeps the last), 60 steps at b4 on 64 images."""
    base = train_proof.train_flags
    monkeypatch.setattr(train_proof, "train_flags",
                        lambda args, data: base(args, data) + TINY_MODEL)
    out = tmp_path / "proof"
    rc = train_proof.main(["--device", "cpu", "--images", "64", "--iters",
                           "60", "--batch_size", "4", "--workers", "2",
                           "--out", str(out)])
    stdout = capsys.readouterr().out
    with open(out / "train_proof.json") as f:
        summary = json.load(f)
    with open(out / "run" / "log.jsonl") as f:
        records = [json.loads(line) for line in f]
    logged = [r for r in records if r["kind"] == "train"]
    evals = [r for r in records if r["kind"] == "eval"]
    assert [t for t, _ in summary["l1"]] == [25, 50] == [r["t"] for r in
                                                         logged]
    assert [v for _, v in summary["l1"]] == [r["L1_pixel_loss"]
                                             for r in logged]
    assert rc == (0 if summary["decreased"] else 1)
    l1 = [v for _, v in summary["l1"]]
    assert summary["l1_head"] == np.mean(l1[:4])
    assert summary["l1_tail"] == np.mean(l1[-4:])
    assert summary["decreased"] == (summary["l1_tail"] < summary["l1_head"])
    assert summary["iou"] == {k: evals[-1][k]
                              for k in ("train_iou", "val_iou")}
    assert summary["h2d"] is None and summary["card"] is None
    assert summary["steady_img_s"] > 0 and len(summary["intervals_s"]) == 1
    assert summary["median_img_s"] == pytest.approx(summary["steady_img_s"])
    assert summary["mode"] == "f32/legacy"
    assert "==== train proof ====" in stdout
    report = (out / "TRAIN_PROOF.md").read_text()
    assert "not measured (no card)" in report and "25: " in report
    # A second, shorter run replaces the first one's log rather than
    # appending to it, and repeats its trace bit for bit.
    first = tmp_path / "first.json"
    os.replace(out / "train_proof.json", first)
    argv = ["--device", "cpu", "--images", "64", "--iters", "50",
            "--batch_size", "4", "--workers", "2", "--out", str(out),
            "--compare_to", str(first)]
    assert train_proof.main(argv) == rc
    with open(out / "train_proof.json") as f:
        again = json.load(f)
    assert again["l1"] == summary["l1"]
    assert again["compared_to"] == {"path": str(first), "records": 2,
                                    "bit_identical": True}
    assert "2 common records, bit-identical" in (
        out / "TRAIN_PROOF.md").read_text()
    # A trace that differs fails the run.
    summary["l1"][1][1] += 1e-7
    first.write_text(json.dumps(summary))
    assert train_proof.main(argv) == 1


def test_train_proof_rates():
    steady, med, med_rate = train_proof.rates(
        [[25, 10.0], [50, 11.0], [75, 14.0], [100, 15.0]], 32)
    assert steady == pytest.approx(75 * 32 / 5.0)
    assert med == pytest.approx(1.0) and med_rate == pytest.approx(800.0)
    assert train_proof.rates([[25, 1.0]], 32) == (None, None, None)


def test_train_flags_are_the_jax_scripts():
    args = train_proof.build_parser().parse_args([
        "--bf16", "1", "--crn_mode", "split", "--cache", "1",
        "--eval_mode_after", "7", "--snapshot_every", "9", "--decoder",
        "pil", "--out", "/o"])
    flags = train_proof.train_flags(args, ["--dataset", "coco"])
    for pair in (("--batch_size", "32"), ("--num_iterations", "500"),
                 ("--print_every", "25"), ("--checkpoint_every", "500"),
                 ("--loader_num_workers", "8"), ("--num_val_samples", "64"),
                 ("--bf16_compute", "1"), ("--cache_dir", "/o/cache"),
                 ("--eval_mode_after", "7"), ("--snapshot_every", "9"),
                 ("--crn_mode", "split"), ("--decoder", "pil"),
                 ("--device", "cuda")):
        i = flags.index(pair[0])
        assert flags[i + 1] == pair[1], pair


@pytest.mark.parametrize("source", ["step_rate", "proof_report"])
def test_loader_bench_runs_against_a_step_rate(tmp_path, capsys, source):
    if source == "step_rate":
        extra = ["--step_rate", "1234.5"]
    else:
        report = tmp_path / "train_proof.json"
        report.write_text(json.dumps({
            "steady_img_s": 1234.5, "mode": "f32/legacy", "batch_size": 32,
            "card": None, "device": "cpu"}))
        extra = ["--proof_report", str(report)]
    assert loader_bench.main(["--images", "24", "--batch_size", "4",
                              "--out", str(tmp_path / "lb")] + extra) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["step_rate"] == 1234.5
    assert set(result["loader_img_s"]) >= {"cached", "raw"}
    assert result["raw_ms"]["pil"] > 0 and result["cached_ms"] > 0
    assert sorted(os.listdir(tmp_path / "lb")) == ["src64"]


def test_loader_bench_needs_a_step_rate():
    with pytest.raises(SystemExit):
        loader_bench.build_parser().parse_args([])
