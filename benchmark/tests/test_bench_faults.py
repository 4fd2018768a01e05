"""The comparison catches each fault a cell can have: the harness's look
for a card skipped, the rest of a run driven at a tiny size on the CPU with
the timed path broken underneath, and ``correct`` must come out false.

The faults: an answer altered where it is produced (the generation cells,
and the serving cell of ``later_cells.json``); a step that returns its
state unchanged, and half of the batch left out with the means taken over
the rest (the training cell of ``later_cells.json``).  No cell spans
chips, so no exchange between chips can be left out."""

import pytest
import torch

from benchmark import run
from benchmark.tests import tiny


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout")
    return root, tiny.build(root)


def runs(cell, tiny_root):
    root, bench_dir = tiny_root
    torch.set_num_threads(2)
    return run.run(cell, 2**31 + 5, 0.5, False, device="cpu", root=root,
                   t_start=0.0, bench_dir=bench_dir)


def altered(generate):
    """``generate`` whose first returned image is inverted."""
    def wrapper(self, *args, **kwargs):
        imgs, out = generate(self, *args, **kwargs)
        imgs = imgs.copy()
        imgs[0] = 255 - imgs[0]
        return imgs, out
    return wrapper


@pytest.mark.parametrize("cell", ["vg128-gen-b128", "coco64-gen-b128",
                                  "vg128-serve-poisson"])
def test_an_altered_answer_is_not_correct(cell, tiny_root, monkeypatch):
    from sg2im_tpu_torch.inference import InferenceEngine

    monkeypatch.setattr(InferenceEngine, "generate",
                        altered(InferenceEngine.generate))
    out = runs(cell, tiny_root)
    assert not out["correct"]
    assert out["checks"]["img_mse"]["value"] > \
        out["checks"]["img_mse"]["limit"]


def test_a_step_that_returns_its_state_is_not_correct(tiny_root,
                                                       monkeypatch):
    from sg2im_tpu_torch.train.trainer import Trainer

    step = Trainer.step

    def unchanged(self, state, batch, noise=None):
        _, metrics = step(self, state, batch, noise)
        return state, metrics

    monkeypatch.setattr(Trainer, "step", unchanged)
    out = runs("coco64-train-b32", tiny_root)
    assert not out["correct"]
    assert out["checks"]["update_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out_is_not_correct(tiny_root, monkeypatch):
    from sg2im_tpu_torch.train.trainer import Trainer

    step = Trainer.step

    def half(self, state, batch, noise=None):
        n = batch["imgs"].shape[0] // 2
        return step(self, state, {k: v[:n] for k, v in batch.items()},
                    noise)

    monkeypatch.setattr(Trainer, "step", half)
    out = runs("coco64-train-b32", tiny_root)
    assert not out["correct"]
    assert out["checks"]["loss_gap"]["value"] > \
        out["checks"]["loss_gap"]["limit"]


def test_the_unbroken_runs_are_correct(tiny_root):
    for cell in ("vg128-gen-b128", "coco64-train-b32"):
        assert runs(cell, tiny_root)["correct"]
