"""On the card, at each cell's own size: the control reads as not correct
against the cell's limits, on three seeds.  The control of the bf16 CRN is
the program's own int8 path; of the float32 parts, the reference in the
program's place with TF32 on.  Run on a card with ``python -m pytest
benchmark/tests -m cuda``; each case skips without one."""

import pytest

from benchmark.harness import files

SEEDS = (3000000901, 3000000902, 3000000903)
CASES = [("vg128-gen-b128", "turbo", "img_mse"),
         ("vg128-gen-b128", "tf32", "box_err"),
         ("coco64-gen-b128", "turbo", "img_mse"),
         ("coco64-gen-b128", "tf32", "mask_err")]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,control,number", CASES)
@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_is_not_correct(cell, control, number, seed):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark import readings

    limit = files.limits(cell)["checks"][number]["limit"]
    r = readings.reading(cell, seed, 1.0, control)
    assert r["numbers"][number] > limit, r
