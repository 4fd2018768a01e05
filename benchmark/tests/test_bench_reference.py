"""The plain reference against the port at a tiny size on the CPU: the
generator, the discriminators, the losses, Adam and threefry; and the
reference's tensor names against the port's modules."""

import numpy as np
import pytest
import torch

from benchmark.drivers import generate as gen_driver
from benchmark.drivers import train as train_driver
from benchmark.harness import checks, inputs
from benchmark.reference import generator as ref
from benchmark.reference import threefry
from benchmark.reference import training as ref_train
from benchmark.tests.tiny import TINY_MODEL, TINY_TRAIN

CFG = {"num_objects": 20, "num_predicates": 7, "model": dict(TINY_MODEL),
       "serving": {"compute_dtype": "float32", "crn_mode": "legacy"},
       "train": {"learning_rate": 1e-4, "compute_dtype": "float32",
                 "crn_mode": "legacy", "l1_pixel_loss_weight": 1.0,
                 "bbox_pred_loss_weight": 10.0, "ac_loss_weight": 0.1,
                 "discriminator_loss_weight": 0.01, "d_obj_weight": 1.0,
                 "d_img_weight": 1.0, **TINY_TRAIN}}
TRAFFIC = {"batch_size": 4, "min_objects": 3, "max_objects": 6,
           "pad_objects": 8, "pad_triples": 12, "min_box": 0.14, "pool": 3,
           "ref_steps": 3}


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_threefry_equals_the_ports():
    from sg2im_tpu_torch.ops import prng

    for seed in (0, 77, -5, 2**31 - 1):
        k = threefry.key(seed)
        assert k == tuple(int(w) for w in prng.prng_key(seed).tolist())
        assert threefry.split(k) == [tuple(r) for r in
                                     prng.split(prng.prng_key(seed)).tolist()]
        ours = threefry.normal_nhwc(k, (3, 5, 7, 4), "cpu", offset=11)
        port = prng.normal(prng.prng_key(seed), (3, 5, 7, 4), offset=11)
        assert torch.equal(ours, port)


def test_tensor_names_and_shapes_are_the_ports():
    from sg2im_tpu_torch.models import AcCropDiscriminator, PatchDiscriminator
    from sg2im_tpu_torch.models.sg2im import Sg2ImGenerator

    tc = train_driver.train_config(CFG, TRAFFIC)
    v = inputs.vocab(CFG)
    for spec, module in (
            (ref.spec(CFG), Sg2ImGenerator(v, **tc.generator_kwargs())),
            (ref_train.d_obj_spec(CFG),
             AcCropDiscriminator(v, **tc.d_obj_kwargs())),
            (ref_train.d_img_spec(CFG),
             PatchDiscriminator(**tc.d_img_kwargs()))):
        assert {n: tuple(s) for n, s, _ in spec} == {
            k: tuple(t.shape) for k, t in module.state_dict().items()}


@pytest.mark.parametrize("seed", [1, 2**31 + 9])
def test_generator_equals_the_ports(seed):
    from sg2im_tpu_torch.inference import InferenceEngine

    kw, _ = gen_driver.engine_kwargs(CFG)
    W = inputs.make_weights(ref.spec(CFG), seed, "g", "cpu")
    engine = InferenceEngine(inputs.vocab(CFG), kw, W, device="cpu")
    graphs = inputs.scene_graphs(CFG, TRAFFIC, inputs.rng(seed, "graphs"), 5)
    imgs, out = engine.generate(graphs, seed=123)
    with torch.no_grad():
        r_imgs, r_boxes, r_masks, om, _ = gen_driver.reference_images(
            CFG, W, graphs, 123, "cpu", block=2)
    assert checks.u8_mse(imgs, r_imgs) < 0.05
    assert checks.real_max_abs(out["boxes"], r_boxes, om) < 1e-5
    assert checks.real_max_abs(out["masks"], r_masks, om) < 1e-5


def test_train_steps_equal_the_trainers():
    """Three steps of the port's Trainer and of the reference from the same
    weights, batches and key: the losses, the first gradients and the
    parameters' change."""
    seed = 5
    drv = train_driver.Driver(type("Ctx", (), {
        "cfg": CFG, "traffic": TRAFFIC, "seed": seed, "device": "cpu"})())
    drv.setup()
    refr = train_driver.reference_readings(CFG, TRAFFIC, seed, "cpu")
    for ps, rs in zip(drv.readings["losses"], refr["losses"]):
        np.testing.assert_allclose(ps, rs, rtol=1e-5)
    numbers = train_driver.compare(drv.readings, refr)
    assert numbers["loss_gap"] < 1e-6
    assert numbers["grad_gap"] < 1e-4
    assert numbers["update_gap"] < 1e-3


def test_half_batch_reference_reads_apart():
    """The fault the train cell's numbers must catch: the reference on half
    of each batch reads far from the whole."""
    whole = train_driver.reference_readings(CFG, TRAFFIC, 3, "cpu")
    half = train_driver.reference_readings(CFG, TRAFFIC, 3, "cpu", rows=2)
    assert train_driver.compare(half, whole)["loss_gap"] > 1e-4
