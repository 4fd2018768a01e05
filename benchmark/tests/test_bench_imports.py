"""No module of JAX, flax or the JAX package in the harness, the reference
or anything they load (top-level names compared whole, so the port,
``sg2im_tpu_torch``, passes), and nothing of the port in the reference."""

import json
import subprocess
import sys

from benchmark.harness import files

FORBIDDEN = ("jax", "jaxlib", "flax", "sg2im_tpu")

LOAD = """
import importlib, json, sys
sys.path.insert(0, {root!r})
for m in {modules!r}:
    importlib.import_module(m)
for p in {paths!r}:
    from benchmark.harness import files
    files.load_file(__import__('pathlib').Path(p))
print(json.dumps(sorted(sys.modules)))
"""


def loaded(modules, paths=()):
    code = LOAD.format(root=str(files.ROOT), modules=list(modules),
                       paths=[str(p) for p in paths])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, env={"PATH": "/usr/bin:/bin",
                                                     "JAX_PLATFORMS": "cpu"})
    return json.loads(out.stdout.strip().splitlines()[-1])


def tops(mods):
    return {m.split(".")[0] for m in mods}


def test_harness_loads_no_jax():
    mods = loaded(["benchmark.run", "benchmark.readings", "benchmark.sweep",
                   "benchmark.drivers.generate", "benchmark.drivers.train",
                   "benchmark.drivers.serve",
                   "sg2im_tpu_torch.inference", "sg2im_tpu_torch.cli.serve",
                   "sg2im_tpu_torch.train.trainer"],
                  sorted((files.BENCH_DIR / "metrics").glob("*.py"))
                  + sorted((files.BENCH_DIR / "kernels").glob("*.py")))
    assert "sg2im_tpu_torch" in tops(mods)
    assert not tops(mods) & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    mods = loaded(["benchmark.reference.generator",
                   "benchmark.reference.training",
                   "benchmark.reference.threefry"])
    assert not tops(mods) & (set(FORBIDDEN) | {"sg2im_tpu_torch"})


def test_run_refuses_a_process_that_holds_jax_names():
    from benchmark import run

    sys.modules["sg2im_tpu.fake_for_test"] = object()
    try:
        assert run.forbidden_modules() == ["sg2im_tpu.fake_for_test"]
    finally:
        del sys.modules["sg2im_tpu.fake_for_test"]
    assert "sg2im_tpu_torch" not in json.dumps(run.forbidden_modules())
