"""Per-section roofline of the vg128 b128 forward on the card.

Port of ``scripts/roofline.py``.  For each mode (``--modes``, default
bf16/split, bf16/phase, bf16/packed and f32: ``InferenceEngine``'s
``compute_dtype`` / ``crn_mode``, with TF32 off for every f32 matmul and
convolution, as the engine runs them) it times every section of the
generator's forward with CUDA events on bench.py:126-134's inputs (O 16
with 11 live objects, T 32, ``RandomState(0)``) and random weights from
seed 0 (``chip_smoke.py``'s vg128), and gives each a row of
``utils.roofline.section_row``: ms, FLOPs, the bytes it must move at
least, the shares of the data sheet's peaks and of the run's measured
ones, and the speed of light.  Sections, named as in the JAX package's
``PERF.json``:

* ``gcn_x5`` (the embeddings and the 5 GCN layers: ``encode_graph``),
  ``box+rel_heads``, ``mask_head``, ``layout_compose`` (K1),
  ``noise+concat`` and ``crn_total``: the generator's own section methods
  (``Sg2ImGenerator.encode_graph`` ... ``crn_input``) and its
  ``refinement_net``, each on what the forward hands it, so that the
  chain of them is the forward (a test holds it bit for bit);
* ``crn_s{1..5}_conv{0,1}``: the legacy-shaped single convs of each stage
  (conv0 over the layout-and-feats concat, conv1), with the stage's own
  weights, eval BatchNorm and LeakyReLU, on random inputs;
* ``crn_stage{1..5}_prod``: each stage's ``RefinementModule`` (or its
  ``packed`` entry where the mode packs the stage) on the inputs the
  network gave it in one forward;
* ``e2e_forward``: the whole generator;
* ``peak_*``: the run's peaks, a bf16 and an f32 ``--peak_size``^3
  ``torch.matmul`` and an f32 scale+add over 1 GiB.

Each operation is held to its type's peak (``utils.roofline``): the f32
GCN, heads, mask head and layout compose (K1) to f32's 67 TFLOP/s in
every mode, the CRN's convolutions to the bf16 tensor cores' 989 in a bf16
mode, so a section that holds both (``e2e_forward``) gets the sum of the
two times as its operations' least time.  ``--profile`` adds, per mode, the
``torch.profiler`` table of the forward over 3 calls: device ms, the
unprofiled wall per forward, idle = 1 - device / wall, the ten largest
kernels.

    python -m sg2im_tpu_torch.tools.roofline [--modes ...] [--profile]
        [--iters 10] [--out DIR]

Prints one JSON object per mode and writes ``<out>/roofline.json``.  It
neither reads nor writes the JAX package's ``PERF.json``.
"""

from __future__ import annotations

import contextlib
import json
import math
import sys
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from sg2im_tpu_torch.tools import _measure as M
from sg2im_tpu_torch.utils.flags import int_tuple, str_tuple
from sg2im_tpu_torch.utils.roofline import peaks, section_row, tensor_bytes

MODES = {"f32": {}, "bf16/split": {"crn_mode": "split"},
         "bf16/phase": {"crn_mode": "phase"},
         "bf16/packed": {"crn_mode": "packed"},
         "bf16/split_noise": {"crn_mode": "split_noise"}}
DEFAULT_MODES = ("bf16/split", "bf16/phase", "bf16/packed", "f32")


class Section(NamedTuple):
    """One section: ``fn(*[env[k] for k in reads])`` -> {name: output};
    ``modules`` hold the parameters it reads."""
    name: str
    fn: Callable
    reads: tuple
    modules: tuple


def engine_kwargs(mode: str) -> dict:
    kw = dict(MODES[mode])
    if mode.startswith("bf16"):
        kw["compute_dtype"] = torch.bfloat16
    return kw


def forward_sections(model) -> list[Section]:
    """The generator's forward as its sections, in order, over an
    environment that starts with objs, triples, obj_mask, triple_mask and
    noise."""
    m = model
    return [
        Section("gcn_x5", lambda *a: dict(zip(
            ("obj_vecs", "pred_vecs", "obj_vecs_orig", "s", "o"),
            m.encode_graph(*a))),
            ("objs", "triples", "obj_mask", "triple_mask"),
            (m.obj_embeddings, m.pred_embeddings, m.gconv,
             getattr(m, "gconv_net", None))),
        Section("box+rel_heads", lambda *a: dict(zip(
            ("boxes", "rel_scores"), m.predict_boxes_rels(*a))),
            ("obj_vecs", "obj_vecs_orig", "s", "o", "obj_mask",
             "triple_mask"), (m.box_net, m.rel_aux_net)),
        Section("mask_head", lambda *a: {"masks": m.predict_masks(*a)},
                ("obj_vecs", "obj_mask"), (m.mask_net,)),
        Section("layout_compose",
                lambda *a: {"layout": m.compose_layout(*a)},
                ("obj_vecs", "boxes", "masks", "obj_mask"), ()),
        Section("noise+concat", lambda *a: dict(zip(
            ("crn_in", "crn_noise"), m.crn_input(*a))),
            ("layout", "noise"), ()),
        Section("crn_total", lambda x, n: {"imgs": m.refinement_net(
            x, m.compute_dtype, noise=n)}, ("crn_in", "crn_noise"),
            (m.refinement_net,)),
    ]


@contextlib.contextmanager
def capture_stages(net):
    """Record every call of the CRN's stages inside the block: [(stage,
    'forward' or 'packed', args, kwargs, output)]."""
    calls, patched = [], []
    for i, mod in enumerate(net.refinement_modules):
        for meth in ("forward", "packed"):
            def wrapped(*a, _orig=getattr(mod, meth), _i=i, _m=meth, **k):
                out = _orig(*a, **k)
                calls.append((_i, _m, a, k, out))
                return out
            setattr(mod, meth, wrapped)
            patched.append((mod, meth))
    try:
        yield calls
    finally:
        for mod, meth in patched:
            delattr(mod, meth)


def stage_sections(net, calls) -> list[tuple]:
    """[(name, fn, operands, module, output)] of the stages' recorded
    calls."""
    out = []
    for i, meth, a, k, res in calls:
        mod = net.refinement_modules[i]
        fn = (lambda mod=mod, meth=meth, a=a, k=k:
              getattr(mod, meth)(*a, **k))
        out.append((f"crn_stage{i + 1}_prod", fn, (a, k), mod, res))
    return out


def legacy_convs(net, N: int, H: int, dtype, device) -> list[tuple]:
    """[(name, fn, operands, modules)] of each stage's legacy-shaped single
    convs on random inputs: conv0 over the (layout + feats)-channel concat
    and conv1, each with its bias, the stage's eval BatchNorm and
    activation."""
    from sg2im_tpu_torch.nn.layers import apply_activation

    gen = torch.Generator(device=device).manual_seed(3)
    out = []
    n = len(net.refinement_modules)
    for i, stage in enumerate(net.refinement_modules):
        res = H >> (n - 1 - i)
        conv0, conv1, norms = stage._layers()
        for k, (conv, norm) in enumerate(((conv0, norms[0]),
                                          (conv1, norms[1]))):
            x = torch.randn((N, conv.weight.shape[1], res, res),
                            generator=gen, device=device).to(dtype).contiguous(
                memory_format=torch.channels_last)

            def fn(x=x, conv=conv, norm=norm, act=stage.act):
                y = F.conv2d(x, conv.weight.to(dtype), conv.bias.to(dtype),
                             padding=1).float()
                if norm is not None:
                    y = norm(y)
                return apply_activation(act, y).to(dtype)

            out.append((f"crn_s{i + 1}_conv{k}", fn, (x,),
                        (conv, norm)))
    return out


def measure_mode(mode, vocab, kwargs, state, batch, device, args,
                 measured) -> dict:
    """Every section's row for one mode (see the module docstring)."""
    from sg2im_tpu_torch.inference import InferenceEngine, full_fp32

    engine = InferenceEngine(vocab, kwargs, state, device=str(device),
                             **engine_kwargs(mode))
    model = engine.model
    inputs = M.device_batch(batch, device)
    H, W = model.image_size
    noise = torch.randn((len(batch.objs), model.layout_noise_dim, H, W),
                        generator=torch.Generator(device=device).manual_seed(
                            2), device=device).contiguous(
        memory_format=torch.channels_last)
    env = dict(zip(("objs", "triples", "obj_mask", "triple_mask"), inputs),
               noise=noise)
    bf16 = mode.startswith("bf16")
    pk = peaks(measured)
    rows = []
    k1_shape = (len(batch.objs), inputs[0].shape[1], model.mask_size, H, W,
                kwargs["gconv_dim"])

    def add(name, fn, operands, modules):
        out = fn()  # also the warm-up
        flops, kernels = M.count_flops(fn, k1_shape)
        ms = M.time_ms(fn, device, args.iters)
        row = section_row(name, ms, flops,
                          tensor_bytes(operands, modules, out), pk)
        row["hand_kernel_flops"] = kernels
        leaves = [t for t in _tensors(out) if t.is_floating_point()]
        row["finite"] = all(bool(torch.isfinite(t).all()) for t in leaves)
        rows.append(row)
        return out

    with torch.inference_mode(), full_fp32():
        for sec in forward_sections(model):
            operands = [env[k] for k in sec.reads]
            env.update(add(sec.name, lambda s=sec, o=operands: s.fn(*o),
                           operands, sec.modules))
        net = model.refinement_net
        dtype = torch.bfloat16 if bf16 else torch.float32
        for name, fn, operands, modules in legacy_convs(
                net, len(batch.objs), H, dtype, device):
            add(name, fn, operands, modules)
        with capture_stages(net) as calls:
            net(env["crn_in"], model.compute_dtype, noise=env["crn_noise"])
        for name, fn, operands, mod, _ in stage_sections(net, calls):
            add(name, fn, operands, (mod,))

        def e2e():
            return model(*inputs, noise)

        add("e2e_forward", e2e, (inputs, noise), (model,))
        profile = None
        if args.profile:
            wall = M.windows_ms(e2e, device, windows=1, iters=3)[0]
            profile = M.kernel_table(e2e, device, iters=3)
            if profile is not None:
                profile["wall_ms"] = wall
                profile["idle_unprofiled"] = 1.0 - profile["device_ms"] / wall
    del engine
    return {"mode": mode, "sections": rows, "profile": profile}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def peak_rows(device, args) -> tuple[dict, list]:
    """The run's measured peaks and their rows."""
    pk = M.measured_peaks(device, args.peak_size, args.stream_shape)
    n, stream = args.peak_size, 2 * 4 * math.prod(args.stream_shape)
    rows = []
    for name, kind, nbytes in (("peak_bf16_matmul", "bf16", 3 * 2 * n * n),
                               ("peak_f32_matmul", "f32", 3 * 4 * n * n)):
        ms = 2 * n ** 3 / pk[name[5:] + "_flops"] * 1e3
        rows.append(section_row(name, ms, {kind: 2 * n ** 3}, nbytes,
                                peaks()))
    ms = stream / pk["scale_add_bytes"] * 1e3
    rows.append(section_row("peak_scale_add", ms, {}, stream, peaks()))
    return pk, rows


def main(argv=None) -> int:
    p = M.base_parser(__doc__)
    p.add_argument("--modes", type=str_tuple, default=DEFAULT_MODES,
                   help=f"comma-separated, of {sorted(MODES)}")
    p.add_argument("--config", default="vg128", choices=("vg128", "tiny"),
                   help="tiny: a small generator for host runs")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--profile", action="store_true")
    p.add_argument("--peak_size", type=int, default=8192)
    p.add_argument("--stream_shape", type=int_tuple,
                   default=(256, 1024, 1024))
    args = p.parse_args(argv)
    bad = [m for m in args.modes if m not in MODES]
    if bad:
        p.error(f"unknown modes {bad}")
    opened = M.open_device(args)
    if opened is None:
        return 1
    device, card = opened
    print(card)
    vocab, kwargs = (M.vg128_config() if args.config == "vg128"
                     else M.tiny_config())
    state = M.random_state(vocab, kwargs, seed=0)
    batch = M.bench_inputs(args.batch, vocab)
    measured, prows = peak_rows(device, args)
    results = []
    for mode in args.modes:
        res = measure_mode(mode, vocab, kwargs, state, batch, device, args,
                           measured)
        res.update(config=args.config, batch=args.batch, card=card,
                   device=str(device), peaks=measured,
                   sections=prows + res["sections"])
        print(json.dumps(res))
        results.append(res)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    M.write_report(args.out, "roofline", results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
