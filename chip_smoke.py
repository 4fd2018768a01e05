#!/usr/bin/env python3
"""Smoke run of the PyTorch port (sg2im_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its numbers on its own line; any failure ends the run
with a non-zero exit code:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, the TF32 flags;
2. build: nvcc builds csrc/layout_compose.cu, csrc/conv3x3.cu,
   csrc/relayout.cu, csrc/crn_epilogue.cu, csrc/mask_head.cu,
   csrc/resample.cu and csrc/threefry.cu for sm_90a, one process each,
   started together;
3. kernels: both entries of the layout-compose kernel against their plain
   PyTorch versions on the card, in f32 and bf16 (flagship shapes, ragged
   cases, degenerate boxes with empty object slots, and for the weights
   entry dense signed weights, M = 32, H not a multiple of its band and
   more objects than one group; for the boxes entry one object past a
   group, O 1 and D 20 on ragged tiles), then their time at the flagship
   batch-128 shape (the boxes entry with f32 and with bf16 output, each
   beside its bound) beside the plain versions, one einsum of the weights
   entry's function and a fill_ of the output's bytes; and E1, the CRN's
   post-convolution chain (csrc/crn_epilogue.cu), against its plain
   version, the eager chain, within one bf16 step up to the float32
   roundings of the BatchNorm's terms (the share bit-equal printed) at
   the eleven chains of a vg128 b128 forward in bf16 'split'
   (each stage's conv0 of two addends and its conv1; the head's float32
   output bit-equal), three addends and channels off 8 a unit; a vg128
   stage in 'legacy' and in 'phase', and one in 'split' left in NCHW (its
   parts' copies to channels_last counted), fused against the same stage
   kept eager; its launches in one generate of each bf16 CRN mode (eleven a
   forward, none in 'packed'); then the eleven chains timed beside their
   bytes bound and the eager chain; and M1, the eval mask head
   (csrc/mask_head.cu), against the eager head (cuDNN, TF32 off) within
   MASK_HEAD_BAR at vg128's b128 shape and a ragged one, one launch a
   step, then timed beside its all-slot operations bound, its plain
   version (the phase form in cuBLAS matmuls) and the eager head; and R1,
   the CRN's 2x resampling (csrc/resample.cu): the layout pyramid and each
   feats upsample of both benchmark cells' b128 bf16 forwards bit-equal to
   aten's avg_pool2d and interpolate, with float32, one and five levels,
   a one-vector width and an NCHW input (its copy counted) besides, each
   direction timed at both cells beside its bytes bound and its plain
   version (aten's own calls), and its launches in one generate of each
   bf16 CRN mode;
4. conv: both entries of the 3x3 conv kernel (bf16, and the turbo tier's
   int8) against their plain versions on the turbo path's shapes, the
   CRN shapes of the TPU prototype and the edges of the kernel's tile plan
   and tensor map (ragged and unaligned inputs), then their time at batch
   128 (the wrapper's call: weight packing and kernel) in turns with
   cuDNN's bf16 conv, beside the plain versions, the weight packing alone
   and the bound;
5. relayout: both entries of the space-to-depth / depth-to-space kernel
   bit-equal to their plain versions at the packed CRN's and the phase
   CRN's batch-128 shapes and on ragged and unaligned cases, with the
   route each took (no path shape on the units route, here and on every
   path driven later), then their time beside the plain version's, beside
   a copy_ of the same bytes and beside the one copy that computes the
   same function (a view of the NHWC tensor permuted and reshaped:
   torch's own relayout); the packed path's sums go into the kernels
   line, the phase path's d2s sum beside its bound on a line of its own;
5b. threefry: the threefry-normal kernel (the JAX package's
   jax.random.normal, drawn on the card) against its plain version
   (ops.prng) on the card: the random bits bit-equal and the normals
   within THREEFRY_BAR in f32 and bf16, on seeds at the int32 edges, an
   odd shape, upsampling by 1, 2 and 4, both memory formats, offsets
   whose counters cross 2^32 (inside one thread's run of values too),
   channel counts and widths that are no multiple of the values a thread
   (the kernel's ragged edges), a key split on the card and read where it
   lies, a data-parallel row slice drawn by offset against those rows
   of the whole draw, and the paths' own draws whole at their shapes
   (THREEFRY_PATH_CASES: b128 bf16 channels_last, the train step's NCHW
   f32, the server's 16 rows); then its time at vg128 b128 (67.1 M
   values, f32 and bf16) beside the plain version and torch.randn of the
   same shape (a reference only: another generator), its bound from the
   least instructions this ISA needs a value (utils/roofline's
   THREEFRY_OPS) at the card's max SM clock, with its SASS's mix
   (cuobjdump, per value) printed beside it, and the train step's NCHW
   draw and b128 at f 2 each timed beside its bound
   (THREEFRY_TIMED_MORE); and the split kernel
   (jax.random.split, the train step's key) bit-equal to the plain split
   and timed beside it, on events and on the device, beside the card's
   least launch by the same route (an empty kernel: the launch floor,
   printed beside its hash's bound); and the uniform entry (jax.random.uniform times a float32
   scale, the parameter init's) bit-equal to its plain version on
   UNIFORM_CASES (the init's bias bounds for fans 9 x 16 ... 9 x 1024,
   its [-1, 1) x sqrt(3 var) kernel draw, ragged sizes, counters across
   2^32), timed at the vg128 generator's largest leaf beside its bound;
5c. init: the JAX package's parameter init (nn/init.py) of the vg128
   generator for PRNGKey(0) drawn on the card, one threefry launch (the
   uniform or the scaled normal) a drawn leaf and no other kernel,
   against the CPU's plain init of the same key (uniform leaves, ones
   and zeros bit-equal, normal leaves within THREEFRY_BAR times their
   scale); its time beside the CPU's;
6. the learned checkpoint artifacts/trained_coco64.pt through the
   run_model CLI on the card, in float32 and on the int8 turbo tier with a
   calibration file made on the card, each held against the CPU engine by
   u8 PSNR;
7. vg128 serving: the flagship generator (random weights from a seed)
   answers generate requests of 1, 3 and 8 graphs in float32, bf16 /
   'split', the turbo tier, bf16 / 'packed', 'phase' and 'split_noise'
   and float32 / 'packed' (M1 launched four times a forward in each),
   agrees with the CPU engines on a small input, and its batch-128
   forward is timed in each mode;
7b. seeded: the JAX package's seed contract across devices: the seeded
   vg128 b128 generate on the card in f32 (one threefry launch, one K1
   launch) against the CPU engine's seeded generate of its first two
   graphs at u8 PSNR >= PSNR_BAR, the card's noise rows against the
   CPU's draw of the same rows by offset within THREEFRY_BAR, and
   torch.profiler's kernel table of the generate naming the threefry
   kernel and K1;
8. serving over HTTP: the port's server (sg2im_tpu_torch.cli.serve) with
   the same vg128 weights, written as a checkpoint, in bf16 / 'split', on
   the turbo tier at a calibration file made on the card and in bf16 /
   'phase': healthz, PNG and npy replies, a seeded reply bit-equal to
   engine.generate, concurrent requests coalesced into fewer engine calls
   (each within 1 u8 level of the request alone), kernel launches per
   engine call and /metrics against what was sent; bf16 / 'split' img/s
   of coalesced batch-128 rounds beside engine.generate and the forward,
   1-graph latency from the server's histogram and host ms per request;
   the on-device deprocess against the host's, noise_downsample=2 on zero
   noise against full resolution, and verify_pretrained --device cuda on
   the learned checkpoint against the CPU engine's images;
9. training: the port's Trainer at the COCO-64 flagship (bench.py's
   train_step_setup, b32) in f32 / 'legacy', bf16 / 'split' and f32 /
   'packed': step 1 on the card against the CPU's from the same state,
   batch (its first TRAIN_CPU_BATCH images) and noise, losses within
   TRAIN_LOSS_BAR; K1's forward at the training shape (f32 and bf16 out)
   against the plain compose, its Function gradients and K3's backward
   against autograd of their plain versions; K1 launched once per G
   forward in every mode, both K3 entries in the G forward and in the G
   backward of a 'packed' step (counts read at the step's phase marks);
   a batch with one NaN image leaves every tensor of the
   state bit-identical; an async save loaded into a fresh Trainer takes
   the uninterrupted run's next step (cuDNN deterministic); median ms per
   step, img/s and peak memory of f32 and bf16 / 'split'; K1's forward
   and plain-backward time per step;
10. the training CLI: sg2im_tpu_torch.cli.train on a synthetic COCO
   written here in the on-disk formats (JPEGs, instances and stuff JSON
   with polygon and RLE segmentations) at COCO-64's full widths, b32, 40
   steps, in f32 / 'legacy' and bf16 / 'split': clean exit and finite
   losses; the loader's first batches after prefetch_to_device bit-equal
   to the host's; step 1 (reading the decoded-sample cache, PIL decoder)
   equal to a direct Trainer.step on the loader's first batch; a run
   stopped at step 20 and resumed by `python -m sg2im_tpu_torch.cli.train
   --restore_from_checkpoint true` equal at steps 30 and 40; the snapshot
   through run_model on the card; K1's launches exactly the steps, the
   check_model batches, three per triptych and step_breakdown's G calls,
   the threefry draw exactly once per step, check_model batch, triptych
   and step_breakdown, and no other kernel; median
   ms per step, img/s, the loader's wait, the
   idle share under torch.profiler and peak memory beside phase_train's
   in-memory step, the same steps with the decoded-sample cache, and
   in-memory steps on the loader's first batch with cuDNN's default
   algorithms, its deterministic ones and the CLI's deterministic mode,
   and whether two runs from one init repeat bit for bit under the last
   two (the CLI's must).
   The CLI's output goes to build/chip_smoke/;
11. tools: sg2im_tpu_torch.cli.sample_images --device cuda on the
   training CLI's f32 snapshots (--checkpoint_list of its output
   directory) and on its Trainer checkpoint (--model_mode train,
   ground-truth boxes and masks) over the synthetic COCO's val split, b24
   with the last batch padded: PNG, ground-truth PNG and data.npz row
   counts, K1 launched once per batch; checkpoint_tools export of the
   checkpoint through run_model --device cuda, bit-equal to the snapshot
   of the same step;
12. jax_checkpoint: the JAX store's format (ckpt.store's backend
   'msgpack'): tests/fixtures/jax_ckpt_tiny, a state.msgpack the JAX
   package wrote, loads on the card and its next step's losses match the
   JAX package's (expected.npz) within TRAIN_LOSS_BAR relative +
   JAX_LOSS_ATOL, K1 launched once; the f32 training CLI run's t=20
   checkpoint, written again as state.msgpack, reads back bit-equal to its
   state.pt with its histories (MB and seconds to write and read both
   files printed), `cli.train --restore_from_checkpoint 1` resumes it to
   CLI_STEPS twice with finite, bit-identical loss traces, K1 and the
   threefry draw launched (the draw exactly once per step, check_model
   batch, triptych and step_breakdown) and no other kernel, and its later
   checkpoint
   still state.msgpack;
   sample_images and checkpoint_tools export open that directory, the
   export's run_model images bit-equal to the snapshot of the same step;
13. parallel: parallel.dryrun's two ranks with Gloo on CUDA tensors, both
   on cuda:0 (NCCL refuses two ranks on one card), on the tiny config
   (step, check_model, save, restore, step) and on the COCO-64 flagship at
   b32 (16 rows a rank), each against the one-process step on the same
   global batch and noise (losses within DP_LOSS_BAR; a correctness run,
   not a speed), K1 launched three times per rank; the Trainer in a
   world-1 NCCL group against Trainer.step without one, timed in turns,
   with its collectives per step; cli.train --multihost true at world 1
   on NCCL from torchrun's variables;
14. mesh: vg128 at b128 on a mesh of two data
   rows on cuda:0 in f32, bf16 / 'split', turbo and bf16 / 'packed'
   against the single engine on each row's graphs with the same noise
   rows (f32 within MESH_F32_BAR, bf16 within 1 u8, turbo within 2 u8 and
   55 dB at shared scales; the single engine's own b128 call printed
   beside it, as cuDNN picks algorithms by batch), K1 once per row, the
   turbo tier's K4 and 'packed''s K3 launched; and the tensor-parallel
   mesh (2 x 2, the GCN hidden dimension split) against the replicated
   one: boxes at tests/test_parallel.py's rtol / atol, images within
   MESH_TP_U8;
15. proofs: the training proofs through sg2im_tpu_torch.tools on their
   learnable disk dataset (2048 64 px JPEGs, each category a colour): K1's
   forward and Function gradients at the proofs' widths (D 64 and 128) on
   a batch of that data; train_proof in f32 / 'legacy' for PROOF_ITERS
   steps at b32 with 8 loader workers, L1 falling; a second f32 run of
   PROOF_REPEAT_ITERS steps whose L1 trace is bit-identical to the
   first's on their common prefix; bf16 / 'split' for PROOF_ITERS steps,
   L1 falling; trained_fidelity for FIDELITY_ITERS steps at its
   documented seed, its box head alive at init and after training, its
   export through verify_pretrained --device cuda against the CPU engine's
   goldens at >= 40 dB, and its box-head probe refusing seed 1 (y1 dead
   under the JAX init) on the card; loader_bench at the f32 proof's steady
   rate.  K1 launched exactly once per step and per final check_model,
   probe and gate forward, the threefry draw exactly once per step and per
   final check_model batch and triptych, and no other kernel (besides the
   inits' draws).  Their
   output goes to build/chip_smoke/proof_*.log;
16. measure: every measurement tool of sg2im_tpu_torch.tools once at
   reduced counts (MEASURE_RUNS): bw_probe's stream rates; roofline's
   per-section rows of the vg128 b128 forward in bf16 / 'split' and bf16 /
   'packed' with its profile; profile_crn's per-stage times, its modes
   equal in f32; roofline_train's rows of the COCO-64 b32 step in both
   configurations with their idle shares; profile_seeded_noise's eager,
   seeded and zero-noise paths, eager and seeded bit-identical, the draw
   seen by the profiler; profile_turbo_frontier's bands.  Each exits 0,
   launches the kernels of its path, and every row is there and finite,
   with no share of a data-sheet peak or of the speed of light above
   SHARE_BAR; then a kernel table of three threefry draws, this late in
   the run, counts one kernel a draw.  Their output goes to
   build/chip_smoke/measure_*.log;
17. bench: sg2im_tpu_torch.tools.bench (the port's bench.py) at its
   defaults (vg128 b128 bf16 / 'split' on bench.py's inputs, 10
   iterations, 3 windows, the extras) and with --mode train: exit 0, every
   key of bench.py's line (BENCH_r05.json's "parsed") plus card and
   psnr_reference, every value finite and not null, the u8 PSNR of the
   f32 and production engines against the CPU reference at least
   PSNR_BAR, the trained checkpoint's gate passed, K1 launched in both
   runs and the int8 conv in the turbo parts; its primary img/s beside
   phase_vg128's bf16 / 'split' on other graphs.  Its output goes to
   build/chip_smoke/bench_*.log.

Each path (the turbo CLI, the vg128 requests of f32 and bf16/split, the
turbo requests, the requests of each further CRN mode, the HTTP traffic of
each server, the train steps of each mode, the uninterrupted CLI run of
each mode, each sample_images run, the JAX fixture's step and each CLI
run resuming state.msgpack, the data-parallel ranks (counted in
their processes), the world-1 NCCL steps and CLI run, each mesh engine's
generate, each proof tool's run, each measurement tool's run, each bench
run) runs with the kernels' launch counts set to 0 just before it and read
just after; the conv wrappers' padded input copies, counted the same way,
must stay 0 on every path and in every timed batch-128 forward.  Every
Trainer.init_state on the card launches exactly Trainer.init_launches()
(the key's split and one threefry draw a drawn leaf); a path's checks of
its per-step counts leave those launches out, its totals keep them.
A line gives each phase's seconds.  The line before the last is a JSON
summary of every ported kernel with its launches on those paths, its time
beside its plain version's, its bound (the larger of its bytes over the
card's memory rate and its operations over the peak rate of their type)
and one PyTorch call of the same function where there is one; the split's
entry adds its device time and the card's least launch by its route
(launch_floor_ms, on events; launch_floor_device_ms), since no launch
comes near its hash's bound.  The boxes
entry stands there twice, each with its own bound: layout_compose_boxes
with all its launches, timed with an f32 output, and
layout_compose_boxes_bf16 with its launches of a bf16 output, timed so;
both counts mean what they mean on every path.  The last line is
{"ok": true, "device": {...}}.  It needs no network and no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

from sg2im_tpu_torch.tools._measure import (
    KERNEL_BAR,
    LAYOUT_TIMED,
    kernel_table,
    layout_inputs,
    time_ms,
    vg128_config,
    within_one_rounding,
)
from sg2im_tpu_torch.utils.roofline import (
    BF16_FLOPS,
    F32_FLOPS,
    INT8_OPS,
    conv_bounds,
    layout_bounds,
    relayout_bounds,
    roofline_ms,
)

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "sg2im_tpu_torch/csrc/layout_compose.cu"
CONV_SOURCE = "sg2im_tpu_torch/csrc/conv3x3.cu"
RELAYOUT_SOURCE = "sg2im_tpu_torch/csrc/relayout.cu"
PSNR_BAR = 40.0    # u8 dB, the fidelity gate of the JAX package


class SmokeFailure(Exception):
    """A failed check: the run ends with a non-zero exit code."""


def fail(msg: str) -> None:
    raise SmokeFailure(msg)


def psnr_u8(a, b) -> float:
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(255.0 ** 2 / mse))


def phase_environment(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()} matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}")
    return card


def phase_build():
    """nvcc of every kernel source, all started together."""
    from sg2im_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build()
    wall = time.perf_counter() - t0
    for source, (path, seconds, log) in built.items():
        print(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)} {source} -> "
              f"{os.path.relpath(path, REPO)} in {seconds:.2f} s")
        for ln in log.splitlines():
            if any(k in ln for k in ("Compiling entry", "registers",
                                     "spill", "smem")):
                print(f"[build]   {ln.strip()}")
    print(f"[build] {len(built)} sources in {wall:.2f} s wall")
    _build.load_library()


KERNEL_CASES = {
    # name: (N, O, M, H, W, D, degenerate boxes and empty object slots,
    # dense random signed Wy / Wx for the weights entry instead of the
    # boxes' tents)
    "vg128 N16 O16 M16 128x128 D128": (16, 16, 16, 128, 128, 128, False,
                                       False),
    "ragged N3 O5 M8 24x40 D13": (3, 5, 8, 24, 40, 13, False, False),
    "ragged N2 O7 M16 40x250 D36": (2, 7, 16, 40, 250, 36, False, False),
    "degenerate N2 O40 M16 64x64 D200": (2, 40, 16, 64, 64, 200, True,
                                         False),
    "dense N4 O16 M16 128x128 D128": (4, 16, 16, 128, 128, 128, False, True),
    "M32 N3 O9 M32 64x96 D64": (3, 9, 32, 64, 96, 64, False, True),
    "band-ragged N2 O6 M6 37x72 D32": (2, 6, 6, 37, 72, 32, False, True),
    "groups N2 O120 M8 9x128 D64": (2, 120, 8, 9, 128, 64, False, False),
    # The boxes entry's tile edges: one object past a group of 37, O 1 on
    # an image narrower than a tile, D 20 (bf16 in 8-byte stores) on H and
    # W not multiples of the tile.
    "groups+1 N2 O38 M16 64x64 D128": (2, 38, 16, 64, 64, 128, False,
                                       False),
    "O1 N3 O1 M4 6x2 D24": (3, 1, 4, 6, 2, 24, False, False),
    "ragged N2 O4 M16 33x47 D20": (2, 4, 16, 33, 47, 20, False, False),
}


def dense_weights(torch, N, O, M, H, W, seed, device="cuda"):
    """Dense, signed warp weights wy (N, O, H, M), wx (N, O, W, M) from a
    seed, uniform in [-1, 1) / sqrt(M): nothing like tents, every tap
    non-zero, sums of the size the tents give."""
    rng = np.random.RandomState(seed + 1000)
    scale = np.float32(1.0 / np.sqrt(M))
    wy = rng.uniform(-1, 1, (N, O, H, M)).astype(np.float32) * scale
    wx = rng.uniform(-1, 1, (N, O, W, M)).astype(np.float32) * scale
    return torch.tensor(wy, device=device), torch.tensor(wx, device=device)


def boxes_plan_text(plan) -> str:
    return (f"TH {plan.TH} TX {plan.TX} G {plan.G} ({plan.groups} "
            f"group{'s' if plan.groups > 1 else ''}) {plan.threads} threads, "
            f"{plan.smem} B smem")


def plan_text(plan) -> str:
    return (f"TH {plan.TH} TX {plan.TX} G {plan.G} oc {plan.oc} PX "
            f"{plan.PX} {plan.threads} threads, "
            f"st.global stores, {plan.smem} B smem")


def check_kernel_case(torch, name, N, O, M, H, W, D, degenerate, dense,
                      seed=0):
    """Both kernel entries against their plain versions on one input, in f32
    at KERNEL_BAR abs and in bf16 within one rounding; with degenerate
    boxes, a zero-area object adds exactly 0 through either entry.  The
    weights entry takes the boxes' tent weights, or with ``dense`` dense
    signed ones.  The float64 errors printed beside say which side a
    difference comes from.  Returns {entry: max abs error}.
    """
    from sg2im_tpu_torch.ops import layout_kernel as lk
    from sg2im_tpu_torch.ops.layout import box_warp_weights

    boxes, masks, vecs = layout_inputs(N, O, M, H, W, D, seed,
                                       degenerate)
    tents = box_warp_weights(boxes, H, W, M, M)
    wy, wx = dense_weights(torch, N, O, M, H, W, seed) if dense else tents

    def exact(wy, wx):
        return lk.layout_compose_weights_ref(wy.double(), wx.double(),
                                             masks.double(), vecs.double())

    entries = {  # entry: (kernel(vecs, out_dtype), plain, float64)
        "boxes": (lambda v, dt: lk.layout_compose(boxes, masks, v, H, W,
                                                  out_dtype=dt),
                  lk.layout_compose_ref(boxes, masks, vecs, H, W),
                  exact(*tents)),
        "weights": (lambda v, dt: lk.layout_compose_weights(
                        wy, wx, masks, v, out_dtype=dt),
                    lk.layout_compose_weights_ref(wy, wx, masks, vecs),
                    exact(wy, wx)),
    }
    errs = {}
    line = [f"[kernels] {name}:"]
    for entry, (kernel, want, f64) in entries.items():
        out = kernel(vecs, torch.float32)
        out_bf16 = kernel(vecs, torch.bfloat16)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            fail(f"{entry} entry gave non-finite values on {name}")
        errs[entry] = (out - want).abs().max().item()
        line.append(
            f"{entry} max_abs_err={errs[entry]:.3e} (vs f64 "
            f"{(out.double() - f64).abs().max().item():.3e}; plain vs f64 "
            f"{(want.double() - f64).abs().max().item():.3e})")
        if errs[entry] > KERNEL_BAR:
            fail(f"{entry} entry disagrees with the plain version on {name}:"
                 f" {errs[entry]:.3e} > {KERNEL_BAR}")
        # bf16 output: within one bf16 rounding of the f32 result.
        bf_err = (out_bf16.float() - want).abs()
        line.append(f"bf16-out {bf_err.max().item():.3e};")
        if not within_one_rounding(out_bf16, want):
            fail(f"{entry} entry's bf16 output off by more than one "
                 f"rounding on {name}")
        if degenerate:
            # A zero-area object adds exactly nothing.
            lone = torch.zeros_like(vecs)
            lone[:, 2] = vecs[:, 2] + 1.0
            if kernel(lone, torch.float32).abs().max().item() != 0.0:
                fail(f"a degenerate box leaked into the {entry} entry's "
                     f"layout")
            line.append("degenerate-box output exactly 0;")
    line.append(f"max|out| {entries['weights'][1].abs().max().item():.2f}; "
                f"boxes plan {boxes_plan_text(lk.boxes_plan(O, H, W, M, D))};"
                f" weights plan {plan_text(lk.weights_plan(O, H, W, M, D))}")
    print(" ".join(line))
    return errs


def weights_library(torch, wy, wx, masks, vecs):
    """The weights entry's function as one PyTorch call."""
    return torch.einsum("noyi,noij,noxj,nod->nyxd", wy, masks, wx, vecs)


def phase_kernels(torch, card):
    from sg2im_tpu_torch.inference import full_fp32
    from sg2im_tpu_torch.ops import layout_kernel as lk
    from sg2im_tpu_torch.ops.layout import box_warp_weights

    errs = {"boxes": 0.0, "weights": 0.0}
    with torch.inference_mode(), full_fp32():
        for i, (name, case) in enumerate(KERNEL_CASES.items()):
            for entry, err in check_kernel_case(torch, name, *case,
                                                seed=i).items():
                errs[entry] = max(errs[entry], err)

        # Time at the serving path's batch-128 shape.
        N, O, M, H, W, D = LAYOUT_TIMED
        boxes, masks, vecs = layout_inputs(N, O, M, H, W, D, seed=7)
        wy, wx = box_warp_weights(boxes, H, W, M, M)
        before = (lk.layout_compose.launches,
                  lk.layout_compose_weights.launches)
        times = {
            "boxes": time_ms(lambda: lk.layout_compose(
                boxes, masks, vecs, H, W)),
            "boxes_plain": time_ms(lambda: lk.layout_compose_ref(
                boxes, masks, vecs, H, W)),
            # The main path's instance: bf16 output (every bf16 mode).
            "boxes_bf16": time_ms(lambda: lk.layout_compose(
                boxes, masks, vecs, H, W, out_dtype=torch.bfloat16)),
            "boxes_bf16_plain": time_ms(lambda: lk.layout_compose_ref(
                boxes, masks, vecs, H, W).to(torch.bfloat16)),
            "weights": time_ms(lambda: lk.layout_compose_weights(
                wy, wx, masks, vecs)),
            "weights_plain": time_ms(
                lambda: lk.layout_compose_weights_ref(
                    wy, wx, masks, vecs)),
            "weights_library": time_ms(
                lambda: weights_library(torch, wy, wx, masks, vecs)),
        }
        # The bf16 instance's error on the timed inputs, within one
        # rounding of the plain version as on every case above.
        want = lk.layout_compose_ref(boxes, masks, vecs, H, W)
        got = lk.layout_compose(boxes, masks, vecs, H, W,
                                out_dtype=torch.bfloat16)
        if not within_one_rounding(got, want):
            fail("the boxes entry's bf16 output is off by more than one "
                 "rounding at b128")
        errs["boxes_bf16"] = (got.float() - want).abs().max().item()
        del want, got
        lib_err = (weights_library(torch, wy, wx, masks, vecs)
                   - lk.layout_compose_weights_ref(wy, wx, masks, vecs)
                   ).abs().max().item()
        if lib_err > KERNEL_BAR:
            fail(f"the one-call einsum is not the weights entry's function: "
                 f"{lib_err:.3e}")
        if (lk.layout_compose.launches == before[0]
                or lk.layout_compose_weights.launches == before[1]):
            fail("a timed kernel was not launched")
        # The write's yardstick: a fill_ of as many bytes as the output.
        for key, dtype in (("fill", torch.float32),
                           ("fill_bf16", torch.bfloat16)):
            dst = torch.empty((N, H, W, D), dtype=dtype, device="cuda")
            times[key] = time_ms(lambda: dst.fill_(1.0))
            del dst
    out_gb = N * H * W * D * 4 / 1e9
    plan = lk.weights_plan(O, H, W, M, D)
    bound, by = roofline_ms(*layout_bounds(*LAYOUT_TIMED, weights=True),
                            F32_FLOPS)
    print(f"[kernels] time at N128 O16 M16 128x128 D128 f32 (ms): "
          f"boxes-entry {times['boxes']:.4f} vs plain "
          f"{times['boxes_plain']:.4f}; weights-entry {times['weights']:.4f}"
          f" vs plain {times['weights_plain']:.4f} vs one einsum "
          f"{times['weights_library']:.4f}; output write "
          f"{out_gb:.3f} GB -> boxes-entry "
          f"{out_gb / times['boxes'] * 1e3:.0f} GB/s, weights-entry "
          f"{out_gb / times['weights'] * 1e3:.0f} GB/s; fill_ of "
          f"{out_gb:.3f} GB {times['fill']:.4f} "
          f"({out_gb / times['fill'] * 1e3:.0f} GB/s); on {card}")
    for tag, key, elem, fill in (("f32", "boxes", 4, "fill"),
                                 ("bf16", "boxes_bf16", 2, "fill_bf16")):
        k1_bound, k1_by = roofline_ms(*layout_bounds(
            *LAYOUT_TIMED, weights=False, out_elem=elem), F32_FLOPS)
        gb = out_gb * elem / 4
        print(f"[kernels] boxes-entry (K1) with {tag} output at b128: "
              f"{times[key]:.4f} ms, {100 * k1_bound / times[key]:.1f}% of "
              f"its {k1_bound:.4f} ms {k1_by} bound, plain "
              f"{times[key + '_plain']:.4f} ms; {gb:.3f} GB written at "
              f"{gb / times[key] * 1e3:.0f} GB/s against a fill_ of the "
              f"same bytes {times[fill]:.4f} ms "
              f"({gb / times[fill] * 1e3:.0f} GB/s); plan "
              f"{boxes_plan_text(lk.boxes_plan(O, H, W, M, D))}; on {card}")
    print(f"[kernels] weights-entry at b128: "
          f"{100 * bound / times['weights']:.1f}% of its {bound:.4f} ms "
          f"{by} bound, {times['weights'] / times['weights_library']:.2f}x "
          f"the einsum, {times['weights'] / times['fill']:.2f}x the fill_; "
          f"plan {plan_text(plan)}")
    e1_errs, e1_times = phase_epilogue(torch, card)
    errs.update(e1_errs)
    times.update(e1_times)
    m1_errs, m1_times = phase_mask_head(torch, card)
    errs.update(m1_errs)
    times.update(m1_times)
    r1_errs, r1_times = phase_resample(torch, card)
    errs.update(r1_errs)
    times.update(r1_times)
    return errs, times


EPILOGUE_SOURCE = "sg2im_tpu_torch/csrc/crn_epilogue.cu"
# The vg128 CRN's stages at b128: (channels, side).
VG128_STAGES = ((1024, 8), (512, 16), (256, 32), (128, 64), (64, 128))
# E1's cases, name: (addends, N, C, H, W, BatchNorm, float32 output).  The
# eleven chains of a vg128 b128 forward in bf16 'split' (each stage's conv0
# of two addends and its conv1, then the head), each checked and timed.
EPILOGUE_PATH = {
    **{f"s{i} {conv} C{c} {r}x{r}": (n, 128, c, r, r, True, False)
       for i, (c, r) in enumerate(VG128_STAGES)
       for conv, n in (("conv0", 2), ("conv1", 1))},
    "head C64 128x128 f32-out": (1, 128, 64, 128, 128, False, True),
}
# Checked only: three addends (the noise's convolution apart), channels
# that are no multiple of a unit of 8.
EPILOGUE_MORE = {
    "split_noise conv0 C256 32x32 N32": (3, 32, 256, 32, 32, True, False),
    "ragged C20 9x7 N8": (2, 8, 20, 9, 7, True, False),
    "ragged head C3 5x6 N2 f32-out": (1, 2, 3, 5, 6, False, True),
}
EPILOGUE_SLOPE = 0.2  # vg128's leakyrelu-0.2


def bf16_steps(torch, a, b):
    """Distance of same-typed a and b in steps of their own grid (bf16 or
    float32 values ordered as integers), elementwise."""
    def ordered(x):
        i = (x.contiguous().view(torch.int16).int()
             if x.dtype == torch.bfloat16
             else x.contiguous().view(torch.int32).long())
        top = 0x7FFF if x.dtype == torch.bfloat16 else 0x7FFFFFFF
        return torch.where(i < 0, -(i & top), i)

    return (ordered(a) - ordered(b)).abs()


def epilogue_inputs(torch, n, N, C, H, W, bn, seed):
    """``n`` bf16 addends channels_last and, with ``bn``, an eval
    BatchNorm's vectors drawn as the benchmark draws them (running means
    and biases 0.1 z, weights 1 + 0.1 z, variances exp(0.2 z))."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    parts = [(2 * torch.randn(N, C, H, W, device="cuda", generator=g)).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
        for _ in range(n)]
    norm = None
    if bn:
        z = torch.randn(4, C, device="cuda", generator=g)
        norm = (0.1 * z[0], torch.exp(0.2 * z[1]), 1 + 0.1 * z[2],
                0.1 * z[3])
    return parts, norm


def epilogue_bar(torch, parts, norm):
    """Elementwise, what two float32 evaluations of the chain's BatchNorm
    may differ by before their bf16 store: a few float32 roundings of its
    terms, 2^-20 (|s scale| + |shift|) for the bf16 sum s (|s| without a
    norm).  The eager chain's terms are cuDNN's, whose NHWC and NCHW
    kernels differ from each other by as much."""
    from sg2im_tpu_torch.ops.crn_epilogue import add_parts

    x = add_parts(parts).float()
    if norm is None:
        return x.abs() * 2.0 ** -20
    mean, var, weight, bias = (t[:, None, None] for t in norm)
    scale = weight * torch.rsqrt(var + 1e-5)
    return ((x * scale).abs() + (bias - mean * scale).abs()) * 2.0 ** -20


def check_epilogue_case(torch, name, n, N, C, H, W, bn, f32, seed=0):
    """E1 against its plain version (the eager chain) on one case: a bf16
    output within one bf16 step of it, |got - want| <= 2^-7 |want|, up to
    the float32 roundings of the BatchNorm's terms (``epilogue_bar``),
    which near 0 span more than one bf16 step; a float32 output without a
    norm bit-equal.  -> (max abs error, the largest
    distance in steps of the output's type, the inputs)."""
    from sg2im_tpu_torch.ops import crn_epilogue as ce

    parts, norm = epilogue_inputs(torch, n, N, C, H, W, bn, seed)
    out_dtype = torch.float32 if f32 else torch.bfloat16
    before = ce.crn_epilogue.launches
    got = ce.crn_epilogue(parts, EPILOGUE_SLOPE, out_dtype, norm)
    want = ce.crn_epilogue_ref(parts, EPILOGUE_SLOPE, out_dtype, norm)
    torch.cuda.synchronize()
    if ce.crn_epilogue.launches != before + 1:
        fail(f"E1 {name}: the wrapper did not launch the kernel")
    if (got.dtype != out_dtype or got.shape != want.shape
            or not got.is_contiguous(memory_format=torch.channels_last)):
        fail(f"E1 {name}: {got.dtype} {tuple(got.shape)} out")
    steps = bf16_steps(torch, got, want)
    share = 100.0 * (steps == 0).float().mean().item()
    worst = int(steps.max().item())
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    past = int((steps > 1).sum().item())
    inside = bool((diff <= want.float().abs() * 2.0 ** -7
                   + epilogue_bar(torch, parts, norm)).all())
    print(f"[kernels] E1 {name}: {share:.5f}% bit-equal to the eager chain, "
          f"{past} of {steps.numel()} values more than one "
          f"{'float32' if f32 else 'bf16'} step off (at most {worst}), "
          f"max_abs_err {err:.3e}")
    if (f32 and not bn and worst) or not inside:
        fail(f"E1 {name}: off the eager chain by more than one rounding "
             f"(max_abs_err {err:.3e}, {worst} steps)")
    return err, worst, (parts, norm, out_dtype)


# The CRN stages E1 is checked in, fused against kept eager: (conv0 mode,
# channels_last); the NCHW stage's parts are copied to channels_last.
EPILOGUE_STAGES = (("legacy", True), ("phase", True), ("split", False))


def check_epilogue_stage(torch, mode, channels_last):
    """A vg128 stage (C 512 -> 256 at 32x32, b32) in ``mode`` on the card,
    its chains fused against the same stage kept eager (the kernel's
    device taken as none): two launches, the outputs within 2^-6 of the
    largest (conv1 carries conv0's chain's roundings on), the share
    bit-equal printed.  Left in NCHW (``channels_last`` False), weights and
    inputs, it still launches E1, and its parts' copies to channels_last
    are counted; channels_last, nothing is copied."""
    from sg2im_tpu_torch.nn import crn
    from sg2im_tpu_torch.ops import crn_epilogue as ce

    fmt = torch.channels_last if channels_last else torch.contiguous_format
    g = torch.Generator(device="cuda").manual_seed(5)
    layout = torch.randn(32, 160, 32, 32, device="cuda", generator=g).to(
        torch.bfloat16).contiguous(memory_format=fmt)
    feats = torch.randn(32, 512, 16, 16, device="cuda", generator=g).to(
        torch.bfloat16).contiguous(memory_format=fmt)
    torch.manual_seed(5)
    m = crn.RefinementModule(160, 512, 256, "batch", "leakyrelu-0.2",
                             conv0_mode=mode).eval()
    for k in (1, 4):
        _, vectors = epilogue_inputs(torch, 0, 1, 256, 1, 1, True, k)
        for buf, v in zip(("running_mean", "running_var", "weight",
                           "bias"), vectors):
            getattr(m.net[k], buf).data.copy_(v.cpu())
    m = m.to("cuda", memory_format=fmt)
    before = ce.crn_epilogue.launches, ce.crn_epilogue.layout_copies
    got = m(layout, feats, torch.bfloat16)
    launched = ce.crn_epilogue.launches - before[0]
    copies = ce.crn_epilogue.layout_copies - before[1]
    device, crn.EPILOGUE_DEVICE = crn.EPILOGUE_DEVICE, None
    try:
        want = m(layout, feats, torch.bfloat16)
    finally:
        crn.EPILOGUE_DEVICE = device
    steps = bf16_steps(torch, got, want)
    share = 100.0 * (steps == 0).float().mean().item()
    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    name = f"'{mode}'" + ("" if channels_last else " NCHW")
    print(f"[kernels] E1 in a {name} stage (b32 C512 -> 256 at 32x32): "
          f"{launched} launches, {copies} parts copied to channels_last, "
          f"{share:.5f}% bit-equal to the eager stage, max_abs_err "
          f"{err:.3e} of max|out| {top:.3e}")
    if (launched != 2 or err > top * 2.0 ** -6
            or (copies == 0) != channels_last):
        fail(f"E1 in a {name} stage: {launched} launches, {copies} copies, "
             f"max_abs_err {err:.3e}")


def check_epilogue_stages(torch):
    """:func:`check_epilogue_stage` at each of EPILOGUE_STAGES."""
    for mode, channels_last in EPILOGUE_STAGES:
        check_epilogue_stage(torch, mode, channels_last)


def check_epilogue_generate(torch):
    """One generate of 2 vg128 graphs in each bf16 CRN mode launches E1
    eleven times a forward, and 'packed' never."""
    from sg2im_tpu_torch.inference import InferenceEngine
    from sg2im_tpu_torch.ops import crn_epilogue as ce
    from sg2im_tpu_torch.ops import resample as rs

    vocab, kwargs = vg128_config()
    state = vg128_state(torch)
    graphs = random_graphs(vocab, 2, np.random.RandomState(3))
    counts, r1 = {}, {}
    for mode in ("split", "legacy", "phase", "split_noise", "packed"):
        engine = InferenceEngine(vocab, kwargs, state, device="cuda",
                                 compute_dtype=torch.bfloat16,
                                 crn_mode=mode)
        before = ce.crn_epilogue.launches, rs.launches, rs.layout_copies
        engine.generate(graphs, seed=1)
        counts[mode] = ce.crn_epilogue.launches - before[0]
        r1[mode] = (rs.launches - before[1], rs.layout_copies - before[2])
        del engine
    print(f"[kernels] E1 launches in one generate of 2 vg128 graphs, bf16: "
          f"{counts}; R1's launches and layout copies: {r1}")
    want = {m: 0 if m == "packed" else 11 for m in counts}
    if counts != want:
        fail(f"E1 launched {counts} in one generate, not {want}")
    if r1 != {m: (n, 0) for m, n in R1_GENERATE.items()}:
        fail(f"R1 launched (and copied) {r1} in one generate, not "
             f"{R1_GENERATE} without copies")


def phase_epilogue(torch, card):
    """E1, the CRN's post-convolution chain, within phase_kernels: every
    case against the eager chain, two CRN modes' stages, the launches of a
    generate in each mode; then the eleven vg128 b128 chains timed beside
    their bytes bound and the eager chain.  -> ({max steps}, {times})."""
    from sg2im_tpu_torch.ops import crn_epilogue as ce
    from sg2im_tpu_torch.utils.roofline import crn_epilogue_bytes

    times = {"crn_epilogue": 0.0, "crn_epilogue_plain": 0.0,
             "crn_epilogue_library": 0.0}
    worst, max_err = 0, 0.0
    with torch.inference_mode():
        for i, (name, case) in enumerate({**EPILOGUE_PATH,
                                          **EPILOGUE_MORE}.items()):
            err, steps, (parts, norm, out_dtype) = check_epilogue_case(
                torch, name, *case, seed=i)
            worst, max_err = max(worst, steps), max(max_err, err)
            if name not in EPILOGUE_PATH:
                continue

            def kernel():
                return ce.crn_epilogue(parts, EPILOGUE_SLOPE, out_dtype, norm)

            def plain():
                return ce.crn_epilogue_ref(parts, EPILOGUE_SLOPE, out_dtype,
                                           norm)

            # The plain version is the eager chain op for op: it is timed
            # twice, in its own turns, as the plain version and as the
            # library's sequence.
            for key, fn in (("crn_epilogue", kernel),
                            ("crn_epilogue_plain", plain),
                            ("crn_epilogue_library", plain)):
                times[key] += time_ms(fn)
            del parts, norm
        check_epilogue_stages(torch)
    check_epilogue_generate(torch)
    nbytes = crn_epilogue_bytes(128, 128, 128,
                                tuple(c for c, _ in VG128_STAGES), 2)
    bound = roofline_ms(nbytes, 0, 1.0)[0]
    times["crn_epilogue_bound"] = bound
    print(f"[kernels] E1 (the CRN's post-convolution chain) at vg128 b128 "
          f"bf16 'split', the eleven chains of a forward summed: "
          f"{times['crn_epilogue']:.4f} ms, "
          f"{100 * bound / times['crn_epilogue']:.1f}% of its {bound:.4f} ms "
          f"bytes bound ({nbytes / 1e9:.3f} GB); the eager chain "
          f"{times['crn_epilogue_plain']:.4f} ms (again "
          f"{times['crn_epilogue_library']:.4f}); at most {worst} steps off "
          f"it, max_abs_err {max_err:.3e}; on {card}")
    return {"crn_epilogue": max_err}, times


MASK_HEAD_SOURCE = "sg2im_tpu_torch/csrc/mask_head.cu"
# M1 against the eager head: the masks (sigmoid outputs) within this, the
# bar of the port's tests for exact reformulations in float32.
MASK_HEAD_BAR = 2e-5
# vg128's mask head at b128: 128 images of 16 object slots, gconv_dim 128,
# 16 x 16 masks; a ragged case checked only.
MASK_HEAD_TIMED = (2048, 128, 16)
MASK_HEAD_MORE = (37, 128, 16)


def mask_head_inputs(torch, slots, C, M, seed):
    """An eval MaskNet on the card, its BatchNorms' vectors drawn as the
    benchmark draws them (running means and biases 0.1 z, weights 1 +
    0.1 z, variances exp(0.2 z)), and (slots, C, 1, 1) vectors."""
    from sg2im_tpu_torch.models.sg2im import MaskNet

    torch.manual_seed(seed)
    net = MaskNet(C, M).eval()
    for k in range(net.steps):
        _, vectors = epilogue_inputs(torch, 0, 1, C, 1, 1, True, seed + k)
        for buf, v in zip(("running_mean", "running_var", "weight", "bias"),
                          vectors):
            getattr(net[4 * k + 1], buf).data.copy_(v.cpu())
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(slots, C, 1, 1, device="cuda", generator=g)
    return net.to("cuda"), x


def mask_head_library(torch, net, x):
    """The eager head, cuDNN's float32 convolutions (TF32 off)."""
    return torch.sigmoid(net(x)).squeeze(1)


def mask_head_plain(torch, net, x):
    """M1's plain version on the card: the phase form in cuBLAS matmuls on
    the unfolded coarse patches."""
    from sg2im_tpu_torch.ops import mask_head as mh

    return mh.mask_head_ref(x.reshape(x.shape[0], -1), net._phase_steps(),
                            net._final(), net[1].eps)


def phase_mask_head(torch, card):
    """M1, the eval mask head, within phase_kernels: at vg128's b128 shape
    and a ragged one against the eager head (cuDNN, TF32 off) within
    MASK_HEAD_BAR, one launch a step; then the head timed beside its
    all-slot operations bound, the eager head and the plain phase form.
    -> ({max abs err}, {times})."""
    from sg2im_tpu_torch.inference import full_fp32
    from sg2im_tpu_torch.ops import mask_head as mh
    from sg2im_tpu_torch.utils.roofline import (
        mask_head_bytes,
        mask_head_flops,
    )

    err, times = 0.0, {}
    with torch.inference_mode(), full_fp32():
        for i, (slots, C, M) in enumerate((MASK_HEAD_TIMED,
                                           MASK_HEAD_MORE)):
            net, x = mask_head_inputs(torch, slots, C, M, seed=11 + i)
            before = mh.mask_head.launches
            got = net.masks(x)
            launched = mh.mask_head.launches - before
            want = mask_head_library(torch, net, x)
            plain = mask_head_plain(torch, net, x)
            torch.cuda.synchronize()
            case = (got - want).abs().max().item()
            plain_err = (plain - want).abs().max().item()
            print(f"[kernels] M1 (the mask head) at {slots} slots C{C} "
                  f"M{M}: {launched} launches, max_abs_err {case:.3e} "
                  f"against the eager head (plain phase form {plain_err:.3e})")
            if (launched != M.bit_length() - 1 or got.shape != (slots, M, M)
                    or max(case, plain_err) > MASK_HEAD_BAR):
                fail(f"M1 at {slots} slots: {launched} launches, "
                     f"{tuple(got.shape)}, max_abs_err {case:.3e}")
            err = max(err, case)
            if i == 0:
                times = {
                    "mask_head": time_ms(lambda: net.masks(x)),
                    "mask_head_plain": time_ms(
                        lambda: mask_head_plain(torch, net, x)),
                    "mask_head_library": time_ms(
                        lambda: mask_head_library(torch, net, x)),
                }
    ops = mask_head_flops(*MASK_HEAD_TIMED)
    bound, by = roofline_ms(mask_head_bytes(*MASK_HEAD_TIMED), ops,
                            F32_FLOPS)
    times["mask_head_bound"] = (bound, by)
    print(f"[kernels] M1 (the mask head) at vg128 b128 ({MASK_HEAD_TIMED[0]} "
          f"slots), the four steps summed: {times['mask_head']:.4f} ms, "
          f"{100 * bound / times['mask_head']:.1f}% of its {bound:.4f} ms "
          f"{by} bound ({ops / 1e9:.2f} GFLOP at the float32 peak); the "
          f"plain phase form (cuBLAS) {times['mask_head_plain']:.4f} ms, "
          f"the eager head (cuDNN) {times['mask_head_library']:.4f} ms; "
          f"on {card}")
    return {"mask_head": err}, times


RESAMPLE_SOURCE = "sg2im_tpu_torch/csrc/resample.cu"
# The benchmark cells' b128 forwards in bf16 'split': (images, layout
# channels, side).  The pyramid pools RESAMPLE_LEVELS levels; the stages
# after the first upsample feats of RESAMPLE_STAGES channels at side /
# 2^(RESAMPLE_LEVELS - i).
RESAMPLE_CELLS = {"vg128": (128, 160, 128), "coco64": (128, 160, 64)}
RESAMPLE_LEVELS = 4
RESAMPLE_STAGES = (1024, 512, 256, 128)
# Checked only, (kind, shape, dtype, levels, channels_last): float32, one
# and five levels, one vector of channels, sides of two sizes, an NCHW
# input (copied, and the copy counted).
RESAMPLE_MORE = (
    ("pyramid", (4, 64, 64, 64), "f32", 4, True),
    ("pyramid", (3, 8, 32, 48), "bf16", 4, True),
    ("pyramid", (2, 16, 64, 32), "bf16", 5, True),
    ("pyramid", (2, 24, 6, 10), "f32", 1, True),
    ("pyramid", (2, 32, 32, 32), "bf16", 3, False),
    ("upsample", (4, 64, 16, 16), "f32", 0, True),
    ("upsample", (3, 8, 5, 7), "bf16", 0, True),
    ("upsample", (2, 32, 8, 8), "bf16", 0, False),
)
# R1's launches in one generate of vg128 in each bf16 CRN mode: the
# pyramid (two with the noise apart) and each stage's feats upsample but
# the first's one channel; 'phase' upsamples none, 'packed' only at its
# one 'legacy' stage after the first.
R1_GENERATE = {"split": 5, "legacy": 5, "phase": 1, "split_noise": 6,
               "packed": 2}
# R1's launches in one forward of vg128's int8 tier (quantized stages 32
# and 64): the pyramid and the float stages' upsamples (16 and 128); the
# quantized stages upsample int8 feats by index expansion.
R1_TURBO = 3


def check_r1(what, path, want):
    """Fail unless R1 launched ``want`` times on a path since the last
    reset_launches, and copied no input to channels_last."""
    from sg2im_tpu_torch.ops import resample as rs

    if path["crn_resample"] != want or rs.layout_copies:
        fail(f"{what}: R1 launched {path['crn_resample']} times, not "
             f"{want}, and copied {rs.layout_copies} inputs to "
             f"channels_last")


def resample_cases(cell):
    """[(kind, NCHW shape, dtype, levels, channels_last)] of a cell's b128
    forward: its pyramid, then each upsampled stage."""
    N, D, H = RESAMPLE_CELLS[cell]
    cases = [("pyramid", (N, D, H, H), "bf16", RESAMPLE_LEVELS, True)]
    for i, C in enumerate(RESAMPLE_STAGES):
        side = H >> (RESAMPLE_LEVELS - i)
        cases.append(("upsample", (N, C, side, side), "bf16", 0, True))
    return cases


def resample_input(torch, shape, dtype, channels_last, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = 3 * torch.randn(shape, device="cuda", generator=g)
    x = x.to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    return x.contiguous(memory_format=torch.channels_last if channels_last
                        else torch.contiguous_format)


def resample_fns(kind, x, levels):
    """(R1's call, its plain version) of one case: each returns a list of
    tensors."""
    from sg2im_tpu_torch.ops import resample as rs

    if kind == "pyramid":
        return (lambda: rs.pool_pyramid(x, levels),
                lambda: rs.pool_pyramid_ref(x, levels))
    return lambda: [rs.upsample2(x)], lambda: [rs.upsample2_ref(x)]


def bits_apart(torch, a, b) -> int:
    """Elements of same-typed a and b whose bits differ."""
    ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return int((a.view(ints) != b.view(ints)).sum())


def check_resample_case(torch, kind, shape, dtype, levels, channels_last,
                        seed=0) -> int:
    """One case against aten's calls: one launch, channels_last outputs of
    the right shapes, the input's copy counted where it was not
    channels_last.  -> the elements whose bits differ (0 when
    bit-equal)."""
    from sg2im_tpu_torch.ops import resample as rs

    x = resample_input(torch, shape, dtype, channels_last, seed)
    kernel, plain = resample_fns(kind, x, levels)
    before = rs.launches, rs.layout_copies
    got = kernel()
    want = plain()
    torch.cuda.synchronize()
    launched = rs.launches - before[0]
    copies = rs.layout_copies - before[1]
    apart = sum(bits_apart(torch, g, w) for g, w in zip(got, want))
    if (launched != 1 or copies != (0 if channels_last else 1)
            or [g.shape for g in got] != [w.shape for w in want]
            or not all(g.is_contiguous(memory_format=torch.channels_last)
                       for g in got)):
        fail(f"R1 {kind} {shape} {dtype}: {launched} launches, {copies} "
             f"copies, shapes {[tuple(g.shape) for g in got]}")
    return apart


def phase_resample(torch, card):
    """R1, the CRN's 2x resampling, within phase_kernels: both cells' b128
    pyramid and upsamples bit-equal to aten's calls, RESAMPLE_MORE
    besides; each direction timed at both cells beside its bytes bound
    and its plain version, which is aten's calls (the library's).
    -> ({elements off}, {times})."""
    from sg2im_tpu_torch.utils.roofline import crn_resample_bytes

    times, apart = {}, 0
    with torch.inference_mode():
        for i, case in enumerate(RESAMPLE_MORE):
            apart += check_resample_case(torch, *case, seed=100 + i)
        for cell in RESAMPLE_CELLS:
            for i, case in enumerate(resample_cases(cell)):
                apart += check_resample_case(torch, *case, seed=i)
                kind, shape, dtype, levels, cl = case
                x = resample_input(torch, shape, dtype, cl, seed=i)
                kernel, plain = resample_fns(kind, x, levels)
                key = f"resample_{kind}_{cell}"
                for suffix, fn in (("", kernel), ("_plain", plain)):
                    times[key + suffix] = (times.get(key + suffix, 0.0)
                                           + time_ms(fn))
                del x
    for cell, (N, D, H) in RESAMPLE_CELLS.items():
        # Level 0 read once, levels 1 .. 4 written once; the rest of the
        # forward's bytes are the upsamples'.
        pool = 2 * N * D * sum((H >> l) ** 2
                               for l in range(RESAMPLE_LEVELS + 1))
        both = crn_resample_bytes(N, H, H, RESAMPLE_STAGES + (64,), D, 2)
        bounds = {"pyramid": pool, "upsample": both - pool}
        for kind, nbytes in bounds.items():
            key = f"resample_{kind}_{cell}"
            bound = roofline_ms(nbytes, 0, 1.0)[0]
            times[key + "_bound"] = bound
            what = " (the four stages summed)" if kind == "upsample" else ""
            print(f"[kernels] R1 {kind} at {cell} b128 bf16{what}: "
                  f"{times[key]:.4f} ms, {100 * bound / times[key]:.1f}% of "
                  f"its {bound:.4f} ms bytes bound ({nbytes / 1e6:.1f} MB); "
                  f"plain (aten's calls, the library's) "
                  f"{times[key + '_plain']:.4f} ms; on {card}")
    if apart:
        fail(f"R1 is not bit-equal to aten: {apart} elements differ")
    print(f"[kernels] R1 bit-equal to aten's avg_pool2d and interpolate on "
          f"both cells' b128 shapes and {len(RESAMPLE_MORE)} more cases")
    return {"crn_resample": 0.0}, times


# name: (N, H, W, Cin, Co).  The turbo path's four int8 convs at vg128 with
# the default band.
TURBO_CONVS = {
    "s3 conv0 feats 32x32 512->256": (32, 32, 512, 256),
    "s3 conv1 32x32 256->256": (32, 32, 256, 256),
    "s4 conv0 feats 64x64 256->128": (64, 64, 256, 128),
    "s4 conv1 64x64 128->128": (64, 64, 128, 128),
}
# name: (N, H, W, Cin, Co, element offset of x's data pointer).  The turbo
# shapes, the CRN shapes of the TPU prototype
# (scripts/proto_pallas_conv.py:162-168), and cases for the edges of the
# kernel's tile plan and tensor map: Cin * elem not a multiple of 16 bytes
# (the padded copy), x off 16-byte alignment, Co not a multiple of a tile,
# two Co tiles, a partial Cin chunk, W wider than a tile, H = W = 1.
CONV_CASES = {
    **{f"turbo {k} N8": (8,) + v + (0,) for k, v in TURBO_CONVS.items()},
    "K4 s5 conv0 128x128 288->64 N8": (8, 128, 128, 288, 64, 0),
    "K4 s5 conv1 128x128 64->64 N8": (8, 128, 128, 64, 64, 0),
    "K4 s4 conv0 64x64 416->128 N8": (8, 64, 64, 416, 128, 0),
    "K4 s3 conv0 32x32 672->256 N8": (8, 32, 32, 672, 256, 0),
    "ragged 13x29 36->20 N2": (2, 13, 29, 36, 20, 0),
    "ragged 9x7 20->24 N3": (3, 9, 7, 20, 24, 0),
    "unaligned x 11x16 64->40 N2": (2, 11, 16, 64, 40, 1),
    "Co 20 16x16 64->20 N3": (3, 16, 16, 64, 20, 0),
    "wide 5x150 48->72 N2": (2, 5, 150, 48, 72, 0),
    "Co 200 12x12 160->200 N2": (2, 12, 12, 160, 200, 0),
    "Co 300 9x7 64->300 N2": (2, 9, 7, 64, 300, 0),
    "1x1 24->8 N3": (3, 1, 1, 24, 8, 0),
}
CONV_BF16_BAR = 1e-4  # f32 output: max abs error / max |plain|


def _at_offset(torch, x, offset):
    """x (channels_last) copied into a buffer whose data starts ``offset``
    elements in: a channels_last view off the allocation's alignment."""
    if offset == 0:
        return x.contiguous(memory_format=torch.channels_last)
    N, C, H, W = x.shape
    flat = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    view = flat[offset:].view(N, H, W, C).permute(0, 3, 1, 2)
    view.copy_(x)
    return view


def conv_inputs(torch, N, H, W, Cin, Co, seed, offset=0, device="cuda"):
    """int8 and bf16 operands of one shape from a seed: x channels_last
    (its data ``offset`` elements into its buffer), weights OIHW, dq /
    scale / bias (Co,) float32."""
    gen = torch.Generator().manual_seed(seed)
    x8 = torch.randint(-127, 128, (N, Cin, H, W), generator=gen,
                       dtype=torch.int8)
    w8 = torch.randint(-127, 128, (Co, Cin, 3, 3), generator=gen,
                       dtype=torch.int8)
    dq = torch.rand(Co, generator=gen) * 1e-4 + 1e-6
    xb = torch.randn((N, Cin, H, W), generator=gen).to(torch.bfloat16)
    wb = (torch.randn((Co, Cin, 3, 3), generator=gen)
          * (2.0 / (9 * Cin)) ** 0.5).to(torch.bfloat16)
    scale = torch.rand(Co, generator=gen) + 0.5
    bias = torch.randn(Co, generator=gen) * 0.1
    return {"x8": _at_offset(torch, x8.to(device), offset),
            "w8": w8.to(device), "dq": dq.to(device),
            "xb": _at_offset(torch, xb.to(device), offset),
            "wb": wb.to(device), "scale": scale.to(device),
            "bias": bias.to(device)}


def ulps(torch, a, b) -> int:
    """Largest distance in float32 ulps between same-signed a and b."""
    diff = a.contiguous().view(torch.int32).long() \
        - b.contiguous().view(torch.int32).long()
    return int(diff.abs().max().item())


def check_conv_case(torch, name, N, H, W, Cin, Co, offset=0, seed=0):
    """Both conv entries against their plain versions on one input: s8
    bit-equal or within 1 ulp; bf16 entry with f32 output within
    CONV_BF16_BAR * max|plain|, with bf16 output within one bf16 rounding.
    Returns {entry: max abs error}."""
    from sg2im_tpu_torch.ops import conv_kernel as ck

    t = conv_inputs(torch, N, H, W, Cin, Co, seed, offset)
    s8 = ck.conv3x3_int8(t["x8"], t["w8"], t["dq"])
    s8_ref = ck.conv3x3_int8_ref(t["x8"], t["w8"], t["dq"])
    plain = ck.conv3x3_ref(t["xb"], t["wb"])
    plain_ep = ck.conv3x3_ref(t["xb"], t["wb"], t["scale"], t["bias"])
    got = ck.conv3x3(t["xb"], t["wb"])
    got_ep = ck.conv3x3(t["xb"], t["wb"], t["scale"], t["bias"])
    got_ep16 = ck.conv3x3(t["xb"], t["wb"], t["scale"], t["bias"],
                          out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    for what, out in (("s8", s8), ("bf16", got), ("bf16+epilogue", got_ep),
                      ("bf16+epilogue bf16-out", got_ep16)):
        if out.shape != (N, Co, H, W) or not torch.isfinite(out).all():
            fail(f"conv {what} entry gave {tuple(out.shape)} or non-finite "
                 f"values on {name}")
    s8_err = (s8 - s8_ref).abs().max().item()
    s8_ulp = ulps(torch, s8, s8_ref)
    s8_equal = bool(torch.equal(s8, s8_ref))
    errs = {"s8": s8_err, "bf16": 0.0}
    line = [f"[conv] {name}: s8 max_abs_err={s8_err:.3e} "
            f"({'bit-equal' if s8_equal else f'{s8_ulp} ulp'}, max|out| "
            f"{s8_ref.abs().max().item():.3e})"]
    if s8_ulp > 1:
        fail(f"s8 entry off by {s8_ulp} ulp on {name}")
    for what, out, ref in (("bf16", got, plain),
                           ("bf16+epilogue", got_ep, plain_ep)):
        err = (out - ref).abs().max().item()
        rel = err / max(ref.abs().max().item(), 1e-30)
        errs["bf16"] = max(errs["bf16"], err)
        line.append(f"{what} max_abs_err={err:.3e} (rel {rel:.2e})")
        if rel > CONV_BF16_BAR:
            fail(f"conv {what} entry disagrees with the plain version on "
                 f"{name}: {rel:.3e} > {CONV_BF16_BAR} of max|plain|")
    bf_err = (got_ep16.float() - plain_ep).abs()
    bound = plain_ep.abs() * 2.0 ** -8 \
        + CONV_BF16_BAR * plain_ep.abs().max()
    line.append(f"bf16-out max_abs_err={bf_err.max().item():.3e}")
    if not bool((bf_err <= bound).all()):
        fail(f"conv bf16 output off by more than one rounding on {name}")
    print(" ".join(line))
    return errs


def phase_conv(torch, card):
    """The conv kernel's entries against their plain versions, then their
    time at batch 128 on the turbo path's shapes, in turns with cuDNN's
    bf16 conv of the same shape (kernels, cuDNN, kernels; each kernel's
    time the lower of its two turns), beside the plain versions, the
    wrapper's weight packing and the bound."""
    import torch.nn.functional as F

    from sg2im_tpu_torch.ops import conv_kernel as ck

    errs = {"s8": 0.0, "bf16": 0.0}
    with torch.inference_mode():
        for i, (name, case) in enumerate(CONV_CASES.items()):
            for entry, err in check_conv_case(torch, name, *case,
                                              seed=i).items():
                errs[entry] = max(errs[entry], err)
        keys = ("s8", "s8_plain", "s8_pack", "bf16", "bf16_plain",
                "bf16_pack", "cudnn_bf16")
        times = {k: 0.0 for k in keys}
        turns = {"s8": [0.0, 0.0], "bf16": [0.0, 0.0]}  # sums per turn
        bounds = {"s8": [0.0, 0.0], "bf16": [0.0, 0.0]}  # [bytes, ops] ms
        for name, (H, W, Cin, Co) in TURBO_CONVS.items():
            t = conv_inputs(torch, 128, H, W, Cin, Co, seed=11)

            def s8():
                return ck.conv3x3_int8(t["x8"], t["w8"], t["dq"])

            def bf16():
                return ck.conv3x3(t["xb"], t["wb"], t["scale"], t["bias"])

            first = {"s8": time_ms(s8),
                     "bf16": time_ms(bf16)}
            ms = {"cudnn_bf16": time_ms(lambda: F.conv2d(
                t["xb"], t["wb"], padding=1))}
            second = {"s8": time_ms(s8),
                      "bf16": time_ms(bf16)}
            for k in ("s8", "bf16"):
                ms[k] = min(first[k], second[k])
                turns[k][0] += first[k]
                turns[k][1] += second[k]
            for k, w, size in (("s8", t["w8"], 1), ("bf16", t["wb"], 2)):
                plan = ck.tile_plan(H, W, Cin, Co, size)
                ms[k + "_pack"] = time_ms(
                    lambda: ck.pack_weights(w, plan))
            # float64 / float32 convolutions: few iterations.
            ms["s8_plain"] = time_ms(lambda: ck.conv3x3_int8_ref(
                t["x8"], t["w8"], t["dq"]), iters=2, warmup=1)
            ms["bf16_plain"] = time_ms(lambda: ck.conv3x3_ref(
                t["xb"], t["wb"], t["scale"], t["bias"]), iters=5, warmup=1)
            for k in keys:
                times[k] += ms[k]
            cudnn = ms["cudnn_bf16"]
            line = [f"[conv] b128 {name} (ms):"]
            for entry, size, peak in (("s8", 1, INT8_OPS),
                                      ("bf16", 2, BF16_FLOPS)):
                nbytes, ops = conv_bounds(128, H, W, Cin, Co, size)
                bound, by = roofline_ms(nbytes, ops, peak)
                bounds[entry][by == "operations"] += bound
                line.append(
                    f"{entry}-entry {ms[entry]:.4f} (wrapper, lower turn of "
                    f"{first[entry]:.4f} / {second[entry]:.4f}; "
                    f"{ops / ms[entry] / 1e9:.1f} TOP/s, "
                    f"{100 * bound / ms[entry]:.1f}% of its {bound:.4f} ms "
                    f"{by} bound, {ms[entry] / cudnn:.2f}x cuDNN) plain "
                    f"{ms[entry + '_plain']:.4f} pack "
                    f"{ms[entry + '_pack']:.4f};")
            line.append(f"cuDNN bf16 conv {cudnn:.4f} "
                        f"({ops / cudnn / 1e9:.1f} TFLOP/s); on {card}")
            print(" ".join(line))
            del t
    for entry in ("s8", "bf16"):
        bound = sum(bounds[entry])
        print(f"[conv] b128 sum of the four turbo convs, {entry}-entry: "
              f"{times[entry]:.4f} ms (sums of the turns "
              f"{turns[entry][0]:.4f} / {turns[entry][1]:.4f}), "
              f"{100 * bound / times[entry]:.1f}% of "
              f"its {bound:.4f} ms bound, "
              f"{times[entry] / times['cudnn_bf16']:.2f}x cuDNN bf16 "
              f"{times['cudnn_bf16']:.4f}; plain "
              f"{times[entry + '_plain']:.4f}; weight packing of the four "
              f"{times[entry + '_pack']:.4f}; on {card}")
    times["bounds"] = {
        e: (sum(v), "operations" if v[1] >= v[0] else "bytes")
        for e, v in bounds.items()}
    return errs, times


# name: (entry, NCHW input shape, dtype name, element offset of the data
# pointer).  The packed vg128 path at batch 128 (the three layout levels
# packed, the two stage boundaries and the head unpacked), then ragged
# runs (2C elements not a multiple of 16 bytes) and inputs off alignment,
# so that every copy unit (16, 8, 4, 2 and 1 bytes) runs.
RELAYOUT_PATH = {
    "s2d level s3 N128 C160 32x32 bf16": ("s2d", (128, 160, 32, 32),
                                          "bfloat16", 0),
    "s2d level s4 N128 C160 64x64 bf16": ("s2d", (128, 160, 64, 64),
                                          "bfloat16", 0),
    "s2d level s5 N128 C160 128x128 bf16": ("s2d", (128, 160, 128, 128),
                                            "bfloat16", 0),
    "d2s s3 out N128 C1024 16x16 bf16": ("d2s", (128, 1024, 16, 16),
                                         "bfloat16", 0),
    "d2s s4 out N128 C512 32x32 bf16": ("d2s", (128, 512, 32, 32),
                                        "bfloat16", 0),
    "d2s head N128 C12 64x64 f32": ("d2s", (128, 12, 64, 64), "float32", 0),
}
# The 'phase' CRN's d2s, one a stage (the vg128 forward at batch 128 in
# bf16: the conv0 phases of stages 1-5 interleaved to the stage's
# resolution).
RELAYOUT_PHASE_PATH = {
    f"phase d2s N128 C{c} {r}x{r} bf16": ("d2s", (128, c, r, r), "bfloat16",
                                         0)
    for c, r in ((4096, 4), (2048, 8), (1024, 16), (512, 32), (256, 64))}
RELAYOUT_RAGGED = {
    "s2d ragged N3 C5 6x10 f32": ("s2d", (3, 5, 6, 10), "float32", 0),
    "s2d ragged N2 C3 14x6 bf16": ("s2d", (2, 3, 14, 6), "bfloat16", 0),
    "d2s ragged N2 C12 3x5 bf16": ("d2s", (2, 12, 3, 5), "bfloat16", 0),
    "d2s ragged N3 C28 5x2 int8": ("d2s", (3, 28, 5, 2), "int8", 0),
    "s2d unaligned N2 C16 8x8 bf16": ("s2d", (2, 16, 8, 8), "bfloat16", 1),
    "d2s unaligned N2 C64 4x4 f32": ("d2s", (2, 64, 4, 4), "float32", 1),
    "s2d unaligned N2 C5 6x4 int8": ("s2d", (2, 5, 6, 4), "int8", 1),
}


def relayout_input(torch, shape, dtype, offset=0, seed=0):
    """A channels_last NCHW tensor of ``shape`` on the card whose data
    starts ``offset`` elements into its buffer."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    N, C, H, W = shape
    n = N * C * H * W
    if dtype == "int8":
        flat = torch.randint(-128, 128, (n + offset,), generator=gen,
                             device="cuda", dtype=torch.int8)
    else:
        flat = torch.randn((n + offset,), generator=gen, device="cuda").to(
            getattr(torch, dtype))
    return flat[offset:].view(N, H, W, C).permute(0, 3, 1, 2)


def relayout_entry(entry):
    """(wrapper, plain version) of K3's 's2d' or 'd2s' entry."""
    from sg2im_tpu_torch.ops import relayout as rl

    if entry == "s2d":
        return rl.space_to_depth, rl.space_to_depth_ref
    return rl.depth_to_space, rl.depth_to_space_ref


def relayout_library(entry, x):
    """One PyTorch call of K3's function on the channels_last ``x``: its
    NHWC view split into 2 x 2 blocks, permuted and reshaped, one copy (the
    s2d packed[n, i, j, (2a + b) C + c] = fine[n, 2i + a, 2j + b, c], or
    its inverse); -> a function giving the NHWC result."""
    N, C, H, W = x.shape
    nhwc = x.permute(0, 2, 3, 1)
    if entry == "s2d":
        return lambda: nhwc.view(N, H // 2, 2, W // 2, 2, C).permute(
            0, 1, 3, 2, 4, 5).reshape(N, H // 2, W // 2, 4 * C)
    return lambda: nhwc.view(N, H, W, 2, 2, C // 4).permute(
        0, 1, 3, 2, 4, 5).reshape(N, 2 * H, 2 * W, C // 4)


def check_relayout_case(torch, name, entry, shape, dtype, offset, seed=0):
    """One kernel entry against its plain version: bit-equal, and the
    output channels_last.  Returns the max abs error (0.0)."""
    x = relayout_input(torch, shape, dtype, offset, seed)
    kernel, plain = relayout_entry(entry)
    got, want = kernel(x), plain(x)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != x.dtype:
        fail(f"relayout {name}: got {tuple(got.shape)} {got.dtype}, want "
             f"{tuple(want.shape)} {x.dtype}")
    if not got.is_contiguous(memory_format=torch.channels_last):
        fail(f"relayout {name}: output is not channels_last")
    if not torch.equal(got, want):
        fail(f"relayout {name}: {entry} entry differs from the plain version")
    return (got.float() - want.float()).abs().max().item()


def check_relayout_routes(what):
    """Fail if a relayout on a path took the units route, the one for
    inputs off 16-byte alignment (``ops/relayout.relayout_plan``)."""
    from sg2im_tpu_torch.ops import relayout as rl

    for wrapper in (rl.space_to_depth, rl.depth_to_space):
        if wrapper.unaligned_launches:
            fail(f"{what}: {wrapper.__name__} took the units route "
                 f"{wrapper.unaligned_launches} times of {wrapper.launches}")


def relayout_route(entry, shape, dtype, offset=0):
    """The plan's route name of one case (its input ``offset`` elements
    into an aligned buffer, as relayout_input makes it; a fresh output),
    and the plan."""
    from sg2im_tpu_torch.ops import relayout as rl

    N, C, H, W = shape
    R, Rw, c = (H // 2, W // 2, C) if entry == "s2d" else (H, W, C // 4)
    elsize = {"float32": 4, "bfloat16": 2, "int8": 1}[dtype]
    plan = rl.relayout_plan(N, R, Rw, c, elsize, offset * elsize, 0)
    return rl.ROUTES[plan.route], plan


def time_relayout_case(torch, name, entry, shape, dtype, card):
    """{'': kernel, '_plain', '_copy', '_library': ms} of one path shape at
    batch 128, each output held to the plain version's first."""
    x = relayout_input(torch, shape, dtype, seed=3)
    fn, plain = relayout_entry(entry)
    dst = torch.empty_like(x)
    library = relayout_library(entry, x)
    if not torch.equal(library().permute(0, 3, 1, 2), fn(x)):
        fail(f"relayout {name}: the permuted copy differs from the kernel")
    ms = {"": time_ms(lambda: fn(x)),
          "_plain": time_ms(lambda: plain(x)),
          "_copy": time_ms(lambda: dst.copy_(x)),
          "_library": time_ms(library)}
    gb = 2 * x.numel() * x.element_size() / 1e9  # read + write
    print(f"[relayout] b128 {name} (ms): kernel {ms['']:.4f} "
          f"({gb / ms[''] * 1e3:.0f} GB/s) vs plain "
          f"{ms['_plain']:.4f} ({gb / ms['_plain'] * 1e3:.0f} GB/s) "
          f"vs copy_ {ms['_copy']:.4f} "
          f"({gb / ms['_copy'] * 1e3:.0f} GB/s) vs the permuted copy "
          f"{ms['_library']:.4f} "
          f"({gb / ms['_library'] * 1e3:.0f} GB/s); on {card}")
    return ms


def phase_relayout(torch, card):
    """K3's entries against their plain versions on every case, each
    case's route printed (no path shape may take the units route), then
    their time at the packed and the phase path's batch-128 shapes beside
    the plain version, a copy_ of the same bytes and the permuted copy.
    The kernels line's K3 rows are the packed path's sums; the phase
    path's d2s sum stands on a line of its own."""
    errs = {"s2d": 0.0, "d2s": 0.0}
    times = {f"{e}{k}": 0.0 for e in ("s2d", "d2s", "phase_d2s")
             for k in ("", "_plain", "_copy", "_library")}
    paths = {**RELAYOUT_PATH, **RELAYOUT_PHASE_PATH}
    routes = {}
    with torch.inference_mode():
        cases = {**paths, **RELAYOUT_RAGGED}
        for i, (name, case) in enumerate(cases.items()):
            entry, shape, dtype, offset = case
            wrapper = relayout_entry(entry)[0]
            before = wrapper.unaligned_launches
            errs[entry] = max(errs[entry],
                              check_relayout_case(torch, name, *case,
                                                  seed=i))
            routes[name] = relayout_route(entry, shape, dtype, offset)[0]
            unaligned = wrapper.unaligned_launches - before
            if unaligned != (routes[name] == "units"):
                fail(f"relayout {name}: planned the {routes[name]} route, "
                     f"{unaligned} launches on the units route")
            if name in paths and routes[name] == "units":
                fail(f"relayout {name}: the path shape took the units route")
        print(f"[relayout] {len(cases)} cases bit-equal to the plain "
              f"versions: max_abs_err s2d {errs['s2d']} d2s {errs['d2s']}; "
              f"routes {routes}")
        for name, (entry, shape, dtype, _) in paths.items():
            plan = relayout_route(entry, shape, dtype)[1]
            print(f"[relayout] plan of {name}: {plan._asdict()}")
            ms = time_relayout_case(torch, name, entry, shape, dtype, card)
            key = entry if name in RELAYOUT_PATH else "phase_d2s"
            for k, v in ms.items():
                times[key + k] += v
    for entry in ("s2d", "d2s"):
        print(f"[relayout] b128 sum of the three {entry} shapes (ms): kernel "
              f"{times[entry]:.4f} vs plain {times[entry + '_plain']:.4f} vs "
              f"copy_ {times[entry + '_copy']:.4f} vs the permuted copy "
              f"{times[entry + '_library']:.4f}")
    bound = relayout_bounds(RELAYOUT_PHASE_PATH.values())["d2s"][0]
    print(f"[relayout] b128 sum of the phase path's five d2s shapes (ms): "
          f"kernel {times['phase_d2s']:.4f}, "
          f"{100 * bound / times['phase_d2s']:.1f}% of its {bound:.4f} ms "
          f"bytes bound, vs plain {times['phase_d2s_plain']:.4f} vs copy_ "
          f"{times['phase_d2s_copy']:.4f} vs the permuted copy "
          f"{times['phase_d2s_library']:.4f}; on {card}")
    return errs, times


# name: (seed, (N, C, H, W), f, offset, channels_last).  Seeds at the int32
# edges, an odd shape, every upsample factor, both memory formats, offsets
# whose counters cross 2^32 (hi word nonzero; 2^32 - 3 crosses inside one
# thread's run of V values in every walk), and the kernel's ragged edges: C
# and W / f not multiples of V (4 values a thread in f32, 8 in bf16; C 33
# and C 19 = 8 * 2 + 3 in both formats).
THREEFRY_CASES = {
    **{f"seed {s} N3 C5 37x29": (s, (3, 5, 37, 29), 1, 0, False)
       for s in (0, 7, 2 ** 31 - 1, -1, -2 ** 31)},
    "seed 7 N3 C5 37x29 channels_last": (7, (3, 5, 37, 29), 1, 0, True),
    "f2 N2 C6 24x40": (11, (2, 6, 24, 40), 2, 0, False),
    "f2 N2 C6 24x40 channels_last": (11, (2, 6, 24, 40), 2, 0, True),
    "f4 N2 C32 32x16 channels_last": (12, (2, 32, 32, 16), 4, 0, True),
    "offset 2^32-700 N2 C5 16x16": (1, (2, 5, 16, 16), 1, 2 ** 32 - 700,
                                    False),
    "C33 N2 14x10 channels_last": (13, (2, 33, 14, 10), 1, 0, True),
    "f2 C33 N2 14x10 channels_last": (13, (2, 33, 14, 10), 2, 0, True),
    "C19 N2 13x22": (14, (2, 19, 13, 22), 1, 0, False),
    "f2 C19 N2 12x20 channels_last": (14, (2, 19, 12, 20), 2, 0, True),
    "offset 2^32-3 N2 C5 9x7 channels_last": (15, (2, 5, 9, 7), 1,
                                              2 ** 32 - 3, True),
    "offset 2^32-3 N2 C5 9x7": (15, (2, 5, 9, 7), 1, 2 ** 32 - 3, False),
    "f2 offset 2^32-3 N2 C5 10x14 channels_last": (16, (2, 5, 10, 14), 2,
                                                   2 ** 32 - 3, True),
}
# name: (seed, (N, C, H, W), dtype, channels_last): the draws the paths
# make at their own shapes, each held whole against the plain version.
THREEFRY_PATH_CASES = {
    "b128 bf16 channels_last (tools.bench's turbo_img_s)":
        (2, (128, 32, 128, 128), "bfloat16", True),
    "COCO-64 b32 NCHW f32 (the train step)":
        (9, (32, 32, 64, 64), "float32", False),
    "16 rows channels_last f32 (the server's per-request rows)":
        (4, (16, 32, 128, 128), "float32", True),
}
THREEFRY_TIMED = (128, 32, 128, 128)  # vg128 b128: 67.1 M values
# The other timed draws, (N, C, H, W), f, channels_last: the COCO-64 train
# step's NCHW draw and vg128 b128 at --noise_downsample 2.
THREEFRY_TIMED_MORE = {"train step NCHW f32": ((32, 32, 64, 64), 1, False),
                       "b128 f2 channels_last f32": ((128, 32, 128, 128), 2,
                                                     True)}
THREEFRY_BAR = 1e-6  # normals, kernel against the plain version
THREEFRY_SOURCE = "sg2im_tpu_torch/csrc/threefry.cu"


def _kernel_scale(fan_in: int) -> float:
    """The init's uniform kernel factor sqrt(3 var), var = (1/3) / fan_in,
    in float32 (nn/init.py)."""
    return float(np.sqrt(np.float32(3) * np.float32((1.0 / 3.0) / fan_in)))


# name: (seed, n, (minval, maxval), scale, offset).  The init's draws:
# its bias bounds 1 / sqrt(fan_in) for fans 9 x 16 ... 9 x 1024 on sizes
# that are no multiple of the 4 values a thread, the [-1, 1) kernel draw
# times sqrt(3 var), counters across 2^32 (2^32 - 3: inside a thread's
# run); and the unit interval.
UNIFORM_CASES = {
    **{f"bias fan_in 9x{c}, {c + 1} values": (
        c, c + 1, (-1.0 / (9 * c) ** 0.5, 1.0 / (9 * c) ** 0.5), None, 0)
       for c in (16, 64, 256, 1024)},
    "kernel [-1, 1) x sqrt(3 var), fan_in 9x160, 3x3x160x7": (
        21, 9 * 160 * 7, (-1.0, 1.0), _kernel_scale(9 * 160), 0),
    "kernel, offset 2^32-3, 4099 values": (
        22, 4099, (-1.0, 1.0), _kernel_scale(128), 2 ** 32 - 3),
    "bias, offset 2^32-700, 1031 values": (
        23, 1031, (-0.25, 0.25), None, 2 ** 32 - 700),
    "unit interval, 5 values": (24, 5, (0.0, 1.0), None, 0),
}


def threefry_sass_mix(mode: int) -> dict:
    """{opcode: count} of the threefry kernel's main-path instance for
    ``mode`` (1 f32, 2 bf16): the flat walk at f 1 without the carry, in
    the built library, by cuobjdump -sass."""
    from sg2im_tpu_torch.ops import _build
    from sg2im_tpu_torch.utils.roofline import sass_mix

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
    out = subprocess.run([tool, "-sass", str(_build.library_path(
        "threefry.cu"))], capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        fail(f"cuobjdump -sass failed: {out.stderr[-2000:]}")
    mix = sass_mix(out.stdout,
                   f"threefry_normal_kernelILi{mode}ELi0ELi1ELb0E")
    if not mix:
        fail(f"no SASS found for the threefry kernel's mode {mode}")
    return mix


def check_threefry_case(torch, name, seed, shape, f, offset, cl):
    """Bits bit-equal and normals within THREEFRY_BAR of the plain version
    on the card, f32 and bf16 -> {"f32": err, "bf16": err}."""
    from sg2im_tpu_torch.ops import prng
    from sg2im_tpu_torch.ops import prng_kernel as pk

    fmt = torch.channels_last if cl else torch.contiguous_format
    key = prng.prng_key(seed)
    kw = dict(f=f, offset=offset, device="cuda", memory_format=fmt)
    bits = pk.threefry_bits(key, shape, **kw)
    N, C, H, W = shape
    want = prng.random_bits(key, (N, H // f, W // f, C), offset,
                            "cuda").to(torch.int32).permute(0, 3, 1, 2)
    want = want.repeat_interleave(f, 2).repeat_interleave(f, 3)
    if not torch.equal(bits, want):
        fail(f"threefry {name}: bits differ from the plain version at "
             f"{int((bits != want).sum())} of {bits.numel()} elements")
    if bits.is_contiguous(memory_format=fmt) is False:
        fail(f"threefry {name}: output not in the asked memory format")
    errs, eq = {}, {}
    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        got = pk.threefry_normal(key, shape, dtype=dtype, **kw)
        plain = pk._plain(lambda k, s, d: prng.normal(k, s, dtype, offset,
                                                      d),
                          key, shape, f, fmt, torch.device("cuda"))
        if got.dtype != dtype or got.shape != torch.Size(shape):
            fail(f"threefry {name}: {tuple(got.shape)} {got.dtype}")
        errs[tag] = (got.float() - plain.float()).abs().max().item()
        eq[tag] = (got == plain).float().mean().item()
        if not errs[tag] <= THREEFRY_BAR:
            fail(f"threefry {name} {tag}: max_abs_err {errs[tag]:.3e} over "
                 f"{THREEFRY_BAR}")
    print(f"[threefry] {name}: bits equal; normals max_abs_err f32 "
          f"{errs['f32']:.3e} ({100 * eq['f32']:.3f}% bit-equal), bf16 "
          f"{errs['bf16']:.3e} ({100 * eq['bf16']:.3f}% bit-equal)")
    return errs


def check_uniform_case(torch, name, seed, n, bounds, scale, offset):
    """The uniform entry against its plain version (ops.prng.uniform times
    the scale), bit for bit -> the max abs error (0.0)."""
    from sg2im_tpu_torch.ops import prng
    from sg2im_tpu_torch.ops import prng_kernel as pk

    key = prng.prng_key(seed)
    got = pk.threefry_uniform(key, n, *bounds, scale, offset, device="cuda")
    want = pk.threefry_uniform(key, n, *bounds, scale, offset, device="cpu")
    if got.dtype != torch.float32 or got.shape != (n,):
        fail(f"uniform {name}: {tuple(got.shape)} {got.dtype}")
    if not torch.equal(got.cpu(), want):
        fail(f"uniform {name}: differs from the plain version at "
             f"{int((got.cpu() != want).sum())} of {want.numel()} elements")
    return (got.cpu() - want).abs().max().item()


def check_threefry_path_case(torch, name, seed, shape, dtype, cl):
    """A draw at a path's own shape against the plain version on the card,
    within THREEFRY_BAR -> max abs err."""
    from sg2im_tpu_torch.ops import prng
    from sg2im_tpu_torch.ops import prng_kernel as pk

    dtype = getattr(torch, dtype)
    fmt = torch.channels_last if cl else torch.contiguous_format
    key = prng.prng_key(seed)
    got = pk.threefry_normal(key, shape, dtype=dtype, device="cuda",
                             memory_format=fmt)
    N, C, H, W = shape
    want = prng.normal(key, (N, H, W, C), dtype, device="cuda")
    if got.dtype != dtype or not got.is_contiguous(memory_format=fmt):
        fail(f"threefry {name}: {got.dtype}, not {dtype} in its format")
    d = (got.permute(0, 2, 3, 1).float() - want.float()).abs()
    err = d.max().item()
    print(f"[threefry] {name} {tuple(shape)}: max_abs_err {err:.3e}, "
          f"{100 * (d == 0).float().mean().item():.4f}% bit-equal")
    if not err <= THREEFRY_BAR:
        fail(f"threefry {name}: max_abs_err {err:.3e} over {THREEFRY_BAR}")
    del got, want, d
    torch.cuda.empty_cache()
    return err


def phase_threefry(torch, card):
    """The threefry kernel against its plain version (ops.prng) on the
    card: every THREEFRY_CASES case, a key split on the card and read
    where it lies, a data-parallel row slice drawn by offset, the paths'
    own draws (THREEFRY_PATH_CASES); then its time at vg128 b128 in f32
    and bf16 beside the plain version and torch.randn (a reference, not
    the same function), its bound from the least instructions this ISA
    needs a value (its SASS printed beside them); and the split kernel
    against the plain split, bit for bit, and timed beside it at the train
    step's split(key).  -> (errs, times)."""
    from sg2im_tpu_torch.ops import prng
    from sg2im_tpu_torch.ops import prng_kernel as pk
    from sg2im_tpu_torch.utils.roofline import (
        INT_OPCODES, THREEFRY_OPS, threefry_bounds)

    errs = {"f32": 0.0, "bf16": 0.0}
    with torch.inference_mode():
        for name, case in THREEFRY_CASES.items():
            for k, v in check_threefry_case(torch, name, *case).items():
                errs[k] = max(errs[k], v)
        # A key split on the card, read by the kernel where it lies.
        key = prng.split(prng.prng_key(5).cuda())[1]
        shape = (2, 32, 16, 16)
        got = pk.threefry_normal(key, shape, device="cuda")
        want = pk.threefry_normal(prng.key_words(key), shape, device="cuda")
        plain = prng.normal(key, (2, 16, 16, 32)).permute(0, 3, 1, 2)
        err = (got - plain).abs().max().item()
        if not torch.equal(got, want) or err > THREEFRY_BAR:
            fail(f"threefry: a key on the card draws otherwise than its "
                 f"words by value (err to plain {err:.3e})")
        # Rows 1 and 2 of a batch of 4, drawn alone by offset (a
        # data-parallel rank's rows) against those rows of the whole draw.
        whole = pk.threefry_normal(prng.prng_key(3), (4, 32, 16, 16),
                                   device="cuda")
        rows = pk.threefry_normal(prng.prng_key(3), (2, 32, 16, 16),
                                  offset=16 * 16 * 32, device="cuda")
        if not torch.equal(rows, whole[1:3]):
            fail("threefry: a row slice drawn by offset differs from the "
                 "same rows of the whole draw")
        print(f"[threefry] {len(THREEFRY_CASES)} cases, a key split on the "
              f"card and a row slice by offset: bits equal, normals "
              f"max_abs_err f32 {errs['f32']:.3e} bf16 {errs['bf16']:.3e}")
        for name, case in THREEFRY_PATH_CASES.items():
            tag = "bf16" if case[2] == "bfloat16" else "f32"
            errs[tag] = max(errs[tag],
                            check_threefry_path_case(torch, name, *case))

        # Time at vg128 b128, channels_last as the engine draws it.
        N, C, H, W = THREEFRY_TIMED
        key = prng.prng_key(2)
        cl = torch.channels_last
        before = pk.threefry_normal.launches
        times = {
            "f32": time_ms(lambda: pk.threefry_normal(
                key, THREEFRY_TIMED, device="cuda", memory_format=cl)),
            "bf16": time_ms(lambda: pk.threefry_normal(
                key, THREEFRY_TIMED, dtype=torch.bfloat16, device="cuda",
                memory_format=cl)),
            "randn": time_ms(lambda: torch.randn(
                (N, H, W, C), device="cuda")),
            "randn_bf16": time_ms(lambda: torch.randn(
                (N, H, W, C), device="cuda", dtype=torch.bfloat16)),
        }
        for name, (shape, f, last) in THREEFRY_TIMED_MORE.items():
            fmt = torch.channels_last if last else torch.contiguous_format
            times[name] = time_ms(lambda: pk.threefry_normal(
                key, shape, f=f, device="cuda", memory_format=fmt))
            got = pk.threefry_normal(key, shape, f=f, device="cuda",
                                     memory_format=fmt)
            want = pk._plain(lambda k, s, d: prng.normal(k, s, device=d),
                             key, shape, f, fmt, torch.device("cuda"))
            errs[name] = (got - want).abs().max().item()
            if not errs[name] <= THREEFRY_BAR:
                fail(f"threefry timed {name}: max_abs_err {errs[name]:.3e}")
            del got, want
        if pk.threefry_normal.launches == before:
            fail("the timed threefry kernel was not launched")
        torch.cuda.empty_cache()
        times["f32_plain"] = time_ms(lambda: prng.normal(
            key, (N, H, W, C), device="cuda"), iters=3, warmup=1)
        times["bf16_plain"] = time_ms(lambda: prng.normal(
            key, (N, H, W, C), torch.bfloat16, device="cuda"), iters=3,
            warmup=1)
        big = pk.threefry_normal(key, THREEFRY_TIMED, device="cuda",
                                 memory_format=cl)
        ref = prng.normal(key, (N, H, W, C), device="cuda")
        d = (big.permute(0, 2, 3, 1) - ref).abs()
        errs["f32_timed"] = d.max().item()
        print(f"[threefry] b128 draw against the plain version: max_abs_err "
              f"{errs['f32_timed']:.3e}, "
              f"{100 * (d == 0).float().mean().item():.4f}% bit-equal")
        if errs["f32_timed"] > THREEFRY_BAR:
            fail(f"threefry b128: max_abs_err {errs['f32_timed']:.3e}")
        del big, ref, d
        torch.cuda.empty_cache()
        # The split kernel: bit-equal to the plain split for keys at the
        # int32 edges, read on the card or by value; then the train step's
        # split(key) timed, kernel against the plain version (tiny
        # launches: the events measure the host's issue time as well).
        for seed in (0, 7, 2 ** 31 - 1, -1, -2 ** 31):
            for num in (1, 2, 5, 300):
                key = prng.prng_key(seed)
                want = prng.split(key, num)
                for got in (pk.threefry_split(key.cuda(), num),
                            pk.threefry_split(key, num, device="cuda")):
                    if got.dtype != torch.uint32 or not torch.equal(
                            got.cpu(), want):
                        fail(f"threefry_split of seed {seed}, num {num} "
                             f"differs from the plain split")
        step_key = prng.prng_key(0).cuda()
        times["split"] = time_ms(lambda: pk.threefry_split(step_key),
                                 iters=50, warmup=5)
        times["split_plain"] = time_ms(lambda: prng.split(step_key),
                                       iters=50, warmup=5)
        # The card's least launch by the same route, and both on the
        # device (torch.profiler): the floor of the split's bound.
        times["empty"] = time_ms(pk.empty_launch, iters=50, warmup=5)
        table = kernel_table(lambda: (pk.threefry_split(step_key),
                                      pk.empty_launch()), "cuda", iters=50,
                             top=None)
        device_ms = {}
        for what, pattern in (("split", "threefry_split_kernel"),
                              ("empty", "empty_kernel")):
            rows = [r for r in table["top"] if pattern in r["name"]]
            if len(rows) != 1 or rows[0]["count"] != 1:
                fail(f"the profiler's table of split and empty launches "
                     f"has {rows} for {pattern}")
            device_ms[what] = times[f"{what}_device"] = rows[0]["ms"]
        print(f"[threefry] split: bit-equal to the plain split (5 seeds, num "
              f"1, 2, 5, 300, the key on the card and by value); the train "
              f"step's split(key): kernel {times['split']:.4f} ms a call on "
              f"events, {device_ms['split']:.5f} on the device; an empty "
              f"kernel by the same route {times['empty']:.4f} on events, "
              f"{device_ms['empty']:.5f} on the device (the launch floor); "
              f"plain torch {times['split_plain']:.4f} ms; on {card}")

        # The uniform entry: bit-equal on UNIFORM_CASES, then timed at the
        # vg128 generator's largest leaf (a flat draw, as the init makes).
        errs["uniform"] = max(check_uniform_case(torch, name, *case)
                              for name, case in UNIFORM_CASES.items())
        print(f"[threefry] uniform: {len(UNIFORM_CASES)} cases bit-equal to "
              f"the plain version (uniform times the scale)")
        from sg2im_tpu_torch.models import Sg2ImGenerator
        from sg2im_tpu_torch.nn.init import init_plan

        vocab, kwargs = vg128_config()
        largest = max(init_plan(Sg2ImGenerator(vocab, **kwargs), "g"),
                      key=lambda leaf: int(np.prod(leaf.shape)))
        n = int(np.prod(largest.shape))
        times["uniform_values"] = n
        flat = (1, n, 1, 1)
        scale = _kernel_scale(n // largest.shape[-1])
        times["uniform"] = time_ms(lambda: pk.threefry_uniform(
            key, n, -1.0, 1.0, scale, device="cuda"))
        times["uniform_plain"] = time_ms(lambda: prng.uniform(
            key, (n,), torch.float32, -1.0, 1.0, device="cuda") * scale,
            iters=3, warmup=1)
        times["uniform_normal"] = time_ms(lambda: pk.threefry_normal(
            key, flat, device="cuda", memory_format=cl, scale=scale))
        # A draw of this size is short against the host's issue of its
        # launch: its device time too.
        table = kernel_table(lambda: pk.threefry_uniform(
            key, n, -1.0, 1.0, scale, device="cuda"),
            "cuda", iters=20, top=None)
        rows = [r for r in table["top"] if "threefry_normal_kernel" in
                r["name"]]
        if len(rows) != 1 or rows[0]["count"] != 1:
            fail(f"the profiler's table of uniform draws has {rows}")
        times["uniform_device"] = rows[0]["ms"]
        got = pk.threefry_uniform(key, n, -1.0, 1.0, scale, device="cuda")
        want = prng.uniform(key, (n,), torch.float32, -1.0, 1.0,
                            device="cuda") * torch.tensor(scale,
                                                          device="cuda")
        if not torch.equal(got, want):
            fail("uniform at the largest leaf differs from the plain version")
        del got, want
        torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=60)
    clock_hz = float(smi.stdout.strip().splitlines()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    values = N * C * H * W
    # split(key): two keys of two words written, each one hash.
    times["split_bound"] = threefry_bounds(2, 16, THREEFRY_OPS["split"],
                                           sms, clock_hz)
    n = times["uniform_values"]
    bound, by = times["uniform_bound"] = threefry_bounds(
        n, 4 * n, THREEFRY_OPS["uniform"], sms, clock_hz)
    print(f"[threefry] uniform at the vg128 generator's largest leaf ({n} "
          f"values, {largest.name}): {times['uniform']:.4f} ms on events, "
          f"{times['uniform_device']:.4f} on the device, "
          f"{100 * bound / times['uniform']:.1f}% and "
          f"{100 * bound / times['uniform_device']:.1f}% of its "
          f"{bound:.4f} ms {by} "
          f"bound ({THREEFRY_OPS['uniform'].instructions:g} instructions a "
          f"value); the scaled normal of the same size "
          f"{times['uniform_normal']:.4f} ms; plain "
          f"{times['uniform_plain']:.3f} ms; on {card}")
    for tag, mode, elem in (("f32", 1, 4), ("bf16", 2, 2)):
        least = THREEFRY_OPS[tag]
        times[f"{tag}_bound"] = threefry_bounds(values, values * elem, least,
                                                sms, clock_hz)
        bound, by = times[f"{tag}_bound"]
        # The kernel's own instructions, a diagnostic: not the bound.  A
        # thread draws V values (one 16-byte store), so the static counts
        # over V are per value.
        mix = threefry_sass_mix(mode)
        V = pk.VEC_BYTES // elem
        n_int = sum(v for k, v in mix.items() if k in INT_OPCODES)
        ops = ", ".join(f"{k} {v}" for k, v in sorted(
            mix.items(), key=lambda kv: -kv[1]))
        print(f"[threefry] {tag} kernel SASS (static, the whole function of "
              f"the flat walk, {V} values a thread): "
              f"{sum(mix.values())} instructions, {n_int} on the integer "
              f"opcodes: {sum(mix.values()) / V:.1f} and {n_int / V:.1f} "
              f"a value ({ops})")
        print(f"[threefry] b128 {tag} draw of {values} values at "
              f"{values / times[tag] / 1e6:.1f} G values/s: "
              f"{times[tag]:.4f} ms, {100 * bound / times[tag]:.1f}% of its "
              f"{bound:.4f} ms {by} bound ({least.instructions:g} "
              f"instructions a value, {least.alu:g} of them on the integer "
              f"ALU: the least this ISA needs, on {sms} SMs issuing 128 a "
              f"clock at {clock_hz / 1e6:.0f} MHz; "
              f"{values * elem / 1e9:.3f} GB written), plain "
              f"{times[tag + '_plain']:.3f} ms, torch.randn of the same "
              f"shape {times['randn' if tag == 'f32' else 'randn_bf16']:.4f}"
              f" ms (another generator: a reference); on {card}")
    for name, (shape, f, _) in THREEFRY_TIMED_MORE.items():
        drawn = int(np.prod(shape)) // (f * f)
        out_bytes = int(np.prod(shape)) * 4
        bound, by = times[f"{name}_bound"] = threefry_bounds(
            drawn, out_bytes, THREEFRY_OPS["f32"], sms, clock_hz)
        print(f"[threefry] {name} {shape} at f {f}, {drawn} values drawn: "
              f"{times[name]:.4f} ms, {100 * bound / times[name]:.1f}% of "
              f"its {bound:.4f} ms {by} bound ({out_bytes / 1e9:.3f} GB "
              f"written), max_abs_err {errs[name]:.3e}; on {card}")
    return errs, times


def phase_init(torch, card, launches):
    """The JAX package's parameter init of the vg128 generator on the card;
    see the module docstring."""
    from sg2im_tpu_torch.models import Sg2ImGenerator
    from sg2im_tpu_torch.nn.init import init_draws, init_plan, init_state_dict
    from sg2im_tpu_torch.ops.prng import prng_key

    vocab, kwargs = vg128_config()
    model = Sg2ImGenerator(vocab, **kwargs)
    key = prng_key(0)
    init_state_dict(model, "g", key, "cuda")  # warm-up
    ms = []
    for i in range(3):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        got = init_state_dict(model, "g", key, "cuda")
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        path = read_launches()
        if i == 0:
            add_launches(launches, path)
        drawn = {k: v for k, v in path.items() if v}
        want = {k: v for k, v in init_draws(model, "g").items() if v}
        if drawn != want:
            fail(f"the vg128 init on the card launched {drawn}, not {want}")
    t0 = time.perf_counter()
    plain = init_state_dict(model, "g", key)
    cpu_s = time.perf_counter() - t0
    worst = {"uniform": 0.0, "normal": 0.0, "ones": 0.0, "zeros": 0.0}
    plan = init_plan(model, "g")
    if set(got) != set(plain) or set(got) != {leaf.name for leaf in plan}:
        fail("the card's and the CPU's init give other names")
    for leaf in plan:
        g, w = got[leaf.name].cpu(), plain[leaf.name]
        err = (g - w).abs().max().item()
        bar = THREEFRY_BAR * leaf.scale if leaf.draw == "normal" else 0.0
        if g.shape != w.shape or not err <= bar:
            fail(f"init {leaf.name} ({leaf.draw}): max_abs_err {err:.3e} "
                 f"over {bar:.3e}")
        worst[leaf.draw] = max(worst[leaf.draw],
                               err / (leaf.scale if bar else 1.0))
    values = sum(int(np.prod(leaf.shape)) for leaf in plan
                 if leaf.draw in ("uniform", "normal"))
    print(f"[init] vg128 generator, PRNGKey(0): {len(plan)} leaves, "
          f"{sum(want.values())} drawn ({values} values; {want}) on the card "
          f"in {statistics.median(ms):.2f} ms (host clock to a synchronize, "
          f"median of {[round(v, 2) for v in ms]}) against {cpu_s:.2f} s of "
          f"the plain init on the host; uniform leaves, ones and zeros "
          f"bit-equal, normal leaves within {worst['normal']:.3e} of their "
          f"scale; on {card}")
    return statistics.median(ms), cpu_s


def kernel_wrappers():
    """{kernels-line name: wrapper}; each wrapper counts its launches."""
    from sg2im_tpu_torch.ops import conv_kernel as ck
    from sg2im_tpu_torch.ops import crn_epilogue as ce
    from sg2im_tpu_torch.ops import layout_kernel as lk
    from sg2im_tpu_torch.ops import mask_head as mh
    from sg2im_tpu_torch.ops import prng_kernel as pk
    from sg2im_tpu_torch.ops import relayout as rl
    from sg2im_tpu_torch.ops import resample as rs

    return {"layout_compose_boxes": lk.layout_compose,
            "layout_compose_weights": lk.layout_compose_weights,
            "conv3x3_bf16": ck.conv3x3,
            "conv3x3_s8": ck.conv3x3_int8,
            "relayout_s2d": rl.space_to_depth,
            "relayout_d2s": rl.depth_to_space,
            "threefry_normal": pk.threefry_normal,
            "threefry_uniform": pk.threefry_uniform,
            "threefry_split": pk.threefry_split,
            "crn_epilogue": ce.crn_epilogue,
            "mask_head": mh.mask_head,
            "crn_resample": rs}


# K1's counts in read_launches: all its launches, and those with a bf16
# output among them.
K1_COUNTS = ("layout_compose_boxes", "layout_compose_boxes_bf16")
# A training run's kernels: K1, the threefry draw of its layout noise
# (once per step, check_model batch, triptych and step_breakdown), the
# split of the state's key (once per step), in bf16 E1 in the generator's
# eval forwards (each checked by train_e1_launches), and M1 in the eval
# forwards of a generator whose mask head it takes (gconv_dim 128), and R1
# in the generator's forwards without a gradient (each checked by
# train_r1_launches).
TRAIN_COUNTS = K1_COUNTS + ("threefry_normal", "threefry_split",
                            "crn_epilogue", "mask_head", "crn_resample")
# The CRN stages of the training runs' generators (the CLI's default
# refinement_network_dims, 1024 to 64).
TRAIN_CRN_STAGES = 5
# The G forwards of a step_breakdown that record a gradient (its
# g_forward_backward section, warm-up and timed); its g_forward section's
# two record none.
BREAKDOWN_GRAD_FORWARDS = 2


def train_e1_launches(bf16, eval_forwards, stages=TRAIN_CRN_STAGES):
    """E1's launches in a training run: one a chain (2 x ``stages`` + 1 a
    CRN forward) of each of its ``eval_forwards`` generator forwards in
    eval mode without a gradient (check_model's batches, the triptychs'
    three) where it computes in bf16; none in float32, and none in a train
    step or step_breakdown, whose forwards run in train mode."""
    return (2 * stages + 1) * eval_forwards if bf16 else 0


def train_r1_launches(k1, steps, prints=0, stages=TRAIN_CRN_STAGES):
    """R1's launches in a training run of ``steps`` train steps and
    ``prints`` step_breakdowns that launched K1 ``k1`` times (once a G
    forward): one pyramid and ``stages`` - 1 feats upsamples (all but the
    first stage's one channel) in each G forward that records no gradient
    (check_model's batches, the triptychs, the breakdowns' g_forward, a
    probe's or the gate's), none in a forward that records one (a train
    step, a breakdown's g_forward_backward)."""
    return stages * (k1 - steps - BREAKDOWN_GRAD_FORWARDS * prints)


def cli_draws(steps, checkpoints, prints, sweeps):
    """The threefry launches of a training CLI run with ``--timing true``:
    one a step, one a check_model batch (``sweeps``: the batches of the
    train and val sweeps at each checkpoint), one a triptych (after each
    non-empty sweep) and one a step_breakdown (at each print)."""
    return (steps + checkpoints * (sum(sweeps) + sum(n > 0 for n in sweeps))
            + prints)


# The launches of the Trainer.init_state calls on the card since the last
# reset_launches (watch_inits).
INIT_LAUNCHES: dict = {}


def reset_launches():
    """Every launch count, the conv wrappers' padded copies, the
    relayout wrappers' unaligned launches and R1's layout copies, to 0."""
    from sg2im_tpu_torch.ops import layout_kernel as lk

    INIT_LAUNCHES.clear()
    lk.layout_compose.launches_bf16 = 0
    for wrapper in kernel_wrappers().values():
        wrapper.launches = 0
        if hasattr(wrapper, "layout_copies"):
            wrapper.layout_copies = 0
        if hasattr(wrapper, "padded_copies"):
            wrapper.padded_copies = 0
        if hasattr(wrapper, "unaligned_launches"):
            wrapper.unaligned_launches = 0


def check_no_padded_copies(what):
    """Fail if a conv on a path took the wrapper's zero-padded input copy
    (every path shape suits the kernel's tensor map as it is), or a
    relayout the units route."""
    for name, wrapper in kernel_wrappers().items():
        if getattr(wrapper, "padded_copies", 0):
            fail(f"{what}: {name} padded its input "
                 f"{wrapper.padded_copies} times")
    check_relayout_routes(what)


def read_launches() -> dict:
    """Each wrapper's launches, and K1's bf16-output launches among its
    own under ``layout_compose_boxes_bf16``."""
    from sg2im_tpu_torch.ops import layout_kernel as lk

    return {**{name: w.launches for name, w in kernel_wrappers().items()},
            "layout_compose_boxes_bf16": lk.layout_compose.launches_bf16}


def watch_inits():
    """Wrap Trainer.init_state: each call on the card must launch exactly
    its Trainer.init_launches() (the key's split and one threefry draw a
    drawn leaf: every init draw a kernel launch), read from the wrappers'
    counts around it, and those launches are set apart in INIT_LAUNCHES
    for the paths whose checks count launches per step."""
    from sg2im_tpu_torch.train.trainer import Trainer

    init_state = Trainer.init_state

    def watched(self, *args, **kwargs):
        before = read_launches()
        state = init_state(self, *args, **kwargs)
        after = read_launches()
        got = {k: after[k] - before[k] for k in after
               if after[k] != before[k]}
        if self.device.type == "cuda":
            want = {k: v for k, v in self.init_launches().items() if v}
            if got != want:
                fail(f"Trainer.init_state on the card launched {got}, not "
                     f"{want}")
        add_launches(INIT_LAUNCHES, got)
        return state

    Trainer.init_state = watched


def without_init(path: dict) -> dict:
    """A path's launches less those of the Trainer inits in it."""
    return {k: v - INIT_LAUNCHES.get(k, 0) for k, v in path.items()}


def add_launches(total: dict, path: dict) -> None:
    for name, n in path.items():
        total[name] = total.get(name, 0) + n


def cli_images(args) -> np.ndarray:
    """Run the run_model CLI into a temporary directory; its PNGs."""
    from PIL import Image

    from sg2im_tpu_torch.cli import run_model

    with tempfile.TemporaryDirectory() as out_dir:
        rc = run_model.main(args + ["--output_dir", out_dir])
        if rc != 0:
            fail(f"run_model {' '.join(args)} exited {rc}")
        names = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
        return np.stack([np.asarray(Image.open(os.path.join(out_dir, f)))
                         for f in names])


def phase_checkpoint(torch, launches):
    """The learned checkpoint through the CLI on the card, in f32 and on
    the int8 turbo tier (scales calibrated on the card on half of the
    graphs, saved, and handed to the CLI and to a CPU engine), each held
    against the CPU engine by u8 PSNR."""
    from sg2im_tpu_torch.inference import InferenceEngine

    ckpt = os.path.join(REPO, "artifacts", "trained_coco64.pt")
    graphs = os.path.join(REPO, "artifacts", "trained_scene_graphs.json")
    common = ["--checkpoint", ckpt, "--scene_graphs_json", graphs,
              "--noise", "zeros", "--device", "cuda"]
    cli_u8 = cli_images(common)
    with open(graphs) as f:
        scene_graphs = json.load(f)
    gpu = InferenceEngine.from_torch_checkpoint(ckpt, device="cuda")
    cpu = InferenceEngine.from_torch_checkpoint(ckpt, device="cpu")
    g_u8, g_out = gpu.generate(scene_graphs, noise="zeros")
    c_u8, c_out = cpu.generate(scene_graphs, noise="zeros")
    if cli_u8.shape != c_u8.shape:
        fail(f"CLI wrote {cli_u8.shape}, expected {c_u8.shape}")
    err = (g_out["imgs"].cpu() - c_out["imgs"]).abs().max().item()
    p_cli, p_eng = psnr_u8(cli_u8, c_u8), psnr_u8(g_u8, c_u8)
    print(f"[checkpoint] trained_coco64 {len(cli_u8)} graphs, f32: CLI u8 "
          f"PSNR {p_cli:.2f} dB, engine u8 PSNR {p_eng:.2f} dB, f32 "
          f"max_abs_err {err:.3e} (GPU vs CPU plain path)")
    if min(p_cli, p_eng) < PSNR_BAR:
        fail(f"trained checkpoint PSNR below {PSNR_BAR} dB")

    # The turbo tier through the CLI with a calibration file.
    turbo = InferenceEngine.from_torch_checkpoint(ckpt, device="cuda",
                                                  quantize="int8")
    turbo.calibrate(scene_graphs[: len(scene_graphs) // 2], noise="zeros")
    with tempfile.TemporaryDirectory() as tmp:
        cal = os.path.join(tmp, "calibration.json")
        turbo.save_calibration(cal)
        reset_launches()
        t_cli = cli_images(common + ["--quantize", "int8",
                                     "--calibration_file", cal])
        path = read_launches()
        check_no_padded_copies("the turbo CLI")
        cpu_turbo = InferenceEngine.from_torch_checkpoint(
            ckpt, device="cpu", quantize="int8")
        cpu_turbo.load_calibration(cal)
    add_launches(launches, path)
    ct_u8, _ = cpu_turbo.generate(scene_graphs, noise="zeros")
    p_turbo, p_vs_f32 = psnr_u8(t_cli, ct_u8), psnr_u8(t_cli, c_u8)
    print(f"[checkpoint] trained_coco64 turbo int8 (band {turbo.quant_band()}"
          f", tags {len(turbo.expected_quant_tags())}, calibrated on "
          f"{len(scene_graphs) // 2} of {len(scene_graphs)} graphs): CLI vs "
          f"CPU turbo engine u8 PSNR {p_turbo:.2f} dB; vs CPU f32 "
          f"{p_vs_f32:.2f} dB; launches {path}")
    if path["conv3x3_s8"] == 0:
        fail("the turbo CLI never launched the int8 conv kernel")
    if p_turbo < PSNR_BAR:
        fail(f"turbo CLI disagrees with the CPU turbo engine: "
             f"{p_turbo:.2f} dB")


def vg128_state(torch, seed=0) -> dict:
    """The vg128 generator's weights that the JAX package's init gives
    PRNGKey(seed) (bench.py's model at seed 0), drawn on the card."""
    from sg2im_tpu_torch.models import Sg2ImGenerator
    from sg2im_tpu_torch.nn.init import init_state_dict
    from sg2im_tpu_torch.ops.prng import prng_key

    vocab, kwargs = vg128_config()
    return init_state_dict(Sg2ImGenerator(vocab, **kwargs), "g",
                           prng_key(seed), "cuda")


def random_graphs(vocab, n, rng, n_objs=10, n_rels=21):
    """Scene graphs of n_objs objects and n_rels relationships: with the
    per-object in-image triples that makes O = 11 -> 16 and T = 31 -> 32
    slots, the bench's flagship batch."""
    objects = vocab["object_idx_to_name"][1:]
    preds = vocab["pred_idx_to_name"][1:]
    graphs = []
    for _ in range(n):
        objs = [objects[i] for i in rng.randint(0, len(objects), n_objs)]
        rels = [[int(rng.randint(n_objs)), preds[rng.randint(len(preds))],
                 int(rng.randint(n_objs))] for _ in range(n_rels)]
        graphs.append({"objects": objs, "relationships": rels})
    return graphs


def phase_vg128(torch, card, launches):
    """-> {mode: b128 forward img/s}."""
    from sg2im_tpu_torch.data import encode_scene_graphs
    from sg2im_tpu_torch.inference import InferenceEngine, full_fp32

    vocab, kwargs = vg128_config()
    state = vg128_state(torch)
    bf16 = dict(compute_dtype=torch.bfloat16, crn_mode="split")
    engines = {
        "f32": InferenceEngine(vocab, kwargs, state, device="cuda"),
        "bf16/split": InferenceEngine(vocab, kwargs, state, device="cuda",
                                      **bf16),
    }
    # The further CRN modes: {name: (engine options, kernels its requests
    # must launch)}.  'packed' packs the 32x32, 64x64 and 128x128 stages
    # and the head.
    more_modes = {
        "bf16/packed": (dict(compute_dtype=torch.bfloat16,
                             crn_mode="packed"),
                        ("relayout_s2d", "relayout_d2s")),
        "bf16/phase": (dict(compute_dtype=torch.bfloat16, crn_mode="phase"),
                       ("relayout_d2s", "crn_epilogue")),
        "bf16/split_noise": (dict(compute_dtype=torch.bfloat16,
                                  crn_mode="split_noise"), ("crn_epilogue",)),
        "f32/packed": (dict(crn_mode="packed"),
                       ("relayout_s2d", "relayout_d2s")),
    }
    rng = np.random.RandomState(0)

    def serve(mode, engine):
        for n in (1, 3, 8):
            imgs, out = engine.generate(random_graphs(vocab, n, rng),
                                        seed=n)
            if imgs.shape != (n, 128, 128, 3) or imgs.dtype != np.uint8:
                fail(f"{mode}: generate({n}) gave {imgs.shape} {imgs.dtype}")
            for k, v in out.items():
                if not torch.isfinite(v).all():
                    fail(f"{mode}: non-finite {k} for {n} graphs")
        torch.cuda.synchronize()

    # The serving path: generate requests, counting kernel launches.
    reset_launches()
    for mode, engine in engines.items():
        serve(mode, engine)
    path = read_launches()
    add_launches(launches, path)
    print(f"[vg128] generate requests of 1, 3, 8 graphs in f32 and "
          f"bf16/split: outputs finite; kernel launches {path}")
    if path["layout_compose_boxes"] == 0:
        fail("the serving path never launched the layout-compose kernel")
    # Three generates of bf16/split: E1 eleven times a forward.
    if path["crn_epilogue"] != 3 * 11:
        fail(f"bf16/split launched E1 {path['crn_epilogue']} times in 3 "
             f"generates, not 11 a forward")
    # Three generates of each: M1 once a step (four) a forward, in f32 and
    # bf16 alike.
    if path["mask_head"] != 2 * 3 * 4:
        fail(f"f32 and bf16/split launched M1 {path['mask_head']} times in "
             f"6 generates, not 4 a forward")
    # R1 five times a forward in f32 ('legacy') and bf16/split alike.
    check_r1("f32 and bf16/split in 6 generates", path,
             2 * 3 * R1_GENERATE["split"])

    # The further CRN modes, each its own path.
    for mode, (opts, needs) in more_modes.items():
        engine = InferenceEngine(vocab, kwargs, state, device="cuda", **opts)
        reset_launches()
        serve(mode, engine)
        path = read_launches()
        add_launches(launches, path)
        print(f"[vg128] {mode}: requests of 1, 3, 8 graphs finite; kernel "
              f"launches {path}")
        for name in ("layout_compose_boxes",) + needs:
            if path[name] == 0:
                fail(f"the {mode} path never launched {name}")
        if path["mask_head"] != 3 * 4:
            fail(f"the {mode} path launched M1 {path['mask_head']} times in "
                 f"3 generates, not 4 a forward")
        if "packed" in mode and path["crn_epilogue"]:
            fail(f"the {mode} path launched E1: 'packed' keeps its chains "
                 f"eager")
        check_r1(f"the {mode} path in 3 generates", path,
                 3 * R1_GENERATE[mode.split("/")[1]])
        check_relayout_routes(f"the vg128 {mode} requests")
        engines[mode] = engine

    # The turbo path: calibrate, then requests, counting kernel launches.
    turbo = InferenceEngine(vocab, kwargs, state, device="cuda",
                            quantize="int8", **bf16)
    turbo.calibrate(random_graphs(vocab, 16, rng), seed=100)
    reset_launches()
    serve("turbo", turbo)
    path = read_launches()
    check_no_padded_copies("the vg128 turbo requests")
    add_launches(launches, path)
    print(f"[vg128] turbo int8 bf16/split (band {turbo.quant_band()}, tags "
          f"{turbo.expected_quant_tags()}): requests of 1, 3, 8 graphs "
          f"finite; kernel launches {path}")
    if path["conv3x3_s8"] == 0 or path["layout_compose_boxes"] == 0:
        fail("the turbo path did not launch both of its kernels")
    if path["crn_epilogue"]:
        fail("the turbo path launched E1: the int8 tier keeps its chains "
             "eager")
    if path["mask_head"] != 3 * 4:
        fail(f"the turbo path launched M1 {path['mask_head']} times in 3 "
             f"generates, not 4 a forward")
    check_r1("the turbo path in 3 generates", path, 3 * R1_TURBO)
    engines["turbo bf16/split"] = turbo

    # Agreement with the CPU engines on a small input with the same
    # explicit noise: the plain path in f32, and the turbo tier in
    # bf16/split at the same calibration file.
    small = random_graphs(vocab, 2, rng)
    small_noise = rng.randn(2, 128, 128, 32).astype(np.float32)
    cpu = InferenceEngine(vocab, kwargs, state, device="cpu")
    cpu_turbo = InferenceEngine(vocab, kwargs, state, device="cpu",
                                quantize="int8", **bf16)
    with tempfile.TemporaryDirectory() as tmp:
        cal = os.path.join(tmp, "calibration.json")
        turbo.save_calibration(cal)
        cpu_turbo.load_calibration(cal)
    c_u8, c_out = cpu.generate(small, noise=small_noise)
    ct_u8, ct_out = cpu_turbo.generate(small, noise=small_noise)
    for mode, engine in engines.items():
        g_u8, g_out = engine.generate(small, noise=small_noise)
        ref_u8, ref_out = ((ct_u8, ct_out) if engine is turbo
                           else (c_u8, c_out))
        p = psnr_u8(g_u8, ref_u8)
        err = (g_out["imgs"].float().cpu() - ref_out["imgs"]).abs().max()
        ref = "CPU turbo bf16/split" if engine is turbo else "CPU float32"
        extra = (f"; vs CPU float32 {psnr_u8(g_u8, c_u8):.2f} dB"
                 if engine is turbo else "")
        print(f"[vg128] {mode} vs {ref} on 2 graphs: u8 PSNR {p:.2f} dB, "
              f"max_abs_err {err.item():.3e}{extra}")
        if p < PSNR_BAR:
            fail(f"vg128 {mode} disagrees with {ref}: {p:.2f} dB")

    # Batch-128 forward throughput and peak memory.
    img_s = {}
    batch = encode_scene_graphs(random_graphs(vocab, 128, rng), vocab,
                                align=8)
    dev = torch.device("cuda")
    args = (torch.as_tensor(batch.objs, device=dev).long(),
            torch.as_tensor(batch.triples, device=dev).long(),
            torch.as_tensor(batch.obj_mask, device=dev).float(),
            torch.as_tensor(batch.triple_mask, device=dev).float())
    noise = torch.randn((128, 32, 128, 128), device=dev).contiguous(
        memory_format=torch.channels_last)
    for mode, engine in engines.items():
        with torch.inference_mode(), full_fp32():
            engine.model(*args, noise)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            reset_launches()
            windows = []
            for _ in range(5):
                t0 = time.perf_counter()
                for _ in range(3):
                    imgs = engine.model(*args, noise)[0]
                torch.cuda.synchronize()
                windows.append((time.perf_counter() - t0) / 3)
            if not torch.isfinite(imgs).all():
                fail(f"{mode}: non-finite b128 images")
            check_no_padded_copies(f"the b128 {mode} forwards")
        ms = float(np.median(windows)) * 1e3
        img_s[mode] = 128 / ms * 1e3
        peak = torch.cuda.max_memory_allocated()
        print(f"[vg128] b128 forward {mode}: {128 / ms * 1e3:.1f} img/s, "
              f"{ms:.2f} ms (median of 5 windows of 3, runs "
              f"{[round(w * 1e3, 2) for w in windows]}), peak "
              f"{peak / 2 ** 30:.2f} GiB allocated ("
              f"{(peak - resident) / 2 ** 30:.2f} GiB above the "
              f"{resident / 2 ** 30:.2f} GiB resident: every engine's "
              f"weights and the inputs), on {card}")
    return img_s


SEEDED_SEED = 11        # phase_seeded's seed
# The port's kernels the profiler must name in a seeded generate: what ->
# a part of the kernel's name.
SEEDED_PROFILED = {"threefry": "threefry_normal_kernel",
                   "K1": "compose_boxes_kernel"}
SEEDED_ROWS = (0, 124)  # the CPU draws 4 rows from each of these


def phase_seeded(torch, card, launches):
    """The JAX package's seed contract across devices: the seeded vg128
    b128 generate on the card (f32, one threefry launch and one K1 launch)
    against the CPU engine's seeded generate of its first two graphs (pad
    bucket 2: the same noise rows), at u8 PSNR >= PSNR_BAR, and the card's
    noise tensor against the CPU's on rows drawn there by offset, within
    THREEFRY_BAR; then torch.profiler's kernel table of one seeded
    generate, which must name the threefry kernel and K1
    (SEEDED_PROFILED)."""
    from sg2im_tpu_torch.inference import InferenceEngine

    vocab, kwargs = vg128_config()
    state = vg128_state(torch)
    card_engine = InferenceEngine(vocab, kwargs, state, device="cuda")
    cpu = InferenceEngine(vocab, kwargs, state, device="cpu")
    graphs = random_graphs(vocab, 128, np.random.RandomState(SEEDED_SEED))
    card_engine.generate(graphs, seed=SEEDED_SEED + 1)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    g_u8, g_out = card_engine.generate(graphs, seed=SEEDED_SEED)
    ms = (time.perf_counter() - t0) * 1e3
    path = read_launches()
    add_launches(launches, path)
    if path["threefry_normal"] != 1 or path["layout_compose_boxes"] != 1:
        fail(f"the seeded b128 generate launched {path}: threefry and K1 "
             f"once each expected")
    c_u8, c_out = cpu.generate(graphs[:2], seed=SEEDED_SEED)
    p = psnr_u8(g_u8[:2], c_u8)
    err = (g_out["imgs"][:2].float().cpu() - c_out["imgs"]).abs().max()
    noise = card_engine.draw_noise(128, SEEDED_SEED).cpu()
    noise_err = max(
        (noise[r:r + 4] - cpu.draw_noise(4, SEEDED_SEED, row=r)).abs().max()
        .item() for r in SEEDED_ROWS)
    print(f"[seeded] vg128 b128 f32 seeded generate on the card ({ms:.1f} "
          f"ms, host included; launches "
          f"{ {k: v for k, v in path.items() if v} }) against the CPU "
          f"engine's seeded generate of its first 2 graphs: u8 PSNR "
          f"{p:.2f} dB, max_abs_err {err.item():.3e}; the card's noise "
          f"rows {SEEDED_ROWS[0]}-{SEEDED_ROWS[0] + 3} and "
          f"{SEEDED_ROWS[1]}-{SEEDED_ROWS[1] + 3} against the CPU's draw "
          f"by offset: max_abs_err {noise_err:.3e}; on {card}")
    if p < PSNR_BAR:
        fail(f"the card's seeded generate disagrees with the CPU's: "
             f"{p:.2f} dB")
    if not noise_err <= THREEFRY_BAR:
        fail(f"the card's seeded noise differs from the CPU's by "
             f"{noise_err:.3e}")
    # The profiler sees the port's own kernels (launched through ctypes):
    # the seeded generate's table names the threefry kernel and K1.
    table = kernel_table(lambda: card_engine.generate(graphs,
                                                      seed=SEEDED_SEED),
                         "cuda", iters=1, top=None)
    rows = {what: [r for r in table["top"] if pattern in r["name"]]
            for what, pattern in SEEDED_PROFILED.items()}
    print(f"[seeded] torch.profiler over one seeded b128 generate: device "
          f"{table['device_ms']:.3f} ms in {table['kernels']:.0f} kernels, "
          f"span {table['span_ms']:.3f} ms, idle {100 * table['idle']:.1f}% "
          f"({table['warmup_lost']} of its warm-up launches lost); the "
          f"port's kernels: " + "; ".join(
              f"{what} {r['name'][:60]!r} {r['ms']:.4f} ms x {r['count']:.0f}"
              for what, found in rows.items() for r in found)
          + "; the largest: " + ", ".join(
              f"{r['name'][:40]!r} {r['ms']:.3f}" for r in table["top"][:6])
          + f"; on {card}")
    missing = [what for what, found in rows.items() if not found]
    if missing:
        fail(f"torch.profiler's kernel table of the seeded generate does not "
             f"name {missing}")


SERVE_WINDOW_MS = 30.0   # the smoke servers' --batch_window_ms
SERVE_CLIENTS = 8        # concurrent requests of SERVE_GRAPHS graphs each:
SERVE_GRAPHS = 16        # one coalesced batch of 128
HTTP_TIMEOUT = 300       # seconds, per HTTP call and per server start
# The turbo tier's coalesced replies against each request alone: an int8
# step of an activation can turn the forward's batch-size dependence (one
# bf16 rounding, within 1 u8 level without int8) into 2 levels.
TURBO_COALESCED_U8 = 2
TURBO_COALESCED_DB = 55.0


def write_vg128_checkpoint(torch, path, seed=0):
    """The vg128 generator with the JAX init's weights of PRNGKey(seed)
    (the weights of phase_vg128) as a reference-layout .pt; returns its
    vocab."""
    vocab, kwargs = vg128_config()
    state = {k: v.cpu() for k, v in vg128_state(torch, seed).items()}
    torch.save({"model_state": state,
                "model_kwargs": dict(kwargs, vocab=vocab)}, path)
    return vocab


class SmokeServer:
    """The port's serve_forever in a thread on port 0, as a context
    manager; shut down and joined on exit."""

    def __init__(self, argv):
        from sg2im_tpu_torch.cli.serve import build_parser

        self.args = build_parser().parse_args(argv + ["--port", "0"])

    def __enter__(self):
        import threading

        from sg2im_tpu_torch.cli.serve import serve_forever

        self.ready = threading.Event()
        self.thread = threading.Thread(target=serve_forever,
                                       args=(self.args, self.ready),
                                       daemon=True)
        self.thread.start()
        if not self.ready.wait(timeout=HTTP_TIMEOUT):
            fail("a smoke server did not start")
        self.state = self.ready.state
        self.engine = self.state.engine
        self.base = f"http://127.0.0.1:{self.ready.httpd.server_address[1]}"
        return self

    def __exit__(self, *exc):
        self.ready.httpd.shutdown()
        self.thread.join(timeout=HTTP_TIMEOUT)
        if self.thread.is_alive():
            fail("a smoke server did not stop")

    def get(self, path):
        import urllib.request

        with urllib.request.urlopen(self.base + path,
                                    timeout=HTTP_TIMEOUT) as r:
            return r.read()

    def post(self, payload):
        import urllib.request

        req = urllib.request.Request(
            self.base + "/generate", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
            return json.loads(r.read())

    def post_all(self, payloads):
        """POST the payloads concurrently, one thread each; the replies in
        order."""
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(len(payloads)) as pool:
            return list(pool.map(self.post, payloads))


def reply_images(reply) -> np.ndarray:
    """The (n, H, W, 3) uint8 images of a 'png' or 'npy' reply."""
    import base64
    import io

    from PIL import Image

    raw = [base64.b64decode(s) for s in reply["images"]]
    if reply["format"] == "png":
        return np.stack([np.asarray(Image.open(io.BytesIO(b))) for b in raw])
    return np.stack([np.frombuffer(b, np.uint8).reshape(reply["shape"])
                     for b in raw])


def drive_server(torch, name, server, vocab, rng, card, needs,
                 coalesced_max=1, coalesced_psnr=None):
    """One server's main path: healthz; a seeded PNG request, the same
    request as npy and two 'zeros' requests, each sent alone and answered
    by an engine call of its own; SERVE_CLIENTS concurrent requests
    coalesced into fewer engine calls; launch counts against the server's
    engine calls and /metrics against the requests sent.  Then the replies
    against the server's own engine called directly on the server's engine
    thread: the seeded request alone bit-equal to ``engine.generate``; the
    coalesced replies bit-equal to ``engine.generate`` of the merged batch
    with the merged noise, and each request alone bit-equal to its 16
    graphs with the same noise rows given explicitly, so that what stays
    between coalesced and alone (held to ``coalesced_max`` u8 levels and,
    if given, ``coalesced_psnr`` dB) is the forward's own dependence on the
    batch size.  ``needs``: {kernel: launches per engine call}.  Returns
    the launches."""
    health = json.loads(server.get("/healthz"))
    if health["status"] != "ok" or health["image_size"] != [128, 128]:
        fail(f"{name}: /healthz gave {health}")
    if health.get("int8_calibrated") is False:
        fail(f"{name}: the turbo server is not calibrated")
    solo = random_graphs(vocab, 3, rng)
    batch = [random_graphs(vocab, SERVE_GRAPHS, rng)
             for _ in range(SERVE_CLIENTS)]
    reset_launches()
    sent = [0, 0]  # requests, images
    batcher = server.state.batcher

    def count(payloads):
        sent[0] += len(payloads)
        sent[1] += sum(len(p["scene_graphs"]) for p in payloads)

    def alone(payload):
        calls0 = batcher.engine_calls
        reply = server.post(payload)
        count([payload])
        if batcher.engine_calls != calls0 + 1:
            fail(f"{name}: a request sent alone took "
                 f"{batcher.engine_calls - calls0} engine calls, not 1")
        return reply

    png = alone({"scene_graphs": solo, "seed": 17})
    npy = alone({"scene_graphs": solo, "seed": 17, "return": "npy"})
    zeros = [alone({"scene_graphs": solo, "noise": "zeros", "return": "npy"})
             for _ in range(2)]
    calls0 = batcher.engine_calls
    payloads = [{"scene_graphs": g, "seed": 100 + i, "return": "npy"}
                for i, g in enumerate(batch)]
    coalesced = server.post_all(payloads)
    count(payloads)
    calls = batcher.engine_calls - calls0
    path = read_launches()
    engine_calls = batcher.engine_calls
    check_no_padded_copies(f"the {name} server")
    metrics = json.loads(server.get("/metrics?format=json"))
    text = server.get("/metrics").decode()
    print(f"[serve] {name}: {sent[0]} requests, {sent[1]} images over HTTP "
          f"in {engine_calls} engine calls (4 requests alone in 4; "
          f"{SERVE_CLIENTS} concurrent requests of {SERVE_GRAPHS} graphs in "
          f"{calls}); kernel launches {path}")
    if calls >= SERVE_CLIENTS:
        fail(f"{name}: {SERVE_CLIENTS} concurrent requests took {calls} "
             f"engine calls: nothing coalesced")
    for kernel, per_call in needs.items():
        if path[kernel] != per_call * engine_calls:
            fail(f"{name}: {kernel} launched {path[kernel]} times in "
                 f"{engine_calls} engine calls, not {per_call} per call")
    # One seeded draw per 'random' request, alone or coalesced: the PNG
    # and the npy of seed 17, and each concurrent request's own rows.
    if path["threefry_normal"] != 2 + SERVE_CLIENTS:
        fail(f"{name}: threefry launched {path['threefry_normal']} times "
             f"for {2 + SERVE_CLIENTS} seeded requests")
    if (metrics["requests"], metrics["images"]) != tuple(sent) or (
            f"sg2im_requests_total {sent[0]}\n" not in text
            or f"sg2im_images_total {sent[1]}\n" not in text
            or metrics["engine_calls"] != engine_calls):
        fail(f"{name}: /metrics counted {metrics}, sent {sent}")

    png_u8, npy_u8 = reply_images(png), reply_images(npy)
    if png_u8.shape != (3, 128, 128, 3) or not np.array_equal(png_u8,
                                                              npy_u8):
        fail(f"{name}: the PNG reply {png_u8.shape} differs from the npy one")
    if zeros[0]["images"] != zeros[1]["images"]:
        fail(f"{name}: two 'zeros' requests, two engine calls, differ")
    engine = server.engine

    def generate(*args, **kw):
        return batcher.worker.submit(engine.generate, *args, **kw).result()[0]

    with batcher.device_lock:
        want = generate(solo, seed=17)
        if not np.array_equal(npy_u8, want):
            fail(f"{name}: a seeded reply differs from engine.generate: "
                 f"{int((npy_u8 != want).sum())} values")
        got = np.concatenate([reply_images(r) for r in coalesced])
        noise = torch.cat([engine.draw_noise(SERVE_GRAPHS, 100 + i)
                           for i in range(SERVE_CLIENTS)]).permute(0, 2, 3, 1)
        merged = generate([g for b in batch for g in b], noise=noise)
        by_request = np.concatenate([
            generate(g, seed=100 + i) for i, g in enumerate(batch)])
        explicit = np.concatenate([
            generate(g, noise=noise[i * SERVE_GRAPHS:(i + 1) * SERVE_GRAPHS])
            for i, g in enumerate(batch)])
    # One merged call is the rule at this window; with more, the merged
    # batch's split is not known here and only the limits below hold.
    if calls == 1 and not np.array_equal(got, merged):
        fail(f"{name}: coalesced replies differ from engine.generate of the "
             f"merged batch: {int((got != merged).sum())} values")
    if not np.array_equal(by_request, explicit):
        fail(f"{name}: a seeded b{SERVE_GRAPHS} generate differs from the "
             f"same noise given explicitly: "
             f"{int((by_request != explicit).sum())} values")
    print(f"[serve] {name}: a seeded 3-graph request alone bit-equal to "
          f"engine.generate; PNG equals npy; two 'zeros' requests equal; "
          f"coalesced replies "
          f"{'bit-equal to' if calls == 1 else 'NOT CHECKED against'} "
          f"engine.generate b128 of the merged graphs and noise; each "
          f"request's b{SERVE_GRAPHS} generate bit-equal with seeded and "
          f"explicit noise; /metrics {metrics['requests']} requests, "
          f"{metrics['images']} images, {metrics['engine_calls']} engine "
          f"calls; on {card}")
    # The server's coalesced replies against each request alone, and the
    # engine's b128 against its b16 calls on the same graphs and noise.
    for what, x, y in (
            ("coalesced replies vs each request alone", got, by_request),
            (f"engine.generate b128 vs b{SERVE_GRAPHS} on the same noise",
             merged, explicit)):
        d = np.abs(x.astype(int) - y)
        worst, p = int(d.max()), psnr_u8(x, y)
        print(f"[serve] {name}: {what}: max |diff| {worst} u8 "
              f"({int((d > 0).sum())} values differ, {int((d > 1).sum())} by "
              f"more than 1, of {d.size}), u8 PSNR {p:.2f} dB; on {card}")
        if worst > coalesced_max or (coalesced_psnr is not None
                                     and p < coalesced_psnr):
            fail(f"{name}: {what}: {worst} u8 levels ({p:.2f} dB) apart "
                 f"(limits {coalesced_max} u8, {coalesced_psnr} dB)")
    return path


def http_client(base, rounds, single=None, repeats=0):
    """An HTTP client, run in a process of its own so that it does not
    share the server's interpreter lock: the payloads of each round posted
    concurrently (one thread each), then ``single`` posted ``repeats``
    times in sequence.  Every reply is read and parsed in full.  Returns
    (seconds per round, seconds per sequential request)."""
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    def post(payload):
        req = urllib.request.Request(
            base + "/generate", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
            reply = json.loads(r.read())
        if len(reply["images"]) != len(payload["scene_graphs"]):
            raise RuntimeError(f"a reply of {len(reply['images'])} images")

    round_s, request_s = [], []
    with ThreadPoolExecutor(max(map(len, rounds), default=1)) as pool:
        for payloads in rounds:
            t0 = time.perf_counter()
            list(pool.map(post, payloads))
            round_s.append(time.perf_counter() - t0)
    for _ in range(repeats):
        t0 = time.perf_counter()
        post(single)
        request_s.append(time.perf_counter() - t0)
    return round_s, request_s


def time_server(torch, server, vocab, rng, card):
    """bf16/split serving numbers: img/s of coalesced batch-128 rounds over
    HTTP from a client process beside engine.generate and the forward
    alone; p50 / p99 of sequential 1-graph requests from the server's
    histogram and as the client saw them; host ms per request split into
    encoding, the noise draw, the generate call and the reply's encoding."""
    import base64
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from sg2im_tpu_torch.cli.serve import _LatencyHistogram, _png_bytes
    from sg2im_tpu_torch.data import encode_scene_graphs
    from sg2im_tpu_torch.inference import full_fp32, pad_bucket

    rounds = {}
    one = random_graphs(vocab, 1, rng)
    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as client:
        for fmt in ("npy", "png"):
            payloads = [[{"scene_graphs": random_graphs(vocab, SERVE_GRAPHS,
                                                        rng),
                          "seed": i, "return": fmt}
                         for i in range(SERVE_CLIENTS)] for _ in range(6)]
            calls0 = server.state.batcher.engine_calls
            runs = client.submit(http_client, server.base,
                                 payloads).result()[0][1:]  # 1st: warm-up
            rounds[fmt] = (SERVE_CLIENTS * SERVE_GRAPHS * len(runs)
                           / sum(runs), runs,
                           server.state.batcher.engine_calls - calls0)
        server.state.latency = _LatencyHistogram()
        seen = client.submit(http_client, server.base, [],
                             {"scene_graphs": one, "seed": 0},
                             50).result()[1]
    lat = json.loads(server.get("/metrics?format=json"))["request_latency_ms"]
    seen_ms = np.percentile(np.asarray(seen) * 1e3, [50, 99])

    engine = server.engine
    graphs = random_graphs(vocab, 128, rng)
    with server.state.batcher.device_lock:
        engine.generate(graphs, seed=1)
        t0 = time.perf_counter()
        for i in range(3):
            engine.generate(graphs, seed=i)
        gen_ms = (time.perf_counter() - t0) / 3 * 1e3
        b = encode_scene_graphs(graphs, vocab, align=engine.pad_align)
        dev = engine.device
        args = (torch.as_tensor(b.objs, device=dev).long(),
                torch.as_tensor(b.triples, device=dev).long(),
                torch.as_tensor(b.obj_mask, device=dev).float(),
                torch.as_tensor(b.triple_mask, device=dev).float(),
                engine.draw_noise(128, 0).contiguous(
                    memory_format=torch.channels_last))
        with torch.inference_mode(), full_fp32():
            engine.model(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                engine.model(*args)
            torch.cuda.synchronize()
            fwd_ms = (time.perf_counter() - t0) / 3 * 1e3

        split = {}
        for n in (1, 128):
            g = graphs[:n]
            ms = {"encode": [], "noise": [], "generate": [], "reply": []}
            for i in range(5):
                t0 = time.perf_counter()
                encode_scene_graphs(g, vocab, align=engine.pad_align)
                t1 = time.perf_counter()
                engine.draw_noise(pad_bucket(n), i)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                imgs, out = engine.generate(g, seed=i)
                t3 = time.perf_counter()
                json.dumps({"images": [base64.b64encode(_png_bytes(im))
                                       .decode("ascii") for im in imgs],
                            "boxes": out["boxes"].float().cpu().numpy()
                            .tolist()})
                t4 = time.perf_counter()
                for k, v in zip(ms, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                    ms[k].append(v * 1e3)
            split[n] = {k: float(np.median(v)) for k, v in ms.items()}

    for fmt, (img_s, runs, calls) in rounds.items():
        print(f"[serve] bf16/split over HTTP from a client process, "
              f"{SERVE_CLIENTS} concurrent requests of {SERVE_GRAPHS} graphs "
              f"('{fmt}' replies, --batch_window_ms {SERVE_WINDOW_MS:g}): "
              f"{img_s:.1f} img/s (rounds {[round(r * 1e3, 2) for r in runs]}"
              f" ms; {calls} engine calls for {len(runs) + 1} rounds, the "
              f"first untimed); on {card}")
    print(f"[serve] bf16/split b128 in the same call: engine.generate "
          f"{128 / gen_ms * 1e3:.1f} img/s ({gen_ms:.2f} ms: encoding, "
          f"noise, forward, deprocess, copy to the host), the forward alone "
          f"{128 / fwd_ms * 1e3:.1f} img/s ({fwd_ms:.2f} ms); on {card}")
    print(f"[serve] bf16/split 1-graph PNG requests, 50 in sequence "
          f"(--batch_window_ms {SERVE_WINDOW_MS:g} included): server "
          f"histogram p50 {lat['p50_ms']:.3f} ms, p99 {lat['p99_ms']:.3f} "
          f"(mean {lat['mean_ms']:.3f}, min {lat['min_ms']:.3f}, max "
          f"{lat['max_ms']:.3f}); as the client saw them p50 "
          f"{seen_ms[0]:.3f} ms, p99 {seen_ms[1]:.3f}; on {card}")
    for n, ms in split.items():
        print(f"[serve] bf16/split host ms per request of {n} graph(s), "
              f"median of 5: encode {ms['encode']:.3f}, noise draw "
              f"{ms['noise']:.3f}, generate call {ms['generate']:.3f} "
              f"(encode and noise included), PNG + base64 + JSON reply "
              f"{ms['reply']:.3f}; on {card}")


def phase_serve(torch, card, launches):
    """The port's HTTP server at vg128 full width on the card: bf16/split,
    the turbo tier at a calibration file made on the card, and 'phase',
    each driven over HTTP with its launches counted; the serving numbers
    of bf16/split; the on-device deprocess against the host's; seeded
    noise drawn at half resolution against full resolution on zero noise;
    verify_pretrained on the learned checkpoint against the CPU engine's
    images."""
    from PIL import Image

    from sg2im_tpu_torch.ckpt import load_reference_checkpoint
    from sg2im_tpu_torch.cli import verify_pretrained
    from sg2im_tpu_torch.data import imagenet_deprocess_batch
    from sg2im_tpu_torch.inference import InferenceEngine

    rng = np.random.RandomState(6)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "vg128.pt")
        vocab = write_vg128_checkpoint(torch, ckpt)
        common = ["--checkpoint", ckpt, "--device", "cuda", "--bf16", "1",
                  "--warmup", "1,16", "--max_graphs", "128",
                  "--batch_window_ms", str(SERVE_WINDOW_MS)]
        with SmokeServer(common + ["--crn_mode", "split"]) as server:
            add_launches(launches, drive_server(
                torch, "bf16/split", server, vocab, rng, card,
                {"layout_compose_boxes": 1, "crn_epilogue": 11,
                 "mask_head": 4, "crn_resample": R1_GENERATE["split"]}))
            time_server(torch, server, vocab, rng, card)
            engine = server.engine
            graphs = random_graphs(vocab, 16, rng)
            with server.state.batcher.device_lock:
                u8, out = engine.generate(graphs, seed=3)
                host = imagenet_deprocess_batch(
                    out["imgs"].permute(0, 2, 3, 1).cpu().numpy())
                zeros, _ = engine.generate(graphs, noise="zeros")
            differ = int((u8 != host).sum())
            bundle = load_reference_checkpoint(ckpt)
            half = InferenceEngine.from_bundle(
                bundle, device="cuda", compute_dtype=torch.bfloat16,
                crn_mode="split", noise_downsample=2)
            half_zeros, _ = half.generate(graphs, noise="zeros")
            noise = half.draw_noise(4, seed=5)
            tiles = all(torch.equal(noise[:, :, 0::2, 0::2],
                                    noise[:, :, dy::2, dx::2])
                        for dy in (0, 1) for dx in (0, 1))
            print(f"[serve] deprocess on the card vs the host's deprocess of "
                  f"the same float images: {differ} of {u8.size} values "
                  f"differ; noise_downsample=2 with zero noise vs f = 1: "
                  f"{'equal' if np.array_equal(half_zeros, zeros) else 'DIFFERENT'}"
                  f", seeded draw constant over 2x2 tiles: {tiles}")
            if differ or not np.array_equal(half_zeros, zeros) or not tiles:
                fail("on-device deprocess or noise_downsample disagrees")
            del half, bundle

        cal = os.path.join(tmp, "calibration.json")
        turbo = InferenceEngine.from_torch_checkpoint(
            ckpt, device="cuda", compute_dtype=torch.bfloat16,
            crn_mode="split", quantize="int8")
        turbo.calibrate(random_graphs(vocab, 16, rng), seed=100)
        turbo.save_calibration(cal)
        del turbo
        with SmokeServer(common + ["--crn_mode", "split", "--quantize",
                                   "int8", "--calibration_file",
                                   cal]) as server:
            add_launches(launches, drive_server(
                torch, "turbo int8 bf16/split", server, vocab, rng, card,
                {"layout_compose_boxes": 1, "conv3x3_s8": 4,
                 "crn_epilogue": 0, "mask_head": 4,
                 "crn_resample": R1_TURBO},
                coalesced_max=TURBO_COALESCED_U8,
                coalesced_psnr=TURBO_COALESCED_DB))
        with SmokeServer(common + ["--crn_mode", "phase"]) as server:
            path = drive_server(torch, "bf16/phase", server, vocab, rng, card,
                                {"layout_compose_boxes": 1,
                                 "crn_epilogue": 11, "mask_head": 4,
                                 "crn_resample": R1_GENERATE["phase"]})
            add_launches(launches, path)
            if path["relayout_d2s"] == 0:
                fail("the phase server never launched the relayout d2s")

        # verify_pretrained on the card, goldens from the CPU engine.
        trained = os.path.join(REPO, "artifacts", "trained_coco64.pt")
        sgs = os.path.join(REPO, "artifacts", "trained_scene_graphs.json")
        with open(sgs) as f:
            scene_graphs = json.load(f)
        golden = os.path.join(tmp, "golden")
        os.makedirs(golden)
        cpu = InferenceEngine.from_torch_checkpoint(trained, device="cpu")
        for i, img in enumerate(cpu.generate(scene_graphs, noise="zeros")[0]):
            Image.fromarray(img).save(os.path.join(golden, f"img{i:06d}.png"))
        rc = verify_pretrained.main(
            ["--checkpoint", trained, "--scene_graphs_json", sgs,
             "--golden_dir", golden, "--output_dir",
             os.path.join(tmp, "verify"), "--device", "cuda"])
        print(f"[serve] verify_pretrained --device cuda on trained_coco64 "
              f"against the CPU engine's goldens: exit {rc}")
        if rc != 0:
            fail(f"verify_pretrained exited {rc}")


# The COCO-64 flagship the repo trains (TrainConfig's defaults at
# bench.py:155-184, sg2im_tpu_torch/tools/profile_train.py::coco64): the
# train phase's configurations on the card.
TRAIN_MODES = {"f32/legacy": {},
               "bf16/split": dict(bf16_compute=True, crn_mode="split"),
               "f32/packed": dict(crn_mode="packed")}
TRAIN_WARMUP, TRAIN_TIMED = 3, 10
TRAIN_CPU_BATCH = 4      # card-vs-CPU step at this batch, full widths
TRAIN_LOSS_BAR = 2e-4    # relative, step-1 losses card vs CPU in f32


def state_tensors(state):
    """Every tensor of a train state but the step and the noise-generator
    state, cloned."""
    from sg2im_tpu_torch.train.state import tensors

    return {k: v.clone() for k, v in tensors(state).items()
            if k not in ("step", "rng")}


def timed_steps(torch, trainer, state, batch, warmup, timed):
    """warmup + timed steps, each between two events on the stream (no
    sync between steps) -> (state, median ms per timed step, peak device
    bytes, every step's metrics)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events, metrics = [], []
    for _ in range(warmup + timed):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, m = trainer.step(state, batch)
        b.record()
        events.append((a, b))
        metrics.append(m)
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in events[warmup:])
    return (state, float(np.median(ms)), torch.cuda.max_memory_allocated(),
            metrics)


def check_steps_finite(name, metrics):
    skipped = sum(int(m["skipped_nonfinite"]) for m in metrics)
    totals = [float(m["total_loss"]) for m in metrics]
    if skipped or not np.isfinite(totals).all():
        fail(f"train {name}: {skipped} skipped steps, totals {totals}")


def check_k1_function(torch, boxes, masks, obj_mask, D, where):
    """K1 through its Function at a training shape (boxes, masks of the
    batch, vecs of width D), with f32 and bf16 output (the f32 and the
    bf16/split steps): the forward against the plain compose (KERNEL_BAR
    abs in f32, one rounding in bf16), and the gradients against autograd
    of the plain compose (1e-5 of max |grad|).  The backward is the plain
    recompute on both sides, so the gradients check the Function's wiring
    (saved inputs, casts, which inputs get a gradient), not a kernel.
    -> the f32 forward's max abs error."""
    from sg2im_tpu_torch.ops import layout_kernel as lk

    g = torch.Generator(device="cuda").manual_seed(4)
    N, O = boxes.shape[:2]
    M = masks.shape[-1]
    vecs = torch.randn((N, O, D), device="cuda", generator=g)
    vecs = vecs * obj_mask[..., None]
    gout = torch.randn((N, 64, 64, D), device="cuda", generator=g)
    for dt in (torch.float32, torch.bfloat16):
        grads = {}
        for name, fn in (
                ("kernel", lambda *a: lk.layout_compose(*a, 64, 64,
                                                        out_dtype=dt)),
                ("plain", lambda *a: lk.layout_compose_ref(
                    *a, 64, 64).to(dt))):
            leaves = [t.clone().requires_grad_()
                      for t in (boxes, masks, vecs)]
            out = fn(*leaves)
            grads[name] = torch.autograd.grad(out, leaves, gout.to(dt))
            if name == "kernel":
                got = out.detach().float()
        # Against the plain compose in f32: bf16 output within one rounding.
        want = lk.layout_compose_ref(boxes, masks, vecs, 64, 64)
        diff = (got - want).abs()
        fwd_err = diff.max().item()
        if dt == torch.float32:
            f32_err = fwd_err
        ok = (fwd_err <= KERNEL_BAR if dt == torch.float32 else
              within_one_rounding(got, want))
        tag = "f32" if dt == torch.float32 else "bf16"
        line = [f"{where} K1 at b{N} O{O} M{M} 64x64 D{D}, {tag} out: "
                f"forward vs the plain compose {fwd_err:.3e} (max |out| "
                f"{want.abs().max().item():.2f}); Function gradients vs "
                f"autograd of the plain compose:"]
        if not ok:
            fail(f"K1's {tag} forward at b{N} D{D} disagrees with the plain "
                 f"compose: {fwd_err:.3e}")
        for i, what in enumerate(("boxes", "masks", "vecs")):
            a, b = grads["kernel"][i], grads["plain"][i]
            # An empty slot's zero box gives a NaN box gradient on both
            # sides (the plain compose divides by its zero size).
            nan = torch.isnan(b)
            if not torch.equal(torch.isnan(a), nan):
                fail(f"K1 {what} gradient ({tag} out, D{D}) is NaN "
                     f"elsewhere than the plain compose's")
            err = (a - b)[~nan].abs().max().item()
            peak = b[~nan].abs().max().item()
            n_nan = int(nan.sum())
            line.append(f"{what} {err:.3e} of max {peak:.3e}"
                        + (f" ({n_nan} NaN on both sides)" if n_nan else "")
                        + ";")
            if not err <= 1e-5 * max(peak, 1.0):
                fail(f"K1 {what} gradient ({tag} out, D{D}) off by "
                     f"{err:.3e} (max {peak:.3e})")
        print(" ".join(line))
    return f32_err


def check_train_gradients(torch, batch):
    """K1 at the training shape (:func:`check_k1_function`, D 128), then
    K3's backward bit-equal to autograd of the plain relayout at the
    packed CRN's b32 shapes, with a non-channels_last incoming gradient
    (the copy the wrapper counts)."""
    from sg2im_tpu_torch.ops import relayout as rl

    check_k1_function(torch, batch["boxes"], batch["masks"],
                      batch["obj_mask"], 128, "[train]")
    g = torch.Generator(device="cuda").manual_seed(4)
    N = batch["boxes"].shape[0]
    cases = {"s2d layout 64x64 C160": (rl.space_to_depth,
                                       rl.space_to_depth_ref,
                                       (N, 160, 64, 64)),
             "s2d layout 32x32 C160": (rl.space_to_depth,
                                       rl.space_to_depth_ref,
                                       (N, 160, 32, 32)),
             "d2s stage 16x16 4x128": (rl.depth_to_space,
                                       rl.depth_to_space_ref,
                                       (N, 512, 16, 16)),
             "d2s stage 32x32 4x64": (rl.depth_to_space,
                                      rl.depth_to_space_ref,
                                      (N, 256, 32, 32))}
    out = []
    for name, (wrapper, plain, shape) in cases.items():
        x = torch.randn(shape, device="cuda", generator=g).contiguous(
            memory_format=torch.channels_last)
        gy = torch.randn(plain(x).shape, device="cuda", generator=g)
        a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
        (ga,) = torch.autograd.grad(wrapper(a), a, gy)
        (gb,) = torch.autograd.grad(plain(b), b, gy)
        if not torch.equal(ga, gb):
            fail(f"K3 backward of {name} is not bit-equal to the plain "
                 f"version's")
        out.append(name)
    print(f"[train] K3 backward bit-equal to autograd of the plain relayout "
          f"on {', '.join(out)} (incoming gradients NCHW-contiguous)")


def phase_train(torch, card, launches):
    """The port's Trainer at the COCO-64 flagship on the card; see the
    module docstring."""
    from sg2im_tpu_torch.inference import full_fp32
    from sg2im_tpu_torch.ops import layout_kernel as lk
    from sg2im_tpu_torch.ops import relayout as rl
    from sg2im_tpu_torch.ops.prng import split
    from sg2im_tpu_torch.tools.profile_train import coco64
    from sg2im_tpu_torch.train.state import from_tensors, tensors
    from sg2im_tpu_torch.train.trainer import Trainer

    # cuDNN's deterministic algorithms: the resume check compares a step
    # from a restored state with the uninterrupted one.
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    vocab, cfg, batch_np = coco64()
    tr = Trainer(cfg, vocab, device="cuda")
    batch = tr.to_device(batch_np)
    N = batch["imgs"].shape[0]
    state = tr.init_state(seed=0)

    # The card's step 1 against the CPU's, at TRAIN_CPU_BATCH, full widths.
    n = TRAIN_CPU_BATCH
    small = {k: v[:n] for k, v in batch_np.items()}
    noise = torch.randn((n, cfg.layout_noise_dim, 64, 64),
                        generator=torch.Generator().manual_seed(1))
    cpu_tr = Trainer(cfg, vocab, device="cpu")
    cpu_state = from_tensors({k: v.cpu() for k, v in tensors(state).items()})
    t0 = time.perf_counter()
    _, want = cpu_tr.step(cpu_state, small, noise=noise)
    cpu_s = time.perf_counter() - t0
    reset_launches()
    _, got = tr.step(state, small, noise=noise.cuda())
    if lk.layout_compose.launches != 1:
        fail(f"the b{n} step launched K1 {lk.layout_compose.launches} times")
    rel = {k: abs(float(got[k]) - float(want[k]))
           / max(abs(float(want[k])), 1e-6) for k in want}
    worst = max(rel, key=rel.get)
    print(f"[train] COCO-64 f32 step 1 at b{n} (full widths), card vs CPU "
          f"({cpu_s:.1f} s on the host): {len(rel)} losses, worst relative "
          f"difference {rel[worst]:.3e} ({worst}); total "
          f"{float(got['total_loss']):.6f} vs {float(want['total_loss']):.6f}"
          f"; on {card}")
    if rel[worst] > TRAIN_LOSS_BAR:
        fail(f"card step 1 {worst} differs from the CPU's by {rel[worst]:.3e}")
    del cpu_tr, cpu_state

    with full_fp32():
        check_train_gradients(torch, batch)

    numbers = {}
    for name, extra in TRAIN_MODES.items():
        _, mcfg, _ = coco64(**extra)
        mtr = tr if not extra else Trainer(mcfg, vocab, device="cuda")
        mstate = state if not extra else mtr.init_state(seed=0)
        packed = name == "f32/packed"
        marks = []
        if packed:
            # The launch counts at each phase mark of the step.
            mtr.train_step.marker = lambda phase: marks.append(
                (phase, read_launches()))
        reset_launches()
        rl.space_to_depth.grad_copies = rl.depth_to_space.grad_copies = 0
        warmup, timed = ((1, 1) if packed else (TRAIN_WARMUP, TRAIN_TIMED))
        mstate, ms, peak, metrics = timed_steps(torch, mtr, mstate, batch,
                                                warmup, timed)
        mtr.train_step.marker = None
        path = read_launches()
        add_launches(launches, path)
        check_steps_finite(name, metrics)
        steps = warmup + timed
        if (path["layout_compose_boxes"] != steps
                or path["threefry_split"] != steps
                or path["crn_resample"]):
            fail(f"train {name}: K1 launched {path['layout_compose_boxes']} "
                 f"times, the key's split {path['threefry_split']} times in "
                 f"{steps} steps, R1 {path['crn_resample']} times (a train "
                 f"step records its gradient)")
        line = (f"[train] {name} b{N}: {steps} steps, K1 launches "
                f"{path['layout_compose_boxes']} (one per G forward)")
        if packed:
            # The last step: its G forward runs from the previous step's
            # last mark to its g_forward mark, its G backward from there to
            # g_backward.
            at = {phase: n for phase, n in marks[-(len(marks) // steps):]}
            prev = marks[-(len(marks) // steps) - 1][1]
            keys = ("relayout_s2d", "relayout_d2s")
            fwd = {k: at["g_forward"][k] - prev[k] for k in keys}
            bwd = {k: at["g_backward"][k] - at["g_forward"][k] for k in keys}
            line += (f"; K3 in the last step's G forward: s2d "
                     f"{fwd['relayout_s2d']} d2s {fwd['relayout_d2s']}, G "
                     f"backward: s2d {bwd['relayout_s2d']} d2s "
                     f"{bwd['relayout_d2s']} (read at the step's phase "
                     f"marks); incoming gradients copied to channels_last: "
                     f"s2d {rl.space_to_depth.grad_copies} d2s "
                     f"{rl.depth_to_space.grad_copies} in {steps} steps")
            if min(*fwd.values(), *bwd.values()) <= 0:
                fail(f"packed training did not launch both K3 entries "
                     f"forward and backward: {line}")
            check_relayout_routes(f"train {name}")
        else:
            numbers[name] = (ms, N * 1e3 / ms, peak)
            line += (f"; median {ms:.3f} ms/step over {timed} steps after "
                     f"{warmup} warm-up ({N * 1e3 / ms:.1f} img/s), peak "
                     f"device memory {peak / 2**30:.2f} GiB")
        print(line + f"; on {card}")
        if name == "f32/legacy":
            state = mstate
        del mtr, mstate

    # The NaN guard: one NaN image leaves the whole state bit-identical
    # but the key, which the skipped step splits as the JAX step does.
    before = state_tensors(state)
    bad = dict(batch, imgs=batch["imgs"].clone())
    bad["imgs"][0, 0, 0, 0] = float("nan")
    state2, m = tr.step(state, bad)
    same = (all(torch.equal(v, before[k])
                for k, v in state_tensors(state2).items())
            and torch.equal(state2.rng, split(state.rng)[0]))
    state3, m3 = tr.step(state2, batch)
    print(f"[train] NaN guard: a batch with one NaN image skipped "
          f"({bool(m['skipped_nonfinite'])}), {len(before)} tensors of G, "
          f"D_obj, D_img and their Adams bit-identical: {same}; next step "
          f"total {float(m3['total_loss']):.6f}, skipped "
          f"{bool(m3['skipped_nonfinite'])}; on {card}")
    if not (bool(m["skipped_nonfinite"]) and same
            and not bool(m3["skipped_nonfinite"])
            and np.isfinite(float(m3["total_loss"]))):
        fail("the NaN guard did not hold on the card")

    # Save and resume (async writer), cuDNN deterministic.
    with tempfile.TemporaryDirectory() as tmp:
        tr.save_checkpoint(state3, os.path.join(tmp, "ckpt"), wait=False)
        _, m_cont = tr.step(state3, batch)
        tr2 = Trainer(cfg, vocab, device="cuda")
        restored, _ = tr2.load_checkpoint(os.path.join(tmp, "ckpt"))
        _, m_res = tr2.step(restored, batch)
    diff = max(abs(float(m_cont[k]) - float(m_res[k])) for k in m_cont)
    print(f"[train] resume: saved after {int(state3.step)} steps (async), "
          f"loaded into a fresh Trainer: the next step's {len(m_cont)} losses"
          f" differ from the uninterrupted run's by at most {diff:.3e} "
          f"(cudnn.deterministic); on {card}")
    if diff != 0.0:
        fail(f"resumed step differs from the uninterrupted one by {diff}")

    # K1's device time and its plain backward's, per step.
    vecs = torch.randn((N, 16, 128), device="cuda") * batch["obj_mask"][
        ..., None]
    gout = torch.randn((N, 64, 64, 128), device="cuda")
    k1 = time_ms(lambda: lk.layout_compose(
        batch["boxes"], batch["masks"], vecs, 64, 64))
    k1_bwd = time_ms(lambda: lk._plain_vjp(
        lambda b, mm, v: lk.layout_compose_ref(b, mm, v, 64, 64),
        (batch["boxes"], batch["masks"], vecs), (False, False, True), gout))
    ms32 = numbers["f32/legacy"][0]
    print(f"[train] per step at b{N}: K1 forward {k1:.4f} ms, its plain "
          f"backward (recompute + vjp for vecs) {k1_bwd:.4f} ms, together "
          f"{100 * (k1 + k1_bwd) / ms32:.2f}% of the f32 step; on {card}")
    torch.backends.cudnn.deterministic = False
    return numbers


# The training CLI (sg2im_tpu_torch.cli.train) on a synthetic COCO in the
# on-disk formats: COCO-64 at TrainConfig's full widths, b32.
CLI_TRAIN_IMAGES, CLI_VAL_IMAGES = 256, 64
CLI_STEPS = 40
CLI_MODES = {"f32/legacy": [],
             "bf16/split": ["--bf16_compute", "true", "--crn_mode", "split"]}
CLI_PREFETCH_BATCHES = 8   # host vs card, bit for bit
CLI_IDLE_STEPS = (3, 12)   # the profiled window, steps counted from 1
# COCO 2017's category ids: 80 things among 1..90, stuff 92..182, and
# 'other' (183), which the dataset leaves out by default.
COCO_THING_IDS = [i for i in range(1, 91) if i not in
                  (12, 26, 29, 30, 45, 66, 68, 69, 71, 83)]
COCO_STUFF_IDS = list(range(92, 184))


def _synthetic_image(rng, H, W):
    """Smooth structure plus noise, so that JPEG coding is realistic."""
    y, x = np.mgrid[0:H, 0:W]
    phase = rng.uniform(0, 2 * np.pi, 3)
    freq = rng.uniform(0.01, 0.06, 3)
    base = np.stack([127 + 100 * np.sin(freq[c] * (x + 2 * y) + phase[c])
                     for c in range(3)], -1)
    return np.clip(base + rng.randint(-20, 20, base.shape), 0,
                   255).astype(np.uint8)


def _polygon(rng, W, H):
    """A star-shaped polygon (flat [x0, y0, ...]) and its box."""
    n = rng.randint(5, 12)
    cx, cy = rng.uniform(0.25 * W, 0.75 * W), rng.uniform(0.25 * H, 0.75 * H)
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    rad = rng.uniform(0.12, 0.3, n) * min(W, H) + 10
    xs = np.clip(cx + rad * np.cos(ang), 0, W - 1).round(2)
    ys = np.clip(cy + rad * np.sin(ang), 0, H - 1).round(2)
    box = [float(xs.min()), float(ys.min()), float(xs.max() - xs.min()),
           float(ys.max() - ys.min())]
    return np.stack([xs, ys], 1).reshape(-1).tolist(), box


def _region(rng, W, H):
    """A random blob as a (H, W) mask and its box."""
    x0, y0 = rng.randint(0, W // 2), rng.randint(0, H // 2)
    w, h = rng.randint(W // 4, W - x0), rng.randint(H // 4, H - y0)
    m = np.zeros((H, W), np.uint8)
    m[y0:y0 + h, x0:x0 + w] = rng.rand(h, w) > 0.15
    return m, [float(x0), float(y0), float(w), float(h)]


def write_coco(root, n_images, split, seed):
    """A COCO-Stuff split in the on-disk formats under ``root``: JPEGs of
    about 320x240, instances JSON with polygons (and a few uncompressed
    RLE crowds), stuff JSON with compressed RLE.  About 9 images in 10
    hold 3..8 objects that pass the dataset's filters; the rest hold 9
    and are filtered out.  -> (image dir, instances path, stuff path)."""
    from PIL import Image

    from sg2im_tpu_torch.data.rle import mask_to_rle

    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, f"{split}2017")
    os.makedirs(img_dir, exist_ok=True)
    images, inst, stuff = [], [], []
    for i in range(n_images):
        W, H = 320 + 16 * rng.randint(-2, 3), 240 + 16 * rng.randint(-2, 3)
        image_id = 1 + i + (0 if split == "train" else 100000)
        name = f"{image_id:012d}.jpg"
        Image.fromarray(_synthetic_image(rng, H, W)).save(
            os.path.join(img_dir, name), quality=90)
        images.append({"id": image_id, "file_name": name, "width": W,
                       "height": H})
        n_obj = 9 if rng.rand() < 0.1 else rng.randint(3, 9)
        n_stuff = rng.randint(1, min(3, n_obj - 1) + 1)
        for j in range(n_obj):
            ann = {"id": len(inst) + len(stuff) + 1, "image_id": image_id,
                   "iscrowd": 0}
            if j < n_stuff:
                m, box = _region(rng, W, H)
                ann.update(category_id=int(rng.choice(COCO_STUFF_IDS[:-1])),
                           bbox=box, segmentation=mask_to_rle(m))
                stuff.append(ann)
                continue
            if rng.rand() < 0.1:
                m, box = _region(rng, W, H)
                flat = m.T.reshape(-1)
                change = np.nonzero(np.diff(flat))[0] + 1
                runs = np.diff(np.concatenate([[0], change, [flat.size]]))
                if flat[0]:
                    runs = np.concatenate([[0], runs])
                seg = {"size": [H, W], "counts": runs.tolist()}
                ann["iscrowd"] = 1
            else:
                poly, box = _polygon(rng, W, H)
                seg = [poly]
            ann.update(category_id=int(rng.choice(COCO_THING_IDS)), bbox=box,
                       segmentation=seg)
            inst.append(ann)
    thing_cats = [{"id": c, "name": f"thing{c}"} for c in COCO_THING_IDS]
    stuff_cats = [{"id": c, "name": "other" if c == 183 else f"stuff{c}"}
                  for c in COCO_STUFF_IDS]
    paths = []
    for kind, cats, anns in (("instances", thing_cats, inst),
                             ("stuff", stuff_cats, stuff)):
        path = os.path.join(root, f"{kind}_{split}2017.json")
        with open(path, "w") as f:
            json.dump({"images": images, "categories": cats,
                       "annotations": anns}, f)
        paths.append(path)
    return img_dir, paths[0], paths[1]


def check_prefetch(torch, host_batches, size, busy_ms=0.0):
    """``prefetch_to_device`` on the card against the host batches, bit
    for bit, with a consumer slower than the producer: before it reads
    each batch, the compute stream spins ``busy_ms`` and the host sleeps
    as long.  -> the number of batches compared."""
    from sg2im_tpu_torch.data.loader import prefetch_to_device

    host_batches = list(host_batches)
    n = 0
    for got, want in zip(prefetch_to_device(iter(host_batches), size=size,
                                            device="cuda"), host_batches):
        if busy_ms:
            torch.cuda._sleep(int(busy_ms * 1.5e6))
            time.sleep(busy_ms / 1e3)
        for k, v in want.items():
            ref = torch.from_numpy(np.asarray(v))
            if k == "imgs":
                ref = ref.permute(0, 3, 1, 2)
            dt = torch.int64 if k in ("objs", "triples") else torch.float32
            g = got[k]
            if not (g.is_cuda and g.dtype == dt and g.is_contiguous()
                    and torch.equal(g.cpu(), ref.to(dt))):
                fail(f"prefetch_to_device batch {n} {k} differs from the "
                     f"host batch (size {size})")
        n += 1
    if n != len(host_batches):
        fail(f"prefetch_to_device gave {n} of {len(host_batches)} batches")
    return n


def _cli_log(out_dir, kind):
    with open(os.path.join(out_dir, "log.jsonl")) as f:
        return {r["t"]: r for r in map(json.loads, f) if r["kind"] == kind}


def _run_cli(argv, log_path):
    """sg2im_tpu_torch.cli.train.main in this process, its stdout into
    ``log_path``; fails unless it returns 0."""
    import contextlib

    from sg2im_tpu_torch.cli import train as cli

    with open(log_path, "w") as log, contextlib.redirect_stdout(log):
        rc = cli.main(argv)
    if rc != 0:
        fail(f"train CLI exited {rc}; its output is in {log_path}")


def _idle_share(torch, argv, log_path):
    """One short CLI run under torch.profiler: the card's idle share over
    the steps CLI_IDLE_STEPS (from the start of the first one's host
    range to the end of the last one's; --timing fences each step), the
    device's busy ms per step there and the window's ms per step."""
    from sg2im_tpu_torch.utils.timing import profile_window

    with profile_window("cuda") as window:
        _run_cli(argv, log_path)
    steps = sorted((e.time_range.start, e.time_range.end)
                   for e in window.host_events if e.name == "train_step")
    first, last = CLI_IDLE_STEPS
    if len(steps) < last:
        fail(f"profiled CLI run shows {len(steps)} train_step ranges")
    lo, hi = steps[first - 1][0], steps[last - 1][1]
    spans = sorted((max(e.time_range.start, lo), min(e.time_range.end, hi))
                   for e in window.device_events if e.name != "train_step")
    busy, end = 0.0, lo
    for a, b in spans:  # the union of the device's intervals
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    if busy <= 0:
        fail("the profiled CLI steps show no device activity")
    steps = last - first + 1
    return 1.0 - busy / (hi - lo), busy / 1e3 / steps, (hi - lo) / 1e3 / steps


def determinism_costs(torch, trainer, batch):
    """In-memory steps of ``trainer`` on ``batch`` (no loader, no fence
    between steps) with cuDNN's default algorithms, with its
    deterministic ones (as phase_train runs), and under the CLI's
    ``deterministic()`` (PyTorch's deterministic algorithms too): {name:
    (median ms a step over 10 after 3 warm-up, kernels a step, kernel ms
    a step over 3 profiled steps)}."""
    import contextlib

    from sg2im_tpu_torch.cli import train as cli
    from sg2im_tpu_torch.tools.profile_train import kernel_profile

    @contextlib.contextmanager
    def cudnn(deterministic):
        saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = deterministic
        try:
            yield
        finally:
            torch.backends.cudnn.deterministic = saved

    state = trainer.init_state(seed=0)
    out = {}
    for name, ctx in (("cudnn default", lambda: cudnn(False)),
                      ("cudnn deterministic", lambda: cudnn(True)),
                      ("deterministic()", cli.deterministic)):
        with ctx():
            state, ms, _, _ = timed_steps(torch, trainer, state, batch,
                                          TRAIN_WARMUP, TRAIN_TIMED)
            busy, count, _, _ = kernel_profile(trainer, state, batch)
        out[name] = (ms, count, busy)
    return out


def repeatability(torch, trainer, batch, steps=5):
    """Two runs of ``steps`` in-memory steps from one init, under cuDNN's
    deterministic algorithms alone and under the CLI's
    ``deterministic()``: {name: state tensors that differ between the two
    runs}.  Fails unless the CLI's mode repeats bit for bit, which its
    resume relies on."""
    from sg2im_tpu_torch.cli import train as cli
    from sg2im_tpu_torch.train.state import tensors

    def run():
        state = trainer.init_state(seed=0)
        for _ in range(steps):
            state, _ = trainer.step(state, batch)
        return {k: v.clone() for k, v in tensors(state).items()}

    saved = torch.backends.cudnn.deterministic
    out = {}
    for name, ctx in (("cudnn deterministic", None),
                      ("deterministic()", cli.deterministic)):
        torch.backends.cudnn.deterministic = True
        try:
            if ctx is None:
                a, b = run(), run()
            else:
                with ctx():
                    a, b = run(), run()
        finally:
            torch.backends.cudnn.deterministic = saved
        out[name] = (sum(not torch.equal(a[k], b[k]) for k in a), len(a))
    if out["deterministic()"][0]:
        fail(f"two runs under the CLI's deterministic() differ in "
             f"{out['deterministic()'][0]} state tensors")
    return out


def phase_train_cli(torch, card, launches, in_memory, work):
    """The training CLI on a synthetic COCO at COCO-64 full widths, b32,
    in f32 / 'legacy' and bf16 / 'split'; see the module docstring.  The
    dataset and the runs' outputs stay in ``work``; returns the CLI's
    dataset flags and the f32 run's output directory (its checkpoint and
    snapshots)."""
    import contextlib

    from sg2im_tpu_torch import native
    from sg2im_tpu_torch.cli import train as cli
    from sg2im_tpu_torch.data.decode import resolve_decoder
    from sg2im_tpu_torch.data.loader import PaddedLoader
    from sg2im_tpu_torch.native import imagedec
    from sg2im_tpu_torch.train.trainer import Trainer

    logs = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(logs, exist_ok=True)
    with contextlib.nullcontext(work) as tmp:
        t0 = time.perf_counter()
        train = write_coco(tmp, CLI_TRAIN_IMAGES, "train", seed=0)
        val = write_coco(tmp, CLI_VAL_IMAGES, "val", seed=1)
        base = ["--dataset", "coco", "--batch_size", "32",
                "--coco_train_image_dir", train[0],
                "--coco_train_instances_json", train[1],
                "--coco_train_stuff_json", train[2],
                "--coco_val_image_dir", val[0],
                "--coco_val_instances_json", val[1],
                "--coco_val_stuff_json", val[2],
                "--num_val_samples", "64", "--loader_num_workers", "4",
                "--device", "cuda"]
        config = cli.config_from_args(cli.build_parser().parse_args(base))
        vocab, train_ds, val_ds = cli.build_datasets(config)
        decoder = resolve_decoder("auto")
        print(f"[train_cli] synthetic COCO: {CLI_TRAIN_IMAGES} train and "
              f"{CLI_VAL_IMAGES} val JPEGs, {len(train_ds)} and "
              f"{len(val_ds)} pass the filters, "
              f"{len(vocab['object_idx_to_name'])} object classes, written "
              f"and read in {time.perf_counter() - t0:.1f} s; --decoder auto "
              f"resolves to {decoder} (native decoder library built: "
              f"{imagedec.build() is not None}); native RLE codec built: "
              f"{native.native_available()}")
        loader_kw = dict(batch_size=32, O_max=config.pad_objects_to,
                         T_max=config.pad_triples_to, num_workers=4, seed=0)
        host, loader = [], PaddedLoader(train_ds, **loader_kw)
        while len(host) < CLI_PREFETCH_BATCHES:  # over epochs if need be
            host.extend(list(loader)[:CLI_PREFETCH_BATCHES - len(host)])
        n = check_prefetch(torch, iter(host), size=2, busy_ms=20.0)
        print(f"[train_cli] prefetch_to_device: the loader's first {n} "
              f"batches on the card bit-equal to the host's (a consumer "
              f"20 ms slower than the producer on the stream and the host)")
        cache_dir = os.path.join(tmp, "cache")
        cached_ds = cli.build_datasets(dataclasses.replace(
            config, cache_dir=cache_dir, decoder="pil"))[1]
        first_cached = next(iter(PaddedLoader(cached_ds, **loader_kw)))
        for k, v in host[0].items():
            if not np.array_equal(v, first_cached[k]):
                fail(f"the cached loader's first batch differs in {k}")
        per_epoch = len(train_ds) // 32
        sweeps = [min(-(-64 // 32), n // 32) for n in (len(train_ds),
                                                        len(val_ds))]
        checkpoints = CLI_STEPS // 20
        prints = CLI_STEPS // 10
        eval_forwards = (checkpoints * sum(sweeps)
                         + 3 * checkpoints * sum(s > 0 for s in sweeps))
        k1_want = CLI_STEPS + eval_forwards + 4 * prints
        tf_want = cli_draws(CLI_STEPS, checkpoints, prints, sweeps)
        with open(os.path.join(tmp, "graphs.json"), "w") as f:
            json.dump([{"objects": ["thing1", "stuff92", "thing18"],
                        "relationships": [[0, "left of", 1],
                                          [2, "above", 1]]},
                       {"objects": ["stuff150", "thing5"],
                        "relationships": [[1, "inside", 0]]}], f)

        for mode, flags in CLI_MODES.items():
            tag = mode.replace("/", "_")
            run = base + flags + ["--print_every", "10", "--checkpoint_every",
                                  "20", "--snapshot_every", "20", "--timing",
                                  "true", "--async_checkpoint", "true"]
            full = os.path.join(tmp, f"{tag}_full")
            reset_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            _run_cli(run + ["--num_iterations", str(CLI_STEPS),
                            "--output_dir", full],
                     os.path.join(logs, f"train_cli_{tag}_full.log"))
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            path = read_launches()
            check_no_padded_copies(f"the train CLI ({mode})")
            add_launches(launches, path)
            path = without_init(path)
            k1 = path["layout_compose_boxes"]
            others = {k: v for k, v in path.items()
                      if k not in TRAIN_COUNTS and v}
            e1_want = train_e1_launches(mode.startswith("bf16"),
                                        eval_forwards)
            r1_want = train_r1_launches(k1_want, CLI_STEPS, prints)
            if (k1 != k1_want or others
                    or path["threefry_normal"] != tf_want
                    or path["threefry_split"] != CLI_STEPS
                    or path["crn_epilogue"] != e1_want
                    or path["crn_resample"] != r1_want):
                fail(f"train CLI {mode}: K1 launched {k1} times, expected "
                     f"{k1_want}; threefry {path['threefry_normal']} times, "
                     f"expected {tf_want}; the key's split "
                     f"{path['threefry_split']} times for {CLI_STEPS} "
                     f"steps; E1 {path['crn_epilogue']} times, expected "
                     f"{e1_want}; R1 {path['crn_resample']} times, expected "
                     f"{r1_want}; other kernels {others}")
            losses = _cli_log(full, "train")
            timing = _cli_log(full, "timing")
            bad = [t for t, r in losses.items()
                   if not all(np.isfinite(v) for k, v in r.items()
                              if k != "kind") or r["skipped_nonfinite"]]
            if sorted(losses) != list(range(10, CLI_STEPS + 1, 10)) or bad:
                fail(f"train CLI {mode}: logged steps {sorted(losses)}, "
                     f"non-finite or skipped at {bad}")
            window = [timing[t] for t in range(11, CLI_STEPS + 1)]
            iter_ms = float(np.median([r["iter_ms"] for r in window]))
            step_ms = float(np.median([r["step_ms"] for r in window]))
            wait = [r["loader_wait_ms"] for r in window]
            # The steps that neither print nor checkpoint.
            plain = [r["iter_ms"] for r in window if r["t"] % 10]

            # The first step against a direct Trainer.step on the loader's
            # first batch, from the same init; this run reads the cache
            # and decodes with PIL.
            first = os.path.join(tmp, f"{tag}_first")
            _run_cli(base + flags + [
                "--num_iterations", "1", "--print_every", "1",
                "--cache_dir", cache_dir, "--decoder", "pil",
                "--output_dir", first],
                os.path.join(logs, f"train_cli_{tag}_first.log"))
            got = _cli_log(first, "train")[1]
            mcfg = cli.config_from_args(cli.build_parser().parse_args(
                base + flags))
            tr = Trainer(mcfg, vocab, device="cuda")
            with cli.deterministic():
                _, want = tr.step(tr.init_state(seed=0), host[0])
            diff = {k: (got[k], float(v)) for k, v in want.items()
                    if got[k] != float(v)}
            if diff:
                fail(f"train CLI {mode}: step 1 differs from Trainer.step "
                     f"on the loader's first batch: {diff}")
            first_batch = tr.to_device(host[0])
            costs = determinism_costs(torch, tr, first_batch)
            repeat = repeatability(torch, tr, first_batch)
            del tr, first_batch

            # The same steps with the decoded-sample cache: the loader's
            # decode leaves the training process's hot path.
            cached = os.path.join(tmp, f"{tag}_cached")
            _run_cli(base + flags + [
                "--num_iterations", "24", "--print_every", "1000",
                "--checkpoint_every", "1000", "--timing", "true",
                "--cache_dir", cache_dir, "--output_dir", cached],
                os.path.join(logs, f"train_cli_{tag}_cached.log"))
            c_ms = float(np.median([r["iter_ms"] for t, r in
                                    _cli_log(cached, "timing").items()
                                    if t > 4]))

            # Resume: 20 steps here, then the module entry point in a
            # subprocess to step 40; steps 30 and 40 as uninterrupted.
            part = os.path.join(tmp, f"{tag}_part")
            _run_cli(run + ["--num_iterations", "20", "--output_dir", part],
                     os.path.join(logs, f"train_cli_{tag}_part.log"))
            if mode == "f32/legacy":  # phase_jax_checkpoint's start
                shutil.copytree(os.path.join(part, "checkpoint_state"),
                                os.path.join(tmp, T20_CHECKPOINT))
            t1 = time.perf_counter()
            with open(os.path.join(logs, f"train_cli_{tag}_resume.log"),
                      "w") as log:
                proc = subprocess.run(
                    [sys.executable, "-m", "sg2im_tpu_torch.cli.train", *run,
                     "--num_iterations", str(CLI_STEPS), "--output_dir",
                     part, "--restore_from_checkpoint", "true"],
                    cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
                    timeout=900)
            resume_s = time.perf_counter() - t1
            if proc.returncode != 0:
                fail(f"train CLI {mode}: the resumed subprocess exited "
                     f"{proc.returncode}")
            resumed = _cli_log(part, "train")
            for t in (30, 40):
                if resumed.get(t) != losses[t]:
                    fail(f"train CLI {mode}: resumed step {t} "
                         f"{resumed.get(t)} != uninterrupted {losses[t]}")

            # The snapshot through run_model on the card.
            snap = os.path.join(full, f"snapshot_{CLI_STEPS:07d}.pt")
            imgs = cli_images(["--checkpoint", snap, "--scene_graphs_json",
                               os.path.join(tmp, "graphs.json"),
                               "--noise", "zeros", "--device", "cuda"])
            if imgs.shape != (2, 64, 64, 3) or imgs.dtype != np.uint8:
                fail(f"run_model on the snapshot wrote {imgs.shape} "
                     f"{imgs.dtype}")

            idle, busy_ms, win_ms = _idle_share(torch, base + flags + [
                "--num_iterations", str(CLI_IDLE_STEPS[1]), "--print_every",
                "1000", "--checkpoint_every", "1000", "--timing", "true",
                "--output_dir", os.path.join(tmp, f"{tag}_prof")],
                os.path.join(logs, f"train_cli_{tag}_prof.log"))
            mem_ms, mem_ips, _ = in_memory[mode]
            print(f"[train_cli] {mode} b32 {CLI_STEPS} steps ({per_epoch} "
                  f"batches an epoch) in {wall:.1f} s: median {iter_ms:.3f} "
                  f"ms/step over steps 11-{CLI_STEPS} ({32e3 / iter_ms:.1f} "
                  f"img/s; mean {np.mean(plain):.3f} and max "
                  f"{max(plain):.3f} over the {len(plain)} steps that "
                  f"neither print nor checkpoint), the fenced step "
                  f"{step_ms:.3f} ms, loader wait {np.mean(wait):.3f} "
                  f"ms/step mean (median {np.median(wait):.3f}, max "
                  f"{max(wait):.3f}); with the decoded-sample cache "
                  f"{c_ms:.3f} ms/step (median of steps 5-24); idle share "
                  f"{idle:.3f} over steps {CLI_IDLE_STEPS[0]}-"
                  f"{CLI_IDLE_STEPS[1]} under torch.profiler ({busy_ms:.3f} "
                  f"ms of device time in {win_ms:.3f} ms a step there; "
                  f"{1 - busy_ms / iter_ms:.3f} against the unprofiled "
                  f"median step); decoder {decoder}; peak device memory "
                  f"{peak / 2**30:.2f} GiB; phase_train's in-memory step "
                  f"{mem_ms:.3f} ms ({mem_ips:.1f} img/s); on {card}")
            print(f"[train_cli] {mode}: in-memory steps on the loader's "
                  f"first batch, ms a step / kernels a step / kernel ms a "
                  f"step: " + "; ".join(
                      f"{name} {ms:.3f} / {count:.0f} / {busy:.3f}"
                      for name, (ms, count, busy) in costs.items())
                  + "; two 5-step runs from one init differ in " + ", ".join(
                      f"{n} of {total} state tensors under {name}"
                      for name, (n, total) in repeat.items())
                  + f"; on {card}")
            print(f"[train_cli] {mode}: K1 launches {k1} = {CLI_STEPS} steps"
                  f" + {checkpoints} x {sum(sweeps)} check_model batches + "
                  f"3 x {checkpoints * sum(s > 0 for s in sweeps)} triptychs"
                  f" + 4 x {prints} step_breakdown G calls, K2 K3 K4 0; step 1"
                  f" equal to Trainer.step (cache, --decoder pil); steps 30 "
                  f"and 40 of `python -m sg2im_tpu_torch.cli.train "
                  f"--restore_from_checkpoint true` ({resume_s:.1f} s) equal "
                  f"to the uninterrupted run's; snapshot_{CLI_STEPS:07d}.pt "
                  f"through run_model --device cuda: {imgs.shape}")
            torch.cuda.empty_cache()
    return base, os.path.join(work, "f32_legacy_full"), sweeps


# Data and tensor parallelism (sg2im_tpu_torch.parallel) on the one card:
# ranks in processes of their own with Gloo on CUDA tensors (NCCL refuses
# two ranks on one card), NCCL at world size 1, and the mesh engines with
# both rows (or both model columns) on cuda:0.
DP_TIMEOUT = 600.0           # seconds a rank may take, its join included
DP_LOSS_BAR = 2e-4           # relative, ranks against the one-process step
NCCL_WARMUP, NCCL_TIMED = 3, 10
MH_STEPS = 12                # cli.train --multihost at world 1
MESH_BATCH = 128
# The tensor-parallel mesh against the replicated one: the GCN's outputs
# (boxes) at tests/test_parallel.py's rtol / atol, which the CPU tests
# hold for the images too.  On the card the split hidden-dimension sums
# round otherwise and the CRN carries that to the images as it carries
# cuDNN's choice of algorithm by batch size (the f32 mesh against the
# single engine's b128 call: 1 u8 level); images within MESH_TP_U8.
MESH_TP_RTOL, MESH_TP_ATOL = 1e-4, 1e-5
MESH_TP_U8 = 1
MESH_F32_BAR = 1e-5          # f32 mesh against the single engine's halves
MESH_MODES = {"f32": {},
              "bf16/split": dict(crn_mode="split"),
              "turbo": dict(crn_mode="split", quantize="int8"),
              "bf16/packed": dict(crn_mode="packed")}


def check_dryrun(name, summary, launches, k1_per_rank, card):
    """A parallel.dryrun summary: passed, every rank's K1 launches as
    expected; the ranks' launches count as the main path's."""
    ranks = summary["ranks"]
    for r in ranks:
        add_launches(launches, {k: v for k, v in r["launches"].items()
                                if k != "collectives"})
    k1 = [r["launches"]["layout_compose_boxes"] for r in ranks]
    coll = [r["launches"]["collectives"] for r in ranks]
    total = [r["step1"]["total_loss"] for r in ranks]
    print(f"[parallel] {name}: {len(ranks)} ranks on {summary['device']} "
          f"({summary['backend']}, a correctness run, not a speed): step 1 "
          f"total {total} vs one process "
          f"{summary['single']['step1']['total_loss']}, worst relative loss "
          f"difference over steps 1, 2 and check_model "
          f"{summary['max_rel_loss_diff']:.3e}; K1 launches per rank {k1}; "
          f"collectives per rank {coll}; on {card}")
    if not summary["ok"] or summary["max_rel_loss_diff"] > DP_LOSS_BAR:
        fail(f"{name}: the ranks' losses differ from the one-process "
             f"step's (ok={summary['ok']})")
    if k1 != [k1_per_rank] * len(ranks):
        fail(f"{name}: K1 launched {k1} times per rank, expected "
             f"{k1_per_rank}")


@contextlib.contextmanager
def launch_env(**env):
    """torchrun's variables in this process's environment for the block."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


PROFILED_STEPS = 2


def profile_steps(torch, trainer, state, batch):
    """PROFILED_STEPS steps under torch.profiler -> per step: kernel
    launches and memcpy calls, device ms, and host ms inside the
    collectives' c10d::allreduce_ (0 without a group)."""
    from sg2im_tpu_torch.utils.timing import profile_window

    with profile_window("cuda") as window:
        for _ in range(PROFILED_STEPS):
            state, _ = trainer.step(state, batch)
    calls = sum(e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                           "cudaMemcpyAsync") for e in window.host_events)
    device = sum(e.device_time for e in window.device_events)
    comm = sum(e.cpu_time_total for e in window.host_events
               if e.name == "c10d::allreduce_")
    n = PROFILED_STEPS
    return calls / n, device / n / 1e3, comm / n / 1e3


def phase_parallel(torch, card, launches, coco_flags):
    """The data-parallel step across processes, at world size 1 on NCCL
    and through cli.train --multihost; see the module docstring."""
    import torch.distributed as dist

    from sg2im_tpu_torch.parallel import collectives, dryrun
    from sg2im_tpu_torch.parallel.mesh import free_port, init_process_group
    from sg2im_tpu_torch.tools.profile_train import coco64
    from sg2im_tpu_torch.train.trainer import Trainer

    # 1. The dry run (tiny config: step, check_model, save, restore, step)
    # and 2. the COCO-64 flagship, b32 global = 16 rows a rank: 2 ranks
    # with Gloo on cuda:0 against one process on the same global batch.
    for name, config in (("dryrun tiny", "tiny"), ("COCO-64 b32", "coco64")):
        t0 = time.perf_counter()
        summary = dryrun.run(2, "gloo", "cuda:0", config, DP_TIMEOUT)
        print(f"[parallel] {name}: ranks and the one-process run took "
              f"{time.perf_counter() - t0:.1f} s")
        check_dryrun(name, summary, launches, 3, card)

    # 3. NCCL at world size 1: the step with its collectives against
    # Trainer.step without a group, in turns, on one batch.
    vocab, cfg, batch_np = coco64()
    plain = Trainer(cfg, vocab, device="cuda")
    batch = plain.to_device(batch_np)
    init_process_group("nccl", "127.0.0.1", free_port(), 0, 1)
    try:
        dp = Trainer(cfg, vocab, device="cuda")
        if dp.group is None:
            fail("the Trainer did not join the world-1 NCCL group")
        states = {"plain": plain.init_state(seed=0),
                  "nccl": dp.init_state(seed=0)}
        _, m_plain = plain.step(states["plain"], batch)
        _, m_dp = dp.step(states["nccl"], batch)
        rel = max(abs(float(m_dp[k]) - float(m_plain[k]))
                  / max(abs(float(m_plain[k])), 1e-6) for k in m_plain)
        if rel > DP_LOSS_BAR:
            fail(f"the world-1 NCCL step's losses differ by {rel:.3e}")
        ms = {"plain": [], "nccl": []}
        calls = k1 = splits = 0
        for name in ("plain", "nccl", "nccl", "plain"):
            tr = plain if name == "plain" else dp
            c0 = collectives.all_reduce.calls
            reset_launches()
            states[name], t, _, metrics = timed_steps(
                torch, tr, states[name], batch, NCCL_WARMUP, NCCL_TIMED)
            check_steps_finite(f"world-1 {name}", metrics)
            path = read_launches()
            if name == "nccl":
                add_launches(launches, path)
                calls += collectives.all_reduce.calls - c0
                k1 += path["layout_compose_boxes"]
                splits += path["threefry_split"]
            ms[name].append(t)
        steps = 2 * (NCCL_WARMUP + NCCL_TIMED)
        if k1 != steps or splits != steps:
            fail(f"world-1 NCCL: K1 launched {k1} times, the key's split "
                 f"{splits} times in {steps} steps")
        prof = {name: profile_steps(torch, tr, states[name], batch)
                for name, tr in (("plain", plain), ("nccl", dp))}
        extra = np.mean(ms["nccl"]) - np.mean(ms["plain"])
        print(f"[parallel] world-1 NCCL step, COCO-64 f32 b32: median "
              f"{ms['nccl']} ms/step against Trainer.step without a group "
              f"{ms['plain']} (in turns: plain, nccl, nccl, plain); extra "
              f"{extra:.3f} ms/step; {calls / steps:.1f} collectives a step "
              f"(BatchNorm sums forward and backward, loss denominators, one "
              f"gradient and loss all-reduce per model); step 1 losses "
              f"within {rel:.3e} of the no-group step; under torch.profiler"
              f" over {PROFILED_STEPS} steps, a step's launches and copies /"
              f" device ms / host ms inside c10d::allreduce_: " + "; ".join(
                  f"{k} {p[0]:.0f} / {p[1]:.3f} / {p[2]:.3f}"
                  for k, p in prof.items()) + f"; on {card}")
    finally:
        dist.destroy_process_group()
    del plain, dp, states, batch
    torch.cuda.empty_cache()

    # 4. cli.train --multihost at world 1, NCCL, from torchrun's variables.
    out = tempfile.mkdtemp(prefix="multihost", dir=os.path.dirname(
        coco_flags[coco_flags.index("--coco_train_image_dir") + 1]))
    logs = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(logs, exist_ok=True)
    reset_launches()
    c0 = collectives.all_reduce.calls
    with launch_env(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                    MASTER_ADDR="127.0.0.1",
                    MASTER_PORT=str(free_port())):
        _run_cli(coco_flags + [
            "--multihost", "true", "--dist_backend", "nccl",
            "--num_iterations", str(MH_STEPS), "--print_every", "4",
            "--checkpoint_every", str(MH_STEPS), "--timing", "true",
            "--output_dir", out], os.path.join(logs, "train_cli_multihost.log"))
    if dist.is_initialized():
        fail("cli.train --multihost left its process group initialised")
    path = read_launches()
    add_launches(launches, path)
    calls = collectives.all_reduce.calls - c0
    timing = _cli_log(out, "timing")
    step_ms = float(np.median([timing[t]["step_ms"]
                               for t in range(4, MH_STEPS + 1)]))
    losses = _cli_log(out, "train")
    if sorted(losses) != [4, 8, 12] or not os.path.isdir(
            os.path.join(out, "checkpoint_state")):
        fail(f"cli.train --multihost logged {sorted(losses)}")
    print(f"[parallel] cli.train --multihost true (RANK 0, WORLD_SIZE 1, "
          f"NCCL), COCO-64 b32 on the synthetic COCO: {MH_STEPS} steps, "
          f"median fenced step {step_ms:.3f} ms over steps 4-{MH_STEPS}; "
          f"{calls} collectives in the run (steps, check_model, the "
          f"initial broadcast, the save barrier); K1 launches "
          f"{path['layout_compose_boxes']}; checkpoint written; on {card}")



def phase_mesh(torch, card, launches):
    """The vg128 mesh and tensor-parallel engines; see the module
    docstring."""
    from sg2im_tpu_torch.inference import InferenceEngine
    from sg2im_tpu_torch.models import Sg2ImGenerator
    from sg2im_tpu_torch.parallel.mesh import make_mesh

    # vg128 at b128 on a mesh of two data rows on cuda:0, per serving
    # mode, against the single engine on each row's 64 graphs with the
    # same noise rows (the seeded draw of all 128; each mesh row draws its
    # own 64 by offset, one threefry launch a row, and those rows equal the
    # whole draw's): the same shapes, so the same kernels and algorithms.  The
    # single engine's own b128 call is printed beside it: cuDNN picks its
    # algorithms by batch size.  Then two model columns (tensor parallel)
    # against the replicated mesh.
    vocab, kwargs = vg128_config()
    state = vg128_state(torch)
    graphs = random_graphs(vocab, MESH_BATCH, np.random.RandomState(3))
    half = MESH_BATCH // 2
    cuda0 = ["cuda:0", "cuda:0"]
    for name, kw in MESH_MODES.items():
        if name != "f32":
            kw = dict(kw, compute_dtype=torch.bfloat16)
        one = InferenceEngine(vocab, kwargs, state, device="cuda", **kw)
        mesh = InferenceEngine(vocab, kwargs, state,
                               mesh=make_mesh(2, devices=cuda0), **kw)
        try:
            if name == "turbo":
                one.calibrate(graphs)
                mesh.calibrate(graphs)
                if mesh.scales() != one.scales():
                    fail("the mesh's int8 scales differ from the engine's")
            noise = one.draw_noise(MESH_BATCH, 7).permute(0, 2, 3, 1)
            halves = [one.generate(graphs[i:i + half],
                                   noise=noise[i:i + half])
                      for i in (0, half)]
            a = np.concatenate([h[0] for h in halves])
            oa = torch.cat([h[1]["imgs"] for h in halves])
            whole = one.generate(graphs, seed=7)[0]
            mesh.generate(graphs, seed=7)  # warm-up: cuDNN's first calls
            reset_launches()
            t0 = time.perf_counter()
            b, ob = mesh.generate(graphs, seed=7)
            mesh_ms = 1e3 * (time.perf_counter() - t0)
            path = read_launches()
            add_launches(launches, path)
            check_no_padded_copies(f"the {name} mesh engine")
            t0 = time.perf_counter()
            one.generate(graphs, seed=7)
            one_ms = 1e3 * (time.perf_counter() - t0)
            u8 = int(np.abs(a.astype(int) - b).max())
            err = float((oa.float() - ob["imgs"].float()).abs().max())
            line = (f"[parallel] vg128 mesh (2 data rows on cuda:0) {name} "
                    f"b{MESH_BATCH}, seeded noise: generate {mesh_ms:.1f} ms "
                    f"(the single engine {one_ms:.1f}); against the single "
                    f"engine on each row's {half} graphs with the same noise "
                    f"max |img| diff {err:.3e}, max u8 diff {u8}, PSNR "
                    f"{psnr_u8(a, b):.2f} dB; against its b{MESH_BATCH} call "
                    f"max u8 diff {int(np.abs(whole.astype(int) - b).max())},"
                    f" PSNR {psnr_u8(whole, b):.2f} dB; launches "
                    f"{ {k: v for k, v in path.items() if v} }")
            if path["layout_compose_boxes"] != 2:
                fail(f"{line}: K1 not launched once per row")
            if path["threefry_normal"] != 2:
                fail(f"{line}: the seeded noise not drawn once per row")
            rows = torch.cat([mesh.draw_noise(half, 7, row=i)
                              for i in (0, half)])
            if not torch.equal(rows.permute(0, 2, 3, 1), noise):
                fail(f"{line}: the rows' draws by offset differ from the "
                     f"whole batch's draw")
            if name == "turbo" and (path["conv3x3_s8"] == 0
                                    or u8 > 2 or psnr_u8(a, b) < 55.0):
                fail(line)
            if name == "bf16/packed" and min(path["relayout_s2d"],
                                              path["relayout_d2s"]) == 0:
                fail(f"{line}: packed mode without both K3 entries")
            check_relayout_routes(line)
            if name == "f32" and err > MESH_F32_BAR:
                fail(line)
            if name.startswith("bf16") and u8 > 1:
                fail(line)
            print(line + f"; on {card}")
            if name == "f32":
                tp = InferenceEngine(vocab, kwargs, state,
                                     mesh=make_mesh(2, 2, devices=cuda0 * 2),
                                     tensor_parallel=True)
                try:
                    reset_launches()
                    c, oc = tp.generate(graphs, seed=7)
                    path = read_launches()
                    add_launches(launches, path)
                    d = (oc["imgs"] - ob["imgs"]).abs()
                    beyond = int((d > MESH_TP_ATOL + MESH_TP_RTOL
                                  * ob["imgs"].abs()).sum())
                    bd = (oc["boxes"] - ob["boxes"]).abs()
                    bad_boxes = int((bd > MESH_TP_ATOL + MESH_TP_RTOL
                                     * ob["boxes"].abs()).sum())
                    u8 = int(np.abs(c.astype(int) - b).max())
                    print(f"[parallel] vg128 tensor-parallel mesh (2 x 2 on "
                          f"cuda:0, GCN hidden split) f32 b{MESH_BATCH}: "
                          f"against the replicated mesh boxes max diff "
                          f"{float(bd.max()):.3e} ({bad_boxes} beyond rtol "
                          f"{MESH_TP_RTOL} atol {MESH_TP_ATOL}); images max "
                          f"diff {float(d.max()):.3e} ({beyond} of "
                          f"{d.numel()} elements beyond that bar), max u8 "
                          f"diff {u8}, PSNR {psnr_u8(b, c):.2f} dB; K1 "
                          f"launches {path['layout_compose_boxes']}; on "
                          f"{card}")
                    if (bad_boxes or u8 > MESH_TP_U8
                            or path["layout_compose_boxes"] != 2):
                        fail("the tensor-parallel engine disagrees")
                finally:
                    tp.close()
        finally:
            mesh.close()
        del one, mesh
        torch.cuda.empty_cache()


SAMPLE_BATCH, SAMPLE_NUM = 24, 50   # sample_images: 3 batches, the last padded


def _pngs(d):
    from PIL import Image

    names = sorted(n for n in os.listdir(d) if n.endswith(".png"))
    return names, [np.asarray(Image.open(os.path.join(d, n))) for n in names]


def sample_flags(coco_flags) -> list:
    """sample_images' flags for the training CLI's synthetic val split."""
    def flag(name):
        return coco_flags[coco_flags.index(name) + 1]

    return ["--dataset", "coco",
            "--coco_image_dir", flag("--coco_val_image_dir"),
            "--instances_json", flag("--coco_val_instances_json"),
            "--stuff_json", flag("--coco_val_stuff_json"),
            "--image_size", "64,64", "--batch_size", str(SAMPLE_BATCH),
            "--num_samples", str(SAMPLE_NUM), "--save_gt_imgs", "true",
            "--loader_num_workers", "4", "--device", "cuda"]


def phase_tools(torch, card, launches, coco_flags, run_dir, work):
    """sample_images and checkpoint_tools on the training CLI's outputs;
    see the module docstring."""
    from sg2im_tpu_torch.cli import checkpoint_tools, sample_images

    data = sample_flags(coco_flags)
    snaps = sorted(n for n in os.listdir(run_dir) if "snapshot" in n)
    lst = os.path.join(work, "checkpoints.txt")
    with open(lst, "w") as f:
        f.write(run_dir + "\n")
    ckpt_dir = os.path.join(run_dir, "checkpoint_state")
    args = sample_images.build_parser().parse_args(data)
    bundle = sample_images.load_bundle(os.path.join(run_dir, snaps[0]))
    n_val = len(sample_images._build_dataset(args, bundle["args"],
                                             bundle["vocab"]))
    want = min(SAMPLE_NUM, n_val)
    batches = -(-want // SAMPLE_BATCH)
    for name, extra, runs in (
            ("snapshots", ["--checkpoint_list", lst], len(snaps)),
            ("the Trainer's checkpoint, --model_mode train, ground-truth "
             "layout", ["--checkpoint", ckpt_dir, "--model_mode", "train",
                        "--use_gt_boxes", "true", "--use_gt_masks", "true"],
             1)):
        out = os.path.join(work, f"samples{runs}")
        reset_launches()
        t0 = time.perf_counter()
        if sample_images.main(data + extra + ["--output_dir", out]) != 0:
            fail(f"sample_images on {name} failed")
        wall = time.perf_counter() - t0
        path = read_launches()
        add_launches(launches, path)
        dirs = ([os.path.join(out, d) for d in sorted(os.listdir(out))]
                if runs > 1 else [out])
        for d in dirs:
            names, imgs = _pngs(os.path.join(d, "img"))
            with np.load(os.path.join(d, "data.npz")) as z:
                rows = {k: z[k].shape[0] for k in z.files}
            if (len(names) != want or set(rows.values()) != {want}
                    or len(_pngs(os.path.join(d, "gt_img"))[0]) != want
                    or imgs[0].shape != (64, 64, 3)):
                fail(f"sample_images on {name}: {len(names)} PNGs, npz rows "
                     f"{rows} in {d}; expected {want}")
        if path["layout_compose_boxes"] != runs * batches:
            fail(f"sample_images on {name}: K1 launched "
                 f"{path['layout_compose_boxes']} times, expected "
                 f"{runs * batches}")
        print(f"[tools] sample_images --device cuda on {name}: {len(dirs)} "
              f"run(s) of {want} images ({n_val} val images pass the "
              f"filters; {batches} batches of {SAMPLE_BATCH}, the last "
              f"padded) in {wall:.1f} s; PNG and data.npz rows {want} each; "
              f"K1 launches {path['layout_compose_boxes']}; on {card}")

    # checkpoint_tools export of the Trainer's checkpoint, through run_model
    # on the card, against the snapshot of the same step.
    exported = os.path.join(work, "exported.pt")
    if checkpoint_tools.main(["export", ckpt_dir, exported]) != 0:
        fail("checkpoint_tools export failed")
    graphs = os.path.join(work, "graphs.json")
    run = ["--scene_graphs_json", graphs, "--noise", "zeros", "--device",
           "cuda"]
    a = cli_images(["--checkpoint", exported] + run)
    b = cli_images(["--checkpoint", os.path.join(run_dir, snaps[-1])] + run)
    if a.shape != b.shape or not np.array_equal(a, b):
        fail("run_model on the exported checkpoint differs from the "
             "snapshot of the same step")
    print(f"[tools] checkpoint_tools export of the Trainer's checkpoint: "
          f"run_model --device cuda writes {a.shape} images bit-equal to "
          f"{snaps[-1]}'s; on {card}")


# The JAX store's format (ckpt.store backend 'msgpack') on the card.
JAX_FIXTURE = os.path.join(REPO, "tests", "fixtures", "jax_ckpt_tiny")
T20_CHECKPOINT = "f32_legacy_t20"  # phase_train_cli's f32 run at t=20
JAX_LOSS_ATOL = 2e-5   # absolute, beside TRAIN_LOSS_BAR (relative)


def _finite_trace(name, records):
    bad = [t for t, r in records.items()
           if not all(np.isfinite(v) for k, v in r.items() if k != "kind")
           or r["skipped_nonfinite"]]
    if bad:
        fail(f"{name}: non-finite or skipped at {bad}")


def phase_jax_checkpoint(torch, card, launches, coco_flags, work, sweeps):
    """A JAX-written checkpoint resumes on the card, and the training CLI's
    checkpoint goes to the JAX store's format and resumes from it; see the
    module docstring."""
    from sg2im_tpu_torch.ckpt import store
    from sg2im_tpu_torch.cli import checkpoint_tools, sample_images
    from sg2im_tpu_torch.cli import train as cli
    from sg2im_tpu_torch.train.config import TrainConfig
    from sg2im_tpu_torch.train.state import tensors
    from sg2im_tpu_torch.train.trainer import Trainer

    logs = os.path.join(REPO, "build", "chip_smoke")

    # (a) The committed fixture (TINY after one JAX step) and the JAX
    # package's losses for its next step.
    state, meta = store.load_checkpoint(JAX_FIXTURE, "cuda")
    tr = Trainer(TrainConfig.from_dict(meta["config"]), meta["vocab"],
                 device="cuda")
    with np.load(os.path.join(JAX_FIXTURE, "expected.npz")) as z:
        expected = {k: z[k] for k in z.files}
    batch = {k[len("batch/"):]: v for k, v in expected.items()
             if k.startswith("batch/")}
    reset_launches()
    with cli.deterministic():
        _, metrics = tr.step(state, batch)
    path = read_launches()
    add_launches(launches, path)
    worst = 0.0
    for k, want in expected.items():
        if not k.startswith("loss/"):
            continue
        got = float(metrics[k[len("loss/"):]])
        err = abs(got - float(want))
        if not err <= JAX_LOSS_ATOL + TRAIN_LOSS_BAR * abs(float(want)):
            fail(f"the JAX fixture's next step: {k} {got} against JAX's "
                 f"{float(want)}")
        worst = max(worst, err / (JAX_LOSS_ATOL + TRAIN_LOSS_BAR
                                  * abs(float(want))))
    if path["layout_compose_boxes"] != 1 or path["threefry_split"] != 1:
        fail(f"the JAX fixture's step launched K1 "
             f"{path['layout_compose_boxes']} times and the key's split "
             f"{path['threefry_split']} times, not once each")
    n_losses = sum(k.startswith("loss/") for k in expected)
    print(f"[jax_ckpt] tests/fixtures/jax_ckpt_tiny (the JAX package's "
          f"state.msgpack of TINY at t={int(state.step)}) loaded on the "
          f"card: its next step's {n_losses} losses match the JAX "
          f"package's within {TRAIN_LOSS_BAR} relative + {JAX_LOSS_ATOL} "
          f"absolute (worst {worst:.3f} of the bar); K1 "
          f"launched once; on {card}")
    del tr, state

    # (b) The f32 COCO-64 b32 CLI run's t=20 checkpoint, written again in
    # the JAX store's format, read back, and resumed twice by the CLI.
    src = os.path.join(work, T20_CHECKPOINT)
    with open(os.path.join(src, "meta.json")) as f:
        src_meta = json.load(f)
    tr = Trainer(TrainConfig.from_dict(src_meta["config"]),
                 src_meta["vocab"], device="cuda")
    state, meta = tr.load_checkpoint(src)
    if int(state.step) != 20:
        fail(f"{src} holds t={int(state.step)}, not 20")
    runs = [os.path.join(work, f"jax_resume_{i}") for i in (0, 1)]
    ckpt = os.path.join(runs[0], "checkpoint_state")
    pt_dir = os.path.join(work, "jax_resume_pt")
    seconds = {}
    for backend, where in (("msgpack", ckpt), ("torch", pt_dir)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.save_checkpoint(state, where, extra=meta.get("extra"),
                           arrays=meta.get("arrays"), backend=backend)
        t1 = time.perf_counter()
        back, back_meta = tr.load_checkpoint(where)
        torch.cuda.synchronize()
        seconds[backend] = (t1 - t0, time.perf_counter() - t1,
                            os.path.getsize(os.path.join(
                                where, store.STATE_FILES[backend])) / 1e6)
        a, b = tensors(back), tensors(state)
        diff = sorted(k for k in b if k not in a or a[k].dtype != b[k].dtype
                      or not torch.equal(a[k], b[k]))
        if set(a) != set(b) or diff:
            fail(f"the t=20 checkpoint through backend {backend!r} differs "
                 f"in {diff[:5] or sorted(set(a) ^ set(b))[:5]}")
        arrays = back_meta.get("arrays") or {}
        if (set(arrays) != set(meta.get("arrays") or {})
                or not all(np.array_equal(arrays[k], v)
                           for k, v in meta["arrays"].items())
                or back_meta["extra"] != meta["extra"]):
            fail(f"the t=20 checkpoint's histories through backend "
                 f"{backend!r} differ")
    del tr, state, back
    torch.cuda.empty_cache()
    shutil.copytree(runs[0], runs[1])
    run = coco_flags + CLI_MODES["f32/legacy"] + [
        "--print_every", "10", "--checkpoint_every", "20",
        "--snapshot_every", "20", "--timing", "true", "--async_checkpoint",
        "true", "--num_iterations", str(CLI_STEPS),
        "--restore_from_checkpoint", "1"]
    traces, k1 = [], []
    # From t=20 to CLI_STEPS: the steps, checkpoints and prints after 20.
    tf_want = cli_draws(CLI_STEPS - 20, CLI_STEPS // 20 - 1,
                        CLI_STEPS // 10 - 2, sweeps)
    for i, out in enumerate(runs):
        reset_launches()
        t0 = time.perf_counter()
        _run_cli(run + ["--output_dir", out],
                 os.path.join(logs, f"jax_resume_{i}.log"))
        wall = time.perf_counter() - t0
        path = read_launches()
        check_no_padded_copies("the training CLI resuming state.msgpack")
        add_launches(launches, path)
        path = without_init(path)
        others = {k: v for k, v in path.items()
                  if k not in TRAIN_COUNTS and v}
        k1.append(path["layout_compose_boxes"])
        r1_want = train_r1_launches(k1[-1], CLI_STEPS - 20,
                                    CLI_STEPS // 10 - 2)
        if (k1[-1] < CLI_STEPS - 20 or others
                or path["threefry_normal"] != tf_want
                or path["threefry_split"] != CLI_STEPS - 20
                or path["crn_epilogue"]
                or path["crn_resample"] != r1_want):
            fail(f"the CLI resuming state.msgpack: K1 launched {k1[-1]} "
                 f"times, threefry {path['threefry_normal']} times, "
                 f"expected {tf_want}, the key's split "
                 f"{path['threefry_split']} times for {CLI_STEPS - 20} "
                 f"steps; E1 {path['crn_epilogue']} times in float32; R1 "
                 f"{path['crn_resample']} times, expected {r1_want}; "
                 f"other kernels {others}")
        losses = _cli_log(out, "train")
        _finite_trace("the CLI resuming state.msgpack", losses)
        if sorted(losses) != list(range(30, CLI_STEPS + 1, 10)):
            fail(f"the CLI resuming state.msgpack logged {sorted(losses)}")
        files = os.listdir(os.path.join(out, "checkpoint_state"))
        if "state.msgpack" not in files or "state.pt" in files:
            fail(f"the resumed run's checkpoint holds {sorted(files)}, not "
                 f"state.msgpack alone")
        later, _ = store.load_checkpoint(os.path.join(out,
                                                      "checkpoint_state"))
        if int(later.step) != CLI_STEPS:
            fail(f"the resumed run's checkpoint is at t={int(later.step)}")
        traces.append((losses, wall))
    if traces[0][0] != traces[1][0] or k1[0] != k1[1]:
        fail("two resumes of one state.msgpack differ: "
             f"{traces[0][0]} against {traces[1][0]}; K1 {k1}")

    # (c) sample_images and checkpoint_tools export open the directory.
    out = os.path.join(work, "jax_samples")
    reset_launches()
    if sample_images.main(sample_flags(coco_flags) + [
            "--checkpoint", ckpt, "--output_dir", out]) != 0:
        fail("sample_images on the state.msgpack directory failed")
    path = read_launches()
    add_launches(launches, path)
    names, imgs = _pngs(os.path.join(out, "img"))
    if not names or imgs[0].shape != (64, 64, 3) or not path[
            "layout_compose_boxes"]:
        fail(f"sample_images on the state.msgpack directory: {len(names)} "
             f"PNGs, K1 {path['layout_compose_boxes']}")
    exported = os.path.join(work, "jax_exported.pt")
    if checkpoint_tools.main(["export", ckpt, exported]) != 0:
        fail("checkpoint_tools export of the state.msgpack directory failed")
    graphs = ["--scene_graphs_json", os.path.join(work, "graphs.json"),
              "--noise", "zeros", "--device", "cuda"]
    a = cli_images(["--checkpoint", exported] + graphs)
    b = cli_images(["--checkpoint", os.path.join(
        runs[0], f"snapshot_{CLI_STEPS:07d}.pt")] + graphs)
    if a.shape != b.shape or not np.array_equal(a, b):
        fail("run_model on the export of the state.msgpack directory "
             "differs from the snapshot of the same step")
    (mw, mr, mb), (pw, pr, pb) = seconds["msgpack"], seconds["torch"]
    print(f"[jax_ckpt] the f32 COCO-64 b32 CLI run's t=20 checkpoint: "
          f"state.msgpack {mb:.3f} MB written in {mw:.3f} s and read to the "
          f"card in {mr:.3f} s, state.pt {pb:.3f} MB in {pw:.3f} s and "
          f"{pr:.3f} s; both read back bit-equal with their histories; "
          f"`cli.train --restore_from_checkpoint 1` resumed it to "
          f"t={CLI_STEPS} twice ({traces[0][1]:.1f} s and "
          f"{traces[1][1]:.1f} s), loss traces bit-identical, K1 launches "
          f"{k1[0]} each, the later checkpoint state.msgpack; "
          f"sample_images wrote {len(names)} PNGs and checkpoint_tools "
          f"export gave run_model images bit-equal to the t={CLI_STEPS} "
          f"snapshot's; on {card}")


# The training proofs (sg2im_tpu_torch.tools) on their learnable disk
# dataset, at the tools' defaults but for these iteration counts, cut so
# that the whole script stays well inside its time limit: a train_proof
# run needs 8 loss records (200 steps) for its first-4 and last-4 means.
PROOF_ITERS = 250          # each train_proof run (the tool's default 500)
PROOF_REPEAT_ITERS = 200   # the second f32 run: a prefix of the first
FIDELITY_ITERS = 400       # trained_fidelity (the tool's default is 3000)
FIDELITY_CRN_STAGES = 3    # its generator's refinement_network_dims
# K1 launches of a run's final check_model: two b32 sweeps of 64 samples
# (train and val) and a triptych of three G calls after each.
PROOF_SWEEP_K1 = 2 + 2 + 3 * 2
# Its threefry launches: one a sweep batch and one a triptych.
PROOF_SWEEP_TF = 2 + 2 + 2


def _tool(main, argv, log_path):
    """A tool's ``main(argv)`` in this process, its stdout into
    ``log_path``; -> (exit code, seconds, launches, the last line)."""
    reset_launches()
    t0 = time.perf_counter()
    with open(log_path, "w") as log, contextlib.redirect_stdout(log):
        rc = main(argv)
    wall = time.perf_counter() - t0
    path = read_launches()
    with open(log_path) as f:
        last = f.read().strip().splitlines()[-1]
    return rc, wall, path, last


def _proof_line(name, s, wall, k1, card):
    h = s["h2d"]
    iv = s["intervals_s"]
    return (f"[proofs] train_proof {name} ({s['mode']}): {s['iters']} steps "
            f"b{s['batch_size']} on {s['images']} JPEGs ({s['dataset_images']}"
            f" pass the filters, {s['dataset_images'] // s['batch_size']} "
            f"batches an epoch) in {wall:.1f} s (the CLI {s['wall_s']:.1f}): "
            f"L1 {s['l1_head']:.4f} -> {s['l1_tail']:.4f} (first and last "
            f"4 records; trace {' '.join(f'{v:.4f}' for _, v in s['l1'])}); "
            f"steady {s['steady_img_s']:.1f} img/s, median interval "
            f"{s['median_interval_s']:.3f} s ({s['median_img_s']:.1f} img/s), "
            f"intervals min {min(iv):.3f} max {max(iv):.3f} s; loader alone "
            f"{s['loader_img_s']:.0f} img/s ({s['workers']} workers, "
            f"{s['cpus']} cores), decode {s['decode_ms_per_image']:.3f} "
            f"ms/img; one batch to the card {h['bytes'] / 1e6:.3f} MB: "
            f"pageable {h['pageable_ms']:.4f} ms ({h['pageable_gb_s']:.2f} "
            f"GB/s), pinned {h['pinned_ms']:.4f} ms ({h['pinned_gb_s']:.2f} "
            f"GB/s), one staged buffer each; final check_model box IoU train "
            f"{s['iou']['train_iou']:.4f} val {s['iou']['val_iou']:.4f}; "
            f"K1 launches {k1}; ops without a deterministic "
            f"implementation: {s['nondeterministic'] or 'none warned'}; "
            f"on {card}")


def phase_proofs(torch, card, launches, work):
    """The training proofs through sg2im_tpu_torch.tools on the card; see
    the module docstring.  Their datasets and runs stay in ``work``, their
    output in build/chip_smoke/proof_*.log."""
    from sg2im_tpu_torch.data.loader import PaddedLoader
    from sg2im_tpu_torch.inference import full_fp32
    from sg2im_tpu_torch.tools import (
        loader_bench,
        train_proof,
        trained_fidelity,
    )

    logs = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(logs, exist_ok=True)
    # K1 at the proofs' widths (trained_fidelity's D 64, train_proof's
    # 128) on a batch of the proof's own data, as the CLI pads it.
    paths = train_proof.build_dataset(os.path.join(work, "proof_k1"), 64)
    batch = next(iter(PaddedLoader(train_proof.open_dataset(*paths),
                                   batch_size=32, O_max=16, T_max=16,
                                   num_workers=4, seed=0)))
    boxes, masks, obj_mask = (torch.tensor(np.asarray(batch[k]),
                                           dtype=torch.float32, device="cuda")
                              for k in ("boxes", "masks", "obj_mask"))
    with full_fp32():
        for D in (64, 128):
            check_k1_function(torch, boxes, masks, obj_mask, D, "[proofs]")

    def others(path):
        return {k: v for k, v in path.items()
                if k not in TRAIN_COUNTS and v}

    runs = {}
    for name, extra in (
            ("f32", []),
            ("f32 again", ["--iters", str(PROOF_REPEAT_ITERS)]),
            ("bf16/split", ["--bf16", "1", "--crn_mode", "split"])):
        tag = name.replace("/", "_").replace(" ", "_")
        out = os.path.join(work, f"proof_{tag}")
        argv = ["--iters", str(PROOF_ITERS), "--workers", "8", "--device",
                "cuda", "--out", out] + extra
        if name == "f32 again":
            argv += ["--compare_to", runs["f32"]]
        rc, wall, path, _ = _tool(train_proof.main, argv,
                                  os.path.join(logs, f"proof_{tag}.log"))
        add_launches(launches, path)
        path = without_init(path)
        check_no_padded_copies(f"train_proof {name}")
        with open(os.path.join(out, "train_proof.json")) as f:
            s = json.load(f)
        runs[name] = os.path.join(out, "train_proof.json")
        k1 = path["layout_compose_boxes"]
        print(_proof_line(name, s, wall, k1, card))
        l1 = [v for _, v in s["l1"]]
        if rc != 0 or not s["decreased"] or not np.isfinite(l1).all():
            fail(f"train_proof {name} exited {rc}: L1 {s['l1_head']:.4f} -> "
                 f"{s['l1_tail']:.4f}, finite {np.isfinite(l1).all()}")
        # The final check_model's forwards: one a K1 launch.
        e1_want = train_e1_launches(name.startswith("bf16"),
                                    PROOF_SWEEP_K1)
        r1_want = train_r1_launches(s["iters"] + PROOF_SWEEP_K1, s["iters"])
        if (k1 != s["iters"] + PROOF_SWEEP_K1 or others(path)
                or path["threefry_normal"] != s["iters"] + PROOF_SWEEP_TF
                or path["threefry_split"] != s["iters"]
                or path["crn_epilogue"] != e1_want
                or path["crn_resample"] != r1_want):
            fail(f"train_proof {name}: K1 launched {k1} times, expected "
                 f"{s['iters'] + PROOF_SWEEP_K1}; threefry "
                 f"{path['threefry_normal']} times, expected "
                 f"{s['iters'] + PROOF_SWEEP_TF}; the key's split "
                 f"{path['threefry_split']} times for {s['iters']} steps; "
                 f"E1 {path['crn_epilogue']} times, expected {e1_want}; "
                 f"R1 {path['crn_resample']} times, expected {r1_want}; "
                 f"other kernels {others(path)}")
        if "compared_to" in s:
            c = s["compared_to"]
            print(f"[proofs] train_proof {name}: its L1 trace against the "
                  f"first f32 run's: {c['records']} common records (steps "
                  f"25-{25 * c['records']}), bit-identical "
                  f"{c['bit_identical']}")
            if not c["bit_identical"]:
                fail("two f32 train_proof runs gave different L1 traces")

    out = os.path.join(work, "fidelity")
    rc, wall, path, last = _tool(trained_fidelity.main, [
        "--iters", str(FIDELITY_ITERS), "--workers", "8", "--device", "cuda",
        "--out", out], os.path.join(logs, "proof_trained_fidelity.log"))
    add_launches(launches, path)
    path = without_init(path)
    result = json.loads(last)
    k1 = path["layout_compose_boxes"]
    l1 = [v for _, v in result["l1"]]
    print(f"[proofs] trained_fidelity: {FIDELITY_ITERS} steps b32 of the "
          f"small generator (embed/gconv 64, CRN 256,128,64) in "
          f"{result['wall_s']:.1f} s of CLI ({wall:.1f} s in all); L1 "
          f"{np.mean(l1[:3]):.4f} -> {np.mean(l1[-3:]):.4f} (first and last "
          f"3 records); final check_model box IoU train "
          f"{result['iou']['train_iou']:.4f} val "
          f"{result['iou']['val_iou']:.4f}; export -> goldens from the CPU "
          f"engine -> "
          f"verify_pretrained --device cuda: {result['psnr_u8_db_trained']:.2f}"
          f" dB u8 (bar {PSNR_BAR}); K1 launches {k1} ({FIDELITY_ITERS} "
          f"steps + {PROOF_SWEEP_K1} + the box-head probe's and the "
          f"gate's forwards); on {card}")
    print(f"[proofs] trained_fidelity's box head at seed {result['seed']}:"
          f" x0, y0, x1, y1 non-zero for "
          f"{', '.join(f'{v:.4f}' for v in result['box_nonzero_share_init'])}"
          f" of the objects at init, alive after training "
          f"{result['box_head_alive']}")
    if rc != 0 or not result["pass"] or not (
            result["psnr_u8_db_trained"] >= PSNR_BAR):
        fail(f"trained_fidelity exited {rc}: {result['psnr_u8_db_trained']}"
             f" dB; box head alive {result['box_head_alive']}; "
             f"{result['cause']}")
    # The seed contract on the card: the probe refuses seed 1's init (y1
    # dead) and passes the documented seed's, on the first batch of the
    # proof data.
    shares = {seed: trained_fidelity.box_head_probe(trained_fidelity.
              train_flags(paths, 1, 32, 4, seed, "cuda"))
              for seed in (1, trained_fidelity.SEED)}
    print(f"[proofs] trained_fidelity's box-head probe on the card, the "
          f"share of objects with x0, y0, x1, y1 non-zero at init: {shares}")
    if min(shares[1]) != 0.0 or min(shares[trained_fidelity.SEED]) == 0.0:
        fail(f"the box-head probe did not refuse seed 1 and pass seed "
             f"{trained_fidelity.SEED}: {shares}")
    # Its probe and gate forwards take zero noise: no threefry launch.
    tf = path["threefry_normal"]
    r1_want = train_r1_launches(FIDELITY_ITERS + PROOF_SWEEP_K1 + 2,
                                FIDELITY_ITERS, stages=FIDELITY_CRN_STAGES)
    if (k1 != FIDELITY_ITERS + PROOF_SWEEP_K1 + 2 or others(path)
            or tf != FIDELITY_ITERS + PROOF_SWEEP_TF
            or path["threefry_split"] != FIDELITY_ITERS
            or path["crn_epilogue"] or path["crn_resample"] != r1_want):
        fail(f"trained_fidelity: K1 launched {k1} times, threefry {tf} "
             f"times (expected {FIDELITY_ITERS + PROOF_SWEEP_TF}), the "
             f"key's split {path['threefry_split']} times, E1 "
             f"{path['crn_epilogue']} times in float32, R1 "
             f"{path['crn_resample']} times (expected {r1_want}); other "
             f"kernels {others(path)}")

    rc, wall, _, last = _tool(loader_bench.main, [
        "--proof_report", runs["f32"], "--out", os.path.join(work, "lb")],
        os.path.join(logs, "proof_loader_bench.log"))
    if rc != 0:
        fail(f"loader_bench exited {rc}")
    lb = json.loads(last)
    print(f"[proofs] loader_bench at the f32 proof's steady "
          f"{lb['step_rate']:.1f} img/s: raw decode ms/img "
          + ", ".join(f"{k} {v:.3f}" for k, v in lb["raw_ms"].items())
          + f", cached read {lb['cached_ms']:.3f} (cache built in "
          f"{lb['cache_build_s']:.1f} s); PaddedLoader img/s "
          + ", ".join(f"{k} {v:.0f}" for k, v in lb["loader_img_s"].items())
          + f" ({wall:.1f} s in all)")


# The measurement tools (sg2im_tpu_torch.tools) once each at reduced
# counts: {tool: (arguments, kernels its run must launch)}.  Their full
# runs, behind PERF.md's tables, are the tools' own defaults.
MEASURE_RUNS = {
    "bw_probe": (["--iters", "5"], ()),
    "roofline": (["--modes", "bf16/split,bf16/packed", "--iters", "3",
                  "--profile"],
                 ("layout_compose_boxes", "relayout_s2d", "relayout_d2s")),
    "profile_crn": (["--iters", "3"], ("relayout_s2d", "relayout_d2s")),
    "roofline_train": (["--iters", "3"], ("layout_compose_boxes",)),
    "profile_seeded_noise": (["--iters", "3", "--windows", "2"],
                             ("layout_compose_boxes",)),
    "profile_turbo_frontier": (["--iters", "3", "--windows", "2"],
                               ("layout_compose_boxes", "conv3x3_s8")),
}
ROOFLINE_SECTIONS = (
    ["peak_bf16_matmul", "peak_f32_matmul", "peak_scale_add", "gcn_x5",
     "box+rel_heads", "mask_head", "layout_compose", "noise+concat",
     "crn_total"] + [f"crn_s{s}_conv{k}" for s in range(1, 6)
                     for k in (0, 1)]
    + [f"crn_stage{s}_prod" for s in range(1, 6)] + ["e2e_forward"])
TRAIN_SECTIONS = ("g_forward", "g_forward_backward", "d_obj_step",
                  "d_img_step", "crop_kernel", "adam_updates", "full_step")
SHARE_BAR = 105.0   # % of a data-sheet peak or of the speed of light


def check_rows(tool, what, rows, names):
    """Every section of ``names`` present once with finite numbers, and no
    share of a data-sheet peak or of the speed of light above SHARE_BAR."""
    from sg2im_tpu_torch.utils.roofline import max_share

    got = [r["section"] for r in rows]
    if sorted(got) != sorted(names):
        fail(f"{tool} {what}: sections {got}, expected {list(names)}")
    for r in rows:
        nums = [r["ms"], r["gflops"], r["mbytes"]]
        if not (np.isfinite(nums).all() and r["ms"] > 0
                and r.get("finite", True)):
            fail(f"{tool} {what}: {r['section']} not finite: {r}")
        if max_share(r) > SHARE_BAR:
            fail(f"{tool} {what}: {r['section']} reads {max_share(r):.1f}% "
                 f"of a data-sheet peak or of its speed of light")


def _share_text(r):
    return (f"{r['section']} {r['ms']:.4f} ms, {r['gflops']:.2f} GF, "
            f"{r['mbytes']:.1f} MB, {r['pct_sol']:.1f}% of sol "
            f"({r['bound']})")


def phase_measure(torch, card, launches, work):
    """Each measurement tool once on the card; see the module docstring.
    Their output goes to build/chip_smoke/measure_*.log."""
    import importlib

    logs = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(logs, exist_ok=True)
    out = {}
    for tool, (argv, needs) in MEASURE_RUNS.items():
        main_fn = importlib.import_module(f"sg2im_tpu_torch.tools.{tool}").main
        d = os.path.join(work, tool)
        rc, wall, path, _ = _tool(main_fn, argv + ["--device", "cuda",
                                                    "--out", d],
                                  os.path.join(logs, f"measure_{tool}.log"))
        add_launches(launches, path)
        check_no_padded_copies(tool)
        if rc != 0:
            fail(f"{tool} exited {rc} (build/chip_smoke/measure_{tool}.log)")
        missing = [k for k in needs if path[k] == 0]
        if missing:
            fail(f"{tool} never launched {missing}: {path}")
        with open(os.path.join(d, f"{tool}.json")) as f:
            out[tool] = json.load(f)
        print(f"[measure] {tool} {' '.join(argv)}: {wall:.1f} s, launches "
              f"{ {k: v for k, v in path.items() if v} }")

    bw = out["bw_probe"]
    for r in bw["rows"]:
        if not (np.isfinite(r["gb_s"]) and 0 < r["pct_sheet"] <= SHARE_BAR):
            fail(f"bw_probe {r['variant']} {r['dtype']}: {r['gb_s']} GB/s")
    print("[measure] bw_probe (GB/s, reads + writes; data sheet 3350): "
          + ", ".join(f"{r['variant']} {r['dtype']} {r['gb_s']:.1f}"
                      for r in bw["rows"]) + f"; on {card}")
    for res in out["roofline"]:
        check_rows("roofline", res["mode"], res["sections"],
                   ROOFLINE_SECTIONS)
        pr = res["profile"]
        print(f"[measure] roofline {res['mode']} b{res['batch']}: "
              + "; ".join(_share_text(r) for r in res["sections"])
              + f"; profile: device {pr['device_ms']:.2f} ms, wall "
              f"{pr['wall_ms']:.2f}, idle {100 * pr['idle_unprofiled']:.1f}%"
              f", {pr['kernels']:.0f} kernels; on {card}")
    crn = out["profile_crn"]
    if not crn["modes_agree"]:
        fail(f"profile_crn: the modes disagree: "
             f"{[r['rel_err_vs_legacy_f32'] for r in crn['stages']]}")
    print("[measure] profile_crn b128 bf16 ms per stage (modes equal in f32 "
          "within " + f"{crn['bar']}): " + "; ".join(
              f"s{r['stage']} " + " ".join(f"{m} {v:.3f}"
                                           for m, v in r["ms"].items())
              for r in crn["stages"]) + f"; on {card}")
    for res in out["roofline_train"]:
        check_rows("roofline_train", res["config"], res["sections"],
                   TRAIN_SECTIONS)
        print(f"[measure] roofline_train {res['config']} b{res['batch']}: "
              + "; ".join(f"{_share_text(r)}, idle {100 * r['idle']:.1f}%"
                          for r in res["sections"]) + f"; on {card}")
    sn = out["profile_seeded_noise"]
    if not sn["bit_identical"]:
        fail("profile_seeded_noise: eager and seeded images differ")
    if sn["draw_threefry_launches"] != 1:
        fail(f"profile_seeded_noise: a draw launched the threefry kernel "
             f"{sn['draw_threefry_launches']} times, not once")
    # Late in a long process, torch.profiler still sees the port's kernels.
    if not (sn["draw_launches"] or 0) >= 1 or not sn["draw_device_ms"] > 0:
        fail(f"profile_seeded_noise: torch.profiler saw "
             f"{sn['draw_launches']} kernels, {sn['draw_device_ms']} device "
             f"ms, in a draw that launched the threefry kernel")
    from sg2im_tpu_torch.ops import prng
    from sg2im_tpu_torch.ops import prng_kernel as pk

    key = prng.prng_key(2)
    table = kernel_table(lambda: pk.threefry_normal(
        key, (8, 32, 64, 64), device="cuda",
        memory_format=torch.channels_last), "cuda", iters=3, top=None)
    print(f"[measure] torch.profiler late in the run: a window of three "
          f"threefry draws shows {table['kernels']:.0f} kernel a draw "
          f"({', '.join(r['name'][:48] for r in table['top'])}), "
          f"{table['warmup_lost']} of its warm-up launches lost; on {card}")
    if table["kernels"] != 1 or "threefry" not in table["top"][0]["name"]:
        fail("torch.profiler late in the run misses threefry launches")
    print(f"[measure] profile_seeded_noise b128 bf16/split: eager "
          f"{sn['eager_img_s']:.1f} img/s, seeded {sn['seeded_img_s']:.1f},"
          f" zeros {sn['zeros_img_s']:.1f}; the draw "
          f"{sn['draw_device_ms']:.3f}"
          f" device ms in {sn['draw_launches']:.0f} launches ("
          f"{sn['draw_ms']:.3f} ms on events, {sn['draw_share_pct']:.1f}% "
          f"of the seeded call); eager and seeded bit-identical; on {card}")
    print("[measure] profile_turbo_frontier b128: " + "; ".join(
        f"{r['config']} {r['psnr_u8_db']:.2f} dB u8, {r['img_s']:.1f} img/s "
        f"({r['vs_production_pct']:+.1f}%)"
        for r in out["profile_turbo_frontier"]) + f"; on {card}")


# sg2im_tpu_torch.tools.bench at its defaults and with --mode train:
# {run: (arguments, kernels its run must launch)}.  The default run's
# int8 conv launches are its turbo parts' (the PSNR's and turbo_img_s).
BENCH_RUNS = {
    "infer": ([], ("layout_compose_boxes", "conv3x3_s8")),
    "train": (["--mode", "train"], ("layout_compose_boxes",
                                    "threefry_normal", "threefry_split")),
}
TRAIN_LINE_KEYS = ("metric", "value", "unit", "vs_baseline", "value_runs")


def _finite(value) -> bool:
    vals = value if isinstance(value, list) else [value]
    return bool(vals) and all(
        v is not None and (not isinstance(v, float) or np.isfinite(v))
        for v in vals)


def phase_bench(torch, card, launches, work, vg128_img_s):
    """The port's bench.py (sg2im_tpu_torch.tools.bench) on the card; see
    the module docstring.  Its output goes to build/chip_smoke/bench_*.log."""
    from sg2im_tpu_torch.tools import bench

    logs = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(logs, exist_ok=True)
    with open(os.path.join(REPO, "BENCH_r05.json")) as f:
        bench_keys = list(json.load(f)["parsed"])
    for run, (argv, needs) in BENCH_RUNS.items():
        d = os.path.join(work, f"bench_{run}")
        rc, wall, path, last = _tool(bench.main, argv + ["--out", d],
                                     os.path.join(logs, f"bench_{run}.log"))
        add_launches(launches, path)
        check_no_padded_copies(f"bench {run}")
        if rc != 0:
            fail(f"bench {' '.join(argv)} exited {rc} "
                 f"(build/chip_smoke/bench_{run}.log)")
        line = json.loads(last)
        want = (bench_keys + ["card", "psnr_reference"] if run == "infer"
                else list(TRAIN_LINE_KEYS))
        missing = [k for k in want if k not in line]
        if missing:
            fail(f"bench {run}: keys missing from its line: {missing}")
        bad = {k: v for k, v in line.items() if not _finite(v)}
        if bad:
            fail(f"bench {run}: non-finite or null values {bad}")
        unfired = [k for k in needs if path[k] == 0]
        if unfired:
            fail(f"bench {run} never launched {unfired}: {path}")
        print(f"[bench] {run} {' '.join(argv)}: {wall:.1f} s, launches "
              f"{ {k: v for k, v in path.items() if v} }; line "
              f"{json.dumps(line)}")
        if run == "infer":
            for k in ("psnr_u8_db_vs_reference_f32",
                      "psnr_u8_db_vs_reference"):
                if line[k] < PSNR_BAR:
                    fail(f"bench: {k} {line[k]:.2f} dB under {PSNR_BAR}")
            if line["trained_gate_pass"] is not True:
                fail("bench: the trained checkpoint's gate failed")
            print(f"[bench] vg128 b{line['batch']} forward on bench.py's "
                  f"inputs: {line['value']:.1f} img/s (runs "
                  f"{[round(r, 1) for r in line['value_runs']]}) against "
                  f"phase_vg128's bf16/split {vg128_img_s['bf16/split']:.1f}"
                  f" on its 10-object, 21-relationship graphs; on {card}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this smoke run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    card = phase_environment(torch)
    seconds, clock = {}, [time.perf_counter()]

    def done(phase):
        now = time.perf_counter()
        seconds[phase] = now - clock[0]
        clock[0] = now

    phase_build()
    done("build")
    watch_inits()
    launches = {}
    errs, times = phase_kernels(torch, card)
    done("kernels")
    conv_errs, conv_times = phase_conv(torch, card)
    done("conv")
    rl_errs, rl_times = phase_relayout(torch, card)
    done("relayout")
    tf_errs, tf_times = phase_threefry(torch, card)
    done("threefry")
    phase_init(torch, card, launches)
    done("init")
    phase_checkpoint(torch, launches)
    done("checkpoint")
    vg128_img_s = phase_vg128(torch, card, launches)
    done("vg128")
    phase_seeded(torch, card, launches)
    done("seeded")
    phase_serve(torch, card, launches)
    done("serve")
    in_memory = phase_train(torch, card, launches)
    done("train")
    with tempfile.TemporaryDirectory() as work:
        coco_flags, run_dir, sweeps = phase_train_cli(
            torch, card, launches, in_memory, work)
        done("train_cli")
        phase_tools(torch, card, launches, coco_flags, run_dir, work)
        done("tools")
        phase_jax_checkpoint(torch, card, launches, coco_flags, work,
                             sweeps)
        done("jax_checkpoint")
        phase_parallel(torch, card, launches, coco_flags)
        done("parallel")
        phase_proofs(torch, card, launches, work)
        done("proofs")
    phase_mesh(torch, card, launches)
    done("mesh")
    with tempfile.TemporaryDirectory() as work:
        phase_measure(torch, card, launches, work)
        done("measure")
        phase_bench(torch, card, launches, work, vg128_img_s)
        done("bench")
    print("[time] seconds per phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items())
        + f"; all phases {sum(seconds.values()):.1f}")
    layout_src = "sg2im_tpu/ops/pallas/layout_kernel.py"
    conv_replaces = "scripts/proto_pallas_conv.py:122"
    relayout_src = "sg2im_tpu/ops/pallas/relayout_kernel.py"
    rl_bounds = relayout_bounds(RELAYOUT_PATH.values())
    # (name, source, replaces, max abs err, ms, plain ms, (bound ms, bound
    # by), one PyTorch call's ms or None)
    # K1 stands twice, with the counts every path reads: layout_compose_boxes
    # (all its launches, either output type) timed with an f32 output, and
    # layout_compose_boxes_bf16 (those with a bf16 output) timed so.
    rows = [
        ("layout_compose_boxes", KERNEL_SOURCE, f"{layout_src}:241",
         errs["boxes"], times["boxes"], times["boxes_plain"],
         roofline_ms(*layout_bounds(*LAYOUT_TIMED, weights=False),
                     F32_FLOPS), None),
        ("layout_compose_boxes_bf16", KERNEL_SOURCE, f"{layout_src}:241",
         errs["boxes_bf16"], times["boxes_bf16"], times["boxes_bf16_plain"],
         roofline_ms(*layout_bounds(*LAYOUT_TIMED, weights=False,
                                    out_elem=2), F32_FLOPS), None),
        ("layout_compose_weights", KERNEL_SOURCE, f"{layout_src}:89",
         errs["weights"], times["weights"], times["weights_plain"],
         roofline_ms(*layout_bounds(*LAYOUT_TIMED, weights=True),
                     F32_FLOPS), times["weights_library"]),
        ("conv3x3_bf16", CONV_SOURCE, conv_replaces, conv_errs["bf16"],
         conv_times["bf16"], conv_times["bf16_plain"],
         conv_times["bounds"]["bf16"], conv_times["cudnn_bf16"]),
        ("conv3x3_s8", CONV_SOURCE, conv_replaces, conv_errs["s8"],
         conv_times["s8"], conv_times["s8_plain"],
         conv_times["bounds"]["s8"], None),
        ("relayout_s2d", RELAYOUT_SOURCE, f"{relayout_src}:77",
         rl_errs["s2d"], rl_times["s2d"], rl_times["s2d_plain"],
         rl_bounds["s2d"], rl_times["s2d_library"]),
        ("relayout_d2s", RELAYOUT_SOURCE, f"{relayout_src}:91",
         rl_errs["d2s"], rl_times["d2s"], rl_times["d2s_plain"],
         rl_bounds["d2s"], rl_times["d2s_library"]),
        # No TPU kernel: the JAX package's jax.random.normal, which XLA
        # expands on the TPU.  torch.randn is another function (printed by
        # phase_threefry as a reference), so no library call.
        ("threefry_normal", THREEFRY_SOURCE, "sg2im_tpu/inference.py:301",
         max(v for k, v in tf_errs.items() if k != "uniform"),
         tf_times["f32"], tf_times["f32_plain"], tf_times["f32_bound"],
         None),
        # The uniform entry: the parameter init's jax.random.uniform
        # (sg2im_tpu/nn/layers.py:37-47 through flax's variance_scaling),
        # which XLA expands on the TPU; timed at vg128's largest leaf.
        ("threefry_uniform", THREEFRY_SOURCE, "sg2im_tpu/nn/layers.py:46",
         tf_errs["uniform"], tf_times["uniform"], tf_times["uniform_plain"],
         tf_times["uniform_bound"], None),
        # jax.random.split of the train step's key (sg2im_tpu/train/
        # step.py:274), which XLA expands on the TPU; checked bit for bit.
        ("threefry_split", THREEFRY_SOURCE, "sg2im_tpu/train/step.py:274",
         0.0, tf_times["split"], tf_times["split_plain"],
         tf_times["split_bound"], None),
        # No TPU kernel: XLA fused the CRN's chain after each convolution
        # (sg2im_tpu/nn/crn.py's norm and activation) into its consumers.
        # Timed as the vg128 b128 forward's eleven chains summed.
        ("crn_epilogue", EPILOGUE_SOURCE, "none (XLA's fusion)",
         errs["crn_epilogue"], times["crn_epilogue"],
         times["crn_epilogue_plain"], (times["crn_epilogue_bound"], "bytes"),
         times["crn_epilogue_library"]),
        # No TPU kernel: XLA compiled the mask head's convolutions
        # (sg2im_tpu/models/sg2im.py MaskNet).  Timed as vg128's b128 head,
        # its four steps summed, beside the eager head (cuDNN).
        ("mask_head", MASK_HEAD_SOURCE, "none (XLA's convolutions)",
         errs["mask_head"], times["mask_head"], times["mask_head_plain"],
         times["mask_head_bound"], times["mask_head_library"]),
        # No TPU kernel: XLA fused the CRN's pooling and upsampling into
        # its convolutions.  Timed as vg128's b128 pyramid and four
        # upsamples summed (each direction apart in the row's extra keys);
        # its plain version is aten's calls, the library's.
        ("crn_resample", RESAMPLE_SOURCE, "none (XLA's fusion)",
         errs["crn_resample"],
         *(times[f"resample_pyramid_vg128{k}"]
           + times[f"resample_upsample_vg128{k}"]
           for k in ("", "_plain")),
         (times["resample_pyramid_vg128_bound"]
          + times["resample_upsample_vg128_bound"], "bytes"),
         times["resample_pyramid_vg128_plain"]
         + times["resample_upsample_vg128_plain"]),
    ]
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches.get(name, 0),
         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library}
        for name, source, replaces, err, ms, plain_ms, bound, library
        in rows]}
    # The split's bound, its hash, is far below any launch: beside it its
    # device time and the card's least launch by the same route (an empty
    # kernel), on events and on the device.
    next(k for k in summary["kernels"] if k["name"] == "threefry_split").update(
        device_ms=tf_times["split_device"],
        launch_floor_ms=tf_times["empty"],
        launch_floor_device_ms=tf_times["empty_device"])
    # R1's row: each direction's times at both cells beside its sums.
    next(k for k in summary["kernels"] if k["name"] == "crn_resample").update(
        {k: v for k, v in times.items() if k.startswith("resample_")})
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
