"""Layout compose: the Hopper kernel's wrappers, their plain versions and
their launch counters.

``layout_compose`` (tent weights built from the boxes in the kernel) and
``layout_compose_weights`` (tent weights given) compute

    out[n, y, x, :] = sum_o (Wy[n, o] @ masks[n, o] @ Wx[n, o]^T)[y, x]
                      * vecs[n, o, :]

into an (N, H, W, D) NHWC tensor.  They replace the TPU kernels of
``sg2im_tpu/ops/pallas/layout_kernel.py``: ``fused_layout_compose_v2`` and
``fused_layout_compose``.  The CUDA source is ``csrc/layout_compose.cu``; its
notes say what bounds each kernel and what each design does about it.
``boxes_plan`` and ``weights_plan`` are the two kernels' cuts of one call
(bands of rows, column tiles, object groups); each wrapper passes its plan
to the launch.

For a CUDA tensor each wrapper launches the kernel or raises; for a CPU
tensor it computes the plain version (``layout_compose_ref``,
``layout_compose_weights_ref``), which materialises the (N, O, H, W) warp.
``<wrapper>.launches`` counts kernel launches and nothing else;
``layout_compose.launches_bf16`` counts those of them with a bfloat16
output.

Gradients: each wrapper is a ``torch.autograd.Function`` whose forward is
the kernel (the plain version on the CPU) and whose backward recomputes the
plain version from the saved inputs and takes its vector-Jacobian product
for every input that requires a gradient, on the inputs' device.  That is
the JAX package's ``custom_vjp`` (``_v2_bwd``, ``_bwd``), which has no
backward kernel either.  Only the small inputs are saved, never the warp.
A call that needs no gradient launches the kernel without the Function.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from sg2im_tpu_torch.ops.sampling import separable_sample

_OUT_DTYPES = (torch.float32, torch.bfloat16)

# The boxes kernel's constants (csrc/layout_compose.cu).
B_THREADS = 256      # threads per block at most
B_X_PER, B_D_PER = 4, 8  # output pixels (along a row) x channels of a thread
B_MAX_TH = 32        # output rows per block
B_MAX_TX = 128       # output columns per block
B_TILE_PIX = 512     # output pixels per block that boxes_plan aims at
B_SMEM_BUDGET = 76800  # bytes of shared memory: three blocks per SM

# The weights kernel's constants (csrc/layout_compose.cu).
TILE_D = 128         # channels per block (both kernels)
W_THREADS = 256      # threads per block at most
X_PER, D_PER = 8, 4  # output pixels (along a row) x channels of one thread
MAX_BAND = 32        # output rows per block
MAX_CHUNK = 8        # objects per staged chunk
MAX_PX = 128         # output pixels per pass
SMEM_BUDGET = 115712  # bytes of shared memory: two blocks per SM


class WeightsPlan(NamedTuple):
    """How the weights kernel cuts one call: blocks of TH output rows by
    TX columns by TILE_D channels; per block, objects in ``groups`` groups
    of G, each group's coefficients built in chunks of ``oc`` objects, then
    per pass of PX consecutive pixels of the TH x TX tile (row-major; TX a
    multiple of PX, or PX a multiple of TX) the sums of all of the group's
    objects, stored from registers.  ``smem``: dynamic shared memory bytes,
    as the source's ``make_plan`` computes them."""
    TH: int
    TX: int
    G: int
    oc: int
    PX: int
    threads: int
    n_bands: int
    x_tiles: int
    d_tiles: int
    groups: int
    smem: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class BoxesPlan(NamedTuple):
    """How the boxes kernel cuts one call: blocks of TH output rows by TX
    columns (powers of two) by TILE_D channels; per block, objects in
    ``groups`` groups of G, each group's masks, vectors and taps staged and
    its (G, TH, TX) coefficients built, then per pass of ``pgs`` groups of
    4 pixels of a row the sums of all of the group's objects, stored from
    registers.  Groups of G < O only where the tile is one pass, so the
    sums carry over in registers.  ``smem``: dynamic shared memory bytes,
    as the source's ``make_boxes_plan`` computes them."""
    TH: int
    TX: int
    G: int
    d_groups: int
    pgs: int
    threads: int
    n_bands: int
    x_tiles: int
    d_tiles: int
    groups: int
    smem: int


def _pow2_at_least(v: int) -> int:
    return 1 << max(0, v - 1).bit_length()


def boxes_smem(G: int, TH: int, TX: int, M: int, d_groups: int) -> int:
    """Shared memory bytes of a boxes tile: coefficients (G, TH, TX), x and
    y taps as float4s, vectors (G, 8 d_groups) and masks (G, M, M), all
    float32."""
    return 4 * G * (TH * TX + 4 * TX + 4 * TH + B_D_PER * d_groups + M * M)


@functools.lru_cache(maxsize=256)
def boxes_plan(O: int, H: int, W: int, M: int, D: int) -> BoxesPlan:
    """The boxes kernel's plan, cached (the wrapper asks on every launch).

    Tiles are at most B_TILE_PIX pixels, no wider or taller than the image
    rounded up to a power of two, and at least one pass of the block's
    threads where the image allows.  Of the tiles that hold every object in
    B_SMEM_BUDGET: the largest, then the one with the fewest taps per pixel
    ((TH + TX) / (TH TX)), then the wider.  Where none does, groups of G < O
    objects on the tile of one pass."""
    d_groups = _cdiv(min(D, TILE_D), B_D_PER)
    one_pass = B_X_PER * (B_THREADS // d_groups)
    tx_cap = min(B_MAX_TX, max(B_X_PER, _pow2_at_least(W)))
    th_cap = min(B_MAX_TH, _pow2_at_least(H))
    least = min(B_TILE_PIX, 1 << one_pass.bit_length() - 1, tx_cap * th_cap)
    tiles = [(TH, TX) for TX in (4, 8, 16, 32, 64, 128) if TX <= tx_cap
             for TH in (1, 2, 4, 8, 16, 32) if TH <= th_cap
             and least <= TH * TX <= B_TILE_PIX]

    def best(cands):
        return max(cands, key=lambda t: (t[0] * t[1], -(t[0] + t[1]), t[1]))

    fit = [t for t in tiles
           if boxes_smem(O, *t, M, d_groups) <= B_SMEM_BUDGET]
    if fit:
        (TH, TX), G = best(fit), O
    else:
        TH, TX = best(t for t in tiles if t[0] * t[1] <= one_pass)
        G = next(g for g in range(O - 1, 0, -1)
                 if boxes_smem(g, TH, TX, M, d_groups) <= B_SMEM_BUDGET)
    pgs = min(one_pass, TH * TX) // B_X_PER
    return BoxesPlan(TH, TX, G, d_groups, pgs, d_groups * pgs, _cdiv(H, TH),
                     _cdiv(W, TX), _cdiv(D, TILE_D), _cdiv(O, G),
                     boxes_smem(G, TH, TX, M, d_groups))


def wx_row_pitch(M: int) -> tuple[int, int]:
    """(Mr, S): M rounded up to 4, and the padded Wx row in shared memory,
    S / 4 odd, so 16-byte reads of eight neighbouring rows hit eight
    distinct bank quads."""
    Mr = _cdiv(M, 4) * 4
    return Mr, Mr + (4 if (Mr // 4) % 2 == 0 else 0)


def weights_plan(O: int, H: int, W: int, M: int, D: int) -> WeightsPlan:
    """The weights kernel's plan: of the tiles whose coefficients, vectors
    and staged chunks fit SMEM_BUDGET, the one that stages the fewest bytes
    per output pixel; object groups of G < O where none holds all
    objects."""
    Mr, S = wx_row_pitch(M)
    d_tiles = _cdiv(D, TILE_D)
    d_groups = _cdiv(min(D, TILE_D), D_PER)
    x_groups = min(W_THREADS // d_groups, _cdiv(W, X_PER), MAX_PX // X_PER)
    PX = X_PER * x_groups

    def fits(G, TH, TX):
        held = 4 * G * TH * TX + 4 * G * D_PER * d_groups
        oc = min(MAX_CHUNK, G)
        while oc >= 1:
            chunk = 4 * oc * (TX * S + M * Mr + TH * Mr)
            total = held + 2 * chunk + 4 * oc * TH * Mr
            if total <= SMEM_BUDGET:
                return G, TH, TX, oc, total
            oc //= 2
        return None

    # Column tiles of whole passes or dividing a pass, by bands of 32, 16,
    # ... 1 rows, all objects in one group: the least staged bytes per
    # pixel, (M + TH + TX) / (TH * TX), first on a tie.
    found, best = None, None
    TX = _cdiv(W, PX) * PX
    while TX % X_PER == 0 and (TX >= PX or PX % TX == 0):
        for t in (32, 16, 8, 4, 2, 1):
            TH = min(t, H)
            if TX < PX and TH * TX % PX:
                continue
            num, den = M + TH + TX, TH * TX
            if best and num * best[1] >= best[0] * den:
                continue
            f = fits(O, TH, TX)
            if f:
                found, best = f, (num, den)
        TX = TX - PX if TX > PX else TX // 2
    # Else groups of G < O objects: one pass per block, sums carried over.
    found = found or next(filter(None, (fits(g, 1, PX)
                                        for g in range(O - 1, 0, -1))))
    G, TH, TX, oc, smem = found
    return WeightsPlan(TH, TX, G, oc, PX, d_groups * x_groups, _cdiv(H, TH),
                       _cdiv(W, TX), d_tiles, _cdiv(O, G), smem)


def layout_compose_weights_ref(wy, wx, masks, vecs) -> torch.Tensor:
    """Plain version of the weights entry: wy (N,O,H,M), wx (N,O,W,M),
    masks (N,O,M,M), vecs (N,O,D) -> (N,H,W,D) in f32."""
    warp = separable_sample(masks, wy, wx)  # (N, O, H, W)
    return torch.einsum("nohw,nod->nhwd", warp, vecs)


def layout_compose_ref(boxes, masks, vecs, H: int, W: int) -> torch.Tensor:
    """Plain version of the boxes entry: box_warp_weights ->
    separable_sample -> compose, in f32."""
    from sg2im_tpu_torch.ops.layout import box_warp_weights

    M = masks.shape[-1]
    wy, wx = box_warp_weights(boxes, H, W, M, M)
    return layout_compose_weights_ref(wy, wx, masks, vecs)


def _on_cpu(*tensors) -> bool:
    """True when every tensor is on the CPU, False when every one is on
    one CUDA device; raises on anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: {devices}")
    (device,) = devices
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"layout compose runs on CPU or CUDA, not {device}")
    return False


def _check_kernel_inputs(named: dict, N: int, O: int, M: int, H: int,
                         W: int, out_dtype):
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 for the kernel, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be one of {_OUT_DTYPES}, "
                        f"got {out_dtype}")
    if O < 1 or N < 1:
        raise ValueError(f"need N >= 1 and O >= 1, got N={N}, O={O}")
    if not 1 <= M <= 32:
        raise ValueError(f"mask side M must be in [1, 32], got {M}")
    if H < 2 or W < 2:
        raise ValueError(f"need H >= 2 and W >= 2, got {H}x{W}")
    if N * H >= 2 ** 31:
        raise ValueError(f"N * H = {N * H} exceeds the kernel's grid")


def _check_shapes(masks, vecs, N: int, O: int):
    if masks.ndim != 4 or masks.shape[:2] != (N, O) \
            or masks.shape[2] != masks.shape[3]:
        raise ValueError(f"masks must be (N, O, M, M) = ({N}, {O}, M, M), "
                         f"got {tuple(masks.shape)}")
    if vecs.ndim != 3 or vecs.shape[:2] != (N, O):
        raise ValueError(f"vecs must be (N, O, D) = ({N}, {O}, D), "
                         f"got {tuple(vecs.shape)}")


def _needs_grad(*tensors) -> bool:
    """Whether autograd must record the call: inference calls skip the
    Function's host cost."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _plain_vjp(fn, inputs, needs, grad_out):
    """Gradients of ``fn(*inputs)`` against ``grad_out`` for the inputs
    flagged in ``needs`` (None for the others), recomputing ``fn`` in f32
    with autograd."""
    with torch.enable_grad():
        xs = [t.detach().float().requires_grad_(need)
              for t, need in zip(inputs, needs)]
        out = fn(*xs)
        wanted = [x for x in xs if x.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad_out.float()))
    return tuple(next(grads).to(t.dtype) if need else None
                 for t, need in zip(inputs, needs))


def _launch_boxes(boxes, masks, vecs, H, W, out_dtype):
    N, O = boxes.shape[:2]
    if _on_cpu(boxes, masks, vecs):
        return layout_compose_ref(boxes.float(), masks.float(), vecs.float(),
                                  H, W).to(out_dtype)
    M, D = masks.shape[-1], vecs.shape[-1]
    _check_kernel_inputs({"boxes": boxes, "masks": masks, "vecs": vecs},
                         N, O, M, H, W, out_dtype)
    from sg2im_tpu_torch.ops._build import load_library

    plan = boxes_plan(O, H, W, M, D)
    out = torch.empty((N, H, W, D), dtype=out_dtype, device=vecs.device)
    with torch.cuda.device(vecs.device):
        rc = load_library().sg2im_layout_compose_boxes(
            boxes.data_ptr(), masks.data_ptr(), vecs.data_ptr(),
            out.data_ptr(), N, O, H, W, M, D,
            int(out_dtype == torch.bfloat16), plan.TH, plan.TX, plan.G,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sg2im_layout_compose_boxes launch failed: "
                           f"cudaError {rc}")
    layout_compose.launches += 1
    layout_compose.launches_bf16 += int(out_dtype == torch.bfloat16)
    return out


def _launch_weights(wy, wx, masks, vecs, out_dtype):
    N, O, H, M = wy.shape
    W = wx.shape[2]
    if _on_cpu(wy, wx, masks, vecs):
        return layout_compose_weights_ref(
            wy.float(), wx.float(), masks.float(), vecs.float()).to(out_dtype)
    _check_kernel_inputs({"wy": wy, "wx": wx, "masks": masks, "vecs": vecs},
                         N, O, M, H, W, out_dtype)
    from sg2im_tpu_torch.ops._build import load_library

    D = vecs.shape[-1]
    plan = weights_plan(O, H, W, M, D)
    out = torch.empty((N, H, W, D), dtype=out_dtype, device=vecs.device)
    with torch.cuda.device(vecs.device):
        rc = load_library().sg2im_layout_compose_weights(
            wy.data_ptr(), wx.data_ptr(), masks.data_ptr(), vecs.data_ptr(),
            out.data_ptr(), N, O, H, W, M, D,
            int(out_dtype == torch.bfloat16), plan.TH, plan.TX, plan.G,
            plan.oc, plan.PX, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sg2im_layout_compose_weights launch failed: "
                           f"cudaError {rc}")
    layout_compose_weights.launches += 1
    return out


class _ComposeBoxes(torch.autograd.Function):
    """The boxes entry: the kernel forward, ``_v2_bwd``'s recompute
    backward."""

    @staticmethod
    def forward(ctx, boxes, masks, vecs, H, W, out_dtype):
        ctx.save_for_backward(boxes, masks, vecs)
        ctx.H, ctx.W = H, W
        return _launch_boxes(boxes, masks, vecs, H, W, out_dtype)

    @staticmethod
    def backward(ctx, grad_out):
        H, W = ctx.H, ctx.W
        grads = _plain_vjp(lambda b, m, v: layout_compose_ref(b, m, v, H, W),
                           ctx.saved_tensors, ctx.needs_input_grad[:3],
                           grad_out)
        return grads + (None, None, None)


class _ComposeWeights(torch.autograd.Function):
    """The weights entry: the kernel forward, ``_bwd``'s recompute
    backward."""

    @staticmethod
    def forward(ctx, wy, wx, masks, vecs, out_dtype):
        ctx.save_for_backward(wy, wx, masks, vecs)
        return _launch_weights(wy, wx, masks, vecs, out_dtype)

    @staticmethod
    def backward(ctx, grad_out):
        grads = _plain_vjp(layout_compose_weights_ref, ctx.saved_tensors,
                           ctx.needs_input_grad[:4], grad_out)
        return grads + (None,)


def layout_compose(boxes, masks, vecs, H: int, W: int,
                   out_dtype=None) -> torch.Tensor:
    """Compose with tent weights built from ``boxes`` (N, O, 4).

    masks (N, O, M, M) and vecs (N, O, D) (already multiplied by the
    object mask) -> (N, H, W, D) in ``out_dtype`` (default: vecs' dtype;
    the kernel writes float32 or bfloat16 and sums in float32).
    Differentiable in all three inputs.
    """
    out_dtype = out_dtype or vecs.dtype
    if boxes.ndim != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (N, O, 4), got {tuple(boxes.shape)}")
    _check_shapes(masks, vecs, *boxes.shape[:2])
    if _needs_grad(boxes, masks, vecs):
        return _ComposeBoxes.apply(boxes, masks, vecs, H, W, out_dtype)
    return _launch_boxes(boxes, masks, vecs, H, W, out_dtype)


def layout_compose_weights(wy, wx, masks, vecs,
                           out_dtype=None) -> torch.Tensor:
    """Compose with given tent weights wy (N, O, H, M) and wx (N, O, W, M);
    masks (N, O, M, M), vecs (N, O, D) -> (N, H, W, D) in ``out_dtype``
    (default: vecs' dtype).  The kernel does both M-sums itself.
    Differentiable in all four inputs."""
    out_dtype = out_dtype or vecs.dtype
    if wy.ndim != 4 or wx.ndim != 4:
        raise ValueError("wy and wx must be (N, O, H, M) and (N, O, W, M)")
    N, O, H, M = wy.shape
    W = wx.shape[2]
    _check_shapes(masks, vecs, N, O)
    if wx.shape != (N, O, W, M) or masks.shape[-1] != M:
        raise ValueError(f"inconsistent shapes: wy {tuple(wy.shape)}, "
                         f"wx {tuple(wx.shape)}, masks {tuple(masks.shape)}")
    if _needs_grad(wy, wx, masks, vecs):
        return _ComposeWeights.apply(wy, wx, masks, vecs, out_dtype)
    return _launch_weights(wy, wx, masks, vecs, out_dtype)


layout_compose.launches = 0
layout_compose.launches_bf16 = 0
layout_compose_weights.launches = 0
