"""Inference engine: JSON scene graphs -> images on one device.

Counterpart of ``sg2im_tpu/inference.py`` (upstream ``scripts/run_model.py``
+ ``Sg2ImModel.forward_json``).  Graphs are encoded and padded on the host,
the batch is padded to a power-of-two bucket, the generator runs under
``torch.inference_mode`` on the engine's device (a CUDA card unless the
caller asks for another), and images are deprocessed there too, so uint8
is fetched (a quarter of the float32 bytes; the bytes equal the host
``imagenet_deprocess_batch``'s).

Precision: every forward runs with TF32 off for both cuBLAS and cuDNN
(restored afterwards), so float32 layers are true float32.  With
``compute_dtype=torch.bfloat16`` only the CRN chain runs in bf16.

Seeded noise contract (the JAX package's, ``sg2im_tpu/inference.py``):
with ``noise=None`` the layout noise of a padded batch of N rows is
``jax.random.normal(jax.random.PRNGKey(seed), (N, H / f, W / f, D))`` with
partitionable threefry, at ``noise_dtype`` (float32 by default),
nearest-upsampled by f = ``noise_downsample`` (1 by default: full
resolution).  The port draws exactly those values (``ops.prng``; on the
card the threefry kernel of ``ops/prng_kernel.py`` draws them in one
launch).  Counters run over the flat index of the draw, so row i's noise
does not depend on N: the same graph at the same position with the same
seed gives the same noise, and so the same image, in every pad bucket, in
a server's coalesced batch (:meth:`InferenceEngine.draw_noise` draws a
request's rows exactly as the request alone would), on every mesh
sharding, on the CPU and on the card, and in the JAX package.  The noise
bits are equal everywhere; the float32 normals agree with the JAX
package's within 1e-6 (log1p rounds differently on each backend).
``noise_impl='rbg'``, XLA's RngBitGenerator, has no single reference to
match (its bits depend on the backend and the padded shape), so the port
refuses it.  Seeds must fit int32, as in the JAX engine.

Mesh (``InferenceEngine(mesh=make_mesh(...))``, the JAX engine's
``mesh=``): each data row of the mesh holds a replica of the generator on
its first device and runs its share of the padded batch (rounded up to a
multiple of the rows) on its own long-lived worker thread, since cuDNN
keeps its plans per thread; each row draws its own rows of the seeded
noise by offset on its device (those rows of the whole batch's draw), and
the rows' outputs are gathered in order on row 0's first device.
``tensor_parallel=True`` splits the GCN's hidden dimension over each row's
model column (``parallel.mesh.tp_generator_sharding``).  On the int8 tier
the activation scales are recorded once, on the whole batch, by row 0, and
every replica runs at the same scales.  Call :meth:`InferenceEngine.close`
to end the workers.

int8 turbo tier (``quantize='int8'``): the CRN's high-resolution stages
run on the int8 conv kernel at calibrated activation scales.  An
uncalibrated engine calibrates on its first batch (whose images are valid
turbo output); :meth:`InferenceEngine.calibrate` records or extends the
scales on chosen graphs, and ``save_calibration`` / ``load_calibration``
keep them in the JAX package's JSON format, so a file written by either
package loads into the other.
"""

from __future__ import annotations

import contextlib
import copy
import json
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from sg2im_tpu_torch.ckpt import load_reference_checkpoint
from sg2im_tpu_torch.data import (
    GraphBatch,
    encode_scene_graphs,
    imagenet_deprocess_batch_torch,
)
from sg2im_tpu_torch.models.sg2im import Sg2ImGenerator
from sg2im_tpu_torch.ops.prng import prng_key
from sg2im_tpu_torch.ops.prng_kernel import threefry_normal
from sg2im_tpu_torch.utils.timing import span

NOISE_DTYPES = (torch.float32, torch.bfloat16)
RBG_REFUSED = (
    "noise_impl 'rbg' (XLA's RngBitGenerator) is not supported: its bits "
    "depend on the backend and on the padded batch shape, so it has no "
    "single reference to match; use 'threefry' (the default)")


class _Fp32Scope:
    """The TF32 switches are process-wide, and engines on several devices
    run forwards in several threads at once (the server's replicas): the
    first block to enter turns TF32 off, the last to leave restores it."""

    def __init__(self):
        self.lock = threading.Lock()
        self.depth = 0
        self.saved = None


_FP32 = _Fp32Scope()
_OUTPUTS = ("imgs", "boxes", "masks", "rel_scores")


@contextlib.contextmanager
def full_fp32():
    """TF32 off for cuBLAS and cuDNN inside the block, restored after the
    last block open in any thread ends."""
    with _FP32.lock:
        if _FP32.depth == 0:
            _FP32.saved = (torch.backends.cuda.matmul.allow_tf32,
                           torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _FP32.depth += 1
    try:
        yield
    finally:
        with _FP32.lock:
            _FP32.depth -= 1
            if _FP32.depth == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _FP32.saved


def pad_bucket(n: int) -> int:
    """The padded batch of ``n`` graphs: the next power of two."""
    return max(1, 1 << (n - 1).bit_length()) if n else 1


def seeded_noise(n: int, shape, seed: int, device, f: int = 1,
                 dtype=torch.float32, row: int = 0,
                 memory_format=torch.contiguous_format) -> torch.Tensor:
    """Rows ``row`` ... ``row + n - 1`` of the seeded layout noise of
    ``seed`` (see the module docstring): (n, C, H, W) for ``shape`` = (C,
    H, W), the rows of ``jax.random.normal(PRNGKey(seed), (., H / f, W /
    f, C), dtype)`` nearest-upsampled by ``f``, on ``device`` (the threefry
    kernel on the card)."""
    C, H, W = (int(s) for s in shape)
    return threefry_normal(prng_key(seed), (n, C, H, W), f=f, dtype=dtype,
                           offset=row * C * (H // f) * (W // f),
                           device=device, memory_format=memory_format)


class InferenceEngine:
    """A generator on one device plus the host-side encoding around it."""

    CALIBRATION_FORMAT = "sg2im_tpu.int8_calibration.v1"
    _QUANT_KNOBS = ("head", "min_res", "max_res")

    def __init__(self, vocab, model_kwargs, state_dict, *, device=None,
                 pad_align: int = 8, compute_dtype=None, crn_mode=None,
                 quantize=None, quant_opts=None, noise_impl=None,
                 noise_dtype=None, noise_downsample: int = 1,
                 mesh=None, tensor_parallel: bool = False):
        """
        Args:
          vocab: dict with object/predicate name <-> index maps.
          model_kwargs: ``Sg2ImGenerator`` arguments (without vocab).
          state_dict: generator weights under upstream's names.
          device: where the generator runs ('cuda', 'cuda:1', 'cpu', ...);
            a CUDA card unless the caller asks for another (or a mesh).
          pad_align: object and triple slots are padded to a multiple.
          compute_dtype: None (float32) or torch.bfloat16 (bf16 CRN).
          crn_mode: None ('legacy'), 'split', 'split_noise', 'phase' or
            'packed' (see ``Sg2ImGenerator``); the int8 tier takes
            'legacy', 'split' and 'split_noise'.
          quantize: None or 'int8' (the turbo tier).
          quant_opts: the tier's band, merged key by key into the default
            {'max_res': 64}: 'head' (bool), 'min_res', 'max_res' (layout
            resolutions); a None value restores the model's default.
          noise_impl: None or 'threefry' (the JAX default, the seed
            contract of the module docstring); 'rbg' raises.
          noise_dtype: None (float32) or torch.bfloat16: the type of the
            seeded draw, as the JAX engine's (bfloat16 rounds the normals
            themselves; 'zeros' and explicit noise are untouched).
          noise_downsample: f in {1, 2, 4}: seeded noise is drawn at
            (H / f, W / f) and nearest-upsampled on the device (the noise
            becomes constant over f x f tiles).  'zeros' and explicit
            noise are untouched.
          mesh: a ``parallel.mesh.Mesh``, exclusive with ``device``: one
            replica per data row (see the module docstring).
          tensor_parallel: with a mesh, split the GCN hidden dimension
            over each row's model column.
        """
        if mesh is not None and device is not None:
            raise ValueError("mesh and device are mutually exclusive")
        if tensor_parallel and mesh is None:
            raise ValueError("tensor_parallel requires a mesh")
        self.mesh = mesh
        self.device = torch.device(
            mesh.devices[0][0] if mesh is not None else device or "cuda")
        devices = ([d for row in mesh.devices for d in row]
                   if mesh is not None else [self.device])
        if (any(d.type == "cuda" for d in devices)
                and not torch.cuda.is_available()):
            # Never run elsewhere than asked.
            raise RuntimeError(f"device {self.device} requested but CUDA is "
                               "not available")
        if noise_impl == "rbg":
            raise ValueError(RBG_REFUSED)
        if noise_impl not in (None, "threefry"):
            raise ValueError(f"unknown noise_impl {noise_impl!r}")
        self.noise_impl = "threefry"
        if noise_dtype not in (None,) + NOISE_DTYPES:
            raise ValueError(f"noise_dtype must be None, torch.float32 or "
                             f"torch.bfloat16, got {noise_dtype!r}")
        self.noise_dtype = noise_dtype
        if noise_downsample not in (1, 2, 4):
            raise ValueError(f"noise_downsample must be 1, 2 or 4, got "
                             f"{noise_downsample!r}")
        H, W = model_kwargs.get("image_size", (64, 64))
        if H % noise_downsample or W % noise_downsample:
            raise ValueError(f"noise_downsample {noise_downsample} does not "
                             f"divide image_size ({H}, {W})")
        self.noise_downsample = int(noise_downsample)
        self.vocab = vocab
        self.model_kwargs = dict(model_kwargs)
        if compute_dtype is not None:
            self.model_kwargs["compute_dtype"] = compute_dtype
        if crn_mode is not None:
            self.model_kwargs["crn_mode"] = crn_mode
        if quantize is not None:
            if quantize != "int8":
                raise ValueError(f"unknown quantize tier {quantize!r}")
            self.model_kwargs["crn_quant"] = quantize
            opts = {"max_res": 64}
            opts.update(dict(quant_opts or {}))
            for k, v in opts.items():
                if k not in self._QUANT_KNOBS:
                    raise ValueError(f"unknown quant_opts key {k!r}")
                if v is not None:
                    self.model_kwargs[f"crn_quant_{k}"] = v
        elif quant_opts:
            raise ValueError("quant_opts requires quantize='int8'")
        self.pad_align = pad_align
        model = Sg2ImGenerator(vocab, **self.model_kwargs)
        model.load_state_dict(state_dict, strict=True)
        model.eval()
        if self.device.type == "cuda":
            # NHWC convolutions: the layout arrives channels_last anyway.
            model = model.to(memory_format=torch.channels_last)
        self.model = model.to(self.device)
        self.replicas, self._workers = [self.model], []
        if mesh is not None:
            from sg2im_tpu_torch.parallel.mesh import apply_tensor_parallel

            self.replicas += [copy.deepcopy(self.model).to(row[0])
                              for row in mesh.devices[1:]]
            if tensor_parallel:
                for i, rep in enumerate(self.replicas):
                    apply_tensor_parallel(rep, mesh, i)
            self._workers = [ThreadPoolExecutor(
                1, thread_name_prefix=f"sg2im-mesh-row{i}")
                for i in range(len(mesh.devices))]

    def close(self):
        """End the mesh rows' worker threads (a no-op without a mesh)."""
        for w in self._workers:
            w.shutdown()

    def pad_rows(self, n: int) -> int:
        """The padded batch of ``n`` graphs: the power-of-two bucket,
        rounded up to a multiple of the mesh's data rows."""
        n_pad = pad_bucket(n)
        if self.mesh is not None:
            d = self.mesh.shape["data"]
            n_pad = -(-n_pad // d) * d
        return n_pad

    @classmethod
    def from_torch_checkpoint(cls, path, **kw) -> "InferenceEngine":
        """Engine from a reference-layout ``.pt`` checkpoint."""
        return cls.from_bundle(load_reference_checkpoint(path), **kw)

    @classmethod
    def from_bundle(cls, bundle, **kw) -> "InferenceEngine":
        """Engine from an already loaded ``(vocab, model_kwargs,
        state_dict)``, as ``load_reference_checkpoint`` returns it: replicas
        on several devices read the checkpoint once."""
        vocab, model_kwargs, state = bundle
        return cls(vocab, model_kwargs, state, **kw)

    def draw_noise(self, n: int, seed: int, row: int = 0,
                   device=None) -> torch.Tensor | None:
        """Rows ``row`` ... ``row + n - 1`` of the seeded layout noise,
        (n, D, H, W) channels_last on ``device`` (default the engine's;
        None for a noiseless model): the module docstring's contract,
        which a request's rows keep in any batch."""
        noise_dim = self.model.layout_noise_dim
        if noise_dim == 0:
            return None
        H, W = self.model.image_size
        return seeded_noise(n, (noise_dim, H, W), seed,
                            device or self.device, row=row,
                            f=self.noise_downsample,
                            dtype=self.noise_dtype or torch.float32,
                            memory_format=torch.channels_last)

    def _noise(self, noise, seed: int, N: int, row: int = 0,
               device=None) -> torch.Tensor | None:
        noise_dim = self.model.layout_noise_dim
        if noise_dim == 0:
            return None
        H, W = self.model.image_size
        if noise is None:
            out = self.draw_noise(N, seed, row, device)
        elif isinstance(noise, str):
            if noise != "zeros":
                raise ValueError(f"noise must be None, 'zeros' or an array, "
                                 f"got {noise!r}")
            out = torch.zeros((N, noise_dim, H, W), device=self.device)
        else:
            # An explicit (n, H, W, noise_dim) array, NHWC as the JAX
            # package takes it; rows beyond n (bucket padding) are zeros.
            # A tensor already on the engine's device stays there.
            if not isinstance(noise, torch.Tensor):
                noise = torch.as_tensor(np.asarray(noise, np.float32))
            arr = noise.to(self.device, torch.float32)
            if arr.shape[0] > N or arr.shape[1:] != (H, W, noise_dim):
                raise ValueError(
                    f"noise must be (n <= {N}, {H}, {W}, {noise_dim}), got "
                    f"{tuple(arr.shape)}")
            out = arr.permute(0, 3, 1, 2)
            if arr.shape[0] < N:
                out = torch.cat([out, out.new_zeros(
                    (N - arr.shape[0], noise_dim, H, W))])
        return out.contiguous(memory_format=torch.channels_last)

    # -- int8 turbo tier: calibration ---------------------------------------

    @property
    def _quantized(self) -> bool:
        return self.model_kwargs.get("crn_quant") is not None

    @property
    def _act_scales(self):
        return self.model.refinement_net.act_scales

    @property
    def calibrated(self) -> bool:
        """int8 tier only: have the activation scales been recorded?"""
        return self._act_scales.values is not None

    def _require_tier(self, what: str):
        if not self._quantized:
            raise ValueError(f"{what}() requires quantize='int8'")

    @staticmethod
    def _warn_zero_scales(scales):
        """An exactly-zero scale means the calibration data never activated
        that tensor; real traffic through it would quantize against the
        1e-30 floor and collapse to ~0.  Warn (it can be legitimate on
        untrained models whose degenerate boxes zero a tensor)."""
        zeros = sorted(k for k, v in scales.items() if float(v) == 0.0)
        if zeros:
            warnings.warn(
                "int8 calibration recorded ZERO activation scale(s) at "
                f"{zeros}: the calibration batch never activated those "
                "tensors (unrepresentative data, e.g. trivial or empty "
                "scene graphs); real traffic through them will collapse "
                "to ~0 after dequantization.  Re-run calibrate() on "
                "representative scene graphs.", stacklevel=3)

    def calibrate(self, scene_graphs, noise=None, seed: int = 0):
        """Record the int8 tier's activation scales on representative
        scene graphs, or extend them (running max) if already calibrated.
        Later out-of-range activations clip at +-127."""
        self._require_tier("calibrate")
        self.generate(scene_graphs, noise=noise, seed=seed, deprocess=False,
                      _calibrate=True)

    def quant_band(self) -> dict:
        """The tier's band (None: the model default), saved with the
        scales so that a file cannot apply to another band."""
        return {k: self.model_kwargs.get(f"crn_quant_{k}")
                for k in self._QUANT_KNOBS}

    def expected_quant_tags(self) -> list[str]:
        """The scale tags this engine's model and band record."""
        H = self.model.image_size[0]
        return self.model.refinement_net.quant_tags(H)

    def set_calibration(self, scales: dict):
        """Install {tag: float} scales after checking the tag set against
        this model and band; zero scales warn."""
        self._require_tier("set_calibration")
        expected = set(self.expected_quant_tags())
        missing = sorted(expected - set(scales))
        extra = sorted(set(scales) - expected)
        if missing or extra:
            raise ValueError(f"scale tags do not match this model/band "
                             f"(missing {missing}, unexpected {extra})")
        self._act_scales.values = {
            k: torch.tensor(float(v), dtype=torch.float32,
                            device=self.device) for k, v in scales.items()}
        self._warn_zero_scales(scales)

    def scales(self) -> dict[str, float]:
        """The calibrated scales as {tag: float} (float32 values)."""
        if not self.calibrated:
            raise ValueError(
                "engine is not calibrated: call calibrate() on "
                "representative scene graphs (or serve a batch) first")
        return {k: float(np.float32(v.item()))
                for k, v in self._act_scales.values.items()}

    def save_calibration(self, path):
        """Write the scales as JSON in the JAX package's format: the band
        and one float per tag.  Python's shortest float repr is exact for
        a float32 value, so a save / load cycle is bit-exact."""
        self._require_tier("save_calibration")
        payload = {"format": self.CALIBRATION_FORMAT,
                   "quant_band": self.quant_band(),
                   "scales": self.scales()}
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)

    def load_calibration(self, path):
        """Load scales written by ``save_calibration`` (either package),
        after checking the format, the band and the tag set; nothing
        changes if a check fails."""
        self._require_tier("load_calibration")
        with open(path) as f:
            payload = json.load(f)
        fmt = payload.get("format")
        if fmt != self.CALIBRATION_FORMAT:
            raise ValueError(
                f"{path}: not an int8 calibration file (format={fmt!r}, "
                f"expected {self.CALIBRATION_FORMAT!r})")
        band = payload.get("quant_band", {})
        mine = self.quant_band()
        if {k: band.get(k) for k in self._QUANT_KNOBS} != mine:
            raise ValueError(
                f"{path}: calibration band {band} does not match this "
                f"engine's {mine}; scales are band-specific: re-calibrate "
                "or construct the engine with matching quant_opts")
        try:
            self.set_calibration(payload.get("scales", {}))
        except ValueError as exc:
            raise ValueError(f"{path}: {exc}") from None

    @contextlib.contextmanager
    def _calibrating(self):
        """Record scales during the block: a running max over the stored
        ones (none when uncalibrated); they are kept only if the block
        ends without an error."""
        scales = self._act_scales
        before = scales.values
        scales.values, scales.calibrating = dict(before or {}), True
        try:
            yield
        except BaseException:
            scales.values = before
            raise
        finally:
            scales.calibrating = False
        self._warn_zero_scales(scales.values)

    def generate_batch(self, batch: GraphBatch, noise=None,
                       seed: int = 0, _calibrate: bool = False) -> dict:
        """Run the generator on an encoded batch.

        Args:
          noise: None (seeded, see the module docstring), 'zeros', or an
            (n, H, W, layout_noise_dim) array or tensor (n <= N; a tensor
            on the engine's device is used where it lies).

        Returns:
          dict of tensors on the device: imgs (N, 3, H, W) float32 in the
          preprocessed space, boxes (N, O, 4), masks (N, O, M, M) or None,
          rel_scores (N, T, num_preds).
        """
        N = batch.objs.shape[0]
        calibrating = self._quantized and (_calibrate or not self.calibrated)
        if self.mesh is None or calibrating:
            layout_noise = self._noise(noise, seed, N)
            # The int8 tier records its scales on the whole batch, on row
            # 0 of a mesh (whose replicas then take them).
            if self.mesh is None:
                out = self._whole_batch(batch, layout_noise, calibrating)
            else:
                out = self._workers[0].submit(
                    self._whole_batch, batch, layout_noise,
                    calibrating).result()
            return dict(zip(_OUTPUTS, out))
        self._share_scales()
        n = N // len(self.replicas)
        given = None if noise is None else self._noise(noise, seed, N)
        futures = []
        for i, (w, rep, row) in enumerate(zip(
                self._workers, self.replicas, self.mesh.devices)):
            rows = slice(i * n, (i + 1) * n)
            if noise is None:
                # Each data row draws its own rows by offset on its
                # device: the values of those rows of the whole draw.
                rows_noise = self._noise(None, seed, n, row=i * n,
                                         device=row[0])
            else:
                rows_noise = None if given is None else given[rows]
            futures.append(w.submit(self._forward, rep, row[0], batch,
                                    rows, rows_noise))
        parts = [f.result() for f in futures]
        out = [None if parts[0][k] is None else torch.cat(
            [p[k].to(self.device) for p in parts]) for k in range(4)]
        return dict(zip(_OUTPUTS, out))

    def _whole_batch(self, batch, layout_noise, calibrating):
        with (self._calibrating() if calibrating
              else contextlib.nullcontext()):
            return self._forward(self.model, self.device, batch,
                                 slice(None), layout_noise)

    @staticmethod
    def _forward(model, device, batch, rows: slice, layout_noise):
        """``model`` on ``device`` over ``rows`` of ``batch`` with those
        rows' ``layout_noise`` -> (imgs, boxes, masks, rel_scores)."""
        def dev(a, dtype):
            return torch.as_tensor(np.asarray(a)[rows]).to(device, dtype)

        noise = None if layout_noise is None else layout_noise.to(device)
        args = (dev(batch.objs, torch.long), dev(batch.triples, torch.long),
                dev(batch.obj_mask, torch.float32),
                dev(batch.triple_mask, torch.float32), noise)
        # The span holds the host's issue of the forward alone; the copies
        # above fall in the engine's own time.
        with torch.inference_mode(), full_fp32(), span("sg2im.model.forward"):
            return model(*args)

    def _share_scales(self):
        """Give every mesh replica row 0's int8 activation scales."""
        if not self._quantized:
            return
        values = self._act_scales.values
        for rep, row in zip(self.replicas[1:], self.mesh.devices[1:]):
            rep.refinement_net.act_scales.values = (
                None if values is None
                else {k: v.to(row[0]) for k, v in values.items()})

    def warmup(self, batch_sizes=(1,), scene_graph=None, seed: int = 0):
        """Run each serving path once per graph-count bucket, so that the
        first real request pays neither the kernels' nvcc build nor
        cuDNN's first calls.  cuDNN keeps its execution plans per thread:
        call this on the thread that will serve.

        A trivial scene graph (or ``scene_graph``, which sets the object
        and triple pad bucket) goes through :meth:`generate` with zero
        and, for a noisy model, seeded noise at each batch size.  int8
        tier: an uncalibrated engine also runs its calibrating forward,
        and scales recorded here are discarded, since warmup graphs are no
        representative data; a calibrated engine keeps its scales.

        Returns the padded (N, O, T) shape of each bucket.
        """
        sg = scene_graph or {"objects": [], "relationships": []}
        keep_scales = not self._quantized or self.calibrated
        noises = ("zeros", None) if self.model.layout_noise_dim else ("zeros",)
        shapes = []
        for n in batch_sizes:
            graphs = [sg] * n
            for noise in noises:
                if not keep_scales:
                    self._act_scales.values = None  # the calibrating forward
                    self.generate(graphs, noise=noise, seed=seed,
                                  deprocess=False)
                self.generate(graphs, noise=noise, seed=seed)
            batch = encode_scene_graphs(graphs, self.vocab,
                                        align=self.pad_align)
            shapes.append((self.pad_rows(n), batch.objs.shape[1],
                           batch.triples.shape[1]))
        if not keep_scales:
            self._act_scales.values = None  # the first real batch calibrates
        return shapes

    def generate(self, scene_graphs, noise=None, seed: int = 0,
                 deprocess: bool = True, _calibrate: bool = False):
        """Scene graph dict(s) -> (images, outputs).

        The batch is padded to a power-of-two bucket and the padded rows
        are dropped from the result.  ``images`` is (n, H, W, 3) uint8
        numpy when ``deprocess`` (deprocessed on the engine's device and
        fetched as uint8), else (n, H, W, 3) float32 numpy in the
        preprocessed space; ``outputs`` is :meth:`generate_batch`'s dict cut
        to the n real rows.

        While spans are on (``utils.timing``) a call records
        ``sg2im.engine.generate`` (attrs ``objects``, the real rows'
        objects with '__image__'; ``obj_slots``, rows x object slots)
        around ``sg2im.engine.encode`` (encode and pad),
        ``sg2im.model.forward`` (the forward's issue) and
        ``sg2im.engine.fetch`` (all after the forward: deprocess's issue,
        the wait for the card, wherever its first synchronisation falls,
        and the copy back).
        """
        with span("sg2im.engine.generate") as s:
            if isinstance(scene_graphs, dict):
                scene_graphs = [scene_graphs]
            n_real = len(scene_graphs)
            with span("sg2im.engine.encode"):
                batch = encode_scene_graphs(scene_graphs, self.vocab,
                                            align=self.pad_align)
                n_pad = self.pad_rows(n_real)
                if n_pad > n_real:
                    batch = batch.pad_rows(n_pad)
            out = self.generate_batch(batch, noise=noise, seed=seed,
                                      _calibrate=_calibrate)
            with span("sg2im.engine.fetch"):
                out = {k: (None if v is None else v[:n_real])
                       for k, v in out.items()}
                imgs = out["imgs"].permute(0, 2, 3, 1)
                imgs = imagenet_deprocess_batch_torch(imgs) if deprocess \
                    else imgs.float()
                imgs = imgs.contiguous().cpu().numpy()
            if s:
                s.attrs.update(objects=int(batch.obj_mask[:n_real].sum()),
                               obj_slots=batch.objs.size)
        return imgs, out
