"""The device mesh, the process group of a data-parallel run and the
tensor-parallel rule (counterpart of ``sg2im_tpu/parallel/mesh.py``).

The JAX package's mesh is a ``('data', 'model')`` grid of devices that
GSPMD shards one program over.  Here:

- training is data parallel across processes, one rank per card: each
  rank loads its own slice of the global batch (``PaddedLoader(shard=...)``
  or :func:`shard_batch`), and the step sums its batch statistics, loss
  denominators and gradients across the ranks (``parallel.collectives``),
  which gives the one-process step on the global batch;
- serving runs a :class:`Mesh` in one process: each data row of the mesh
  holds a replica of the generator on its own worker thread, and with
  tensor parallelism the GCN's hidden dimension is split over the row's
  model column (``InferenceEngine(mesh=..., tensor_parallel=True)``).
"""

from __future__ import annotations

import copy
import dataclasses
import datetime
import os
import re
import socket
import time

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from sg2im_tpu_torch.parallel import collectives

DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, model) grid of ``torch.device``s: ``devices[i][j]`` is the
    device of data row i, model column j."""

    devices: tuple

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "model": len(self.devices[0])}


def make_mesh(n_data: int | None = None, n_model: int = 1,
              devices=None) -> Mesh:
    """A (data, model) mesh over ``devices`` (default: every visible CUDA
    card), row-major; the same device may appear more than once."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_model < 1:
        raise ValueError(f"n_model must be >= 1, got {n_model}")
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data < 1 or n_data * n_model > len(devices):
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs "
                         f"{max(n_data, 1) * n_model} devices, have "
                         f"{len(devices)}")
    return Mesh(tuple(tuple(devices[i * n_model:(i + 1) * n_model])
                      for i in range(n_data)))


def _timeout(seconds):
    return datetime.timedelta(
        seconds=DEFAULT_TIMEOUT_S if seconds is None else seconds)


def launch_config() -> dict | None:
    """The process group the environment describes: torchrun's ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``, or
    the JAX package's manual ``SG2IM_COORDINATOR`` (host:port),
    ``SG2IM_NUM_PROCESSES``, ``SG2IM_PROCESS_ID``.  None when neither is
    set; raises when one is set only in part."""
    env = os.environ
    if env.get("SG2IM_COORDINATOR"):
        names = ("SG2IM_NUM_PROCESSES", "SG2IM_PROCESS_ID")
        missing = [k for k in names if not env.get(k)]
        if missing:
            raise RuntimeError(f"multihost: SG2IM_COORDINATOR is set but "
                               f"{missing} are not")
        host, _, port = env["SG2IM_COORDINATOR"].rpartition(":")
        rank = int(env["SG2IM_PROCESS_ID"])
        return {"addr": host, "port": int(port), "rank": rank,
                "world": int(env["SG2IM_NUM_PROCESSES"]),
                "local_rank": int(env.get("LOCAL_RANK", rank))}
    names = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
    given = [k for k in names if env.get(k)]
    if not given:
        return None
    if len(given) < len(names):
        raise RuntimeError(
            f"multihost: {given} are set but "
            f"{[k for k in names if k not in given]} are not")
    return {"addr": env["MASTER_ADDR"], "port": int(env["MASTER_PORT"]),
            "rank": int(env["RANK"]), "world": int(env["WORLD_SIZE"]),
            "local_rank": int(env.get("LOCAL_RANK", env["RANK"]))}


def init_process_group(backend: str, addr: str, port: int, rank: int,
                       world: int, timeout_s: float | None = None):
    """``torch.distributed.init_process_group`` over TCP; a failure raises
    (RuntimeError), never degrades to independent runs."""
    try:
        dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                                rank=rank, world_size=world,
                                timeout=_timeout(timeout_s))
    except Exception as e:  # noqa: BLE001 — re-raised with the context
        raise RuntimeError(
            f"multihost: rank {rank} of {world} could not join the "
            f"{backend} group at {addr}:{port}") from e


def init_multihost(backend: str = "gloo",
                   timeout_s: float | None = None) -> tuple[int, int]:
    """Join the process group the environment describes (see
    :func:`launch_config`) -> ``(rank, world)``; feed them to
    ``PaddedLoader(shard=...)``.

    Idempotent: with a group already initialised it returns that group's.
    With nothing configured it runs one process and says so.  With a group
    configured, a failure to join raises: N independent runs, each on the
    full dataset, would be the worst way to fail."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    cfg = launch_config()
    if cfg is None:
        print("multihost: running single-process (no RANK / WORLD_SIZE / "
              "MASTER_ADDR / MASTER_PORT or SG2IM_COORDINATOR set)")
        return 0, 1
    init_process_group(backend, cfg["addr"], cfg["port"], cfg["rank"],
                       cfg["world"], timeout_s)
    return dist.get_rank(), dist.get_world_size()


def local_rank() -> int:
    """This process's card index on its host (0 without a launcher)."""
    cfg = launch_config()
    return 0 if cfg is None else cfg["local_rank"]


def free_port() -> int:
    """A TCP port on localhost that no socket holds now, for a group's
    rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(target, args_of_rank, world: int,
                timeout_s: float | None):
    """Start ``world`` spawned processes running ``target(*args_of_rank(r))``
    and wait for all of them.  A rank that fails ends the run at once (the
    others would wait in their next collective until the group's timeout),
    and so does ``timeout_s`` (None: no limit); no process is left
    running, and a failure raises."""
    from multiprocessing.connection import wait

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=args_of_rank(r), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                break
            wait([p.sentinel for p in procs if p.is_alive()],
                 timeout=left if left is not None else 5.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise RuntimeError(f"ranks exited with {codes} (negative: killed, "
                           f"after one failed or after {timeout_s} s)")


def shard_batch(batch: dict, rank: int, world: int) -> dict:
    """Rows ``[rank * n, (rank + 1) * n)`` of every array of ``batch``, n =
    rows / world: this rank's slice of a global batch (numpy or tensors;
    None stays None)."""
    def rows(v):
        if v is None:
            return None
        N = v.shape[0]
        if N % world:
            raise ValueError(f"a batch of {N} rows does not split over "
                             f"{world} ranks")
        n = N // world
        return v[rank * n:(rank + 1) * n]

    return {k: rows(v) for k, v in batch.items()}


def replicate_tensors(tensors: dict, pg=None, src: int = 0) -> dict:
    """Every tensor of ``tensors`` as rank ``src`` of ``pg`` holds it (the
    default group when one is initialised; the identity without one): one
    broadcast per dtype, of the tensors flattened together on the first
    tensor's device (a CPU tensor, such as a generator state, travels on
    it and comes back)."""
    if pg is None:
        if not dist.is_initialized():
            return dict(tensors)
        pg = dist.group.WORLD
    names = [k for k, v in tensors.items() if v is not None]
    if not names:
        return dict(tensors)
    device = next((tensors[k].device for k in names
                   if tensors[k].device.type != "cpu"),
                  tensors[names[0]].device)
    if dist.get_backend(pg) == "nccl" and device.type == "cpu":
        device = torch.device("cuda", torch.cuda.current_device())
    out = dict(tensors)
    for dtype in sorted({tensors[k].dtype for k in names}, key=str):
        group_names = [k for k in names if tensors[k].dtype == dtype]
        # uint32 (a threefry key) travels as int32: the backends have no
        # unsigned 32-bit type.
        wire = torch.int32 if dtype == torch.uint32 else dtype
        flat = torch.cat([tensors[k].detach().reshape(-1).view(wire).to(
            device) for k in group_names])
        collectives.broadcast(flat, pg, src)
        i = 0
        for k in group_names:
            t = tensors[k]
            out[k] = flat[i:i + t.numel()].view(dtype).reshape(t.shape).to(
                t.device).clone()
            i += t.numel()
    return out


def replicate_state(state, pg=None, src: int = 0):
    """A train state (or a dict of tensors) as rank ``src`` holds it."""
    from sg2im_tpu_torch.train.state import TrainState, from_tensors, tensors

    if isinstance(state, TrainState):
        return from_tensors(replicate_tensors(tensors(state), pg, src))
    return replicate_tensors(state, pg, src)


def replicate_host_array(x, pg=None, src: int = 0) -> torch.Tensor:
    """Host data that every rank must hold alike (noise from a step-derived
    seed, say), as rank ``src`` holds it."""
    t = torch.as_tensor(x)
    return replicate_tensors({"x": t}, pg, src)["x"]


# -- tensor parallelism of the GCN -------------------------------------------

_GCN_MLP = re.compile(r"(^|\.)(gconv|gconv_net\.gconvs\.\d+)\.net[12]\.(\d+)\."
                      r"(weight|bias|running_mean|running_var)$")


def tp_generator_sharding(mesh: Mesh, state_dict: dict) -> dict:
    """{name: the dim split over the mesh's model column, or None} for a
    generator state dict: the JAX package's rule in upstream's names.  The
    GCN triple MLP (``net1``) and node MLP (``net2``) of every
    ``gconv`` / ``gconv_net.gconvs.{k}`` split their HIDDEN dimension,
    Megatron style: the first Linear column-parallel (its weight's output
    rows and its bias), the second row-parallel (its weight's input
    columns); the partial outputs of the second are summed.  A BatchNorm
    between the two (``mlp_normalization='batch'``) splits its channels
    with the first Linear's outputs.  Everything else is replicated; a
    dimension that does not divide by the column's size stays whole (and
    so does the whole MLP).  With one model column nothing splits."""
    n = mesh.shape["model"]
    out = {k: None for k in state_dict}
    if n == 1:
        return out
    mlps: dict = {}
    for k in state_dict:
        m = _GCN_MLP.search(k)
        if m:
            prefix = k[:m.start(3)]
            mlps.setdefault(prefix, set()).add(int(m.group(3)))
    for prefix, idx in mlps.items():
        lin = sorted(i for i in idx if prefix + f"{i}.weight" in state_dict
                     and state_dict[prefix + f"{i}.weight"].ndim == 2)
        if len(lin) != 2:
            continue
        first, second = lin
        H = state_dict[prefix + f"{first}.weight"].shape[0]
        if H % n:
            continue
        for i in idx:
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                name = prefix + f"{i}.{leaf}"
                if name not in state_dict:
                    continue
                if first <= i < second:
                    out[name] = 0
                elif i == second and leaf == "weight":
                    out[name] = 1
    return out


def shard_generator_tp(state_dict: dict, mesh: Mesh, row: int = 0) -> list:
    """The generator state of data row ``row`` under the rule above: one
    dict per model column j, on device ``mesh.devices[row][j]``, holding
    column j's slice of each split tensor; column 0 also holds every
    replicated tensor."""
    spec = tp_generator_sharding(mesh, state_dict)
    cols = mesh.devices[row]
    n = len(cols)
    out = [{} for _ in cols]
    for k, v in state_dict.items():
        d = spec[k]
        if d is None:
            out[0][k] = v.to(cols[0])
            continue
        for j, part in enumerate(torch.chunk(v, n, dim=d)):
            out[j][k] = part.contiguous().to(cols[j])
    return out


class TensorParallelMLP(nn.Module):
    """A GCN MLP (Linear, [BatchNorm], ReLU, Linear, [BatchNorm], ReLU)
    with its hidden dimension split over ``devices`` by the rule of
    :func:`tp_generator_sharding`: column j holds its slice of the first
    Linear (and of a BatchNorm between), runs up to the second Linear's
    partial product without bias on ``devices[j]``, and the partial
    products are summed on ``devices[0]``, which adds the second Linear's
    bias and runs the layers after it.  ``parts``: one state dict per
    column, ``shard_generator_tp``'s, holding the tensors under
    ``prefix``."""

    def __init__(self, mlp: nn.Sequential, prefix: str, parts: list,
                 devices):
        super().__init__()
        lin = [i for i, m in enumerate(mlp) if isinstance(m, nn.Linear)]
        self.first, self.second = lin
        self.devices = [torch.device(d) for d in devices]
        self.cols = nn.ModuleList()
        self.weights2 = []
        for j, dev in enumerate(self.devices):
            layers = []
            for i in range(self.first, self.second):
                m = copy.deepcopy(mlp[i])
                own = {k[len(prefix) + len(f"{i}."):]: v
                       for k, v in parts[j].items()
                       if k.startswith(prefix + f"{i}.")}
                if isinstance(m, nn.Linear):
                    m = nn.Linear(m.in_features, own["weight"].shape[0])
                elif hasattr(m, "weight"):
                    m = type(m)(own["weight"].shape[0])
                if own:
                    m.load_state_dict(own, strict=True)
                layers.append(m.to(dev).eval())
            self.cols.append(nn.Sequential(*layers))
            self.weights2.append(parts[j][prefix + f"{self.second}.weight"])
        self.bias2 = parts[0][prefix + f"{self.second}.bias"]
        # The layers after the second Linear are replicated: the MLP's own.
        self.tail = nn.Sequential(*[copy.deepcopy(m).to(self.devices[0])
                                    for m in list(mlp)[self.second + 1:]])

    def forward(self, x, mask=None):
        from sg2im_tpu_torch.nn.layers import run_masked

        out = None
        for col, w2, dev in zip(self.cols, self.weights2, self.devices):
            p = F.linear(col(x.to(dev)), w2).to(self.devices[0])
            out = p if out is None else out + p
        return run_masked(self.tail, out + self.bias2, mask)


def apply_tensor_parallel(model: nn.Module, mesh: Mesh, row: int = 0):
    """Replace every GCN MLP of ``model`` (a generator on
    ``mesh.devices[row][0]``) that :func:`tp_generator_sharding` splits by
    a :class:`TensorParallelMLP` over the row's devices; returns the
    number replaced."""
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    spec = tp_generator_sharding(mesh, sd)
    parts = shard_generator_tp(sd, mesh, row)
    done = 0
    for name, module in list(model.named_modules()):
        for net in ("net1", "net2"):
            mlp = getattr(module, net, None)
            prefix = f"{name}.{net}." if name else f"{net}."
            if not isinstance(mlp, nn.Sequential) or not any(
                    spec.get(k) is not None for k in sd
                    if k.startswith(prefix)):
                continue
            setattr(module, net, TensorParallelMLP(mlp, prefix, parts,
                                                   mesh.devices[row]))
            done += 1
    return done
