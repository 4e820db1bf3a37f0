"""The device mesh and the DiT's parameter placements (counterpart of
maa3_tpu/parallel/mesh.py).

One process drives one GPU (torchrun's model, where JAX drives every local
device from one process per host). `init_distributed` starts the process
group from the launcher's environment: NCCL on CUDA, gloo on the CPU.
`make_mesh` arranges the ranks as JAX reshapes devices, (n_data, n_model)
with "model" innermost, in a `DeviceMesh` with the dims ("data", "model"),
and exposes each dim's process group. A mesh the world cannot hold raises;
nothing falls back to one device.

Placements are tuples with one entry per tensor dim: None, "model" or
"data" (JAX's PartitionSpec, in the port's layouts). The port's matmul
weights are nn.Linear's (out, in), so a column-parallel weight shards dim 0
and a row-parallel one dim 1; the blocks are a ModuleList, so there is no
stacked depth axis. `dit_param_specs` gives the Megatron placements,
`add_fsdp_specs` adds ZeRO-3's data dim, and `shard_tensor` /
`gather_tensor` move a tensor between its full and its local form.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import re
from typing import Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist

Spec = Tuple[Optional[str], ...]

# column-parallel (output dim sharded) and row-parallel (input dim sharded)
# weights, by name (maa3_tpu/parallel/mesh.py:86-87); wqkv / w13 are the
# fused layouts, whose rank-local shards parallel/tp.py builds part by part
COL = ("wq", "wk", "wv", "wk_y", "wv_y", "w1", "w3", "wqkv", "w13")
ROW = ("wo", "w2")
BIG_LEAF = 1_000_000


# -- the process group -------------------------------------------------------------

def launched() -> bool:
    """True under a launcher that set the process group's environment
    (torchrun: RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                         "MASTER_PORT"))


def init_distributed(device: str = "cuda", multihost: bool = False) -> torch.device:
    """Start the process group from torchrun's environment when it is set
    (NCCL on CUDA, gloo on the CPU) and return this rank's device: cuda:<
    LOCAL_RANK> on CUDA. Without that environment, one process and no
    group; multihost then raises. A world spanning more than one node
    (LOCAL_WORLD_SIZE < WORLD_SIZE) needs multihost, as JAX's CLI needs
    --multihost to call jax.distributed.initialize()."""
    dev = torch.device(device)
    if not launched():
        if multihost:
            raise RuntimeError("--multihost initialises from the launcher's "
                               "environment (RANK, WORLD_SIZE, MASTER_ADDR, "
                               "MASTER_PORT): launch with torchrun")
        return dev
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if local < world and not multihost:
        raise RuntimeError(f"the world of {world} ranks spans {world // local} nodes: "
                           "pass --multihost")
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kw = {"device_id": dev} if dev.type == "cuda" else {}
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", **kw)
    if multihost:
        print(f"multihost: process {dist.get_rank()}/{dist.get_world_size()}", flush=True)
    return dev


@contextlib.contextmanager
def distributed(device: str = "cuda", multihost: bool = False):
    """init_distributed for the span of a CLI: yields this rank's device and
    destroys the process group it started."""
    started = launched() and not dist.is_initialized()
    dev = init_distributed(device, multihost)
    try:
        yield dev
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def control_group(timeout_s: float = 7 * 24 * 3600.0):
    """A gloo group over every rank for host messages (the server's lockstep
    broadcasts), with a long timeout: an idle server waits in it."""
    return dist.new_group(backend="gloo",
                          timeout=datetime.timedelta(seconds=timeout_s))


# -- the mesh ----------------------------------------------------------------------

@dataclasses.dataclass
class Mesh:
    """(n_data, n_model) ranks, "model" innermost; this rank's coordinate
    and each dim's process group (None on a 1 x 1 mesh without a process
    group). n_nodes: the nodes the data dim spans (torchrun's
    WORLD_SIZE / LOCAL_WORLD_SIZE)."""
    n_data: int = 1
    n_model: int = 1
    data_rank: int = 0
    model_rank: int = 0
    data_group: Optional[object] = None
    model_group: Optional[object] = None
    device_mesh: Optional[object] = None
    n_nodes: int = 1
    dim_names: Tuple[str, ...] = ("data", "model")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}

    def size(self, axis: str) -> int:
        return self.n_data if axis == "data" else self.n_model

    def coord(self, axis: str) -> int:
        return self.data_rank if axis == "data" else self.model_rank

    def group(self, axis: str):
        return self.data_group if axis == "data" else self.model_group

    @property
    def data_per_node(self) -> int:
        return self.n_data // self.n_nodes


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The ("data", "model") mesh over the process group's ranks, rank r at
    (r // n_model, r % n_model) as JAX's make_mesh reshapes devices
    (maa3_tpu/parallel/mesh.py:29). n_data defaults to world / n_model.
    Without a process group only the 1 x 1 mesh exists. Raises ValueError
    for a shape the world cannot hold."""
    if n_model < 1 or (n_data is not None and n_data < 1):
        raise ValueError(f"mesh {n_data} x {n_model}: sizes must be positive")
    if not dist.is_initialized():
        if n_model != 1 or (n_data or 1) != 1:
            raise ValueError(
                f"n_model={n_model}: a {n_data or '?'} x {n_model} mesh needs "
                f"{(n_data or 1) * n_model} ranks, and no process group is "
                "initialised (launch with torchrun --nproc_per_node N)")
        return Mesh()
    world = dist.get_world_size()
    if world % n_model:
        raise ValueError(f"n_model={n_model} does not divide the world size {world}")
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data} x {n_model} != {world} ranks")
    from torch.distributed.device_mesh import init_device_mesh
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=("data", "model"))
    d, m = dm.get_coordinate()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    n_nodes = max(1, world // local)
    if n_data % n_nodes or local % n_model:
        raise ValueError(f"mesh {n_data} x {n_model} over {n_nodes} nodes of {local} "
                         "ranks: the model dim must lie within a node")
    return Mesh(n_data, n_model, d, m, dm.get_group("data"), dm.get_group("model"),
                dm, n_nodes)


# -- the DiT's placements -------------------------------------------------------------

def _names(name: str):
    return name.split(".")


def _spec_for(name: str, shape: Tuple[int, ...], check_coverage: bool) -> Spec:
    comps = _names(name)
    nd = len(shape)
    rep: Spec = (None,) * nd
    if "blocks" not in comps:
        return rep
    col = any(n in comps for n in COL)
    row = any(n in comps for n in ROW)

    def at(dim: int) -> Spec:
        return tuple("model" if i == dim else None for i in range(nd))

    if comps[-1] in ("w_scale", "w_q") and (col or row):
        # int8 weights (ops/quant.py): w_q (out, in) / grouped (G, out, gs),
        # w_scale (out,) / grouped (G, out); the scale follows the output
        # dim (mesh.py:96-102); a grouped row weight shards its groups
        grouped = nd == (3 if comps[-1] == "w_q" else 2)
        if col:
            return at(1 if grouped else 0)
        if grouped:
            return at(0)
        return at(1) if comps[-1] == "w_q" else rep
    if col:
        return at(0)
    if row:
        return at(1)
    if "gate" in comps:
        return at(0)                          # per-head gate (n_heads,)
    if "adaLN_modulation" in comps:
        # replicated on purpose (mesh.py:111-115): its (B, 6H) output
        # modulates replicated activations; sharding it would gather per block
        return rep
    numel = 1
    for s in shape:
        numel *= s
    if check_coverage and nd >= 2 and numel > BIG_LEAF:
        raise ValueError(f"dit_param_specs: unrecognized large block leaf {name} "
                         f"{tuple(shape)} would be silently replicated - extend "
                         "the sharding rules")
    return rep


def dit_param_specs(tensors: Dict[str, torch.Tensor],
                    check_coverage: bool = True) -> Dict[str, Spec]:
    """The tensor-parallel placement of every named tensor of a DiT or MoEDiT
    (its named_parameters(), state_dict() or the int8 buffers): COL weights
    shard their output dim, ROW weights their input dim, the per-head gate
    its heads; adaLN, norms, embedders and the final layer are replicated.
    A block tensor of 2 or more dims and more than 1 M elements that no rule
    names raises (maa3_tpu/parallel/mesh.py:70-123)."""
    return {n: _spec_for(n, tuple(t.shape), check_coverage) for n, t in tensors.items()}


_BLOCK = re.compile(r"(^|\.)blocks\.(\d+)\.")


def add_fsdp_specs(tensors: Dict[str, torch.Tensor], specs: Dict[str, Spec],
                   n_fsdp: int, axis: str = "data", min_size: int = 65536) -> Dict[str, Spec]:
    """ZeRO-3 placements (maa3_tpu/parallel/mesh.py:176-206): each leaf of at
    least min_size elements gets one more dim sharded over `axis`, the
    largest not-yet-sharded dim that n_fsdp divides, the first of equals in
    JAX's dim order (a port weight is JAX's transposed, so its dims are
    taken last first). JAX's leaves stack the blocks over depth, so a block
    tensor counts depth times its size against min_size, as its stacked
    leaf does (the depth axis is never the largest divisible dim of the
    configs' leaves)."""
    depth = len({m.group(2) for n in tensors for m in [_BLOCK.search(n)] if m})
    out = {}
    for name, t in tensors.items():
        spec = tuple(specs[name]) + (None,) * (t.dim() - len(specs[name]))
        size = t.numel() * (depth if _BLOCK.search(name) else 1)
        cands = [d for d in reversed(range(t.dim()))
                 if spec[d] is None and t.shape[d] % n_fsdp == 0]
        if size < min_size or not cands:
            out[name] = tuple(specs[name])
            continue
        d = max(cands, key=lambda i: t.shape[i])
        out[name] = tuple(axis if i == d else s for i, s in enumerate(spec))
    return out


def spec_dim(spec: Spec, axis: str) -> Optional[int]:
    """The dim a placement shards over `axis`, or None."""
    return next((i for i, s in enumerate(spec) if s == axis), None)


# -- full and local tensors ------------------------------------------------------------

def local_slice(t: torch.Tensor, dim: int, index: int, n: int) -> torch.Tensor:
    """Shard `index` of n equal shards of t along dim (a view)."""
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} is not divisible into {n} shards")
    k = t.shape[dim] // n
    return t.narrow(dim, index * k, k)


def all_gather_dim(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The n ranks' shards of `group` concatenated along dim."""
    if n == 1:
        return t
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


def shard_tensor(t: torch.Tensor, spec: Spec, mesh: Mesh,
                 axes: Iterable[str] = ("model", "data")) -> torch.Tensor:
    """This rank's shard of the full tensor t under spec (over `axes`), a
    contiguous copy."""
    for axis in axes:
        d = spec_dim(spec, axis)
        if d is not None and mesh.size(axis) > 1:
            t = local_slice(t, d, mesh.coord(axis), mesh.size(axis))
    return t.contiguous()


def gather_tensor(t: torch.Tensor, spec: Spec, mesh: Mesh,
                  axes: Iterable[str] = ("data", "model")) -> torch.Tensor:
    """The full tensor from every rank's shard t under spec (a collective:
    every rank of the groups calls it)."""
    for axis in axes:
        d = spec_dim(spec, axis)
        if d is not None and mesh.size(axis) > 1:
            t = all_gather_dim(t, d, mesh.group(axis), mesh.size(axis))
    return t


@torch.no_grad()
def shard_params_(module: torch.nn.Module, specs: Dict[str, Spec], mesh: Mesh,
                  axes: Iterable[str] = ("model",)) -> torch.nn.Module:
    """Turn module's parameters, in place, into this rank's shards under
    specs (keyed by parameter name) over `axes`; the Parameter objects stay
    (maa3_tpu/parallel/mesh.py:126 shard_params)."""
    axes = tuple(axes)
    for name, p in module.named_parameters():
        if any(spec_dim(specs[name], a) is not None and mesh.size(a) > 1 for a in axes):
            p.data = shard_tensor(p.data, specs[name], mesh, axes)
    return module
