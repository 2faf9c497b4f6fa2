"""Device meshes over the process group, and the FSDP and TP splits of a model.

Port of unit_tpu/parallel/mesh.py.  unit_tpu jits one program over a mesh
of devices and lets GSPMD place the collectives; the port runs one process
a rank and splits the model's parameters explicitly:

  * ``make_mesh(n)``: a 1-D ``DeviceMesh`` ("data",) over the n ranks of the
    process group; ``make_mesh_tp(n_data, n_model)``: ("data", "model"), rank
    r at (r // n_model, r % n_model), so the model ranks of one data rank
    are neighbours (``comm.data_rank(n_model)`` is r // n_model);
    ``make_mesh_pp(n_data, n_stage)``: ("data", "stage") for pipeline
    parallelism, rank r at (r // n_stage, r % n_stage), unit_tpu's
    ``make_mesh_pp`` reshape (mesh.py:177-184).  Each rank holds the whole
    model: the pipeline step (``engine.train.make_pipeline_train_step``)
    splits the work, not the parameters.  ``make_mesh_2d(n_data,
    n_spatial)``: ("data", "spatial"), rank r at (r // n_spatial, r %
    n_spatial); ``shard_batch_spatial`` gives a rank its data rank's rows
    and its band of the image rows, and the train step runs the backbone
    on the bands (``parallel.spatial``).
  * FSDP (``fsdp_shard``): FSDP2's ``fully_shard`` on each bottleneck block,
    each box head, the RPN head, the supervised predictor, the mask head
    and the root, ``reshard_after_forward=True``: the per-layer all-gather
    before each use and the gradient reduce-scatter of unit_tpu's FSDP
    (mesh.py:70-110).  ``fsdp_sharding`` is unit_tpu's rule, in the torch
    layout: each leaf of at least 2**14 elements is split on its largest
    dim the ranks divide (in the flax layout; ties to the first), the
    others stay whole (``ignored_params``: the train step all-reduces their
    gradients).  The weak detector and the visual attention head stay in
    the root's unit: their methods other than ``forward`` and the direct
    reads of their weights run inside the root's forward (``train_losses``,
    registered as one), where the root's parameters are whole.  No
    mixed-precision policy: the parameters and the momentum stay f32, and
    the convolutions cast inside ``Conv2d.forward`` as in one process.
  * TP (``tp_shard``): unit_tpu's rule (``tp_sharding``, mesh.py:136-156):
    every convolution (``models.resnet.Conv2d``), dense layer
    (``models.box_heads.Linear``) and the mask head's ``Deconv2d`` whose
    output channels are >= 256 and divisible by the model ranks becomes its
    column-parallel form (``parallel.tensor``).  unit_tpu also splits the
    2-D ``embeddings`` leaf [80, 300]; the port keeps that buffer whole
    (the numbers do not depend on it).

Both splits start from rank 0's parameters (broadcast first).  Over gloo
(ranks that share a card: NCCL refuses two ranks on one device) every
collective here, FSDP2's own asynchronous all-gathers and reduce-scatters
included, runs on the CUDA tensors as they are: gloo stages them through
the host itself (PyTorch 2.11 on the H100; nothing needs a route of its
own).

``full_tensor`` / ``full_shape`` / ``load_full_`` move a parameter, buffer
or momentum between its split and its whole form, so that checkpoints and
warm starts are one format for every topology.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
from torch.distributed.tensor import DTensor, Shard

from . import comm

DATA_AXIS = "data"
MODEL_AXIS = "model"
STAGE_AXIS = "stage"
SPATIAL_AXIS = "spatial"
FSDP_MIN_SHARD_ELEMS = 2 ** 14
TP_MIN_CHANNELS = 256


def _device_mesh(shape, names, device_type: str):
    from torch.distributed.device_mesh import DeviceMesh

    n = int(np.prod(shape))
    if comm.world() != n:
        raise ValueError(f"a mesh of {shape} needs {n} ranks; the process group has "
                         f"{comm.world()}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=names)


def make_mesh(n: Optional[int] = None, device_type: str = "cuda"):
    """The 1-D ("data",) mesh over the ``n`` ranks (default: all) of the
    process group; the world is its data group."""
    return _device_mesh((n or comm.world(),), (DATA_AXIS,), device_type)


def make_mesh_tp(n_data: int, n_model: int, device_type: str = "cuda"):
    """The (data, model) mesh: rank r at (r // n_model, r % n_model), so
    ``comm.data_rank(n_model)`` is its data coordinate."""
    return _device_mesh((n_data, n_model), (DATA_AXIS, MODEL_AXIS), device_type)


def make_mesh_pp(n_data: int, n_stage: int, device_type: str = "cuda"):
    """The (data, stage) mesh: rank r at (r // n_stage, r % n_stage), so the
    stage ranks of one data rank are neighbours and ``comm.data_rank(n_stage)``
    is its data coordinate; ``mesh.get_group("stage")`` / ``("data")`` are
    this rank's stage and data groups."""
    return _device_mesh((n_data, n_stage), (DATA_AXIS, STAGE_AXIS), device_type)


def make_mesh_2d(n_data: int, n_spatial: int, device_type: str = "cuda"):
    """The (data, spatial) mesh: rank r at (r // n_spatial, r % n_spatial),
    so the spatial ranks of one data rank are neighbours, each holding a
    band of the canvas rows (``parallel.spatial``), and
    ``comm.data_rank(n_spatial)`` is its data coordinate."""
    return _device_mesh((n_data, n_spatial), (DATA_AXIS, SPATIAL_AXIS), device_type)


def shard_batch_spatial(mesh, batch):
    """This rank's part of a global batch dict (unit_tpu mesh.py:203-220):
    its data rank's rows of every array and, for the key ``image`` alone,
    its band of the canvas rows (``spatial.band_rows``: the height must
    split evenly at stride 16).  Keyed on the name, not on the rank: other
    4-D arrays (``gt_masks`` [B, G, m, m]) carry no image rows in dim 1 and
    stay whole.  Numpy arrays or tensors; other values as they are."""
    from . import spatial

    n_data, n_spatial = axis_size(mesh, DATA_AXIS), axis_size(mesh, SPATIAL_AXIS)
    d, s = mesh.get_local_rank(DATA_AXIS), mesh.get_local_rank(SPATIAL_AXIS)

    def part(key, x):
        if not hasattr(x, "shape") or len(x.shape) == 0:
            return x
        if x.shape[0] % n_data:
            raise ValueError(f"{key}: a batch of {x.shape[0]} does not split over "
                             f"{n_data} data ranks")
        n = x.shape[0] // n_data
        x = x[d * n:(d + 1) * n]
        if key == "image":
            start, stop = spatial.band_rows(x.shape[1], n_spatial, s)
            x = x[:, start:stop]
        return x

    return {k: part(k, v) for k, v in batch.items()}


def axis_size(mesh, axis: str) -> int:
    """The ranks along ``axis`` of ``mesh`` (1 where it has no such axis)."""
    names = mesh.mesh_dim_names or ()
    return int(mesh.size(names.index(axis))) if axis in names else 1


# ------------------------------------------------------------------- layouts
def _flax_to_torch_dims(name: str, t: torch.Tensor) -> list:
    """torch dim of each flax-layout dim of parameter ``name``."""
    from ..checkpoint.jax_params import _transposed

    if t.dim() == 4:
        return [2, 3, 0, 1] if _transposed(name) else [2, 3, 1, 0]  # HWIO
    if t.dim() == 2:
        return [1, 0]  # [in, out]
    return list(range(t.dim()))


def fsdp_sharding(model: nn.Module, n: int,
                  min_shard_elems: int = FSDP_MIN_SHARD_ELEMS) -> Dict[str, Optional[int]]:
    """{parameter name: the torch dim split over the ``n`` data ranks, or
    None (whole)}: unit_tpu's ``fsdp_sharding``, whose dims are the flax
    layout's, mapped to the torch layout."""
    out: Dict[str, Optional[int]] = {}
    for name, p in model.named_parameters():
        out[name] = None
        if p.numel() < min_shard_elems:
            continue
        dims = _flax_to_torch_dims(name, p)
        flax_shape = [p.shape[d] for d in dims]
        for i in sorted(range(len(flax_shape)), key=lambda i: -flax_shape[i]):
            if flax_shape[i] % n == 0 and flax_shape[i] >= n:
                out[name] = dims[i]
                break
    return out


def tp_sharding(model: nn.Module, n_model: int,
                min_channels: int = TP_MIN_CHANNELS) -> Dict[str, int]:
    """{parameter name: torch dim split over the ``n_model`` model ranks} of
    the layers ``tp_shard`` splits: unit_tpu's rule (output channels >=
    ``min_channels`` and divisible), each kernel with its bias."""
    from .tensor import COLUMN_PARALLEL

    out: Dict[str, int] = {}
    if n_model <= 1:
        return out
    for name, module in model.named_modules():
        if type(module) not in COLUMN_PARALLEL:
            continue
        dim = COLUMN_PARALLEL[type(module)].weight_dim
        channels = module.weight.shape[dim]
        if channels >= min_channels and channels % n_model == 0:
            prefix = f"{name}." if name else ""
            out[prefix + "weight"] = dim
            if module.bias is not None:
                out[prefix + "bias"] = 0
    return out


# ---------------------------------------------------------------------- FSDP
def _fsdp_units(model: nn.Module):
    from ..models.resnet import BottleneckBlock

    units = [m for m in model.modules() if isinstance(m, BottleneckBlock)]
    for name in ("box_head", "weak_box_head", "rpn_head", "supervised", "mask_head"):
        if getattr(model, name, None) is not None:
            units.append(getattr(model, name))
    return units


def fsdp_shard(model: nn.Module, mesh) -> nn.Module:
    """Split ``model`` (on its device) over the ("data",) ``mesh`` with FSDP2,
    in place, from rank 0's parameters; returns it.  Build its solver after."""
    comm.broadcast_module(model)
    plan = fsdp_sharding(model, axis_size(mesh, DATA_AXIS))
    dims = {p: plan[name] for name, p in model.named_parameters()}
    whole = {p for p, dim in dims.items() if dim is None}

    def placement(p):
        return Shard(dims[p])

    for unit in _fsdp_units(model) + [model]:
        fully_shard(unit, mesh=mesh, reshard_after_forward=True,
                    shard_placement_fn=placement, ignored_params=whole)
    register_fsdp_forward_method(model, "train_losses")
    return model


# ------------------------------------------------------------------------ TP
def tp_shard(model: nn.Module, mesh) -> nn.Module:
    """Split ``model`` (on its device) over the "model" dim of ``mesh``, in
    place, from rank 0's parameters: each layer of ``tp_sharding`` becomes
    its column-parallel form.  Returns it; build its solver after."""
    from .tensor import COLUMN_PARALLEL

    comm.broadcast_module(model)
    plan = tp_sharding(model, axis_size(mesh, MODEL_AXIS))
    group = mesh.get_group(MODEL_AXIS)
    for name, module in list(model.named_modules()):
        if f"{name}.weight" in plan:
            parent_name, _, attr = name.rpartition(".")
            parent = model.get_submodule(parent_name)
            setattr(parent, attr, COLUMN_PARALLEL[type(module)](module, group))
    return model


# ------------------------------------------------------- whole <-> split forms
def is_sharded(model: nn.Module) -> bool:
    """Whether any parameter of ``model`` is split (FSDP or TP)."""
    return any(comm.is_split(p) for p in model.parameters())


def full_shape(t: torch.Tensor) -> tuple:
    """The shape of the whole tensor ``t`` is a part of."""
    if hasattr(t, "tp_shard"):
        dim, _, ranks = t.tp_shard
        shape = list(t.shape)
        shape[dim] *= ranks
        return tuple(shape)
    return tuple(t.shape)  # a DTensor reports its global shape


def full_tensor(t: torch.Tensor, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's part (a collective for a
    split one: every rank of its group calls it), detached; ``like``: the
    parameter whose split ``t`` follows (its momentum), default ``t``."""
    like = t if like is None else like
    t = t.detach()
    if isinstance(t, DTensor):  # by plain all_gather over the mesh's group
        (placement,) = t.placements
        return _gather(t.to_local(), placement.dim, t.device_mesh.get_group())
    if hasattr(like, "tp_shard"):
        return _gather(t, like.tp_shard[0], like.tp_group)
    return t


def _gather(local: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' equal parts ``local`` of ``group``, joined along ``dim``."""
    local = local.movedim(dim, 0).contiguous()
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local, group=group)
    return torch.cat(parts).movedim(0, dim)


def local_part(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's part of the whole tensor ``full`` as ``like`` (a parameter,
    DTensor or TP slice) is split; ``full`` itself where ``like`` is whole."""
    if isinstance(like, DTensor):
        (placement,) = like.placements
        n, r = like.device_mesh.size(), like.device_mesh.get_local_rank()
        return full.chunk(n, dim=placement.dim)[r]
    if hasattr(like, "tp_shard"):
        dim, rank, ranks = like.tp_shard
        size = full.shape[dim] // ranks
        return full.narrow(dim, rank * size, size)
    return full


def load_full_(dst: torch.Tensor, full: torch.Tensor) -> None:
    """Copy this rank's part of the whole tensor ``full`` into ``dst``
    (a parameter or buffer, split or whole), in place, without autograd."""
    with torch.no_grad():
        part = local_part(full, dst).to(dtype=dst.dtype)
        (dst.to_local() if isinstance(dst, DTensor) else dst).copy_(part)


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every split tensor whole (a collective on a
    split model: every rank calls it), as one process's model holds it."""
    params = dict(model.named_parameters())
    return {k: full_tensor(v, params.get(k)) for k, v in model.state_dict().items()}


def load_full_state_dict(model: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Load one process's state dict into ``model``, split or whole (each
    rank takes its part), strictly: the same keys and whole shapes."""
    targets = dict(model.named_parameters())
    targets.update(dict(model.named_buffers()))
    missing, unexpected = set(targets) - set(state), set(state) - set(targets)
    if missing or unexpected:
        raise KeyError(f"state dict mismatch: missing {sorted(missing)[:5]}, unexpected "
                       f"{sorted(unexpected)[:5]}")
    for name, dst in targets.items():
        if full_shape(dst) != tuple(state[name].shape):
            raise ValueError(f"{name}: shape {tuple(state[name].shape)} vs {full_shape(dst)}")
        load_full_(dst, state[name].to(dst.device))
