"""The world mesh and batch sharding for env fleets, over ``torch.distributed``.

The port of ``parallel/mesh.py``.  Worlds are independent along the batch
axis, so the fleet is one flat ``"worlds"`` axis over every device: each
device steps its own block of the world batch with no collective in the
rollout, and the train step reduces its gradients across the axis once a
step (``parallel/rollout.py:make_train_step``).

Where the layout differs from JAX's:

* JAX runs one SPMD program over every device and places arrays with
  shardings.  Here one process (a *rank*) drives one device, and a
  :class:`~torch.distributed.device_mesh.DeviceMesh` names the ranks.
  Placement is explicit, so ``batch_sharding`` has no counterpart:
  :func:`shard_batch` hands each rank its block, :func:`replicated` makes
  every rank hold rank 0's tensors and :func:`gather_batch` reads a sharded
  batch whole (what ``np.asarray`` does on a global ``jax.Array``).
* A rollout receives a rank's shard, not a global array: its batch is the
  rank's.  Rank *r* of *N* owns the contiguous block ``[r B/N, (r+1) B/N)``
  of a global batch of B worlds, as device *r* does in JAX.

Collectives run on NCCL for CUDA tensors and on gloo for CPU tensors; the
backend follows the device, as the kernel wrappers follow the tensors'
device.  On ``device="cuda"`` a failing NCCL start raises; gloo on CUDA
tensors runs only where the caller passes ``backend="gloo"``.

Launch: ``torchrun --nproc_per_node=N -m <program>`` and
``distributed_init(auto=True)`` (``env://``), or ``distributed_init(
"tcp://host:port", world_size=N, rank=r)`` in each process.  A bare
``distributed_init()`` is a no-op, and :func:`make_world_mesh` with no
process group starts a one-rank group, so single-process code runs
unchanged.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from parallax_tpu_torch.utils.device import resolve
from parallax_tpu_torch.utils.pytree import tree_map

WORLD_AXIS = "worlds"


def backend_for(device) -> str:
    """The collective backend for tensors on ``device``: nccl on CUDA, gloo
    on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _set_local_device(device: torch.device) -> None:
    """On CUDA, make ``LOCAL_RANK``'s card (torchrun sets it; 0 without it)
    the current device, so ``"cuda"`` tensors land on the rank's own card."""
    if device.type == "cuda":
        torch.cuda.set_device(
            device.index if device.index is not None else int(os.environ.get("LOCAL_RANK", 0))
        )


def distributed_init(init_method: Optional[str] = None, *, world_size: Optional[int] = None,
                     rank: Optional[int] = None, backend: Optional[str] = None,
                     device="cuda", auto: bool = False) -> None:
    """Start this process's rank of a multi-process fleet.

    Called bare, this is a no-op (one process), as in JAX.  ``auto=True``
    reads the rendezvous from the environment (``env://``: ``torchrun`` sets
    ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); otherwise
    ``init_method`` (``tcp://host:port`` or ``file:///path``) with
    ``world_size`` and ``rank``.  ``backend`` defaults to the device's
    (:func:`backend_for`)."""
    if init_method is None and world_size is None and rank is None and not auto:
        return
    dev = resolve(device)
    _set_local_device(dev)
    dist.init_process_group(
        backend or backend_for(dev),
        init_method="env://" if auto else init_method,
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank,
    )


def make_world_mesh(device="cuda", axis: str = WORLD_AXIS) -> DeviceMesh:
    """A 1-D mesh over every rank of the process group, its one dim named
    ``axis``.  Without a process group it starts a one-rank group on
    ``device``'s backend (an in-process store: no port, no file)."""
    dev = resolve(device)
    _set_local_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend_for(dev), store=dist.HashStore(),
                                world_size=1, rank=0)
    return init_device_mesh(dev.type, (dist.get_world_size(),), mesh_dim_names=(axis,))


def mesh_axis(mesh, axis: str = WORLD_AXIS) -> str:
    """``axis``, or the one dim name of a 1-D mesh built with another
    (``make_world_mesh(axis=...)``); a mesh of more dims needs ``axis``
    named.  Anything but a :class:`DeviceMesh` raises ``TypeError``."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, got {type(mesh).__name__}")
    names = mesh.mesh_dim_names or ()
    if axis in names:
        return axis
    if mesh.ndim == 1:
        return names[0] if names else axis
    raise ValueError(
        f"axis {axis!r} not in mesh axes {names}; pass axis= explicitly for "
        "multi-axis meshes"
    )


def axis_group(mesh, axis: str = WORLD_AXIS):
    """``(size, this rank's index, process group)`` of the mesh along
    ``axis`` (resolved as :func:`mesh_axis` does)."""
    axis = mesh_axis(mesh, axis)
    dim = mesh.mesh_dim_names.index(axis) if mesh.mesh_dim_names else 0
    return mesh.size(dim), mesh.get_local_rank(dim), mesh.get_group(dim)


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_batch(tree, mesh, axis: str = WORLD_AXIS):
    """This rank's block of a batched tree: rank *r* of *N* takes rows
    ``[r B/N, (r+1) B/N)`` of every tensor leaf whose leading dim B divides
    by N, on the mesh's device.  A leaf whose leading dim does not divide
    (and a 0-d one) stays whole, and then every rank steps the full batch:
    that warns, as in JAX."""
    n, r, _ = axis_group(mesh, axis)
    dev = mesh_device(mesh)
    fell_back = []

    def put(x):
        if not torch.is_tensor(x):
            return x
        if x.ndim == 0 or x.shape[0] % n != 0:
            if x.ndim > 0:
                fell_back.append(tuple(x.shape))
            return x.to(dev)
        per = x.shape[0] // n
        return x[r * per:(r + 1) * per].to(dev)

    out = tree_map(put, tree)
    if fell_back:
        warnings.warn(
            f"shard_batch: {len(fell_back)} leaves with leading dim not "
            f"divisible by mesh size {n} (e.g. {fell_back[0]}) were "
            f"REPLICATED — every device will step the full batch. Pad the "
            f"batch to a multiple of {n} for actual parallelism.",
            stacklevel=2,
        )
    return out


def replicated(tree, mesh, axis: str = WORLD_AXIS):
    """Every tensor leaf as rank 0's, on every rank of ``axis``: one
    broadcast a leaf.  A leaf that requires grad gives a leaf tensor that
    does too (a parameter stays a parameter)."""
    _, _, group = axis_group(mesh, axis)
    src = dist.get_global_rank(group, 0)
    dev = mesh_device(mesh)

    def bcast(x):
        if not torch.is_tensor(x):
            return x
        y = x.detach().to(dev).clone()
        dist.broadcast(y, src=src, group=group)
        return y.requires_grad_(x.requires_grad)

    return tree_map(bcast, tree)


def gather_batch(tree, mesh, axis: str = WORLD_AXIS, dim: int = 0):
    """A sharded batch read whole on every rank: the ranks' blocks of each
    tensor leaf joined along ``dim`` (0 for states; 1 for time-major
    trajectories) in rank order, which is the world order of
    :func:`shard_batch`.  Every rank's block must have the same shape."""
    n, _, group = axis_group(mesh, axis)

    def gather(x):
        if not torch.is_tensor(x):
            return x
        # gloo has no bool collectives: move flags as bytes
        y = x.to(torch.uint8) if x.dtype == torch.bool else x
        parts = [torch.empty_like(y) for _ in range(n)]
        dist.all_gather(parts, y.contiguous(), group=group)
        out = torch.cat(parts, dim=dim)
        return out.bool() if x.dtype == torch.bool else out

    return tree_map(gather, tree)


def host_local_batch(global_batch: int) -> int:
    """The batch this process makes: ``global_batch`` over the world size
    (1 without a process group)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    return global_batch // n
