"""Multi-process initialisation: torch.distributed plumbing + global meshes.

Counterpart of ``auromat_tpu.parallel.distributed``. One process drives
one device. A launcher such as ``torchrun`` starts the processes and
describes the cluster in the standard environment (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``);
:func:`initialize` reads it and joins the process group (NCCL for CUDA
devices, gloo for the CPU), and :func:`global_mesh` builds the (dp, sp)
mesh over all ranks. Without that environment everything is a world of
one and nothing needs initialising.
"""

import os

import torch
import torch.distributed as dist

_CLUSTER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize(device="cuda"):
    """Join the process group the environment describes (idempotent).

    :param device: the device type the ranks compute on: 'cuda' selects
        NCCL and makes ``cuda:LOCAL_RANK`` this process's current device,
        'cpu' selects gloo; 'cuda' raises when torch finds no CUDA device
    :returns: True when a process group is up, False when no cluster is
        configured (a world of one; a no-op)
    :raises ValueError: when the cluster environment is incomplete; any
        failure of the process group's start propagates (a configured
        cluster never degrades to a world of one)
    """
    from auromat_tpu_torch.ops.georef import compute_device

    device = compute_device(device)
    if dist.is_initialized():
        return True
    present = [k for k in _CLUSTER_ENV if os.environ.get(k)]
    if not present:
        return False
    if len(present) != len(_CLUSTER_ENV):
        missing = sorted(set(_CLUSTER_ENV) - set(present))
        raise ValueError(f"incomplete cluster config: {missing} not set "
                         f"(got {present})")
    if device.type == "cuda":
        torch.cuda.set_device(local_device("cuda"))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]))
    return True


def local_device(device_type="cuda"):
    """This process's device: ``cuda:LOCAL_RANK`` for 'cuda', else the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return torch.device("cpu")


def is_multi_process():
    return dist.is_initialized() and dist.get_world_size() > 1


def global_mesh(dp=None, sp=None, device="cuda"):
    """(dp, sp) mesh over every rank of the default process group (a world
    of one without one); ``device`` is this rank's device (the card by
    default).

    The mosaic step's band routing is a reduction over the whole mesh, so
    with several hosts it crosses the network whatever the (dp, sp) split;
    size the burst to amortize it (one reduce-scatter per burst).
    """
    from auromat_tpu_torch.parallel.sharding import make_mesh

    return make_mesh(dp=dp, sp=sp, device=device)


def process_local_batch(global_batch_size):
    """This process's slice of a globally sharded frame batch.

    :returns: (start, count) frame indices of this rank's frames
    """
    n = dist.get_world_size() if dist.is_initialized() else 1
    i = dist.get_rank() if dist.is_initialized() else 0
    if global_batch_size % n != 0:
        raise ValueError(
            f"global_batch_size {global_batch_size} not divisible by "
            f"{n} processes")
    per = global_batch_size // n
    return i * per, per
