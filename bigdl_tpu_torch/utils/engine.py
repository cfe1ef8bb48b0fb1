"""Engine: the process topology of a run (counterpart of
bigdl_tpu/utils/engine.py ``_Engine`` :43-283; ref utils/Engine.scala:208).

The JAX package is one SPMD program over a device mesh; the port is one
process per rank and one card per process, PyTorch's idiom, so each JAX
device becomes one rank of a ``torch.distributed`` process group.  The
backend is NCCL on the card and gloo on the CPU; a device and a backend
that do not match raise, and nothing falls back to the other.

:meth:`_Engine.init_distributed` forms the group from its arguments or
from torchrun's variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``); with neither it forms a world of one
over an in-memory store, as ``jax.process_count() == 1`` is one
process.  A rank's device is ``cuda:{LOCAL_RANK}`` unless the caller
asks for the CPU.  The preemption handler of the JAX engine comes with
the resilience slice.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

#: the backend each device kind takes
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
#: torchrun's variables that name a world
WORLD_VARS = ("RANK", "WORLD_SIZE")


def backend_for(device) -> str:
    kind = torch.device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"no process-group backend for device {device!r}")
    return BACKENDS[kind]


class _Engine:
    def __init__(self):
        self._initialized = False
        self._node_number = 1
        self._core_number = 1
        self._local_rank = 0
        #: whether this engine formed the default group (and so destroys
        #: it on ``reset``)
        self._owns_group = False

    # -- lifecycle (ref Engine.init Engine.scala:339) ---------------------
    def init(self, node_number: int | None = None,
             core_number: int | None = None):
        """Topology bookkeeping: the nodes (ranks) and the devices a node,
        the live world's unless given."""
        self._node_number = int(self.device_count() if node_number is None
                                else node_number)
        self._core_number = int(self.local_device_count()
                                if core_number is None else core_number)
        self._initialized = True
        return self

    def init_distributed(self, device="cuda", backend: str | None = None,
                         init_method: str | None = None,
                         world_size: int | None = None,
                         rank: int | None = None,
                         local_rank: int | None = None, store=None):
        """Form the default process group (the ``jax.distributed
        .initialize`` role).  Arguments win over torchrun's variables;
        with no world named by either, a world of one over a
        ``HashStore``.  ``backend`` defaults to the device's (NCCL for
        ``cuda``, gloo for ``cpu``) and must match it.  On the card the
        process takes ``cuda:{local_rank}``."""
        want = backend_for(device)
        if backend is not None and backend != want:
            raise ValueError(f"backend {backend!r} does not serve device "
                             f"{device!r}: it takes {want!r}")
        if dist.is_initialized():
            self._check_backend(device)
            return self.init()
        env = os.environ
        named = all(v in env for v in WORLD_VARS)
        if rank is None:
            rank = int(env["RANK"]) if named else 0
        if world_size is None:
            world_size = int(env["WORLD_SIZE"]) if named else 1
        if local_rank is None:
            local_rank = int(env.get("LOCAL_RANK", rank if named else 0))
        if store is None and init_method is None:
            if world_size == 1 and not named:
                store = dist.HashStore()
            else:
                init_method = "env://"
        self._local_rank = int(local_rank)
        if want == "nccl":
            if not torch.cuda.is_available():
                raise RuntimeError("NCCL asked for, but CUDA is not "
                                   "available; pass device='cpu' for gloo")
            torch.cuda.set_device(self._local_rank)
        kwargs = dict(backend=want, rank=int(rank),
                      world_size=int(world_size))
        if want == "nccl":
            kwargs["device_id"] = torch.device("cuda", self._local_rank)
        if store is not None:
            kwargs["store"] = store
        else:
            kwargs["init_method"] = init_method
        dist.init_process_group(**kwargs)
        self._owns_group = True
        return self.init()

    def ensure_group(self, device):
        """The default group, formed as :meth:`init_distributed` forms it
        when there is none; an existing group must serve ``device``."""
        if not dist.is_initialized():
            self.init_distributed(device=device)
        self._check_backend(device)
        return dist.group.WORLD

    def _check_backend(self, device):
        want, have = backend_for(device), dist.get_backend()
        if have != want:
            raise ValueError(f"the process group runs {have!r}, device "
                             f"{device!r} needs {want!r}")

    def _ensure_init(self):
        if not self._initialized:
            self.init()

    # -- topology queries (ref Engine.scala:234-264) ----------------------
    def node_number(self) -> int:
        self._ensure_init()
        return self._node_number

    def core_number(self) -> int:
        self._ensure_init()
        return self._core_number

    def device_count(self) -> int:
        """Devices of the whole world: one a rank."""
        return dist.get_world_size() if dist.is_initialized() else 1

    def local_device_count(self) -> int:
        """Devices this process drives: one."""
        return 1

    def process_index(self) -> int:
        return dist.get_rank() if dist.is_initialized() else 0

    def device(self, device="cuda") -> torch.device:
        """This rank's device: ``cuda:{LOCAL_RANK}``, or the CPU when
        asked."""
        kind = torch.device(device).type
        if kind == "cuda":
            return torch.device("cuda", self._local_rank)
        return torch.device(kind)

    def reset(self):
        """Forget the topology, and destroy the default group if this
        engine formed it."""
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.__init__()


Engine = _Engine()
