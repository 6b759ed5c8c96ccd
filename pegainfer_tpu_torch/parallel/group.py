"""The process groups of one tensor-parallel engine, the port's counterpart
of ``pegainfer_tpu/parallel/sharding.py::make_mesh``.

One process a rank. Each rank joins two groups over a shared store (a
``FileStore`` at a path, or a ``TCPStore`` at ``tcp://host:port``):

- the device group, for the model's collectives (``all_reduce_sum``,
  ``gather_vocab``): NCCL when every rank has a card of its own, gloo when
  ranks share a card (NCCL refuses two ranks on one device) or run on the
  CPU (``choose_backend``). Gloo takes CUDA tensors for both collectives and
  stages them through host memory itself;
- a gloo group on the CPU for rank 0's messages to the other ranks
  (``send`` / ``recv``, pickled objects) and the ranks' reports
  (``all_gather_objects``).

Both groups carry ``timeout_s``: a collective that a dead or stuck rank
never joins raises within it. A rank waiting for rank 0's next message
waits up to ``IDLE_TIMEOUT`` instead (an engine with no requests sends
none); a rank that exits closes its connections, and the others' next
operation with it raises at once.

The groups are made directly, not through ``init_process_group``: the
process that serves rank 0 is the caller's, and a second engine in it must
not meet the first one's default group.
"""

from __future__ import annotations

import datetime
import logging
import pickle
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist

from pegainfer_tpu_torch.utils.device import resolve_device

log = logging.getLogger("pegainfer_torch.parallel")

DEFAULT_TIMEOUT_S = 300.0
IDLE_TIMEOUT = datetime.timedelta(days=7)


class GroupError(RuntimeError):
    """A collective or a message of the groups failed: a rank exited, or a
    rank did not join within the timeout. The groups are unusable after
    one."""


def choose_backend(devices: Sequence) -> str:
    """The device group's backend for ranks on ``devices`` (one a rank):
    ``"nccl"`` when every rank has a CUDA card of its own, else ``"gloo"``
    (ranks that share a card, or ranks on the CPU)."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len({d.index for d in devs}) == len(devs):
        return "nccl"
    return "gloo"


def rank_devices(device_ordinals: Sequence[int], device, tp: int) -> List[torch.device]:
    """Each rank's device, as the JAX engine takes ``jax.devices()[:tp]``:
    on ``cuda``, rank r on ``cuda:{device_ordinals[r]}`` when
    ``device_ordinals`` lists one ordinal a rank (a repeat puts two ranks on
    one card), else the first ``tp`` cards; fewer cards than that raises.
    ``device="cpu"`` puts every rank on the CPU."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * tp
    if dev.type != "cuda":
        raise ValueError(f"tensor parallelism runs on cuda or the cpu, not {dev}")
    n = torch.cuda.device_count()
    ords = list(device_ordinals) if len(device_ordinals) == tp else list(range(tp))
    if any(not 0 <= o < n for o in ords):
        raise ValueError(f"{tp} ranks on cards {ords}, but this machine has {n} card(s); "
                         f"list {tp} ordinals in device_ordinals to share cards")
    return [torch.device("cuda", o) for o in ords]


def make_store(addr: str, rank: int, size: int, timeout_s: float) -> dist.Store:
    """A ``TCPStore`` for ``tcp://host:port`` (rank 0 serves it), else a
    ``FileStore`` at the path ``addr``."""
    timeout = datetime.timedelta(seconds=timeout_s)
    if addr.startswith("tcp://"):
        host, port = addr[len("tcp://"):].rsplit(":", 1)
        return dist.TCPStore(host, int(port), size, rank == 0, timeout)
    store = dist.FileStore(addr, size)
    store.set_timeout(timeout)
    return store


class RankGroups:
    """One rank's two groups, and the tensor-parallel context the model
    functions take (``models/qwen3.py``'s ``tp``): ``rank``, ``size``,
    ``all_reduce_sum``, ``gather_vocab``; ``collectives`` counts the
    device group's collectives."""

    def __init__(self, rank: int, size: int, store: str, backend: str,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        self.rank, self.size, self.backend = rank, size, backend
        self.collectives = 0
        base = make_store(store, rank, size, timeout_s)
        timeout = datetime.timedelta(seconds=timeout_s)
        self._ctrl = dist.ProcessGroupGloo(dist.PrefixStore("ctrl", base), rank, size, timeout)
        if backend == "nccl":
            opts = dist.ProcessGroupNCCL.Options()
            opts._timeout = timeout
            self._dev = dist.ProcessGroupNCCL(dist.PrefixStore("dev", base), rank, size, opts)
        elif backend == "gloo":
            self._dev = dist.ProcessGroupGloo(dist.PrefixStore("dev", base), rank, size,
                                              timeout)
        else:
            raise ValueError(f"no device group for backend {backend!r}")

    @staticmethod
    def _run(op: Callable[[], Any]) -> None:
        """Start the collective ``op`` and wait for it; its failure raises
        ``GroupError``."""
        try:
            op().wait()
        except RuntimeError as e:
            raise GroupError(str(e)) from e

    # ── the model's collectives (device group) ──────────────────────────

    def all_reduce_sum(self, partial: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of each rank's ``partial`` (f32 partial
        sums of a row-parallel projection), in f32: every rank gets the
        same bits. The caller casts once."""
        y = partial.float().contiguous()
        self._run(lambda: self._dev.allreduce([y]))
        self.collectives += 1
        return y

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """Each rank's vocab shard of ``logits`` [N, V/size] -> the whole
        [N, V], the shards side by side in rank order, on every rank."""
        x = logits.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        self._run(lambda: self._dev.allgather([parts], [x]))
        self.collectives += 1
        return torch.cat(parts, dim=-1)

    # ── rank 0's messages and the ranks' reports (CPU group) ───────────

    def send(self, obj: Any) -> None:
        """Rank 0: ``obj`` to every other rank (pickled)."""
        data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        n = torch.tensor([len(data)], dtype=torch.int64)
        buf = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        self._run(lambda: self._ctrl.broadcast(n, 0))
        self._run(lambda: self._ctrl.broadcast(buf, 0))

    def recv(self) -> Any:
        """Another rank: rank 0's next ``send``, waited for up to
        ``IDLE_TIMEOUT``."""
        n = torch.zeros(1, dtype=torch.int64)
        self._run(lambda: self._ctrl.broadcast(n, 0, IDLE_TIMEOUT))
        buf = torch.empty(int(n.item()), dtype=torch.uint8)
        self._run(lambda: self._ctrl.broadcast(buf, 0))
        return pickle.loads(buf.numpy().tobytes())

    def all_gather_objects(self, obj: Any) -> List[Any]:
        """Every rank's ``obj``, in rank order, on every rank."""
        data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(self.size)]
        mine = torch.tensor([len(data)], dtype=torch.int64)
        self._run(lambda: self._ctrl.allgather([sizes], [mine]))
        top = max(int(s.item()) for s in sizes)
        buf = torch.zeros(top, dtype=torch.uint8)
        buf[:len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        bufs = [torch.empty(top, dtype=torch.uint8) for _ in range(self.size)]
        self._run(lambda: self._ctrl.allgather([bufs], [buf]))
        return [pickle.loads(b[:int(s.item())].numpy().tobytes()) for b, s in zip(bufs, sizes)]

    def agree_min(self, n: int) -> int:
        """The least of the ranks' ``n``, on every rank."""
        t = torch.tensor([n], dtype=torch.int64)
        opts = dist.AllreduceOptions()
        opts.reduceOp = dist.ReduceOp.MIN
        self._run(lambda: self._ctrl.allreduce([t], opts))
        return int(t.item())

    def barrier(self) -> None:
        self.agree_min(0)

    def close_device(self) -> None:
        """Shut the device group down and drop it (the CPU group stays)."""
        if self._dev is not None:
            self._dev.shutdown()
        self._dev = None

    def close(self) -> None:
        """Shut both groups down and drop them."""
        self.close_device()
        if self._ctrl is not None:
            self._ctrl.shutdown()
        self._ctrl = None
