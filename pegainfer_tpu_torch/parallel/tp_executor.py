"""A tensor-parallel engine as one process a rank, rank 0 mirroring its
executor to the others. What GSPMD does for the JAX engine, with no single
JAX counterpart.

Every rank runs its own executor (a ``TorchExecutor`` with ``tp``) on its
shard and its pool. Rank 0 serves the scheduler through ``TPExecutor``,
which sends each call that changes an executor's state or runs the model
to the other ranks over the CPU group, in rank 0's order, before running
it on its own executor: ``execute_prefill``, ``execute_decode``,
``execute_decode_async``, ``resolve_pending(_multi)``, ``execute_unified``,
``release_request``, each ``next`` of a ``prefill_stepper`` (with the
scheduler's ``decode_active`` / ``mixed_items`` / ``mixed_rand`` of that
moment) and the shutdown. The calls are plans of host data, so the ranks'
host state (page accounting, prefix cache, decode blocks) stays identical
by construction, and the collectives inside the model calls keep the
shards in step. Every rank samples from the same gathered logits with the
draws that rank 0's scheduler put in the items, so no token is sent
inside a decode block; a block that feeds on the last one's tokens on the
device names that block, and each rank takes its own. Pure queries
(``page_size``, ``available_pages``, ...) are rank 0's alone.

Each mirrored call holds rank 0's lock from its message to the end of its
own run, so calls from two threads (the scheduler's, a caller's) reach
every rank in one order. A worker runs each received call and drops its
result. Workers are ``torch.multiprocessing`` processes of the spawn
context (as many intra-op threads as rank 0's process), handed the
caller's parameters through a pipe (shared memory on the CPU, CUDA IPC on
a card) or a checkpoint's path. A dead worker makes rank 0's next call
raise (the scheduler turns it into ``Error`` events), within the groups'
timeout at worst; after one, every call raises. ``shutdown`` gathers
every rank's counters (``rank_stats``), joins the workers and drops the
groups.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
import threading
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import torch
import torch.multiprocessing as mp

from pegainfer_tpu_torch.parallel.group import GroupError, RankGroups

log = logging.getLogger("pegainfer_torch.parallel")

JOIN_TIMEOUT_S = 60.0


@dataclass
class TPSpec:
    """What every rank needs to build its executor (pickled to the
    workers): the model's config and options, the ranks' devices, the
    groups' backend and store, the intra-op threads, and the checkpoint
    path when the ranks load their shards from it."""

    cfg: Any
    options: Any
    devices: List[str]
    backend: str
    store: str
    threads: int = 1
    model_path: Optional[str] = None

    @property
    def size(self) -> int:
        return len(self.devices)

    def sharers(self, rank: int) -> int:
        """Ranks on rank ``rank``'s device (itself included)."""
        return self.devices.count(self.devices[rank])


def rank_stats(ex) -> dict:
    """A rank's executor counters, kernel launches, collectives and bytes
    of parameters."""
    from pegainfer_tpu_torch.models import qwen3 as q3
    from pegainfer_tpu_torch.ops.cuda import flash_prefill, int8_linear, paged_decode

    return {
        "rank": ex.tp.rank, "device": str(ex.device), "backend": ex.tp.backend,
        "params_bytes": q3.params_bytes(ex.params), "num_pages": ex.kv_pages.shape[2],
        "prefills": ex.prefills, "chunk_pieces": ex.chunk_pieces,
        "mixed_pieces": ex.mixed_pieces, "decode_steps": ex.decode_steps,
        "decode_blocks": ex.decode_blocks, "collectives": ex.tp.collectives,
        "prefix_hits": None if ex.prefix_cache is None else ex.prefix_cache.hits,
        "launches": {"paged_decode": paged_decode.launches,
                     "flash_prefill": flash_prefill.launches,
                     "int8_linear": int8_linear.launches},
    }


# ── the workers ──────────────────────────────────────────────────────────


def worker_main(rank: int, spec: TPSpec, build: Callable, conn) -> None:
    """A worker process: the caller's parameters from ``conn`` (a pipe:
    held by nothing else here, so the shared memory is let go once the
    shard is cut), its groups, its executor (``build(spec, rank, groups,
    params)``), then rank 0's calls until the shutdown."""
    torch.set_num_threads(spec.threads)
    dev = torch.device(spec.devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    params = conn.recv()
    conn.close()
    groups = RankGroups(rank, spec.size, spec.store, spec.backend)
    try:
        ex = build(spec, rank, groups, params)
        del params  # the caller's tree: this rank holds its own shard now
        groups.all_gather_objects(rank_stats(ex))  # ready
        serve_rank(ex, groups)
    finally:
        groups.close()


def serve_rank(ex, groups: RankGroups) -> None:
    """Run rank 0's calls on ``ex`` in its order until its shutdown. A call
    that raises is logged and dropped, as rank 0's scheduler drops the same
    failure (the ranks' state is the same); a failed collective ends the
    loop."""
    live = {}  # seq -> this rank's PendingDecode of rank 0's block seq
    steppers = {}  # request id -> this rank's prefill stepper
    while True:
        msg = groups.recv()
        kind = msg[0]
        if kind in ("stats", "shutdown"):
            groups.all_gather_objects(rank_stats(ex))
            if kind == "shutdown":
                return
            continue
        try:
            _apply(ex, msg, live, steppers)
        except GroupError:
            raise
        except Exception:  # noqa: BLE001 — rank 0 meets the same failure
            log.warning("rank %d: %s failed", groups.rank, kind, exc_info=True)


def _apply(ex, msg, live, steppers) -> None:
    kind = msg[0]
    if kind == "prefill":
        ex.execute_prefill(msg[1])
    elif kind == "decode":
        ex.execute_decode(msg[1])
    elif kind == "unified":
        ex.execute_unified(msg[1])
    elif kind == "decode_async":
        _, seq, items, feed, n_tokens, rand_matrix = msg
        tokens_dev = None if feed is None else live[feed].tokens_dev
        live[seq] = ex.execute_decode_async(items, tokens_dev, n_tokens, rand_matrix)
    elif kind == "resolve":
        ex.resolve_pending_multi(live.pop(msg[1]))
    elif kind == "release":
        steppers.pop(msg[1], None)
        ex.release_request(msg[1])
    elif kind == "stepper":
        item = msg[1]
        steppers[item.request_id] = ex.prefill_stepper(item)
    elif kind == "next":
        _, rid, ex.decode_active, ex.mixed_items, ex.mixed_rand = msg
        try:
            next(steppers[rid])
        except StopIteration:
            del steppers[rid]
        finally:
            ex.mixed_pending = None  # rank 0's scheduler applies its own copy
    else:
        raise ValueError(f"unknown call {kind!r}")


# ── rank 0 ───────────────────────────────────────────────────────────────

# the attributes the scheduler sets around stepper pieces and reads back
_SCHEDULER_ATTRS = ("decode_active", "mixed_items", "mixed_rand", "mixed_pending")


class TPExecutor:
    """Rank 0's ``ModelExecutor``: its own executor (``local``) behind the
    mirroring of every call that changes state (module docstring). Other
    attributes are ``local``'s."""

    def __init__(self, local, groups: RankGroups, procs, store_dir: Optional[str]):
        self.__dict__.update(local=local, _groups=groups, _procs=procs, _store_dir=store_dir,
                             _lock=threading.RLock(), _live={}, _seq=0, _broken=None,
                             _closed=False, final_stats=None)

    def __getattr__(self, name):
        return getattr(self.local, name)

    def __setattr__(self, name, value):
        if name in _SCHEDULER_ATTRS:
            setattr(self.local, name, value)
        else:
            object.__setattr__(self, name, value)

    @property
    def tp_size(self) -> int:
        return self._groups.size

    # ── mirroring ────────────────────────────────────────────────────

    def _send(self, msg) -> None:
        if self._broken is not None:
            raise RuntimeError(f"the tensor-parallel group is down: {self._broken}")
        dead = [(r, p.exitcode) for r, p in enumerate(self._procs, 1) if not p.is_alive()]
        if dead:
            self._broken = "worker rank(s) exited: " + ", ".join(
                f"rank {r} (exit code {c})" for r, c in dead)
            raise RuntimeError(f"the tensor-parallel group is down: {self._broken}")
        self._guard(self._groups.send, msg)

    def _guard(self, fn, *args):
        """``fn(*args)``; a failed collective marks the group down."""
        try:
            return fn(*args)
        except GroupError as e:
            self._broken = str(e)
            raise

    def _mirror(self, msg, fn, *args):
        with self._lock:
            self._send(msg)
            return self._guard(fn, *args)

    def execute_prefill(self, plan):
        return self._mirror(("prefill", plan), self.local.execute_prefill, plan)

    def execute_decode(self, plan):
        return self._mirror(("decode", plan), self.local.execute_decode, plan)

    def execute_unified(self, plan):
        return self._mirror(("unified", plan), self.local.execute_unified, plan)

    def release_request(self, request_id: int) -> None:
        with self._lock:
            if self._broken is not None:  # the scheduler drops a failed request
                self.local.release_request(request_id)
                return
            self._mirror(("release", request_id), self.local.release_request, request_id)

    def execute_decode_async(self, items, tokens_dev=None, n_tokens: int = 1,
                             rand_matrix=None):
        with self._lock:
            feed = None
            if tokens_dev is not None:  # the block in flight whose tokens these are
                feed = next(s for s, p in self._live.items() if p.tokens_dev is tokens_dev)
            seq = self._seq
            self._seq += 1
            pend = self._mirror(("decode_async", seq, list(items), feed, n_tokens, rand_matrix),
                                self.local.execute_decode_async, items, tokens_dev, n_tokens,
                                rand_matrix)
            self._live[seq] = pend
            return pend

    def _resolve(self, pending, fn):
        with self._lock:
            seq = next((s for s, p in self._live.items() if p is pending), None)
            if seq is None:  # a fused piece's rows: sampled and read already
                return fn(pending)
            del self._live[seq]
            return self._mirror(("resolve", seq), fn, pending)

    def resolve_pending(self, pending):
        return self._resolve(pending, self.local.resolve_pending)

    def resolve_pending_multi(self, pending):
        return self._resolve(pending, self.local.resolve_pending_multi)

    def prefill_stepper(self, item):
        with self._lock:
            self._send(("stepper", item))
            return self._stepper(item.request_id, self.local.prefill_stepper(item))

    def _stepper(self, rid, gen):
        """Each ``next`` of rank 0's stepper ``gen``, mirrored with the
        scheduler's attributes of that moment (the lock is not held across
        the yields)."""
        loc = self.local
        while True:
            try:
                end = self._mirror(("next", rid, loc.decode_active, loc.mixed_items,
                                    loc.mixed_rand), next, gen)
            except StopIteration as done:
                return done.value
            yield end

    def rank_stats(self) -> List[dict]:
        """Every rank's ``rank_stats``, in rank order."""
        with self._lock:
            self._send(("stats",))
            return self._guard(self._groups.all_gather_objects, rank_stats(self.local))

    # ── what tensor parallelism does not run ─────────────────────────

    def precompile(self) -> None:
        raise NotImplementedError("tensor parallelism runs the eager decode step "
                                  "(--no-precompile)")

    def export_pages(self, page_ids):
        raise NotImplementedError("PD handoff under tensor parallelism is not ported")

    def import_pages(self, rows, page_ids) -> None:
        raise NotImplementedError("PD handoff under tensor parallelism is not ported")

    # ── shutdown ─────────────────────────────────────────────────────

    def shutdown(self) -> None:
        """Gather every rank's counters into ``final_stats`` (while the
        group is up), join the workers (terminating any that outlive
        ``JOIN_TIMEOUT_S``) and drop the groups. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            try:
                self._send(("shutdown",))
                self.final_stats = self._guard(self._groups.all_gather_objects,
                                               rank_stats(self.local))
            except RuntimeError as e:  # a group that is down gathers nothing
                log.warning("tensor-parallel shutdown without the ranks' counters: %s", e)
            finally:
                stop_workers(self._procs)
                self._groups.close()
                if self._store_dir is not None:
                    shutil.rmtree(self._store_dir, ignore_errors=True)


def stop_workers(procs) -> None:
    """Join each worker; terminate, then kill, one that does not exit."""
    for p in procs:
        p.join(JOIN_TIMEOUT_S)
        if p.is_alive():
            log.warning("tensor-parallel worker %s did not exit: terminating it", p.name)
            p.terminate()
            p.join(5.0)
        if p.is_alive():
            p.kill()
            p.join()


def start_ranks(spec_kw: dict, build: Callable, params=None,
                store: Optional[str] = None) -> TPExecutor:
    """Start the ranks of one tensor-parallel engine: spawn ranks 1..n-1
    (``worker_main``), build rank 0's executor here, wait until every rank
    is ready, and return rank 0's ``TPExecutor``. ``spec_kw``: ``TPSpec``'s
    fields but the store and the threads; ``build(spec, rank, groups,
    params)`` makes a rank's executor (a module-level function: it is
    pickled by name); ``params``: the caller's tree, or None when the ranks
    load ``spec.model_path``; ``store``: a ``FileStore`` path or
    ``tcp://host:port`` (None: a file in a new temporary directory)."""
    store_dir = None
    if store is None:
        store_dir = tempfile.mkdtemp(prefix="pegainfer-tp-")
        store = os.path.join(store_dir, "store")
    spec = TPSpec(store=store, threads=torch.get_num_threads(), **spec_kw)
    log.info("tensor parallel: %d ranks on %s, device group %s", spec.size,
             ", ".join(spec.devices), spec.backend)
    ctx = mp.get_context("spawn")
    procs = []
    groups = None
    try:
        conns = []
        for r in range(1, spec.size):
            mine, theirs = ctx.Pipe()
            p = ctx.Process(target=worker_main, args=(r, spec, build, theirs), daemon=True,
                            name=f"pegainfer-tp-rank{r}")
            p.start()
            theirs.close()
            procs.append(p)
            conns.append(mine)
        for c in conns:  # shared memory on the CPU, CUDA IPC handles on a card
            c.send(params)
            c.close()
        groups = RankGroups(0, spec.size, spec.store, spec.backend)
        local = build(spec, 0, groups, params)
        ready = groups.all_gather_objects(rank_stats(local))
        if torch.device(spec.devices[0]).type == "cuda":
            torch.cuda.ipc_collect()  # the workers let go of the caller's tensors
    except BaseException:
        for p in procs:
            if p.is_alive():
                p.terminate()
        stop_workers(procs)
        if groups is not None:
            groups.close()
        if store_dir is not None:
            shutil.rmtree(store_dir, ignore_errors=True)
        raise
    for st in ready:
        log.info("rank %d on %s: %.2f GB of parameters, %d pages", st["rank"], st["device"],
                 st["params_bytes"] / 1e9, st["num_pages"])
    return TPExecutor(local, groups, procs, store_dir)
