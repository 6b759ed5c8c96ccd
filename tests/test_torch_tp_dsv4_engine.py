"""DeepSeek-V4's model-parallel engine in the port on the CPU: rank 0 in the
test process, the other ranks spawned processes, gloo groups over a
``FileStore`` under ``tmp_path``, one intra-op thread a rank.

- The rank's load (``dsv4_weights.load_params_rank``) at tp 2 and 8,
  resident and bf16, on ``tests/test_torch_dsv4_checkpoint.py``'s
  checkpoint (``tests/test_dsv4_sharded_load.py``'s):
  bit for bit the JAX ``load_params_sharded``'s shard (its grouped leaves
  taken apart by layer; the fp8 scale grids, whole on every JAX device, cut
  by the port's block rule) and ``shard_dsv4`` of the port's whole load; a
  rank reads tensors from its own rank files only.
- ``resolve_tp_size``: the JAX ``test_resolve_tp_size``'s eight cases.
- The executor at tp 2 (``dsv4_engine.start_tp_executor`` on f32 resident
  weights, fp4 and the bf16 mode) against one process's ``SlotExecutor``
  under the port's scheduler stepped by hand: a prompt stored in the slot
  prefix cache, two requests at once (one sampled), a third that waits for
  a slot and resumes the cached prompt (eagerly); the tokens equal, the
  logprobs within 1e-5, every rank's counters, slot map and snapshots
  equal, the route tapes equal on both ranks, and the collectives
  ``collectives_per_forward`` a forward.
- ``start_engine(path, tp_size=2)`` (each rank loading its four files) and
  ``--tp-size 2 --no-precompile`` through the CLI against the JAX
  ``start_engine(path, tp_size=2)``'s greedy streams
  (``tests/test_torch_dsv4_checkpoint.py``'s ``assert_streams_agree``: bf16
  models part only at a JAX top-2 gap within its tolerance), and each
  rank's load report.
- The refusals, each its own case, and a killed worker.
"""

import logging

import numpy as np
import pytest
import torch

import jax
from pegainfer_tpu.engine import contract as jc
from pegainfer_tpu.models import dsv4 as jdsv4
from pegainfer_tpu.models import dsv4_engine as jengine
from pegainfer_tpu.models import dsv4_weights as jweights
from pegainfer_tpu_torch.engine import contract as tc
from pegainfer_tpu_torch.engine import pd
from pegainfer_tpu_torch.engine.executor import PrefillStepItem
from pegainfer_tpu_torch.engine.slot_executor import SlotExecutor
from pegainfer_tpu_torch.models import dsv4 as tdsv4
from pegainfer_tpu_torch.models import dsv4_engine as tengine
from pegainfer_tpu_torch.models import dsv4_manifest as tman
from pegainfer_tpu_torch.models import dsv4_weights as tweights
from pegainfer_tpu_torch.parallel import sharding, tp_executor
from pegainfer_tpu_torch.server import main as tmain
from pegainfer_tpu_torch.utils import weights as tw
from tests.test_torch_dsv4_checkpoint import assert_same_tree, assert_streams_agree
from tests.test_torch_dsv4_checkpoint import ckpt  # noqa: F401 (the checkpoint fixture)
from tests.test_torch_tp_engine import (SAMPLED, WAIT_S, Side, _children_alive, _close,
                                        _collect, _greedy, one_thread)  # noqa: F401

OPTS = dict(precompile=False, max_batch_size=2, max_model_len=64)
COUNTERS = ("prefills", "decode_steps", "decode_blocks", "prefix_hits", "collectives",
            "slots", "free_slots", "snapshots", "resume_steps")


def _tcfg(ckpt):
    return ckpt["tcfg"]


# ── the rank's load ─────────────────────────────────────────────────────


def _ungroup(cfg, gtree, r, tp, mesh):
    """Device r's shard of the JAX grouped tree as the port's per-layer
    tree (numpy leaves; fp8 grids whole, as JAX places them)."""
    def shard(a):
        return np.asarray(next(s.data for s in a.addressable_shards
                               if s.device == mesh.devices.flat[r]))

    layers = []
    for seg, (a, b, _, _) in zip(gtree["segments"], jdsv4.segments(cfg)):
        for j in range(b - a):
            layers.append(jax.tree.map(lambda x: shard(x)[j], seg))
    out = {k: shard(v) for k, v in gtree.items() if k != "segments"}
    out["layers"] = layers
    return out


def _cut_fp8_grids(tree, r, tp):
    """The port's rule for a JAX tree whose fp8 scale grids are whole: each
    cut on its leaf's axis unless one block spans it."""
    for lw in tree["layers"]:
        for k, v in lw.items():
            axis = sharding.DSV4_LAYER_SPLIT.get(k)
            if (isinstance(v, dict) and set(v) == {"q", "s"} and v["s"].ndim == 2
                    and axis is not None):
                s = v["s"]
                if s.shape[axis] > 1:
                    n = s.shape[axis] // tp
                    v["s"] = np.take(s, range(r * n, (r + 1) * n), axis=axis)
    return tree


@pytest.mark.parametrize("resident", [True, False], ids=["resident", "bf16"])
@pytest.mark.parametrize("tp", [2, 8])
def test_load_params_rank_is_the_jax_shard_bit_for_bit(ckpt, tp, resident):  # noqa: F811
    jcfg, path = ckpt["jcfg"], ckpt["fixture"]
    cfg = _tcfg(ckpt)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:tp]), ("tp",))
    jtree = jweights.load_params_sharded(jcfg, path, mesh, resident=resident)
    whole = tweights.load_params(cfg, path, resident=resident, device="cpu")
    for r in range(tp):
        got = tweights.load_params_rank(cfg, path, r, tp, resident=resident, device="cpu")
        want = tdsv4.params_from_jax(_cut_fp8_grids(_ungroup(jcfg, jtree, r, tp, mesh), r, tp))
        assert_same_tree(got, want)
        assert_same_tree(got, sharding.shard_dsv4(cfg, whole, r, tp))


@pytest.mark.parametrize("tp", [2, 8])
def test_a_rank_reads_only_its_own_rank_files(ckpt, tp, monkeypatch):  # noqa: F811
    """Every file's header is read by the manifest check; tensors only from
    the rank's 8 / tp files, which its report names with their bytes."""
    cfg = _tcfg(ckpt)
    reads = []
    orig = tw.SafetensorsReader.read
    monkeypatch.setattr(tw.SafetensorsReader, "read",
                        lambda self, name: reads.append(self.path) or orig(self, name))
    files = tman.rank_files(ckpt["fixture"])
    per = 8 // tp
    for r in (0, tp - 1):
        reads.clear()
        report = {}
        tweights.load_params_rank(cfg, ckpt["fixture"], r, tp, device="cpu", files_read=report)
        mine = files[r * per:(r + 1) * per]
        assert set(reads) == set(mine)
        assert sorted(report) == sorted(f.rsplit("/", 1)[1] for f in mine)
        assert all(n > 0 for n in report.values())
    with pytest.raises(ValueError, match="must divide the mp8 world"):
        tweights.load_params_rank(cfg, ckpt["fixture"], 0, 3, device="cpu")


@pytest.mark.parametrize("tp_size, n, want", [
    (None, 8, 8), (None, 16, 8), (None, 4, 4), (None, 3, 2), (None, 1, 1), (2, 8, 2),
    (3, 8, None), (8, 4, None)])
def test_resolve_tp_size_as_jax(tp_size, n, want):
    if want is None:
        with pytest.raises(ValueError) as w:
            jengine.resolve_tp_size(tp_size, n)
        with pytest.raises(ValueError) as g:
            tengine.resolve_tp_size(tp_size, n)
        assert str(g.value) == str(w.value)
    else:
        assert tengine.resolve_tp_size(tp_size, n) == jengine.resolve_tp_size(tp_size, n) == want


# ── the executor against one process ────────────────────────────────────


def _f32_resident(cfg):
    return tdsv4.quantize_params_resident(
        tdsv4.init_random_params(cfg, seed=13, dtype=torch.float32, scale=0.08))


def _traffic(ex):
    """A prompt that the slot cache keeps; two requests at once (one
    sampled); a third, arriving after the second decode block's dispatch
    while both slots are taken, that waits and resumes the kept prompt."""
    side = Side(ex)
    rng = np.random.default_rng(7)
    shared = rng.integers(2, 128, 30).tolist()
    warm = side.submit(shared, 3)
    side.run()
    a = side.submit(rng.integers(2, 128, 12).tolist(), 10, **SAMPLED)
    b = side.submit(rng.integers(2, 128, 9).tolist(), 6, logprobs=2)
    late = shared + rng.integers(2, 128, 4).tolist()
    chans, dispatches, free = [], [], []
    dispatch = ex.execute_decode_async

    def arrive_after_two(*args, **kw):
        out = dispatch(*args, **kw)
        dispatches.append(1)
        if len(dispatches) == 2:
            free.append(ex.free_slots())
            chans.append(side.submit(late, 5, logprobs=1))
        return out

    ex.execute_decode_async = arrive_after_two
    try:
        side.run()
    finally:
        del ex.execute_decode_async
    assert chans and free == [0]  # the third waits for a slot
    return [_collect(ch) for ch in (warm, a, b, chans[0])]


@pytest.mark.parametrize("quantize", [None, "bf16"], ids=["fp4", "bf16"])
def test_tp2_serves_the_one_process_streams(ckpt, quantize, tmp_path):  # noqa: F811
    cfg = _tcfg(ckpt)
    opts = tc.EngineLoadOptions(**OPTS, quantize=quantize)
    one_params = _f32_resident(cfg)
    if quantize == "bf16":
        tdsv4.dequantize_params(one_params, one_params["embed"].dtype)
    slots, mml, state = tengine.slot_state(cfg, opts, torch.device("cpu"))
    one = SlotExecutor(cfg, one_params, state, slots, mml, opts)
    ref = _traffic(one)
    ex = tengine.start_tp_executor(cfg, opts, torch.device("cpu"), 2, params=_f32_resident(cfg),
                                   store=str(tmp_path / "store"))
    try:
        ex.on_ranks(tengine.start_route_tape)
        got = _traffic(ex)
        tapes = ex.on_ranks(tengine.take_route_tape)
        stats = ex.rank_stats()
    finally:
        ex.shutdown()
    assert not _children_alive()
    for (t, lp, _), (rt, rlp, _) in zip(got, ref):
        assert t == rt
        assert all(_close(g, r) for g, r in zip(lp, rlp))
    assert one.slot_prefix_cache.hits == 1 and one.resume_steps == 4  # the resumed suffix
    host = {"slots": dict(one._slots), "free_slots": list(one._free_slots),
            "snapshots": [(hash(k), len(k)) for k in one.slot_prefix_cache._entries],
            "resume_steps": one.resume_steps}
    forwards = one.prefills + one.decode_steps + one.resume_steps
    for st in stats:
        assert {k: st[k] for k in COUNTERS} == {k: stats[0][k] for k in COUNTERS}
        assert {k: st[k] for k in host} == host
        assert (st["prefills"], st["decode_steps"], st["prefix_hits"]) == (
            one.prefills, one.decode_steps, one.slot_prefix_cache.hits)
        assert st["collectives"] == tdsv4.collectives_per_forward(cfg) * forwards
        assert st["load"]["files"] == {}  # cut from the caller's tree, no file read
    (t0, t1) = tapes
    assert t0["entries"] and len(t0["entries"]) == len(t1["entries"])
    for (k0, a), (k1, b) in zip(t0["entries"], t1["entries"]):
        assert k0 == k1 and all(torch.equal(x, y) for x, y in zip(a, b))
    # each rank holds a half of the experts and its vocabulary rows, the
    # whole slot state
    assert stats[0]["params_bytes"] == stats[1]["params_bytes"] < tp_executor.tree_bytes(
        one_params)
    assert stats[0]["state_bytes"] == tp_executor.tree_bytes(one.state)


# ── from a path, through the CLI, against the JAX engine ────────────────


@pytest.mark.parametrize("quantize", [None, "bf16"], ids=["resident", "bf16"])
def test_start_engine_from_a_path_at_tp2_matches_the_jax_mp_engine(ckpt, quantize,  # noqa: F811
                                                                     tmp_path):
    handle = tengine.start_engine(ckpt["fixture"], tc.EngineLoadOptions(quantize=quantize, **OPTS),
                                  device="cpu", tp_size=2, store=str(tmp_path / "store"))
    ex = handle._scheduler.executor
    stats = ex.rank_stats()
    files = tman.rank_files(ckpt["fixture"])
    for r, st in enumerate(stats):
        assert sorted(st["load"]["files"]) == sorted(f.rsplit("/", 1)[1]
                                                     for f in files[4 * r:4 * r + 4])
    w1 = ex.params["layers"][1]["experts_w1"]
    assert (w1.dtype if quantize else w1["q"].dtype) == (torch.bfloat16 if quantize
                                                          else torch.uint8)
    assert (w1.shape if quantize else w1["q"].shape)[0] == 4  # 8 experts over 2 ranks
    assert_streams_agree(handle, ckpt, quantize, tp_size=2)
    assert not _children_alive()


def test_the_cli_serves_dsv4_with_tp_size_2(ckpt):  # noqa: F811
    args = tmain.parse_args(["--model-path", ckpt["fixture"], "--tp-size", "2", "--no-precompile",
                             "--max-batch-size", "2"])
    tmain.check_supported(args)
    handle = tmain.build_engine(args, device="cpu")
    assert handle._scheduler.executor.tp_size == 2
    assert_streams_agree(handle, ckpt, None, tp_size=2)
    assert not _children_alive()


# ── refusals, a killed worker ───────────────────────────────────────────


def test_int8_experts_under_tp_raise_the_jax_error(ckpt):  # noqa: F811
    with pytest.raises(ValueError) as want:
        jengine.start_engine(ckpt["fixture"], jc.EngineLoadOptions(
            quantize="int8-experts", **OPTS), tp_size=2)
    with pytest.raises(ValueError) as got:
        tengine.start_engine(ckpt["fixture"], tc.EngineLoadOptions(quantize="int8-experts", **OPTS),
                             device="cpu", tp_size=2)
    assert str(got.value) == str(want.value)
    cfg = _tcfg(ckpt)
    with pytest.raises(ValueError, match="multichip"):
        tengine.start_engine_from_params(cfg, _f32_resident(cfg), tc.EngineLoadOptions(
            quantize="int8-experts", **OPTS), device="cpu", tp_size=2)


def test_the_experts_variable_is_ignored_under_tp_with_the_jax_warning(  # noqa: F811
        ckpt, monkeypatch, caplog, tmp_path):
    monkeypatch.setenv("PEGAINFER_DSV4_EXPERTS", "int8")
    with caplog.at_level(logging.WARNING, logger="pegainfer_torch.dsv4"):
        handle = tengine.start_engine(ckpt["fixture"], tc.EngineLoadOptions(**OPTS), device="cpu",
                                      tp_size=2, store=str(tmp_path / "store"))
    try:
        assert ("PEGAINFER_DSV4_EXPERTS=int8 ignored: not supported under a multichip mesh"
                in caplog.text)
        w1 = handle._scheduler.executor.params["layers"][1]["experts_w1"]
        assert w1["q"].dtype == torch.uint8
    finally:
        handle.shutdown()
        handle._thread.join(WAIT_S)
    assert not _children_alive()


@pytest.mark.parametrize("case", ["graphs", "moe_chain", "ep"])
def test_what_tp_does_not_run_raises(ckpt, case, monkeypatch):  # noqa: F811
    cfg = _tcfg(ckpt)
    opts = dict(OPTS)
    kw = {}
    if case == "graphs":
        opts["precompile"] = True
    elif case == "moe_chain":
        kw["moe_chain"] = True
    else:
        monkeypatch.setenv("PEGAINFER_DSV4_EP", "dense")
    match = {"graphs": "no-precompile", "moe_chain": "moe_chain", "ep": "PEGAINFER_DSV4_EP"}
    with pytest.raises(NotImplementedError, match=match[case]):
        tengine.start_engine_from_params(cfg, _f32_resident(cfg), tc.EngineLoadOptions(**opts),
                                         device="cpu", tp_size=2, **kw)
    if case != "moe_chain":
        with pytest.raises(NotImplementedError, match=match[case]):
            tengine.start_engine(ckpt["fixture"], tc.EngineLoadOptions(**opts), device="cpu",
                                 tp_size=2)
    assert not _children_alive()


class _TwoRanks:
    size = 2


def test_pd_refuses_a_model_parallel_executor(ckpt):  # noqa: F811
    """The PD handoff's export and import on rank 0's ``TPExecutor`` of a
    DSv4 rank raise before any call reaches the ranks."""
    cfg = _tcfg(ckpt)
    opts = tc.EngineLoadOptions(**OPTS)
    slots, mml, state = tengine.slot_state(cfg, opts, torch.device("cpu"))
    local = SlotExecutor(cfg, _f32_resident(cfg), state, slots, mml, opts)
    ex = tp_executor.TPExecutor(local, _TwoRanks(), [], None)
    item = PrefillStepItem(request_id=1, prompt_tokens=[3, 4, 5], params=tc.SamplingParams())
    with pytest.raises(NotImplementedError, match="PD handoff"):
        pd.prefill_and_export(ex, item)
    with pytest.raises(NotImplementedError, match="PD handoff"):
        ex.slot_export(0)
    assert local.prefills == 0


def test_a_killed_worker_surfaces_as_an_error(ckpt, tmp_path):  # noqa: F811
    cfg = _tcfg(ckpt)
    prompt = np.random.default_rng(3).integers(2, 128, 20).tolist()
    opts = tc.EngineLoadOptions(**OPTS)
    one = tengine.start_engine_from_params(cfg, _f32_resident(cfg), opts, device="cpu")
    try:
        want, _ = _greedy(one, prompt, 5)
    finally:
        one.shutdown()
    handle = tengine.start_engine_from_params(cfg, _f32_resident(cfg), opts, device="cpu",
                                              tp_size=2, store=str(tmp_path / "store"))
    ex = handle._scheduler.executor
    try:
        got, fin = _greedy(handle, prompt, 5)
        assert got == want and isinstance(fin, tc.Finished)
        (worker,) = _children_alive()
        worker.kill()
        worker.join(WAIT_S)
        got, fin = _greedy(handle, prompt, 5)
        assert isinstance(fin, tc.Error) and "tensor-parallel group is down" in fin.message, fin
    finally:
        handle.shutdown()
        handle._thread.join(WAIT_S)
    assert not handle._thread.is_alive() and not _children_alive()
