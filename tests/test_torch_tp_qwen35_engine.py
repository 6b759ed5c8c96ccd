"""The tensor-parallel Qwen3.5 hybrid engine on the CPU: rank 0 in the test
process, the other rank a spawned process, gloo groups over a
``FileStore`` under ``tmp_path``, one intra-op thread a rank.

- The executor at TP 2 (``qwen35_engine.start_tp_executor``) against the
  one-process ``HybridExecutor`` on the same f32 weights, each under the
  port's scheduler stepped by hand, in f32 and in ``quantize="int8"``, on 2
  state slots: a prompt that fills the prefix cache (its pages and a state
  snapshot at 128 tokens), then a sampled stream (seeded by the scheduler)
  and an echo request with logprobs, then, after the second decode block's
  dispatch, a third request that waits for a state slot, hits the
  snapshot and prefills its rest in fused mixed pieces beside the sampled
  stream. The tokens are equal, every logprob within 1e-5 (f32 sums in
  another order), the executors' counters equal, and every rank's
  counters, slot map, free slots and snapshots equal rank 0's and the one
  process's.
- ``start_engine_from_params(..., tp_size=2)`` behind its scheduler thread
  streams the one-process engine's tokens; a killed worker then turns the
  next request into an ``Error``, and no child outlives the shutdown.
- ``--tp-size 2 --no-precompile`` through the CLI's ``build_engine`` on a
  tiny hybrid checkpoint written here (bf16 at load): each streamed token
  the one-process model's argmax given the same prefix, or within bf16's
  resolution of it; each rank holds its shard; the PD hooks refuse a
  tensor-parallel executor.
"""

import json

import numpy as np
import pytest
import torch

from pegainfer_tpu_torch.engine import contract as tc
from pegainfer_tpu_torch.engine import pd
from pegainfer_tpu_torch.engine.executor import PrefillStepItem
from pegainfer_tpu_torch.engine.hybrid_executor import HybridExecutor
from pegainfer_tpu_torch.models import qwen35 as tq
from pegainfer_tpu_torch.models import qwen35_engine as tqe
from pegainfer_tpu_torch.server import main as tmain
from pegainfer_tpu_torch.utils.weights import load_state_dict
from tests.test_torch_tp_engine import (BF16_RTOL, SAMPLED, WAIT_S, Side, _children_alive,
                                        _close, _collect, _greedy, one_thread)  # noqa: F401

OPTS = dict(precompile=False, max_num_pages=64, prefill_chunk=64, prefill_chunk_mixed=64,
            enable_prefix_cache=True, max_batch_size=2)
COUNTERS = ("prefills", "chunk_pieces", "mixed_pieces", "decode_steps", "decode_blocks",
            "prefix_hits", "collectives", "num_pages", "slots", "free_slots", "snapshots")


def _cfg_kw(**over):
    kw = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=4,
              num_attention_heads=8, num_key_value_heads=4, head_dim=16,
              vocab_size=256, rms_norm_eps=1e-6, rope_theta=1e6,
              partial_rotary_factor=0.25,
              layer_types=("linear_attention", "full_attention") * 2,
              linear_num_key_heads=4, linear_num_value_heads=8,
              linear_key_head_dim=8, linear_value_head_dim=8,
              linear_conv_kernel_dim=4, tie_word_embeddings=False,
              eos_token_id=1, stop_token_ids=(1,), max_position_embeddings=512)
    kw.update(over)
    return kw


CFG = tq.Qwen35Config(**_cfg_kw())


def _params():
    return tq.init_random_params(CFG, seed=11, dtype=torch.float32, scale=0.2)


def _traffic(ex):
    """The test's traffic on ``ex``: the third prompt arrives right after
    the second decode block's dispatch, while both slots are taken."""
    side = Side(ex)
    rng = np.random.default_rng(7)
    shared = rng.integers(2, 256, 150).tolist()
    warm = side.submit(shared, 4)
    side.run()  # the prompt's first 128 tokens: pages and a state snapshot
    a = side.submit(rng.integers(2, 256, 30).tolist(), 24, **SAMPLED)
    b = side.submit(rng.integers(2, 256, 20).tolist(), 8, logprobs=2, echo=True)
    late = shared[:128] + rng.integers(2, 256, 130).tolist()
    chans, dispatches, free = [], [], []
    dispatch = ex.execute_decode_async

    def arrive_after_two(*args, **kw):
        out = dispatch(*args, **kw)
        dispatches.append(kw.get("tokens_dev") is not None)
        if len(dispatches) == 2:
            free.append(ex.free_slots())
            chans.append(side.submit(late, 8, logprobs=1))
        return out

    ex.execute_decode_async = arrive_after_two
    try:
        side.run()
    finally:
        del ex.execute_decode_async
    assert dispatches[:2] == [False, True] and chans and free == [0]  # the third waits
    return [_collect(ch) for ch in (warm, a, b, chans[0])]


def _host_state(ex):
    """The one-process executor's slot map, free slots and snapshots, as
    ``rank_stats`` reads them."""
    return {"slots": dict(ex._slots), "free_slots": list(ex._free_slots),
            "snapshots": [(k, pos) for k, (pos, _) in ex.prefix_cache._snaps.items()]}


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_tp2_serves_the_one_process_streams(quantize, tmp_path):
    opts = tc.EngineLoadOptions(**OPTS, quantize=quantize)
    params = _params()
    one = HybridExecutor(CFG, tq.quantize_params_int8(params) if quantize else params,
                         tq.make_state(CFG, OPTS["max_num_pages"], tqe.DEFAULT_PAGE_SIZE,
                                       OPTS["max_batch_size"], kv_dtype=torch.float32), opts)
    ref = _traffic(one)
    ex = tqe.start_tp_executor(CFG, opts, torch.device("cpu"), 2, params=_params(),
                               store=str(tmp_path / "store"))
    try:
        got = _traffic(ex)
        stats = ex.rank_stats()
    finally:
        ex.shutdown()
    assert not _children_alive()
    for (t, lp, plp), (rt, rlp, rplp) in zip(got, ref):
        assert t == rt
        assert all(_close(g, r) for g, r in zip(lp, rlp))
        assert (plp is None) == (rplp is None)
        assert plp is None or all(_close(g, r) for g, r in zip(plp, rplp))
    assert got[2][2] is not None and got[3][1][0] is not None  # echo, logprobs served
    # the traffic took the paths it is for: a snapshot hit, fused pieces
    assert one.prefix_cache.hits >= 1 and one.mixed_pieces >= 1 and one.chunk_pieces >= 1
    host = _host_state(one)
    assert host["snapshots"]
    lcfg = tqe.sharding.local_config_qwen35(CFG, 2)
    for st in stats:
        assert {k: st[k] for k in COUNTERS} == {k: stats[0][k] for k in COUNTERS}
        assert (st["prefills"], st["chunk_pieces"], st["mixed_pieces"], st["decode_steps"],
                st["decode_blocks"], st["prefix_hits"]) == (
            one.prefills, one.chunk_pieces, one.mixed_pieces, one.decode_steps,
            one.decode_blocks, one.prefix_cache.hits)
        assert {k: st[k] for k in host} == host
        # a rank's state: its value heads and conv channels, the slots and the dead one
        assert st["state_bytes"] == tq.slot_bytes(lcfg) * (OPTS["max_batch_size"] + 1) + (
            OPTS["max_num_pages"] * tq.kv_bytes_per_page(lcfg, tqe.DEFAULT_PAGE_SIZE,
                                                         torch.float32))
    # 2 collectives a layer and the head's gather, each forward
    forwards = one.prefills + one.chunk_pieces + one.decode_steps  # fused pieces among the pieces
    assert stats[0]["collectives"] == (2 * CFG.num_hidden_layers + 1) * forwards
    assert ex.final_stats is not None and ex.final_stats[1]["collectives"] == stats[1][
        "collectives"]


def test_a_killed_worker_surfaces_as_an_error(tmp_path):
    prompt = np.random.default_rng(3).integers(2, 256, 40).tolist()
    opts = tc.EngineLoadOptions(**OPTS)
    one = tqe.start_engine_from_params(CFG, _params(), opts, device="cpu")
    try:
        want, _ = _greedy(one, prompt, 6)
    finally:
        one.shutdown()
    handle = tqe.start_engine_from_params(CFG, _params(), opts, device="cpu", tp_size=2,
                                          store=str(tmp_path / "store"))
    ex = handle._scheduler.executor
    try:
        got, fin = _greedy(handle, prompt, 6)
        assert got == want and isinstance(fin, tc.Finished)
        (worker,) = _children_alive()
        worker.kill()
        worker.join(WAIT_S)
        got, fin = _greedy(handle, prompt, 6)
        assert isinstance(fin, tc.Error) and "tensor-parallel group is down" in fin.message, fin
    finally:
        handle.shutdown()
        handle._thread.join(WAIT_S)
    assert not handle._thread.is_alive() and not _children_alive()
    assert ex.final_stats is None  # a group that is down reports nothing


# ── the CLI on a checkpoint ─────────────────────────────────────────────


def _write_checkpoint(path, params):
    """A tiny Qwen3Next checkpoint (config.json, one safetensors file in the
    HF names and [out, in] layout, f32), written here: the inverse of
    ``params_from_state_dict``'s splits (q / k / v / z and b / a
    interleaved by key head, q / gate by head)."""
    c = CFG
    Hk, dk, dv = c.linear_num_key_heads, c.linear_key_head_dim, c.linear_value_head_dim
    R = c.linear_num_value_heads // Hk
    Hq, hd, inter = c.num_attention_heads, c.head_dim, c.intermediate_size
    lin, full = params["lin"], params["full"]
    sd = {"model.embed_tokens.weight": params["embed"], "model.norm.weight": params["final_ln"],
          "lm_head.weight": params["lm_head"].T}

    def mlp(pre, w):
        sd.update({pre + "mlp.gate_proj.weight": w["mlp_gate_up"][:, :inter].T,
                   pre + "mlp.up_proj.weight": w["mlp_gate_up"][:, inter:].T,
                   pre + "mlp.down_proj.weight": w["mlp_down"].T,
                   pre + "input_layernorm.weight": w["input_ln"],
                   pre + "post_attention_layernorm.weight": w["post_ln"]})

    for g in range(c.num_groups):
        for j in range(c.period - 1):
            w = {k: v[g, j] for k, v in lin.items()}
            pre = f"model.layers.{g * c.period + j}."
            qkvz = torch.cat([w["wq"].T.reshape(Hk, dk, -1), w["wk"].T.reshape(Hk, dk, -1),
                              w["wv"].T.reshape(Hk, R * dv, -1),
                              w["wz"].T.reshape(Hk, R * dv, -1)], dim=1)
            ba = torch.cat([w["wb"].T.reshape(Hk, R, -1), w["wa"].T.reshape(Hk, R, -1)], dim=1)
            a = pre + "linear_attn."
            sd.update({a + "in_proj_qkvz.weight": qkvz.reshape(-1, c.hidden_size),
                       a + "in_proj_ba.weight": ba.reshape(-1, c.hidden_size),
                       a + "conv1d.weight": w["conv_w"][:, None, :],
                       a + "dt_bias": w["dt_bias"], a + "A_log": w["A_log"],
                       a + "norm.weight": w["norm_w"], a + "out_proj.weight": w["out_proj"].T})
            mlp(pre, w)
        w = {k: v[g] for k, v in full.items()}
        pre = f"model.layers.{g * c.period + c.period - 1}."
        qg = torch.cat([w["wq"].T.reshape(Hq, hd, -1), w["wgate"].T.reshape(Hq, hd, -1)], dim=1)
        a = pre + "self_attn."
        sd.update({a + "q_proj.weight": qg.reshape(-1, c.hidden_size),
                   a + "k_proj.weight": w["wk"].T, a + "v_proj.weight": w["wv"].T,
                   a + "o_proj.weight": w["wo"].T, a + "q_norm.weight": w["q_norm"],
                   a + "k_norm.weight": w["k_norm"]})
        mlp(pre, w)
    header, blobs, off = {}, [], 0
    for name, t in sd.items():
        b = t.contiguous().numpy().tobytes()
        header[name] = {"dtype": "F32", "shape": list(t.shape), "data_offsets": [off, off + len(b)]}
        blobs.append(b)
        off += len(b)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path / "model.safetensors", "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head + b"".join(blobs))
    cfg = _cfg_kw()
    cfg.pop("stop_token_ids")
    cfg["layer_types"] = list(cfg["layer_types"])
    (path / "config.json").write_text(json.dumps({**cfg,
                                                  "architectures": ["Qwen3NextForCausalLM"]}))


def test_the_cli_serves_a_hybrid_checkpoint_with_tp_size_2(tmp_path):
    params = _params()
    _write_checkpoint(tmp_path, params)
    cfg = tq.Qwen35Config.from_model_path(str(tmp_path))
    assert cfg == CFG
    w = tq.params_from_state_dict(cfg, load_state_dict(str(tmp_path)), dtype=torch.float32)
    for part in ("lin", "full"):  # the writer inverts the loader
        for k, v in params[part].items():
            assert torch.equal(w[part][k], v), (part, k)
    args = tmain.parse_args(["--model-path", str(tmp_path), "--tp-size", "2", "--no-precompile",
                             "--max-num-pages", "64", "--max-batch-size", "2"])
    prompt = np.random.default_rng(4).integers(2, 256, 40).tolist()
    handle = tmain.build_engine(args, device="cpu")
    ex = handle._scheduler.executor
    try:
        got, fin = _greedy(handle, prompt, 8)
        assert isinstance(fin, tc.Finished) and ex.tp_size == 2
        assert ex.params["lin"]["wq"].dtype == torch.bfloat16
        lcfg = ex.cfg  # rank 0's local config and shard
        assert (lcfg.linear_num_value_heads, lcfg.conv_dim) == (4, 64)
        assert tuple(ex.params["lin"]["conv_w"].shape[2:]) == (lcfg.conv_dim, 4)
        with pytest.raises(NotImplementedError):
            pd.prefill_and_export(ex, PrefillStepItem(request_id=99, prompt_tokens=prompt,
                                                      params=tc.SamplingParams()))
        with pytest.raises(NotImplementedError):
            ex.slot_export(0)
        with pytest.raises(NotImplementedError):
            ex.precompile()
    finally:
        handle.shutdown()
        handle._thread.join(WAIT_S)
    assert not _children_alive()
    # the one-process model on the checkpoint's bf16 weights, over the
    # prompt and the streamed tokens: each token its argmax, or within
    # bf16's resolution of it
    wb = tq.params_from_state_dict(cfg, load_state_dict(str(tmp_path)), dtype=torch.bfloat16)
    ids = torch.tensor(prompt + got[:-1], dtype=torch.int32)
    state = tq.make_state(cfg, 8, tqe.DEFAULT_PAGE_SIZE, 1)
    with torch.no_grad():
        _, logits = tq.prefill(cfg, wb, state, ids, torch.arange(1, 8, dtype=torch.int32), 0,
                               return_all_logits=True)
    for i, tok in enumerate(got):
        row = logits[len(prompt) - 1 + i]
        assert float(row.max() - row[tok]) <= BF16_RTOL * float(row.abs().max()), (i, tok)


def test_the_graph_options_and_a_tp_that_does_not_divide_raise():
    params = _params()
    with pytest.raises(NotImplementedError, match="no-precompile"):
        tqe.start_engine_from_params(CFG, params, tc.EngineLoadOptions(max_num_pages=16),
                                     device="cpu", tp_size=2)
    state = tq.make_state(CFG, 16, tqe.DEFAULT_PAGE_SIZE, 2, kv_dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="no-precompile"):
        HybridExecutor(CFG, params, state, tc.EngineLoadOptions(), tp=object())
    with pytest.raises(ValueError, match="must divide linear_num_key_heads"):
        tqe.start_engine_from_params(CFG, params, tc.EngineLoadOptions(
            max_num_pages=16, precompile=False), device="cpu", tp_size=3)
