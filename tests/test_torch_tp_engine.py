"""The tensor-parallel Qwen3 engine on the CPU: rank 0 in the test process,
each other rank a spawned process, gloo groups over a ``FileStore`` under
``tmp_path``, one intra-op thread a rank.

- The executor at TP 2 (``qwen3_engine.start_tp_executor``) against the
  one-process executor on the same f32 weights, each under the port's
  scheduler stepped by hand, in f32 and in ``quantize="int8"``: a prompt
  that fills the prefix cache, then a sampled stream (seeded by the
  scheduler) and an echo request with logprobs, then, while both decode, a
  prompt that hits the cache and prefills its rest in fused mixed pieces.
  The tokens are equal, every logprob within 1e-5 (f32 sums in another
  order), the executors' counters equal, and every rank's counters equal
  rank 0's.
- ``start_engine_from_params(..., tp_size=2)`` behind its scheduler
  thread streams the one-process engine's tokens; a killed worker then
  turns the next request into an ``Error`` within the groups' timeout, and
  no child outlives the shutdown. A rank that exits while the ranks start
  makes the start raise.
- ``--tp-size 2 --no-precompile`` through the CLI's ``build_engine`` on a
  tiny checkpoint (bf16): each streamed token the one-process model's
  argmax given the same prefix, or within bf16's resolution of it; the PD
  hooks refuse a tensor-parallel executor.
"""

import json
import multiprocessing
import os

import numpy as np
import pytest
import torch

from pegainfer_tpu_torch.engine import contract as tc
from pegainfer_tpu_torch.engine import pd
from pegainfer_tpu_torch.engine import scheduler as sched_mod
from pegainfer_tpu_torch.engine.executor import PrefillStepItem
from pegainfer_tpu_torch.engine.torch_executor import TorchExecutor
from pegainfer_tpu_torch.models import qwen3 as tq3
from pegainfer_tpu_torch.models import qwen3_engine as tq3e
from pegainfer_tpu_torch.parallel import group, tp_executor
from pegainfer_tpu_torch.server import main as tmain
from pegainfer_tpu_torch.utils.weights import load_state_dict

LOGPROB_ATOL = 1e-5
MAX_STEPS = 500
WAIT_S = 60
BF16_RTOL = 2e-2
OPTS = dict(precompile=False, max_num_pages=64, prefill_chunk=64, prefill_chunk_mixed=64,
            enable_prefix_cache=True, max_batch_size=8)
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9)
COUNTERS = ("prefills", "chunk_pieces", "mixed_pieces", "decode_steps", "decode_blocks",
            "prefix_hits", "collectives", "num_pages")


def _cfg_kw(**over):
    kw = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=8, num_key_value_heads=4, head_dim=16, vocab_size=256,
              rms_norm_eps=1e-6, rope_theta=1e6, tie_word_embeddings=False, eos_token_id=1,
              stop_token_ids=(1,), max_position_embeddings=512)
    kw.update(over)
    return kw


CFG = tq3.Qwen3Config(**_cfg_kw())


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # the workers take rank 0's count
    yield
    torch.set_num_threads(n)


def _params(dtype=torch.float32):
    return tq3.init_random_params(CFG, seed=11, dtype=dtype)


def _children_alive():
    return [p for p in multiprocessing.active_children() if p.name.startswith("pegainfer-tp")]


class Side:
    """An executor under the port's scheduler, stepped by hand."""

    def __init__(self, ex):
        self.ex = ex
        self.handle = tc.EngineHandle()
        self.sched = sched_mod.Scheduler(ex, self.handle, seed=42)

    def submit(self, prompt, max_tokens, logprobs=0, echo=False, **sampling):
        ch = tc.TokenChannel()
        self.handle.submit(tc.GenerateRequest(
            prompt_tokens=list(prompt), max_tokens=max_tokens, logprobs=logprobs, echo=echo,
            params=tc.SamplingParams(ignore_eos=True, **sampling), channel=ch))
        return ch

    def run(self):
        for _ in range(MAX_STEPS):
            reqs, _ = self.handle._drain()
            for r in reqs:
                self.sched._ingest(r)
            if not self.sched.step() and self.handle._submit_q.empty():
                return
        raise AssertionError("the scheduler never went idle")


def _collect(ch):
    """(tokens, [(logprob, top)] per token, prompt logprobs) of a finished
    stream."""
    toks, lps, prompt_lps = [], [], None
    while True:
        ev = ch.get(timeout=1)
        assert ev is not None, "the stream did not end"
        if isinstance(ev, tc.PromptTokens):
            prompt_lps = [None if lp is None else lp.logprob for lp in ev.logprobs]
        elif isinstance(ev, tc.Token):
            toks.append(ev.id)
            lps.append(None if ev.logprob is None else (ev.logprob.logprob,
                                                        ev.logprob.top_logprobs))
        elif tc.is_terminal(ev):
            assert isinstance(ev, tc.Finished), ev
            return toks, lps, prompt_lps


def _traffic(ex):
    """The test's traffic on ``ex``: the third prompt arrives right after
    the second decode block's dispatch (fed on the first block's tokens on
    the device), while both streams decode."""
    side = Side(ex)
    rng = np.random.default_rng(7)
    shared = rng.integers(2, 256, 150).tolist()
    warm = side.submit(shared, 4)
    side.run()  # the prompt's first 128 tokens (two pages) are cached
    a = side.submit(rng.integers(2, 256, 30).tolist(), 24, **SAMPLED)
    b = side.submit(rng.integers(2, 256, 20).tolist(), 8, logprobs=2, echo=True)
    late = shared[:128] + rng.integers(2, 256, 130).tolist()
    chans, dispatches = [], []
    dispatch = ex.execute_decode_async

    def arrive_after_two(*args, **kw):
        out = dispatch(*args, **kw)
        dispatches.append(kw.get("tokens_dev") is not None)
        if len(dispatches) == 2:
            chans.append(side.submit(late, 8, logprobs=1))
        return out

    ex.execute_decode_async = arrive_after_two
    try:
        side.run()
    finally:
        del ex.execute_decode_async
    assert dispatches[:2] == [False, True] and chans
    return [_collect(ch) for ch in (warm, a, b, chans[0])]


def _close(got, ref):
    if ref is None:
        return got is None
    if isinstance(ref, tuple):  # (chosen, [(id, top), ...])
        return (abs(got[0] - ref[0]) <= LOGPROB_ATOL
                and [i for i, _ in got[1]] == [i for i, _ in ref[1]]
                and all(abs(g - r) <= LOGPROB_ATOL for (_, g), (_, r) in zip(got[1], ref[1])))
    return abs(got - ref) <= LOGPROB_ATOL


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_tp2_serves_the_one_process_streams(quantize, tmp_path):
    opts = tc.EngineLoadOptions(**OPTS, quantize=quantize)
    params = _params()
    one = TorchExecutor(CFG, tq3.quantize_params_int8(params) if quantize else params,
                        tq3.make_kv_pages(CFG, OPTS["max_num_pages"], tq3e.DEFAULT_PAGE_SIZE,
                                          dtype=torch.float32), opts)
    ref = _traffic(one)
    ex = tq3e.start_tp_executor(CFG, opts, torch.device("cpu"), 2, params=_params(),
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
    # the traffic took the paths it is for: the cache hit, fused pieces
    assert one.prefix_cache.hits >= 1 and one.mixed_pieces >= 1
    for st in stats:
        assert {k: st[k] for k in COUNTERS} == {k: stats[0][k] for k in COUNTERS}
        assert (st["prefills"], st["chunk_pieces"], st["mixed_pieces"], st["decode_steps"],
                st["decode_blocks"], st["prefix_hits"]) == (
            one.prefills, one.chunk_pieces, one.mixed_pieces, one.decode_steps,
            one.decode_blocks, one.prefix_cache.hits)
    assert ex.final_stats is not None and ex.final_stats[1]["collectives"] == stats[1][
        "collectives"]


def _greedy(handle, prompt, n):
    ch = tc.TokenChannel()
    handle.submit(tc.GenerateRequest(prompt_tokens=prompt, max_tokens=n, channel=ch,
                                     params=tc.SamplingParams(ignore_eos=True)))
    toks = []
    while True:
        ev = ch.get(timeout=WAIT_S)
        assert ev is not None, "the engine produced no event in time"
        if isinstance(ev, tc.Token):
            toks.append(ev.id)
        elif tc.is_terminal(ev):
            return toks, ev


def test_a_killed_worker_surfaces_as_an_error(tmp_path):
    prompt = np.random.default_rng(3).integers(2, 256, 40).tolist()
    opts = tc.EngineLoadOptions(**OPTS)
    one = tq3e.start_engine_from_params(CFG, _params(), opts, device="cpu")
    try:
        want, _ = _greedy(one, prompt, 6)
    finally:
        one.shutdown()
    handle = tq3e.start_engine_from_params(CFG, _params(), opts, device="cpu", tp_size=2,
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


def _exit_at_start(spec, rank, tp, params):
    """``tp_rank_executor``, but rank 1 exits right after joining the groups."""
    if rank:
        os._exit(3)
    return tq3e.tp_rank_executor(spec, rank, tp, params)


def test_a_rank_that_exits_at_start_makes_the_start_raise(tmp_path):
    spec = dict(cfg=CFG, options=tc.EngineLoadOptions(**OPTS), devices=["cpu", "cpu"],
                backend="gloo")
    with pytest.raises(group.GroupError):
        tp_executor.start_ranks(spec, _exit_at_start, _params(), str(tmp_path / "store"))
    assert not _children_alive()


# ── the CLI on a checkpoint ─────────────────────────────────────────────


def _write_checkpoint(path, params):
    """A tiny Qwen3 checkpoint (config.json, one safetensors file in the HF
    names and [out, in] layout, f32), written here."""
    ly, inter = params["layers"], CFG.intermediate_size
    sd = {"model.embed_tokens.weight": params["embed"], "model.norm.weight": params["final_ln"],
          "lm_head.weight": params["lm_head"].T}
    for i in range(CFG.num_hidden_layers):
        pre = f"model.layers.{i}."
        sd.update({pre + "input_layernorm.weight": ly["input_ln"][i],
                   pre + "self_attn.q_proj.weight": ly["wq"][i].T,
                   pre + "self_attn.k_proj.weight": ly["wk"][i].T,
                   pre + "self_attn.v_proj.weight": ly["wv"][i].T,
                   pre + "self_attn.o_proj.weight": ly["wo"][i].T,
                   pre + "self_attn.q_norm.weight": ly["q_norm"][i],
                   pre + "self_attn.k_norm.weight": ly["k_norm"][i],
                   pre + "post_attention_layernorm.weight": ly["post_ln"][i],
                   pre + "mlp.gate_proj.weight": ly["w_gate_up"][i][:, :inter].T,
                   pre + "mlp.up_proj.weight": ly["w_gate_up"][i][:, inter:].T,
                   pre + "mlp.down_proj.weight": ly["w_down"][i].T})
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
    (path / "config.json").write_text(json.dumps({**cfg, "architectures": ["Qwen3ForCausalLM"]}))


def test_the_cli_serves_a_checkpoint_with_tp_size_2(tmp_path):
    params = _params()
    _write_checkpoint(tmp_path, params)
    args = tmain.parse_args(["--model-path", str(tmp_path), "--tp-size", "2", "--no-precompile",
                             "--max-num-pages", "64"])
    prompt = np.random.default_rng(4).integers(2, 256, 40).tolist()
    handle = tmain.build_engine(args, device="cpu")
    ex = handle._scheduler.executor
    try:
        got, fin = _greedy(handle, prompt, 8)
        assert isinstance(fin, tc.Finished) and ex.tp_size == 2
        assert ex.params["embed"].dtype == torch.bfloat16
        with pytest.raises(NotImplementedError):
            pd.prefill_and_export(ex, PrefillStepItem(request_id=99, prompt_tokens=prompt,
                                                      params=tc.SamplingParams()))
        with pytest.raises(NotImplementedError):
            ex.precompile()
    finally:
        handle.shutdown()
        handle._thread.join(WAIT_S)
    assert not _children_alive()
    # the one-process model on the checkpoint's bf16 weights, over the prompt
    # and the streamed tokens: each token its argmax, or within bf16's
    # resolution of it
    cfg = tq3.Qwen3Config.from_model_path(str(tmp_path))
    w = tq3.params_from_state_dict(cfg, load_state_dict(str(tmp_path)), dtype=torch.bfloat16)
    ids = torch.tensor(prompt + got[:-1], dtype=torch.int32)
    kv = tq3.make_kv_pages(cfg, 8, tq3e.DEFAULT_PAGE_SIZE)
    with torch.no_grad():
        _, logits = tq3.prefill(cfg, w, kv, ids, torch.arange(1, 8, dtype=torch.int32),
                                return_all_logits=True)
    for i, tok in enumerate(got):
        row = logits[len(prompt) - 1 + i]
        assert float(row.max() - row[tok]) <= BF16_RTOL * float(row.abs().max()), (i, tok)


def test_the_collectives_study_runs_on_the_cpu():
    """``studies/tp_collectives_study.py`` with its ranks on the CPU: every
    collective at every shape timed, a step's floor 72 reductions and one
    gather."""
    from pegainfer_tpu_torch.studies import tp_collectives_study as study

    res = study.run(2, "cpu")
    assert not _children_alive()
    ms = res["ms"]
    assert len(ms) == 2 * len(study.ROWS) - 1 and all(v > 0 for v in ms.values())
    for M in (1, 2, 8, 64):
        want = 72 * ms[f"all_reduce_sum M={M}"] + ms[f"gather_vocab M={M}"]
        assert res["step_ms"][f"M={M}"] == pytest.approx(want)
