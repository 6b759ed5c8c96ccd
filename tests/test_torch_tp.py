"""Tensor parallelism of the port's Qwen3 against the JAX package's, on the
CPU.

- The shards (``parallel/sharding.py::shard_qwen3``) against the JAX
  ``shard_qwen3``'s ``addressable_shards[r]`` at tp 2 and 4, f32, bf16 and
  int8 leaves (codes transposed into the port's container), the KV pool's shard
  shape too; the one exception, w_gate_up, held to ``gate shard ‖ up
  shard`` (and pinned as unequal to the JAX contiguous shard); a tied
  head cut out of the embedding.
- The model functions under ``tp`` (``prefill`` and ``decode`` with a
  rank's ``RankGroups``, gloo over a ``FileStore`` under ``tmp_path``, one
  thread a rank) at ``tests/test_tp_parity.py``'s setup (f32, seed 11, a
  10-token prompt from ``default_rng(5)``, 10 greedy tokens): the tokens of
  JAX TP 1 and JAX TP N exactly, rank 0's logits within 1e-5 of JAX TP 1's
  largest (f32 sums in another order: the per-rank partial sums and their
  reduction), and every rank's logits the same bits.
- ``validate_qwen3_tp``'s errors (JAX's messages), ``local_config``, the
  device group's backend, the ranks' devices, and the refusals: the graph
  options, a tp that does not divide, DeepSeek-V2-Lite and the multi-host
  variables at the CLI (Qwen3, the Qwen3.5 hybrid and DeepSeek-V4 pass its
  checks).

The engine under tensor parallelism (processes, the scheduler) is
``tests/test_torch_tp_engine.py``.
"""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pegainfer_tpu.models import qwen3 as jq3
from pegainfer_tpu.ops.sampling import sample_greedy as j_greedy
from pegainfer_tpu.parallel import sharding as jsh
from pegainfer_tpu_torch.engine import contract as tc
from pegainfer_tpu_torch.engine.torch_executor import TorchExecutor
from pegainfer_tpu_torch.models import qwen3 as tq3
from pegainfer_tpu_torch.models import qwen3_engine as tq3e
from pegainfer_tpu_torch.parallel import group, sharding
from pegainfer_tpu_torch.server import main as tmain

PAGE_SIZE = 4
NUM_PAGES = 16
N_NEW = 10
LOGITS_RTOL = 1e-5
JOIN_S = 60


def _cfg_kw(**over):
    kw = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=8, num_key_value_heads=4, head_dim=16, vocab_size=256,
              rms_norm_eps=1e-6, rope_theta=1e6, tie_word_embeddings=False, eos_token_id=1,
              stop_token_ids=(1,), max_position_embeddings=512)
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def setup():
    """test_tp_parity.py's config and f32 weights (JAX tree and the port's
    copy) and its prompt."""
    jcfg = jq3.Qwen3Config(**_cfg_kw())
    jparams = jq3.init_random_params(jcfg, seed=11, dtype=jnp.float32)
    prompt = np.random.default_rng(5).integers(0, 255, 10).tolist()
    return jcfg, jparams, tq3.Qwen3Config(**_cfg_kw()), prompt


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ── the JAX side: greedy runs that keep their logits ────────────────────


def _jax_greedy(cfg, params, kv, prompt):
    """test_tp_parity.py's ``greedy_run`` (pages 1, 2, ... in order), also
    returning each step's logits."""
    T = len(prompt)
    Tp = -(-T // PAGE_SIZE) * PAGE_SIZE
    table = np.arange(1, NUM_PAGES, dtype=np.int32)
    toks = np.zeros(Tp, np.int32)
    toks[:T] = prompt
    pf = jax.jit(lambda p, k, t, sl, pt: jq3.prefill(cfg, p, k, t, sl, pt))
    dc = jax.jit(lambda p, k, t, po, pt, sl: jq3.decode(cfg, p, k, t, po, pt, sl))
    kv, last, _ = pf(params, kv, jnp.asarray(toks), jnp.int32(T),
                     jnp.asarray(table[: Tp // PAGE_SIZE]))
    out = [int(np.asarray(j_greedy(jnp.asarray(last)[None]))[0])]
    logits = [np.asarray(last, np.float32)]
    for i in range(N_NEW - 1):
        pos = T + i
        kv, lg = dc(params, kv, jnp.asarray([out[-1]], jnp.int32), jnp.asarray([pos], jnp.int32),
                    jnp.asarray(table[None, :8]), jnp.asarray([pos + 1], jnp.int32))
        out.append(int(np.asarray(j_greedy(lg))[0]))
        logits.append(np.asarray(lg, np.float32)[0])
    return out, np.stack(logits)


@pytest.fixture(scope="module")
def jax_runs(setup):
    """JAX TP 1 and TP 2 / 4 (GSPMD on the virtual CPU mesh): tokens and
    logits."""
    jcfg, jparams, _, prompt = setup
    runs = {1: _jax_greedy(jcfg, jparams, jq3.make_kv_pages(jcfg, NUM_PAGES, PAGE_SIZE,
                                                           dtype=jnp.float32), prompt)}
    for tp in (2, 4):
        mesh = jsh.make_mesh(jsh.MeshConfig(dp=1, tp=tp))
        kv = jq3.make_kv_pages(jcfg, NUM_PAGES, PAGE_SIZE, dtype=jnp.float32)
        params, kv = jsh.shard_qwen3(mesh, jcfg, jparams, kv)
        runs[tp] = _jax_greedy(jcfg, params, kv, prompt)
    return runs


# ── the port's side: one thread a rank ──────────────────────────────────


def _port_greedy(cfg, params, kv, prompt, tp):
    table = torch.arange(1, NUM_PAGES, dtype=torch.int32)
    with torch.no_grad():
        last, _ = tq3.prefill(cfg, params, kv, torch.tensor(prompt, dtype=torch.int32),
                              table, tp=tp)
        out, logits = [int(last.argmax())], [last]
        for i in range(N_NEW - 1):
            pos = len(prompt) + i
            lg = tq3.decode(cfg, params, kv, torch.tensor([out[-1]], dtype=torch.int32),
                            torch.tensor([pos], dtype=torch.int32), table[None, :8],
                            torch.tensor([pos + 1], dtype=torch.int32), tp=tp)[0]
            out.append(int(lg.argmax()))
            logits.append(lg)
    return out, torch.stack(logits).numpy()


def run_ranks(tp, store, fn):
    """``fn(rank, groups)`` in ``tp`` threads, one rank each, over gloo
    groups on ``store``; the ranks' results in rank order."""
    results, errors = [None] * tp, []

    def rank(r):
        try:
            results[r] = fn(r, group.RankGroups(r, tp, store, "gloo", JOIN_S))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(tp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(2 * JOIN_S)
    assert not any(t.is_alive() for t in threads), "a rank did not finish"
    if errors:
        raise errors[0]
    return results


@pytest.mark.parametrize("tp", [2, 4])
def test_port_tp_gives_the_jax_tp_tokens(setup, jax_runs, tp, tmp_path):
    jcfg, jparams, cfg, prompt = setup
    tparams = tq3.params_from_jax(_np_tree(jparams))
    lcfg = sharding.local_config(cfg, tp)

    def rank(r, g):
        shard = sharding.shard_qwen3(cfg, tparams, r, tp)
        kv = tq3.make_kv_pages(lcfg, NUM_PAGES, PAGE_SIZE, dtype=torch.float32)
        return _port_greedy(lcfg, shard, kv, prompt, g)

    runs = run_ranks(tp, str(tmp_path / "store"), rank)
    toks, logits = runs[0]
    assert toks == jax_runs[1][0] == jax_runs[tp][0]
    ref = jax_runs[1][1]
    err = float(np.abs(logits - ref).max())
    assert err <= LOGITS_RTOL * float(np.abs(ref).max()), err
    for t, lg in runs[1:]:  # every rank holds the same gathered logits
        assert t == toks and np.array_equal(lg, logits)


def test_port_tp_reduces_in_f32_in_bf16(setup, tmp_path):
    """bf16 weights at TP 2 against TP 1: the partial sums are reduced in f32
    and rounded once, so TP only reorders the sums: the prefill's logits
    within bf16's resolution of TP 1's (2e-2 of the largest), the tokens
    the same while TP 1's top-2 gap exceeds that, both ranks the same
    bits."""
    _, jparams, cfg, prompt = setup
    tparams = tq3.params_from_jax(_np_tree(jparams), dtype=torch.bfloat16)
    ref_toks, ref = _port_greedy(cfg, tparams, tq3.make_kv_pages(
        cfg, NUM_PAGES, PAGE_SIZE, dtype=torch.bfloat16), prompt, None)
    lcfg = sharding.local_config(cfg, 2)

    def rank(r, g):
        kv = tq3.make_kv_pages(lcfg, NUM_PAGES, PAGE_SIZE, dtype=torch.bfloat16)
        return _port_greedy(lcfg, sharding.shard_qwen3(cfg, tparams, r, 2), kv, prompt, g)

    (toks, logits), (toks1, logits1) = run_ranks(2, str(tmp_path / "store"), rank)
    assert toks == toks1 and np.array_equal(logits, logits1)
    limit = 2e-2 * float(np.abs(ref).max())
    assert float(np.abs(logits[0] - ref[0]).max()) <= limit
    for step, (a, b) in enumerate(zip(toks, ref_toks)):
        if a != b:
            top2 = np.sort(ref[step])[-2:]
            assert top2[1] - top2[0] <= limit, (step, a, b)
            break


# ── the shards against the JAX shards ───────────────────────────────────


def _on(arr, dev):
    """The shard of a JAX array on ``dev``, as numpy (bf16 widened to f32,
    exactly)."""
    a = np.asarray(next(s.data for s in arr.addressable_shards if s.device == dev))
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _gate_up_shard(full, dim, r, tp):
    gate, up = np.split(full, 2, axis=dim)
    k = gate.shape[dim] // tp
    return np.concatenate([np.take(gate, range(r * k, (r + 1) * k), axis=dim),
                           np.take(up, range(r * k, (r + 1) * k), axis=dim)], axis=dim)


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_shards_match_the_jax_shards(setup, tp, mode):
    jcfg, jparams, cfg, _ = setup
    if mode == "bf16":
        jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    if mode == "int8":
        jparams = jq3.quantize_params_int8(jax.tree.map(lambda a: a, jparams))
    mesh = jsh.make_mesh(jsh.MeshConfig(dp=1, tp=tp))
    jshard, jkv = jsh.shard_qwen3(mesh, jcfg, jparams,
                                  jq3.make_kv_pages(jcfg, NUM_PAGES, PAGE_SIZE, dtype=jnp.float32))
    tparams = tq3.params_from_jax(_np_tree(jparams))
    full = jax.tree.map(lambda a: np.asarray(a, np.float32 if a.dtype == jnp.bfloat16
                                             else a.dtype), jparams)
    lcfg = sharding.local_config(cfg, tp)
    for r in range(tp):
        dev = mesh.devices.flat[r]
        mine = sharding.shard_qwen3(cfg, tparams, r, tp)
        assert tuple(tq3.make_kv_pages(lcfg, NUM_PAGES, PAGE_SIZE).shape) == _on(jkv, dev).shape
        pairs = [(mine["embed"], jshard["embed"], "embed"),
                 (mine["final_ln"], jshard["final_ln"], "final_ln"),
                 (mine["lm_head"], jshard["lm_head"], "lm_head")]
        pairs += [(mine["layers"][k], jshard["layers"][k], k) for k in mine["layers"]]
        for got, want, name in pairs:
            if name == "w_gate_up":  # the stated exception: gate shard ‖ up shard
                w = full["layers"]["w_gate_up"]
                if mode == "int8":
                    exp_q = _gate_up_shard(w["q8"], -1, r, tp)
                    np.testing.assert_array_equal(got["q"].numpy(), np.swapaxes(exp_q, -1, -2))
                    np.testing.assert_array_equal(got["s"].numpy(),
                                                  _gate_up_shard(w["s"], -1, r, tp))
                    contiguous = np.swapaxes(_on(want["q8"], dev), -1, -2)
                    got_t = got["q"].numpy()
                else:
                    np.testing.assert_array_equal(_np(got), _gate_up_shard(w, -1, r, tp))
                    contiguous, got_t = _on(want, dev), _np(got)
                if r == 0:  # the JAX contiguous shard would be all gate
                    assert not np.array_equal(got_t, contiguous)
            elif isinstance(got, dict):
                np.testing.assert_array_equal(got["q"].numpy(),
                                              np.swapaxes(_on(want["q8"], dev), -1, -2))
                np.testing.assert_array_equal(got["s"].numpy(), _on(want["s"], dev))
            else:
                assert got.dtype == tparams["embed"].dtype
                np.testing.assert_array_equal(_np(got), _on(want, dev), err_msg=name)


def test_a_tied_head_is_cut_out_of_the_embedding():
    cfg = tq3.Qwen3Config(**_cfg_kw(tie_word_embeddings=True))
    params = tq3.init_random_params(cfg, seed=3, dtype=torch.float32)
    assert params["lm_head"].data_ptr() == params["embed"].data_ptr()
    for r in range(2):
        mine = sharding.shard_qwen3(cfg, params, r, 2)
        torch.testing.assert_close(mine["lm_head"], params["embed"][r * 128:(r + 1) * 128].T,
                                   rtol=0, atol=0)
        torch.testing.assert_close(mine["embed"], params["embed"], rtol=0, atol=0)
        assert mine["lm_head"].is_contiguous()
        assert mine["embed"].data_ptr() != params["embed"].data_ptr()  # a copy of its own


def test_local_config_divides_the_heads_and_the_intermediate_width(setup):
    _, _, cfg, _ = setup
    lcfg = sharding.local_config(cfg, 4)
    assert (lcfg.num_attention_heads, lcfg.num_key_value_heads, lcfg.intermediate_size,
            lcfg.vocab_size, lcfg.head_dim) == (2, 1, 32, 256, 16)


@pytest.mark.parametrize("over", [dict(num_key_value_heads=2), dict(num_attention_heads=6),
                                  dict(intermediate_size=130), dict(vocab_size=258)])
def test_validate_qwen3_tp_raises_the_jax_errors(over):
    with pytest.raises(ValueError) as want:
        jsh.validate_qwen3_tp(jq3.Qwen3Config(**_cfg_kw(**over)), 4)
    with pytest.raises(ValueError) as got:
        sharding.validate_qwen3_tp(tq3.Qwen3Config(**_cfg_kw(**over)), 4)
    assert str(got.value) == str(want.value)


# ── groups and devices ──────────────────────────────────────────────────


@pytest.mark.parametrize("devices, want", [
    (["cuda:0", "cuda:1"], "nccl"), (["cuda:0", "cuda:0"], "gloo"), (["cpu", "cpu"], "gloo"),
    (["cuda:0", "cpu"], "gloo"), (["cuda:0", "cuda:1", "cuda:2", "cuda:1"], "gloo")])
def test_the_device_group_is_nccl_only_with_a_card_a_rank(devices, want):
    assert group.choose_backend(devices) == want


@pytest.mark.parametrize("ordinals, cards, want", [
    ([0, 0], 1, ["cuda:0", "cuda:0"]), ([0], 4, ["cuda:0", "cuda:1"]),
    ([3, 1], 4, ["cuda:3", "cuda:1"]), ([0], 1, None), ([0, 2], 2, None)])
def test_the_ranks_devices(ordinals, cards, want, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if want is None:  # fewer cards than ranks
        with pytest.raises(ValueError):
            group.rank_devices(ordinals, "cuda", 2)
    else:
        assert [str(d) for d in group.rank_devices(ordinals, "cuda", 2)] == want
    assert group.rank_devices(ordinals, "cpu", 2) == [torch.device("cpu")] * 2


def test_the_groups_carry_messages_and_reports(tmp_path):
    def rank(r, g):
        got = [g.send(("call", i, list(range(50 * i)))) if r == 0 else g.recv()
               for i in range(3)]
        return got, g.all_gather_objects({"rank": r}), g.agree_min(10 - r)

    runs = run_ranks(3, str(tmp_path / "store"), rank)
    for r, (got, reports, least) in enumerate(runs):
        assert reports == [{"rank": 0}, {"rank": 1}, {"rank": 2}] and least == 8
        if r:
            assert got == [("call", i, list(range(50 * i))) for i in range(3)]


# ── refusals ────────────────────────────────────────────────────────────


def test_the_graph_options_and_a_tp_that_does_not_divide_raise(setup):
    _, _, cfg, _ = setup
    params = tq3.init_random_params(cfg, seed=1, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="no-precompile"):
        tq3e.start_engine_from_params(cfg, params, tc.EngineLoadOptions(max_num_pages=16),
                                      device="cpu", tp_size=2)
    kv = tq3.make_kv_pages(cfg, 16, PAGE_SIZE, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="no-precompile"):
        TorchExecutor(cfg, params, kv, tc.EngineLoadOptions(), tp=object())
    with pytest.raises(ValueError, match="must divide num_key_value_heads"):
        tq3e.start_engine_from_params(cfg, params, tc.EngineLoadOptions(
            max_num_pages=16, precompile=False), device="cpu", tp_size=3)


@pytest.mark.parametrize("family", [
    {"model_type": "deepseek_v2", "architectures": ["DeepseekV2ForCausalLM"]}])
def test_the_cli_refuses_tp_for_the_other_families(family, tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(family))
    args = tmain.parse_args(["--model-path", str(tmp_path), "--tp-size", "2",
                             "--no-precompile"])
    with pytest.raises(NotImplementedError, match="tensor parallelism serves Qwen3"):
        tmain.build_engine(args, device="cpu")


def test_the_cli_accepts_tp_for_the_qwen35_hybrid(tmp_path):
    """``--tp-size 2 --no-precompile`` passes the CLI's checks for a
    Qwen3Next checkpoint (served in ``tests/test_torch_tp_qwen35_engine.py``)."""
    (tmp_path / "config.json").write_text(json.dumps(
        {"architectures": ["Qwen3NextForCausalLM"]}))
    args = tmain.parse_args(["--model-path", str(tmp_path), "--tp-size", "2",
                             "--no-precompile"])
    tmain.check_supported(args)
    assert tmain.detect_model_type(str(tmp_path)) in tmain.TP_FAMILIES


def test_the_cli_accepts_tp_for_dsv4(tmp_path):
    """``--tp-size 2 --no-precompile`` passes the CLI's checks for a
    DeepSeek-V4 checkpoint (served in ``tests/test_torch_tp_dsv4_engine.py``)."""
    (tmp_path / "config.json").write_text(json.dumps(
        {"model_type": "deepseek_v4", "architectures": ["DeepseekV4ForCausalLM"]}))
    args = tmain.parse_args(["--model-path", str(tmp_path), "--tp-size", "2",
                             "--no-precompile"])
    tmain.check_supported(args)
    assert tmain.detect_model_type(str(tmp_path)) in tmain.TP_FAMILIES


@pytest.mark.parametrize("arch", ["Qwen3ForCausalLM", "Qwen3NextForCausalLM",
                                  "DeepseekV4ForCausalLM"])
def test_the_cli_refuses_tp_with_graphs_and_multihost(arch, tmp_path, monkeypatch):
    (tmp_path / "config.json").write_text(json.dumps({"architectures": [arch]}))
    argv = ["--model-path", str(tmp_path), "--tp-size", "2"]
    with pytest.raises(NotImplementedError, match="no-precompile"):
        tmain.build_engine(tmain.parse_args(argv), device="cpu")
    monkeypatch.setenv("PEGAINFER_COORD", "localhost:1234")
    with pytest.raises(NotImplementedError, match="multi-host"):
        tmain.build_engine(tmain.parse_args(argv + ["--no-precompile"]), device="cpu")


# ── the int8 linear kernel's f32-output form (its plain version) ────────


@pytest.mark.parametrize("M", [1, 8, 64])
def test_the_f32_output_form_keeps_the_jax_sums_unrounded(M):
    """``int8_linear(..., f32_out=True)``: the plain version of the kernel's
    f32-output epilogue (bf16 rows, f32 y), and ``quant.int8_linear``'s
    JAX form, against the JAX ``int8_linear`` on the same bf16 values held
    in f32 (its output f32): each row within 1e-5 of its max |ref|, the f32
    sums in another order; the bf16 output is the f32 one rounded once."""
    from pegainfer_tpu.ops import quant as jquant
    from pegainfer_tpu_torch.ops import quant
    from pegainfer_tpu_torch.ops.cuda import int8_linear as il

    rng = np.random.default_rng(M)
    q8 = rng.integers(-127, 128, (400, 96)).astype(np.int8)  # [in, out]
    s = (rng.random(96) * 1e-2 + 1e-3).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((M, 400)).astype(np.float32)).to(torch.bfloat16)
    ref = np.asarray(jquant.int8_linear(jnp.asarray(x.float().numpy()), jnp.asarray(q8),
                                        jnp.asarray(s)))
    w = {"q": torch.from_numpy(np.ascontiguousarray(q8.T)), "s": torch.from_numpy(s)}
    (plain,) = il.int8_linear_plain(x, [w["q"]], [w["s"]], f32_out=True)
    jax_form = quant.int8_linear(x, w, f32_out=True)
    lim = 1e-5 * np.abs(ref).max(axis=1, keepdims=True)
    for y in (plain, jax_form):
        assert y.dtype == torch.float32
        assert (np.abs(y.numpy() - ref) <= lim).all()
    (rounded,) = il.int8_linear_plain(x, [w["q"]], [w["s"]])
    assert torch.equal(rounded, plain.to(torch.bfloat16))
