"""Tensor parallelism of the port's Qwen3.5 hybrid against the JAX package's,
on the CPU.

A tiny f32 period-2 config that tp 2 and 4 both divide (hidden 64, 2
groups of one GDN and one full layer, GDN key / value heads 4 / 8 of 8,
full heads 8 / 4 of 16, vocab 256), weights from the JAX
``init_random_params`` (seed 17, scale 0.2) through ``params_from_jax``.

- The shards (``parallel/sharding.py::shard_qwen35``) against the JAX
  ``shard_qwen35``'s ``addressable_shards[r]`` on the virtual CPU mesh at
  tp 2 and 4, f32, bf16 and int8 leaves (codes transposed into the port's
  container), and a rank's state (``make_state`` at the local config)
  against a random state's JAX shards. Two exceptions, each held to its own rule and pinned
  as unequal to the JAX contiguous shard: ``mlp_gate_up`` (``gate shard ‖
  up shard``, as Qwen3's) and the conv channels, ``conv_w`` and the conv
  state (``q[r] ‖ k[r] ‖ v[r]``); ``make_state`` at the local config has
  each shard's shape.
- Each rank's value heads read their own key heads: ``_gdn_split_heads``
  on a rank's conv channels gives value head ``Hv/tp r + i`` key head
  ``Hk/tp r + i // R``, the whole model's map.
- The model functions under ``tp`` (a rank's ``RankGroups``, gloo over a
  ``FileStore`` under ``tmp_path``, one thread a rank): ``prefill`` then
  ``decode``; ``prefill_chunk`` pieces then ``decode``; a second prompt's
  pieces through ``mixed_chunk`` with the first stream's decode rows, then
  both at B 2 through ``decode``. The greedy tokens equal JAX TP 1's and
  JAX TP N's exactly (``tests/test_qwen35_sharding.py``'s check), rank 0's
  logits are within 1e-5 of JAX TP 1's largest (f32 sums in another
  order), and every rank holds the same logits bits.
- bf16 weights at TP 2 against one process: the partial sums reduced in
  f32 and rounded once.
- ``validate_qwen35_tp``'s errors (the JAX messages) and
  ``local_config_qwen35``.

The engine under tensor parallelism is ``tests/test_torch_tp_qwen35_engine.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pegainfer_tpu.models import qwen35 as jq
from pegainfer_tpu.ops.sampling import sample_greedy as j_greedy
from pegainfer_tpu.parallel import sharding as jsh
from pegainfer_tpu_torch.models import qwen35 as tq
from pegainfer_tpu_torch.parallel import sharding
from tests.test_torch_tp import run_ranks

PS = 4
NUM_PAGES = 32
MAX_SLOTS = 3
CHUNK = 16  # the JAX GDN chunk; its prompt rows are padded to a multiple
N_NEW = 8
T_PROMPT = 10
PIECE = 4  # the port's chunk pieces (a page each)
LOGITS_RTOL = 1e-5
BF16_RTOL = 2e-2


def _cfg_kw(**over):
    kw = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=4,
              num_attention_heads=8, num_key_value_heads=4, head_dim=16,
              vocab_size=256, rms_norm_eps=1e-6, rope_theta=1e6,
              partial_rotary_factor=0.25,
              layer_types=("linear_attention", "full_attention") * 2,
              linear_num_key_heads=4, linear_num_value_heads=8,
              linear_key_head_dim=8, linear_value_head_dim=8,
              linear_conv_kernel_dim=4, tie_word_embeddings=False,
              eos_token_id=1, stop_token_ids=(1,), max_position_embeddings=256)
    kw.update(over)
    return kw


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    jcfg = jq.Qwen35Config(**_cfg_kw())
    jparams = jq.init_random_params(jcfg, seed=17, dtype=jnp.float32, scale=0.2)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, 255, T_PROMPT).tolist() for _ in range(2)]
    return jcfg, jparams, tq.Qwen35Config(**_cfg_kw()), prompts


# ── the JAX side: greedy runs that keep their logits ────────────────────


def _jax_greedy(cfg, params, state, prompt):
    """Prefill into slot 0 (pages 1, 2, ...), then N_NEW - 1 greedy decode
    steps; the tokens and each step's logits."""
    T = len(prompt)
    Tp = -(-T // CHUNK) * CHUNK
    table = np.arange(1, 1 + Tp // PS, dtype=np.int32)
    toks = np.zeros(Tp, np.int32)
    toks[:T] = prompt
    pf = jax.jit(lambda p, s, t, sl, pt: jq.prefill(cfg, p, s, t, sl, pt, 0,
                                                    gdn_chunk_size=CHUNK)[:2])
    dc = jax.jit(lambda p, s, t, po, pt, sl: jq.decode(cfg, p, s, t, po, pt, sl,
                                                       jnp.zeros(1, jnp.int32)))
    state, last = pf(params, state, jnp.asarray(toks), jnp.int32(T), jnp.asarray(table))
    out = [int(np.asarray(j_greedy(jnp.asarray(last)[None]))[0])]
    logits = [np.asarray(last, np.float32)]
    tables = np.arange(1, 9, dtype=np.int32)[None]
    for i in range(N_NEW - 1):
        pos = T + i
        state, lg = dc(params, state, jnp.asarray([out[-1]], jnp.int32),
                       jnp.asarray([pos], jnp.int32), jnp.asarray(tables),
                       jnp.asarray([pos + 1], jnp.int32))
        out.append(int(np.asarray(j_greedy(lg))[0]))
        logits.append(np.asarray(lg, np.float32)[0])
    return out, np.stack(logits)


@pytest.fixture(scope="module")
def jax_runs(setup):
    """JAX TP 1, 2 and 4 (GSPMD on the virtual CPU mesh): each prompt's
    tokens and logits."""
    jcfg, jparams, _, prompts = setup
    runs = {}
    for tp in (1, 2, 4):
        params, state = jparams, jq.make_state(jcfg, NUM_PAGES, PS, MAX_SLOTS,
                                               kv_dtype=jnp.float32)
        if tp > 1:
            mesh = jsh.make_mesh(jsh.MeshConfig(dp=1, tp=tp))
            params, state = jsh.shard_qwen35(mesh, jcfg, jparams, state)
        runs[tp] = [_jax_greedy(jcfg, params, state, p) for p in prompts]
    return runs


# ── the port's side: one thread a rank ──────────────────────────────────


def _i32(x):
    return torch.tensor(x, dtype=torch.int32)


def _decode(cfg, params, state, streams, tp):
    """One decode step of ``streams`` (each [slot, pages, tokens]) on
    their slots; appends each row's argmax. Returns the logits [B, V]."""
    pos = [len(s[2]) - 1 for s in streams]  # the last token's position
    tables = torch.stack([s[1] for s in streams])
    lg = tq.decode(cfg, params, state, _i32([s[2][-1] for s in streams]), _i32(pos), tables,
                   _i32([p + 1 for p in pos]), _i32([s[0] for s in streams]), tp=tp)
    for s, row in zip(streams, lg):
        s[2].append(int(row.argmax()))
    return lg


def _port_run(cfg, params, prompts, tp, form):
    """The greedy streams of ``form``: "whole" (prompt 0 through
    ``prefill``), "chunk" (prompt 0 through ``prefill_chunk`` pieces of
    PIECE) or "mixed" (prompt 0 whole, then prompt 1's pieces through
    ``mixed_chunk`` beside prompt 0's decode rows, then both at B 2). Each
    stream's tokens (the prompt's first, then N_NEW) and logits."""
    state = tq.make_state(cfg, NUM_PAGES, PS, MAX_SLOTS, kv_dtype=torch.float32)
    a = [0, torch.arange(1, 9, dtype=torch.int32), list(prompts[0])]
    b = [1, torch.arange(9, 17, dtype=torch.int32), list(prompts[1])]
    la, lb = [], []
    with torch.no_grad():
        if form == "chunk":
            toks = _i32(prompts[0])
            for start in range(0, T_PROMPT, PIECE):
                valid = min(PIECE, T_PROMPT - start)
                last = tq.prefill_chunk(cfg, params, state, toks[start:start + valid], start,
                                        valid, a[1], a[0], tp=tp)
        else:
            last, _ = tq.prefill(cfg, params, state, _i32(prompts[0]), a[1], a[0], tp=tp)
        a[2].append(int(last.argmax()))
        la.append(last)
        streams = [a]
        if form == "mixed":
            toks = _i32(prompts[1])
            for start in range(0, T_PROMPT, PIECE):
                valid = min(PIECE, T_PROMPT - start)
                pos = len(a[2]) - 1
                last, dec = tq.mixed_chunk(cfg, params, state, toks[start:start + valid],
                                           start, valid, b[1], b[0], _i32([a[2][-1]]),
                                           _i32([pos]), a[1][None], _i32([pos + 1]),
                                           _i32([a[0]]), tp=tp)
                a[2].append(int(dec[0].argmax()))
                la.append(dec[0])
            b[2].append(int(last.argmax()))
            lb.append(last)
            streams = [a, b]
        while len(streams[-1][2]) < T_PROMPT + N_NEW:
            live = [s for s in streams if len(s[2]) < T_PROMPT + N_NEW]
            lg = _decode(cfg, params, state, live, tp)
            for s, row in zip(live, lg):
                (la if s is a else lb).append(row)
    out = [(a[2][T_PROMPT:], torch.stack(la).numpy())]
    if form == "mixed":
        out.append((b[2][T_PROMPT:], torch.stack(lb).numpy()))
    return out


@pytest.mark.parametrize("form", ["whole", "chunk", "mixed"])
@pytest.mark.parametrize("tp", [2, 4])
def test_port_tp_gives_the_jax_tp_tokens(setup, jax_runs, tp, form, tmp_path):
    jcfg, jparams, cfg, prompts = setup
    tparams = tq.params_from_jax(_np_tree(jparams))
    lcfg = sharding.local_config_qwen35(cfg, tp)

    def rank(r, g):
        return _port_run(lcfg, sharding.shard_qwen35(cfg, tparams, r, tp), prompts, g, form)

    runs = run_ranks(tp, str(tmp_path / "store"), rank)
    for i, (toks, logits) in enumerate(runs[0]):
        assert toks == jax_runs[1][i][0] == jax_runs[tp][i][0], (i, toks)
        ref = jax_runs[1][i][1]
        err = float(np.abs(logits - ref).max())
        assert err <= LOGITS_RTOL * float(np.abs(ref).max()), (i, err)
    for other in runs[1:]:  # every rank holds the same gathered logits
        for (t, lg), (t0, lg0) in zip(other, runs[0]):
            assert t == t0 and np.array_equal(lg, lg0)


def test_port_tp_reduces_in_f32_in_bf16(setup, tmp_path):
    """bf16 weights at TP 2 against TP 1 (the port in one process): TP only
    reorders the f32 sums before one rounding, so the prefill's logits are
    within bf16's resolution of TP 1's (2e-2 of the largest) and the
    tokens the same while TP 1's top-2 gap exceeds that; both ranks the
    same bits."""
    _, jparams, cfg, prompts = setup
    tparams = tq.params_from_jax(_np_tree(jparams), dtype=torch.bfloat16)
    ((ref_toks, ref),) = _port_run(cfg, tparams, prompts, None, "whole")
    lcfg = sharding.local_config_qwen35(cfg, 2)

    def rank(r, g):
        return _port_run(lcfg, sharding.shard_qwen35(cfg, tparams, r, 2), prompts, g, "whole")

    ((toks, logits),), ((toks1, logits1),) = run_ranks(2, str(tmp_path / "store"), rank)
    assert toks == toks1 and np.array_equal(logits, logits1)
    limit = BF16_RTOL * float(np.abs(ref).max())
    assert float(np.abs(logits[0] - ref[0]).max()) <= limit
    for step, (x, y) in enumerate(zip(toks, ref_toks)):
        if x != y:
            top2 = np.sort(ref[step])[-2:]
            assert top2[1] - top2[0] <= limit, (step, x, y)
            break


def test_without_tp_the_functions_are_unchanged(setup):
    """``tp=None`` is the one-process path: the same bits as the default."""
    _, jparams, cfg, prompts = setup
    tparams = tq.params_from_jax(_np_tree(jparams))
    states = [tq.make_state(cfg, NUM_PAGES, PS, MAX_SLOTS, kv_dtype=torch.float32)
              for _ in range(2)]
    table = torch.arange(1, 9, dtype=torch.int32)
    with torch.no_grad():
        a, _ = tq.prefill(cfg, tparams, states[0], _i32(prompts[0]), table, 0)
        b, _ = tq.prefill(cfg, tparams, states[1], _i32(prompts[0]), table, 0, tp=None)
    assert torch.equal(a, b)
    for k in states[0]:
        assert torch.equal(states[0][k], states[1][k])


# ── the shards against the JAX shards ───────────────────────────────────


def _on(arr, dev):
    """The shard of a JAX array on ``dev``, as numpy (bf16 widened to f32,
    exactly)."""
    a = np.asarray(next(s.data for s in arr.addressable_shards if s.device == dev))
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _run(full, axis, r, tp):
    k = full.shape[axis] // tp
    return np.take(full, range(r * k, (r + 1) * k), axis=axis)


def _gate_up_shard(full, axis, r, tp):
    gate, up = np.split(full, 2, axis=axis)
    return np.concatenate([_run(gate, axis, r, tp), _run(up, axis, r, tp)], axis=axis)


def _conv_shard(cfg, full, axis, r, tp):
    kd = cfg.key_dim
    q, k, v = np.split(full, [kd, 2 * kd], axis=axis)
    return np.concatenate([_run(q, axis, r, tp), _run(k, axis, r, tp), _run(v, axis, r, tp)],
                          axis=axis)


# the stated exceptions: (part, leaf) -> (the port's rule, the axis of the
# JAX [in, out] leaf it cuts)
EXCEPTIONS = {("lin", "mlp_gate_up"): ("gate_up", -1), ("full", "mlp_gate_up"): ("gate_up", -1),
              ("lin", "conv_w"): ("conv", -2)}


def _exception(cfg, rule, full, axis, r, tp):
    return (_gate_up_shard if rule == "gate_up" else
            lambda *a: _conv_shard(cfg, *a))(full, axis, r, tp)


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_shards_match_the_jax_shards(setup, tp, mode):
    jcfg, jparams, cfg, _ = setup
    if mode == "bf16":
        jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    if mode == "int8":
        jparams = jq.quantize_params_int8(jax.tree.map(lambda a: a, jparams))
    mesh = jsh.make_mesh(jsh.MeshConfig(dp=1, tp=tp))
    jshard, _ = jsh.shard_qwen35(mesh, jcfg, jparams,
                                 jq.make_state(jcfg, NUM_PAGES, PS, MAX_SLOTS,
                                               kv_dtype=jnp.float32))
    tparams = tq.params_from_jax(_np_tree(jparams))
    full = jax.tree.map(lambda a: np.asarray(a, np.float32 if a.dtype == jnp.bfloat16
                                             else a.dtype), jparams)
    for r in range(tp):
        dev = mesh.devices.flat[r]
        mine = sharding.shard_qwen35(cfg, tparams, r, tp)
        pairs = [(mine[k], jshard[k], (k,)) for k in ("embed", "final_ln", "lm_head")]
        pairs += [(mine[p][k], jshard[p][k], (p, k)) for p in ("lin", "full") for k in mine[p]]
        for got, want, name in pairs:
            if name in EXCEPTIONS:
                rule, axis = EXCEPTIONS[name]
                w = full[name[0]][name[1]]
                if isinstance(got, dict):  # int8 mlp_gate_up: its codes and scales
                    exp_q = _exception(jcfg, rule, w["q8"], axis, r, tp)
                    np.testing.assert_array_equal(got["q"].numpy(), np.swapaxes(exp_q, -1, -2))
                    np.testing.assert_array_equal(got["s"].numpy(),
                                                  _exception(jcfg, rule, w["s"], -1, r, tp))
                    contiguous = np.swapaxes(_on(want["q8"], dev), -1, -2)
                    got_t = got["q"].numpy()
                else:
                    np.testing.assert_array_equal(_np(got), _exception(jcfg, rule, w, axis, r,
                                                                       tp), err_msg=str(name))
                    contiguous, got_t = _on(want, dev), _np(got)
                assert got_t.shape == contiguous.shape
                if r == 0:  # the JAX contiguous shard holds other channels
                    assert not np.array_equal(got_t, contiguous), name
            elif isinstance(got, dict):
                np.testing.assert_array_equal(got["q"].numpy(),
                                              np.swapaxes(_on(want["q8"], dev), -1, -2))
                np.testing.assert_array_equal(got["s"].numpy(), _on(want["s"], dev))
            else:
                leaf = tparams[name[0]] if len(name) == 1 else tparams[name[0]][name[1]]
                assert got.dtype == leaf.dtype
                np.testing.assert_array_equal(_np(got), _on(want, dev), err_msg=str(name))


@pytest.mark.parametrize("tp", [2, 4])
def test_a_rank_state_is_the_jax_state_shard_but_its_conv_channels(setup, tp):
    """A rank's state (``make_state`` at ``local_config_qwen35``) against a
    random whole state's JAX shards: kv (its kv heads) and rec (its value
    heads) are the JAX shards' shape and rows, the contiguous runs; conv
    holds the rank's own channels in ``conv_w``'s order (``conv_channels``
    on its last axis, ``q[r] ‖ k[r] ‖ v[r]``), unequal to the JAX run."""
    jcfg, _, cfg, _ = setup
    rng = np.random.default_rng(tp)
    zero = jq.make_state(jcfg, NUM_PAGES, PS, MAX_SLOTS, kv_dtype=jnp.float32)
    full = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in zero.items()}
    mesh = jsh.make_mesh(jsh.MeshConfig(dp=1, tp=tp))
    jparams = jq.init_random_params(jcfg, seed=1, dtype=jnp.float32)
    _, jstate = jsh.shard_qwen35(mesh, jcfg, jparams, {k: jnp.asarray(v) for k, v in full.items()})
    local = tq.make_state(sharding.local_config_qwen35(cfg, tp), NUM_PAGES, PS, MAX_SLOTS)
    for r in range(tp):
        dev = mesh.devices.flat[r]
        for k, axis in (("kv", 1), ("rec", 3)):
            assert tuple(local[k].shape) == _on(jstate[k], dev).shape
            np.testing.assert_array_equal(_run(full[k], axis, r, tp), _on(jstate[k], dev))
        conv = sharding.conv_channels(cfg, torch.from_numpy(full["conv"]), -1, r, tp)
        assert conv.shape == local["conv"].shape
        np.testing.assert_array_equal(conv.numpy(), _conv_shard(cfg, full["conv"], -1, r, tp))
        assert not np.array_equal(conv.numpy(), _on(jstate["conv"], dev))


@pytest.mark.parametrize("tp", [2, 4])
def test_each_rank_value_head_reads_its_own_key_head(setup, tp):
    """Conv channels labelled by their head (q and k by key head, v by value
    head), cut as a rank's, split by ``_gdn_split_heads`` at the local
    config: local value head i carries global value head Hv/tp r + i and
    global key head (Hv/tp r + i) // R, the one-process map."""
    _, _, cfg, _ = setup
    Hk, Hv = cfg.linear_num_key_heads, cfg.linear_num_value_heads
    R = Hv // Hk
    kd, dk, dv = cfg.key_dim, cfg.linear_key_head_dim, cfg.linear_value_head_dim
    label = torch.cat([torch.arange(Hk).repeat_interleave(dk)] * 2
                      + [torch.arange(Hv).repeat_interleave(dv)]).float()[None]
    assert label.shape[1] == cfg.conv_dim and kd == Hk * dk
    q, k, v = tq._gdn_split_heads(cfg, label)  # the one-process map
    whole = {int(v[0, h, 0]): int(q[0, h, 0]) for h in range(Hv)}
    assert whole == {h: h // R for h in range(Hv)}
    lcfg = sharding.local_config_qwen35(cfg, tp)
    for r in range(tp):
        ql, kl, vl = tq._gdn_split_heads(lcfg, sharding.conv_channels(cfg, label, -1, r, tp))
        n = Hv // tp
        assert [int(vl[0, i, 0]) for i in range(n)] == list(range(n * r, n * (r + 1)))
        for i in range(n):
            assert int(ql[0, i, 0]) == int(kl[0, i, 0]) == whole[n * r + i]
            assert int(ql[0, i, 0]) == Hk // tp * r + i // R


def test_local_config_divides_the_heads_and_the_intermediate_width(setup):
    _, _, cfg, _ = setup
    lcfg = sharding.local_config_qwen35(cfg, 4)
    assert (lcfg.linear_num_key_heads, lcfg.linear_num_value_heads, lcfg.num_attention_heads,
            lcfg.num_key_value_heads, lcfg.intermediate_size, lcfg.vocab_size) == (
        1, 2, 2, 1, 32, 256)
    assert (lcfg.key_dim, lcfg.value_dim, lcfg.conv_dim) == (8, 16, 32)
    assert tq.slot_bytes(lcfg) * 4 == tq.slot_bytes(cfg)


@pytest.mark.parametrize("over", [dict(linear_num_key_heads=2), dict(linear_num_value_heads=6),
                                  dict(num_attention_heads=6), dict(num_key_value_heads=2),
                                  dict(intermediate_size=130), dict(vocab_size=258)])
def test_validate_qwen35_tp_raises_the_jax_errors(over):
    with pytest.raises(ValueError) as want:
        jsh.validate_qwen35_tp(jq.Qwen35Config(**_cfg_kw(**over)), 4)
    with pytest.raises(ValueError) as got:
        sharding.validate_qwen35_tp(tq.Qwen35Config(**_cfg_kw(**over)), 4)
    assert str(got.value) == str(want.value)
