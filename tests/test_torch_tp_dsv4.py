"""DeepSeek-V4's model parallelism in the port against the JAX package's MP8
mesh, on the CPU.

- The shards (``parallel/sharding.py::shard_dsv4``) at tp 2, 4 and 8
  against the JAX ``shard_dsv4``'s ``addressable_shards[r]``: f32 leaves and
  the resident tree's fp8 / packed-fp4 containers (the JAX fp8 scales are
  whole on every device, ``place_tree``: the port's are held to that whole
  grid cut by its block rule); ``validate_dsv4_mp8``'s JAX messages,
  ``local_config_dsv4``, a cut inside a scale block.
- The model under ``tp`` (``prefill`` then one ``decode`` step with a
  rank's ``RankGroups``, gloo over a ``FileStore`` under ``tmp_path``, one
  thread a rank) on ``tests/test_dsv4_sharding.py``'s ``tiny8`` (f32, seed
  3, its 9 tokens): rank 0's logits against the port at tp 1 at that
  test's tolerances (2e-4 the prefill, 5e-4 and the argmax the decode
  step), against the JAX unsharded and MP8 runs at the port's own JAX
  tolerance (``LOGIT_TOL``: the port rounds the MoE's activations to bf16)
  with the argmax equal, every rank's logits and route tape (the gates'
  experts, the indexer's selections) the same bits, and the collectives
  ``collectives_per_forward`` a forward. The same on the resident tree
  (fp8 / packed fp4, a hash layer: K3 at the local ids, K5 on the rank's
  rows, their plain versions here) and in bf16 (``bf16_grouped``, the
  gathered decode rows) against tp 1.
- The combine (``_moe`` under ``tp``, the routing handed in through a
  replayed tape, the shared expert zero) against the JAX ``moe_ep``
  (``tests/test_moe_ep.py``'s case) and against the whole ``_moe``.
- ``RouteTape``'s replay (its entries in place of the run's own, flips
  counted).

The engine (processes, the loader, the CLI) is
``tests/test_torch_tp_dsv4_engine.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pegainfer_tpu.models import dsv4 as jdsv4
from pegainfer_tpu.ops.moe_ep import moe_ep as j_moe_ep
from pegainfer_tpu.parallel import sharding as jsh
from pegainfer_tpu_torch.models import dsv4 as tdsv4
from pegainfer_tpu_torch.ops import quant
from pegainfer_tpu_torch.parallel import sharding
from tests.test_torch_dsv4 import LOGIT_TOL
from tests.test_torch_tp import _np, _on, run_ranks

TPS = (2, 4, 8)
PREFILL_TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_dsv4_sharding.py's
DECODE_TOL = dict(rtol=5e-4, atol=5e-4)


def tiny8_kw(**over):
    kw = dict(vocab_size=128, dim=32, moe_inter_dim=16, n_layers=2, num_attention_heads=8,
              head_dim=16, q_lora_rank=16, qk_rope_head_dim=8, o_groups=8, o_lora_rank=4,
              sliding_window=8, n_routed_experts=8, n_shared_experts=1, n_activated_experts=2,
              n_hash_layers=0, routed_scaling_factor=1.5, swiglu_limit=7.0, rms_norm_eps=1e-6,
              index_n_heads=8, index_head_dim=16, index_topk=4, max_position_embeddings=4096,
              rope_theta=1e4, compress_rope_theta=1e4, compress_ratios=(0, 4),
              yarn_original_seq_len=256, yarn_factor=4.0)
    kw.update(over)
    return kw


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny8():
    """test_dsv4_sharding.py's config, f32 params (JAX and the port's copy)
    and tokens."""
    jcfg = jdsv4.DSv4Config(**tiny8_kw())
    jparams = jdsv4.init_random_params(jcfg, seed=3, dtype=jnp.float32, scale=0.08)
    toks = np.random.default_rng(4).integers(2, 128, 9)
    tparams = tdsv4.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, tdsv4.DSv4Config(**tiny8_kw()), tparams, toks


@pytest.fixture(scope="module")
def jax_runs(tiny8):
    """The JAX prefill (last row) and decode-step logits, unsharded and on
    the MP8 mesh (test_dsv4_sharding.py's run)."""
    jcfg, jparams, _, _, toks = tiny8
    pf = jax.jit(lambda p, t, s: jdsv4.prefill(jcfg, p, t, state=s, slot=jnp.int32(0)))
    dc = jax.jit(lambda p, s, *a: jdsv4.decode(jcfg, p, s, *a)[1])
    step = (jnp.asarray([toks[8]], jnp.int32), jnp.asarray([8], jnp.int32),
            jnp.asarray([0], jnp.int32))
    out = {}
    for name, tp in (("one", None), ("mp8", 8)):
        params, state = jparams, jdsv4.make_state(jcfg, max_slots=1, max_blocks=8)
        if tp:
            params, state = jsh.shard_dsv4(jsh.make_mesh(jsh.MeshConfig(dp=1, tp=tp)), params,
                                           state)
        logits, state = pf(params, jnp.asarray(toks[:8], jnp.int32), state)
        out[name] = (np.asarray(logits[-1]), np.asarray(dc(params, state, *step))[0])
    return out


def port_forward(cfg, params, toks, tp_size, store, dtype=torch.float32, plain=False):
    """Prefill of toks[:8] into slot 0, then one decode step of toks[8] at
    position 8, on ``tp_size`` ranks in threads (1: one process, no
    groups). Each rank: (prefill logits [8, V], step logits [V], its route
    tape's host entries, its collectives)."""
    def run(r, g):
        shard = params if g is None else sharding.shard_dsv4(cfg, params, r, tp_size)
        lcfg = cfg if g is None else sharding.local_config_dsv4(cfg, tp_size)
        tape = tdsv4.RouteTape()
        state = tdsv4.make_state(cfg, 1, 8, dtype=dtype)
        t = torch.tensor(toks, dtype=torch.int32)
        one = torch.tensor([0], dtype=torch.int32)
        with torch.no_grad():
            lp, _ = tdsv4.prefill(lcfg, shard, t[:8], state=state, slot=0, tp=g, tape=tape,
                                  plain_kernels=plain)
            ld = tdsv4.decode(lcfg, shard, state, t[8:9], torch.tensor([8], dtype=torch.int32),
                              one, tp=g, tape=tape, plain_kernels=plain)
        return lp.float(), ld[0].float(), tape.host(), None if g is None else g.collectives

    if tp_size == 1:
        return [run(0, None)]
    return run_ranks(tp_size, store, run)


def assert_same_tapes(runs):
    """Every rank's route ids and selections equal rank 0's, bit for bit."""
    ref = runs[0][2]
    assert ref and {k for k, _ in ref} == {"route", "select"}
    for _, _, tape, _ in runs[1:]:
        assert [k for k, _ in tape] == [k for k, _ in ref]
        for (_, a), (_, b) in zip(tape, ref):
            assert all(torch.equal(x, y) for x, y in zip(a, b))


def assert_ranks_agree(runs, cfg):
    lp, ld = runs[0][0], runs[0][1]
    for r in runs[1:]:
        assert torch.equal(r[0], lp) and torch.equal(r[1], ld)
    assert_same_tapes(runs)
    assert all(c == 2 * tdsv4.collectives_per_forward(cfg) for *_, c in runs)


@pytest.fixture(scope="module")
def port_one(tiny8, tmp_path_factory):
    _, _, cfg, tparams, toks = tiny8
    return port_forward(cfg, tparams, toks, 1, None)[0]


@pytest.mark.parametrize("tp", TPS)
def test_port_tp_matches_tp1_and_the_jax_mp8_mesh(tiny8, jax_runs, port_one, tp, tmp_path):
    _, _, cfg, tparams, toks = tiny8
    runs = port_forward(cfg, tparams, toks, tp, str(tmp_path / "store"))
    assert_ranks_agree(runs, cfg)
    lp, ld = runs[0][0][-1].numpy(), runs[0][1].numpy()
    np.testing.assert_allclose(lp, port_one[0][-1].numpy(), **PREFILL_TOL)
    np.testing.assert_allclose(ld, port_one[1].numpy(), **DECODE_TOL)
    assert int(ld.argmax()) == int(port_one[1].argmax())
    for name in ("one", "mp8"):
        jp, jd = jax_runs[name]
        np.testing.assert_allclose(lp, jp, **LOGIT_TOL)
        np.testing.assert_allclose(ld, jd, **LOGIT_TOL)
        assert int(ld.argmax()) == int(jd.argmax())
    # the route tape: rank 0 chose tp 1's experts and rows (its weights are
    # f32 sums in another order)
    assert [k for k, _ in runs[0][2]] == [k for k, _ in port_one[2]]
    for (k, a), (_, b) in zip(runs[0][2], port_one[2]):
        assert torch.equal(tdsv4._decision_rows(k, a), tdsv4._decision_rows(k, b))


@pytest.fixture(scope="module")
def trees():
    """tiny8 with a hash layer: {"resident": its f32 draws quantized to the
    resident tree (fp8 linears, packed-fp4 experts; f32 activations),
    "bf16": its bf16 draws quantized, then dequantized as the bf16 mode
    does (bf16 activations)}."""
    cfg = tdsv4.DSv4Config(**tiny8_kw(n_hash_layers=1))
    res = tdsv4.quantize_params_resident(
        tdsv4.init_random_params(cfg, seed=7, dtype=torch.float32, scale=0.08))
    bf = tdsv4.quantize_params_resident(
        tdsv4.init_random_params(cfg, seed=7, dtype=torch.bfloat16, scale=0.08))
    tdsv4.dequantize_params(bf, torch.bfloat16)
    return cfg, {"resident": (res, torch.float32), "bf16": (bf, torch.bfloat16)}


@pytest.mark.parametrize("mode", ["resident", "bf16"])
@pytest.mark.parametrize("tp", [2, 8])
def test_port_tp_on_the_resident_and_bf16_trees(trees, tiny8, mode, tp, tmp_path):
    """K3's and K5's paths at the local ids (their plain versions here, as
    on the card with ``plain_kernels``), the bf16 mode's grouped and
    gathered rows: rank 0 against tp 1 (the resident tree at the sharding
    tolerances; bf16 activations at ``LOGIT_TOL``), the ranks' logits and
    tapes the same bits."""
    cfg, by_mode = trees
    params, dtype = by_mode[mode]
    toks = tiny8[4]
    one = port_forward(cfg, params, toks, 1, None, dtype=dtype)[0]
    runs = port_forward(cfg, params, toks, tp, str(tmp_path / "store"), dtype=dtype)
    assert_ranks_agree(runs, cfg)
    tol = (PREFILL_TOL, DECODE_TOL) if mode == "resident" else (LOGIT_TOL, LOGIT_TOL)
    np.testing.assert_allclose(runs[0][0].numpy(), one[0].numpy(), **tol[0])
    np.testing.assert_allclose(runs[0][1].numpy(), one[1].numpy(), **tol[1])
    assert int(runs[0][1].argmax()) == int(one[1].argmax())


# ── the combine ─────────────────────────────────────────────────────────


def test_the_combine_matches_the_jax_moe_ep(tmp_path):
    """tests/test_moe_ep.py's case (T 3, D 16, I 8, E 8, K 2, limit 7) through
    ``_moe`` at tp 2 and 8: the routing handed in by a replayed tape, the
    shared expert zero. Against the JAX ``moe_ep`` on the mesh within the
    port's bf16 rounding of the rows (each row to 1e-2 of its max), and
    against the port's whole ``_moe`` to f32 sums in another order."""
    rng = np.random.default_rng(0)
    T, D, I, E, K = 3, 16, 8, 8, 2

    def bf(a):  # values bf16 holds, so the two sides start from the same ones
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float().numpy()

    x = bf(rng.standard_normal((T, D)))
    w1, w2, w3 = (bf(rng.standard_normal(s) * 0.2) for s in ((E, I, D), (E, D, I), (E, I, D)))
    idx = np.stack([rng.choice(E, K, replace=False) for _ in range(T)]).astype(np.int32)
    wts = rng.random((T, K)).astype(np.float32)
    mesh = jsh.make_mesh(jsh.MeshConfig(dp=1, tp=8))
    put = lambda a: jsh.place_tree(mesh, jnp.asarray(a), jsh.P("tp"))  # noqa: E731
    ref = np.asarray(j_moe_ep(mesh, jnp.asarray(x), put(w1), put(w2), put(w3),
                              jnp.asarray(idx), jnp.asarray(wts), 7.0))

    cfg = tdsv4.DSv4Config(**tiny8_kw(dim=D, moe_inter_dim=I, n_routed_experts=E,
                                      n_activated_experts=K))
    t = torch.from_numpy
    lw = {"gate_weight": torch.zeros(E, D), "gate_bias": torch.zeros(E),
          "shared_w1": torch.zeros(I, D), "shared_w2": torch.zeros(D, I),
          "shared_w3": torch.zeros(I, D), "experts_w1": t(w1), "experts_w2": t(w2),
          "experts_w3": t(w3)}
    routes = [("route", (t(wts), t(idx)))]
    tokens = torch.zeros(T, dtype=torch.int32)
    whole = tdsv4._moe(cfg, lw, False, t(x), tokens, tape=tdsv4.RouteTape(routes))

    def rank(r, g, tp):
        mine = {k: (sharding.shard_dsv4_leaf(k, v, r, tp)) for k, v in lw.items()}
        return tdsv4._moe(sharding.local_config_dsv4(cfg, tp), mine, False, t(x), tokens,
                          tp=g, tape=tdsv4.RouteTape(routes))

    lim = 1e-2 * np.abs(ref).max(axis=1, keepdims=True)
    for tp in (2, 8):
        outs = run_ranks(tp, str(tmp_path / f"store{tp}"), lambda r, g: rank(r, g, tp))
        assert all(torch.equal(o, outs[0]) for o in outs)
        assert (np.abs(outs[0].numpy() - ref) <= lim).all()
        np.testing.assert_allclose(outs[0].numpy(), whole.numpy(), rtol=1e-6, atol=1e-6)


def test_a_replayed_tape_routes_as_recorded_and_counts_flips(tiny8):
    """A run replaying another run's tape takes its decisions (the logits
    then equal that run's) and counts the rows where its own differ."""
    _, _, cfg, tparams, toks = tiny8
    t = torch.tensor(toks[:8], dtype=torch.int32)
    rec = tdsv4.RouteTape()
    with torch.no_grad():
        ref, _ = tdsv4.prefill(cfg, tparams, t, tape=rec)
        same = tdsv4.RouteTape(rec.host())
        got, _ = tdsv4.prefill(cfg, tparams, t, tape=same)
    assert torch.equal(got, ref) and same.flips == 0 and same.rows > 0
    forced = rec.host()
    k, (w, e) = next((i, v) for i, (kind, v) in enumerate(forced) if kind == "route")
    forced[k] = ("route", (w, (e + 1) % cfg.n_routed_experts))
    swap = tdsv4.RouteTape(forced)
    with torch.no_grad():
        tdsv4.prefill(cfg, tparams, t, tape=swap)
    # every token of that call, and later decisions the swapped experts moved
    assert 8 <= swap.flips <= swap.rows
    with pytest.raises(RuntimeError, match="replaying"):
        with torch.no_grad():
            tdsv4.prefill(cfg, tparams, t, tape=tdsv4.RouteTape(forced[1:]))


# ── the shards against the JAX shards ───────────────────────────────────


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _full(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name in ("bfloat16", "float8_e4m3fn") else a


def _port_np(t):
    return _np(t.float() if t.dtype == quant.F8 else t)


@pytest.mark.parametrize("mode", ["f32", "resident"])
@pytest.mark.parametrize("tp", TPS)
def test_shards_match_the_jax_shards(tiny8, tp, mode):
    jcfg, jparams, cfg, _, _ = tiny8
    if mode == "resident":
        jparams = jdsv4.quantize_params_resident(jparams)
    mesh = jsh.make_mesh(jsh.MeshConfig(dp=1, tp=tp))
    jshard, _ = jsh.shard_dsv4(mesh, jparams)
    tparams = tdsv4.params_from_jax(jax.tree.map(np.asarray, jparams))
    jleaves = dict(_leaves(jshard))
    whole = dict(_leaves(jparams))
    seen = 0
    for r in range(tp):
        dev = mesh.devices.flat[r]
        mine = dict(_leaves(sharding.shard_dsv4(cfg, tparams, r, tp)))
        assert sorted(mine) == sorted(jleaves)
        for path, got in mine.items():
            want = jleaves[path]
            key = path.rsplit("/", 2)
            if key[-1] == "s" and want.ndim == 2:  # JAX: the fp8 grid whole on every device
                full = _full(whole[path])
                assert np.array_equal(_full(_on(want, dev)), full)
                axis = sharding.DSV4_LAYER_SPLIT.get(key[-2])
                if axis is not None and full.shape[axis] > 1:  # one block: whole
                    n = full.shape[axis] // tp
                    full = np.take(full, range(r * n, (r + 1) * n), axis=axis)
                np.testing.assert_array_equal(_port_np(got), full, err_msg=path)
            else:
                np.testing.assert_array_equal(_port_np(got), _full(_on(want, dev)),
                                              err_msg=path)
            seen += 1
    assert seen == tp * len(jleaves)


@pytest.mark.parametrize("name", ["num_attention_heads", "o_groups", "n_routed_experts",
                                  "index_n_heads", "vocab_size"])
def test_validate_dsv4_mp8_raises_the_jax_errors(name):
    over = {name: {"vocab_size": 132}.get(name, 12)}
    with pytest.raises(ValueError) as want:
        jsh.validate_dsv4_mp8(jdsv4.DSv4Config(**tiny8_kw(**over)))
    with pytest.raises(ValueError) as got:
        sharding.validate_dsv4_mp8(tdsv4.DSv4Config(**tiny8_kw(**over)))
    assert str(got.value) == str(want.value)


def test_local_config_and_a_cut_inside_a_scale_block():
    cfg = tdsv4.DSv4Config(**tiny8_kw())
    lcfg = sharding.local_config_dsv4(cfg, 4)
    assert (lcfg.num_attention_heads, lcfg.o_groups, lcfg.index_n_heads,
            lcfg.n_routed_experts, lcfg.vocab_size, lcfg.n_layers) == (2, 2, 2, 2, 128, 2)
    w = quant.quantize_fp8_tensor(np.random.default_rng(0).standard_normal((256, 256)))
    assert tuple(w["s"].shape) == (2, 2)
    with pytest.raises(ValueError, match="falls inside its scale blocks"):
        sharding.shard_dsv4_leaf("wq_b", w, 0, 4)
    two = sharding.shard_dsv4_leaf("wo_b", w, 1, 2)  # cut on the input, on a block edge
    assert torch.equal(two["q"].float(), w["q"][:, 128:].float())
    assert torch.equal(two["s"], w["s"][:, 1:])
