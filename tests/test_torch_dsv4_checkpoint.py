"""DeepSeek-V4 from an mp8 checkpoint in the port, against the JAX package,
on the CPU: the manifest and its problem lists, the streaming loader's
trees in the resident and bf16 modes (bit for bit, on the test fixtures'
dtypes and on the real checkpoint's packed ``F4`` and ``F8_E8M0``),
``start_engine(path)``'s greedy tokens in the three modes, the bf16 mode's
forward, the refusals and the CLI.

The tiny checkpoint is ``tests/test_dsv4_engine.py``'s (``tiny_cfg_dict``,
``write_fake_checkpoint``: f32 scales, E2M1 values in E4M3 containers). Its
real-dtype twin is written here by a header writer of the test's own: each
expert weight packed two E2M1 codes a byte, each scale its E8M0 code; the
JAX reader takes these through ml_dtypes. The JAX loads and engines are
made once a module; the module runs on one torch thread (the tiny model's
thousands of small ops).
"""

import json
import logging
import os
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pegainfer_tpu.engine import contract as jc
from pegainfer_tpu.models import dsv4 as jdsv4
from pegainfer_tpu.models import dsv4_engine as jengine
from pegainfer_tpu.models import dsv4_manifest as jman
from pegainfer_tpu.models import dsv4_weights as jweights
from pegainfer_tpu_torch.engine import contract as tc
from pegainfer_tpu_torch.engine.slot_executor import SlotExecutor
from pegainfer_tpu_torch.models import dsv4 as tdsv4
from pegainfer_tpu_torch.models import dsv4_engine as tengine
from pegainfer_tpu_torch.models import dsv4_manifest as tman
from pegainfer_tpu_torch.models import dsv4_weights as tweights
from pegainfer_tpu_torch.ops import quant as tquant
from pegainfer_tpu_torch.server import main as tmain
from pegainfer_tpu_torch.utils import weights as tw
from tests.test_dsv4_engine import tiny_cfg_dict, write_fake_checkpoint
from tests.test_torch_dsv4 import LOGIT_TOL

WAIT_S = 300
PROMPTS = ([3, 17, 42, 9, 88], [5, 60, 7, 21, 99, 14, 33, 2, 71, 8, 45])
MAX_TOKENS = 6
# the engines' options on both sides (the JAX test's)
OPTS = dict(max_batch_size=2, max_model_len=64)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ── the checkpoints ─────────────────────────────────────────────────────


def read_raw(path):
    """A safetensors file's tensors as {name: (dtype, shape, bytes)}, in
    the header's order of offsets."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = f.read()
    header.pop("__metadata__", None)
    items = sorted(header.items(), key=lambda kv: kv[1]["data_offsets"][0])
    return {k: (e["dtype"], list(e["shape"]), data[slice(*e["data_offsets"])]) for k, e in items}


def write_raw(path, tensors):
    """``read_raw``'s form back to a safetensors file, any dtype name."""
    header, off = {}, 0
    for name, (dtype, shape, raw) in tensors.items():
        header[name] = {"dtype": dtype, "shape": shape, "data_offsets": [off, off + len(raw)]}
        off += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head)
        for _, _, raw in tensors.values():
            f.write(raw)


def to_real_dtypes(src, dst):
    """The fixture checkpoint at ``src`` in the real checkpoint's dtypes at
    ``dst``: expert weights packed ``F4`` (the E4M3 containers hold E2M1
    values), scales ``F8_E8M0`` codes (the f32 scales are powers of two)."""
    shutil.copytree(src, dst)
    for path in tman.rank_files(str(dst)):
        out = {}
        for name, (dtype, shape, raw) in read_raw(path).items():
            if name.endswith(".scale"):
                bits = np.frombuffer(raw, np.uint32)
                assert dtype == "F32" and not (bits & 0x807FFFFF).any()  # positive powers of 2
                out[name] = ("F8_E8M0", shape, (bits >> 23).astype(np.uint8).tobytes())
            elif ".ffn.experts." in name:
                vals = torch.frombuffer(bytearray(raw), dtype=torch.float8_e4m3fn).float()
                out[name] = ("F4", shape, tquant.pack_fp4(vals.numpy()).tobytes())
            else:
                out[name] = (dtype, shape, raw)
        write_raw(path, out)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """{"fixture": dir, "real": dir}, the configs and the JAX params."""
    root = tmp_path_factory.mktemp("dsv4_mp8")
    fixture = root / "fixture"
    fixture.mkdir()
    (fixture / "config.json").write_text(json.dumps(tiny_cfg_dict()))
    jcfg = jdsv4.DSv4Config.from_model_path(str(fixture))
    tcfg = tdsv4.DSv4Config.from_model_path(str(fixture))
    params = jdsv4.init_random_params(jcfg, seed=5, dtype=jnp.float32, scale=0.08)
    write_fake_checkpoint(fixture, jcfg, params)
    to_real_dtypes(fixture, root / "real")
    return {"fixture": str(fixture), "real": str(root / "real"), "jcfg": jcfg, "tcfg": tcfg}


_JAX_LOADS = {}


def jax_tree(ckpt, dtypes, resident):
    """The JAX loader's tree as the port's (``params_from_jax``), once."""
    key = (dtypes, resident)
    if key not in _JAX_LOADS:
        jp = jweights.load_params(ckpt["jcfg"], ckpt[dtypes], resident=resident)
        _JAX_LOADS[key] = tdsv4.params_from_jax(jax.tree.map(np.asarray, jp))
    return _JAX_LOADS[key]


def assert_same_tree(got, want, path="params"):
    """The same keys and lists, and every leaf of the same dtype, shape and
    bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{path}[{i}]")
    else:
        assert (got.dtype, tuple(got.shape)) == (want.dtype, tuple(want.shape)), path
        assert torch.equal(got.reshape(-1).view(torch.uint8),
                           want.reshape(-1).view(torch.uint8)), path


# ── (a) the manifest ────────────────────────────────────────────────────

FLASH_8 = dict(
    vocab_size=129280, dim=4096, moe_inter_dim=2048, n_layers=8, num_attention_heads=64,
    head_dim=512, q_lora_rank=1024, qk_rope_head_dim=64, o_groups=8, o_lora_rank=1024,
    sliding_window=128, n_routed_experts=256, n_shared_experts=1, n_activated_experts=6,
    n_hash_layers=3, routed_scaling_factor=1.5, swiglu_limit=7.0, rms_norm_eps=1e-6,
    index_n_heads=64, index_head_dim=128, index_topk=512, max_position_embeddings=1048576,
    rope_theta=10000.0, compress_rope_theta=10000.0,
    compress_ratios=(0, 0, 4, 128, 4, 128, 4, 128), yarn_original_seq_len=65536,
    yarn_factor=16.0)


def _manifest(mod, cfg, rank):
    return {k: (tuple(v.shape), v.dtypes, tuple(v.scale_of), tuple(v.scale_block))
            for k, v in mod.expected_rank_manifest(cfg, rank).items()}


@pytest.mark.parametrize("config", ["tiny", "flash_8_layers"])
def test_expected_rank_manifest_equals_jax(config, ckpt):
    """Every rank's expected tensors, shard shapes, dtypes and scale grids,
    at the tiny config and at DeepSeek-V4-Flash's widths cut to 8 layers."""
    if config == "tiny":
        jcfg, tcfg = ckpt["jcfg"], ckpt["tcfg"]
    else:
        jcfg, tcfg = jdsv4.DSv4Config(**FLASH_8), tdsv4.DSv4Config(**FLASH_8)
    for rank in range(tman.WORLD):
        got = _manifest(tman, tcfg, rank)
        assert got == _manifest(jman, jcfg, rank)
    if config != "tiny":  # the last rank's last expert, and an indexer shard
        assert got["layers.7.ffn.experts.255.w2.scale"][2] == (4096, 2048)
        assert got["layers.6.attn.indexer.wq_b.weight"][0] == (64 * 128 // 8, 1024)


# ── (b) validation ──────────────────────────────────────────────────────


def _mutate(rank, fn):
    def corrupt(path):
        f = tman.rank_files(str(path))[rank]
        tensors = read_raw(f)
        fn(tensors)
        write_raw(f, tensors)
    return corrupt


def _drop_add(t):
    del t["layers.0.attn.wq_a.weight"]
    t["layers.0.attn.bogus"] = ("F32", [3], bytes(12))


def _short_embed(t):
    dtype, shape, raw = t["embed.weight"]
    t["embed.weight"] = (dtype, [shape[0] - 1, shape[1]], raw[:-2 * shape[1]])


def _f32_norm(t):
    _, shape, raw = t["norm.weight"]
    vals = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
    t["norm.weight"] = ("F32", shape, vals.tobytes())


def _double_scale(t):
    dtype, shape, raw = t["layers.0.attn.wq_a.scale"]
    t["layers.0.attn.wq_a.scale"] = (dtype, [2 * shape[0], *shape[1:]], raw + raw)


def _zero_norm(t):
    dtype, shape, raw = t["norm.weight"]
    t["norm.weight"] = (dtype, shape, bytes(len(raw)))


CORRUPTIONS = {
    "valid": (None, False),
    "valid_deep": (None, True),
    "missing_rank_file": (lambda p: os.remove(tman.rank_files(str(p))[3]), False),
    "missing_and_extra_tensor": (_mutate(1, _drop_add), False),
    "wrong_shard_shape": (_mutate(0, _short_embed), False),
    "wrong_dtype": (_mutate(2, _f32_norm), False),
    "wrong_scale_grid": (_mutate(0, _double_scale), False),
    "replicated_divergence_deep": (_mutate(5, _zero_norm), True),
    "replicated_divergence_shallow": (_mutate(5, _zero_norm), False),
    "real_dtypes": ("real", True),
}


@pytest.mark.parametrize("case", sorted(CORRUPTIONS))
def test_validate_checkpoint_problems_equal_jax(case, ckpt, tmp_path):
    """The problem list of the JAX ``validate_checkpoint``, string for
    string, for tests/test_dsv4_manifest.py's checkpoints; the loader
    refuses each broken one with ValueError before it reads a tensor."""
    corrupt, deep = CORRUPTIONS[case]
    if corrupt == "real":
        path = ckpt["real"]
    else:
        path = tmp_path / "ckpt"
        shutil.copytree(ckpt["fixture"], path)
        if corrupt is not None:
            corrupt(path)
        path = str(path)
    want = jman.validate_checkpoint(ckpt["jcfg"], path, deep=deep)
    got = tman.validate_checkpoint(ckpt["tcfg"], path, deep=deep)
    assert got == want
    assert bool(got) == (corrupt not in (None, "real")
                         and case != "replicated_divergence_shallow")
    if got and not deep:
        reads = []
        orig = tw.SafetensorsReader.read

        def counted(self, name):
            reads.append(name)
            return orig(self, name)

        tw.SafetensorsReader.read = counted
        try:
            with pytest.raises(ValueError, match="manifest validation"):
                tweights.load_params(ckpt["tcfg"], path, device="cpu")
        finally:
            tw.SafetensorsReader.read = orig
        assert reads == []


def test_world_divisibility_raises_as_jax():
    kw = dict(FLASH_8, num_attention_heads=6, n_layers=1, compress_ratios=(0,))
    with pytest.raises(ValueError, match="heads") as want:
        jman.expected_rank_manifest(jdsv4.DSv4Config(**kw), 0)
    with pytest.raises(ValueError, match="heads") as got:
        tman.expected_rank_manifest(tdsv4.DSv4Config(**kw), 0)
    assert str(got.value) == str(want.value)


# ── (c) the loader ──────────────────────────────────────────────────────


@pytest.mark.parametrize("dtypes", ["fixture", "real"])
@pytest.mark.parametrize("resident", [True, False], ids=["resident", "bf16"])
def test_load_params_equals_jax_bit_for_bit(dtypes, resident, ckpt):
    """Every leaf of the port's tree equals the JAX loader's (carried over
    by ``params_from_jax``): keys, dtypes, shapes and bits."""
    got = tweights.load_params(ckpt["tcfg"], ckpt[dtypes], resident=resident, device="cpu")
    assert_same_tree(got, jax_tree(ckpt, dtypes, resident))
    w1 = got["layers"][1]["experts_w1"]
    if resident:
        assert w1["q"].dtype == torch.uint8 and w1["s"].dtype == torch.bfloat16
        assert got["layers"][0]["wq_b"]["q"].dtype == torch.float8_e4m3fn
    else:
        assert w1.dtype == torch.bfloat16 and not any(
            tquant.is_quantized(v) for lw in got["layers"] for v in lw.values())
    assert got["layers"][0]["gate_tid2eid"].dtype == torch.int32


def test_reader_reads_the_real_dtypes_as_jax(ckpt):
    """``SafetensorsReader`` of a real-dtype rank file against the JAX
    reader's (ml_dtypes): header shapes and dtypes, the packed bytes, and
    every tensor's values (``read_safetensors_raw``: E8M0 and F4 as f32)."""
    path = tman.rank_files(ckpt["real"])[2]
    got, want = tw.SafetensorsReader(path), jweights.SafetensorsReader(path)
    assert sorted(got.keys()) == sorted(want.keys())
    assert {want.stored_dtype(n) for n in want.keys()} >= {"F4", "F8_E8M0"}
    values = tw.read_safetensors_raw(path)
    for name, ref in jweights.read_safetensors_raw(path).items():
        assert got.shape(name) == want.shape(name)
        assert got.stored_dtype(name) == want.stored_dtype(name)
        value = values[name]
        if value.is_floating_point():
            value, ref = value.float(), np.asarray(ref, np.float32)
        np.testing.assert_array_equal(value.numpy(), np.asarray(ref))
        packed = want.read_f4_packed(name)
        if packed is None:
            assert got.read_f4_packed(name) is None
        else:
            np.testing.assert_array_equal(got.read_f4_packed(name).numpy(), packed)


# ── (d) start_engine(path) ──────────────────────────────────────────────


def _collect(mod, handle, logprobs=0):
    """Each of PROMPTS greedily, one after another: [(ids, top-2 gaps)]."""
    out = []
    for p in PROMPTS:
        ch = mod.TokenChannel()
        handle.submit(mod.GenerateRequest(prompt_tokens=list(p), max_tokens=MAX_TOKENS,
                                          params=mod.SamplingParams(ignore_eos=True),
                                          channel=ch, logprobs=logprobs))
        ids, gaps = [], []
        while True:
            ev = ch.get(timeout=WAIT_S)
            assert ev is not None, "no event from the engine in time"
            if isinstance(ev, mod.Token):
                ids.append(ev.id)
                if logprobs:
                    (_, a), (_, b) = ev.logprob.top_logprobs[:2]
                    gaps.append(a - b)
            elif mod.is_terminal(ev):
                assert isinstance(ev, mod.Finished), ev
                break
        out.append((ids, gaps))
    return out


_JAX_STREAMS = {}


def jax_streams(ckpt, quantize, tp_size=1):
    """The JAX ``start_engine(path)``'s greedy streams on ``tp_size``
    devices of its mesh, with each step's top-2 logprob gap, once a mode."""
    if (quantize, tp_size) not in _JAX_STREAMS:
        h = jengine.start_engine(ckpt["fixture"], jc.EngineLoadOptions(
            precompile=False, quantize=quantize, **OPTS), tp_size=tp_size)
        try:
            _JAX_STREAMS[quantize, tp_size] = _collect(jc, h, logprobs=2)
        finally:
            h.shutdown()
    return _JAX_STREAMS[quantize, tp_size]


def assert_streams_agree(handle, ckpt, quantize, tp_size=1):
    """The port engine's greedy ids against the JAX engine's at
    ``tp_size``, under tests/test_torch_dsv4.py's logit tolerance. The
    checkpoint's weights are bf16, so both models run in bf16, whose
    roundings the two packages take in different orders (logits differ by
    about 1e-2 here): each stream is equal to its end, or up to a step
    where the JAX engine's top-2 gap is within LOGIT_TOL's atol (a near tie
    either side may break), where the streams part."""
    try:
        got = _collect(tc, handle)
    finally:
        handle.shutdown()
        handle._thread.join(WAIT_S)
    for (ids, _), (want, gaps) in zip(got, jax_streams(ckpt, quantize, tp_size)):
        n = next((i for i, (a, b) in enumerate(zip(ids, want)) if a != b), len(want))
        assert len(ids) == len(want) and (n == len(want) or gaps[n] <= LOGIT_TOL["atol"]), (
            ids, want, gaps)


@pytest.mark.parametrize("quantize", [None, "int8-experts", "bf16"])
def test_start_engine_from_path_matches_jax_engine(quantize, ckpt):
    """``start_engine(path, device="cpu")`` serves the JAX engine's greedy
    tokens in each mode; the executor's weights are the mode's."""
    handle = tengine.start_engine(ckpt["fixture"], tc.EngineLoadOptions(
        quantize=quantize, **OPTS), device="cpu")
    w1 = handle._scheduler.executor.params["layers"][1]["experts_w1"]
    kind = w1["q"].dtype if tquant.is_quantized(w1) else w1.dtype
    assert kind == {None: torch.uint8, "int8-experts": torch.int8,
                    "bf16": torch.bfloat16}[quantize]
    assert_streams_agree(handle, ckpt, quantize)


# ── (e) the bf16 mode's forward ─────────────────────────────────────────


def _f32(tree):
    """A tree's bf16 leaves made f32 (exactly), the rest as they are."""
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f32(v) for v in tree]
    return tree.float() if tree.dtype == torch.bfloat16 else tree


def _port_forward(tcfg, params, toks, step, dtype):
    state = tdsv4.make_state(tcfg, 1, 16, dtype=dtype)
    with torch.no_grad():
        logits, state = tdsv4.prefill(tcfg, params, torch.tensor(toks, dtype=torch.int32),
                                      state=state, slot=0)
        dec = tdsv4.decode(tcfg, params, state, *(torch.tensor(a, dtype=torch.int32)
                                                  for a in step))
    return logits.float(), dec.float()


def test_bf16_forward_matches_jax_and_the_resident_mode(ckpt):
    """The bf16 mode's prefill (10 tokens: the grouped expert product) and
    one decode step (the gathered rows), from the real-dtype files: against
    the JAX forward on the JAX loader's bf16 tree at tests/test_torch_dsv4.py's
    tolerance, both trees' leaves made f32 so that both models run in f32 as
    that file's do (the experts still round their inputs and weights to
    bf16); and, as loaded (bf16), against the port's resident mode at
    tests/test_dsv4_engine.py's atol 5e-2 (the same bytes dequantized at
    another point)."""
    jcfg, tcfg = ckpt["jcfg"], ckpt["tcfg"]
    jp = jax.tree.map(lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
                      jweights.load_params(jcfg, ckpt["real"], resident=False))
    deq = tweights.load_params(tcfg, ckpt["real"], resident=False, device="cpu")
    res = tweights.load_params(tcfg, ckpt["real"], resident=True, device="cpu")
    toks = [3, 17, 42, 9, 88, 5, 60, 7, 21, 99]
    step = ([7], [len(toks)], [0])
    lj, state_j = jax.jit(lambda p, t, s: jdsv4.prefill(jcfg, p, t, state=s, slot=jnp.int32(0))
                          )(jp, jnp.asarray(toks, jnp.int32), jdsv4.make_state(jcfg, 1, 16))
    dj = jax.jit(lambda p, s, *a: jdsv4.decode(jcfg, p, s, *a)[1])(
        jp, state_j, *(jnp.asarray(a, jnp.int32) for a in step))

    lt, dt = _port_forward(tcfg, _f32(deq), toks, step, torch.float32)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **LOGIT_TOL)
    for a, b in zip(_port_forward(tcfg, deq, toks, step, torch.bfloat16),
                    _port_forward(tcfg, res, toks, step, torch.bfloat16)):
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=5e-2)


# ── (f) refusals, the environment and the CLI ───────────────────────────


def test_int8_experts_on_bf16_weights_raise(ckpt):
    """A bf16 tree cannot be requantized to int8: ``quantize="int8-experts"``
    on it raises ValueError, as the JAX engine refuses int8 without
    resident weights."""
    deq = tweights.load_params(ckpt["tcfg"], ckpt["fixture"], resident=False, device="cpu")
    with pytest.raises(ValueError, match="int8-experts"):
        tengine.start_engine_from_params(ckpt["tcfg"], deq, tc.EngineLoadOptions(
            quantize="int8-experts", **OPTS), device="cpu")


@pytest.mark.parametrize("quantize", [None, "bf16"])
def test_experts_env_variable(quantize, ckpt, monkeypatch, caplog):
    """``PEGAINFER_DSV4_EXPERTS=int8`` serves int8 experts on one device
    (the JAX engine's int8-experts tokens); under bf16 it is ignored with
    the JAX engine's warning and the bf16 tokens are served."""
    monkeypatch.setenv("PEGAINFER_DSV4_EXPERTS", "int8")
    with caplog.at_level(logging.WARNING, logger="pegainfer_torch.dsv4"):
        handle = tengine.start_engine(ckpt["fixture"], tc.EngineLoadOptions(
            quantize=quantize, **OPTS), device="cpu")
    w1 = handle._scheduler.executor.params["layers"][1]["experts_w1"]
    warned = "PEGAINFER_DSV4_EXPERTS=int8 ignored" in caplog.text
    if quantize is None:
        assert w1["q"].dtype == torch.int8 and not warned
    else:
        assert w1.dtype == torch.bfloat16 and warned
    assert_streams_agree(handle, ckpt, quantize or "int8-experts")


def test_tp_size_above_one_raises(ckpt):
    """Model parallelism (served in ``tests/test_torch_tp_dsv4_engine.py``)
    runs the eager decode step: ``tp_size=2`` with the graph options on
    raises before a tensor is read; a tp that does not divide the mp8 world
    raises the JAX ValueError."""
    with pytest.raises(NotImplementedError, match="no-precompile"):
        tengine.start_engine(ckpt["fixture"], tc.EngineLoadOptions(**OPTS), device="cpu",
                             tp_size=2)
    with pytest.raises(ValueError, match="must divide mp8 world 8, got 3"):
        tengine.start_engine(ckpt["fixture"], tc.EngineLoadOptions(**OPTS), device="cpu",
                             tp_size=3)


@pytest.mark.parametrize("tp_size", [None, 0], ids=["none", "cli_default"])
def test_unset_tp_size_serves_one_process_on_eight_cards(ckpt, tp_size, monkeypatch):
    """With ``tp_size`` unset (the CLI's default is 0) the engine serves one
    process under the default options (the decode graphs, which do not run
    split), whatever the devices: here ``n_devices`` counts eight cards,
    where the JAX auto rule would pick 8."""
    monkeypatch.setattr(tengine, "n_devices", lambda dev, opts, tp: 8)
    handle = tengine.start_engine(ckpt["fixture"], tc.EngineLoadOptions(**OPTS), device="cpu",
                                  tp_size=tp_size)
    try:
        ex = handle._scheduler.executor
        assert isinstance(ex, SlotExecutor) and ex.tp is None
    finally:
        handle.shutdown()
        handle._thread.join(WAIT_S)


@pytest.mark.parametrize("argv", [[], ["--quantize", "bf16"]], ids=["resident", "bf16"])
def test_cli_builds_dsv4_from_a_path(argv, ckpt):
    """``server/main.py::build_engine`` serves a DSv4 path on the CPU
    (``--quantize bf16`` too): the JAX engine's tokens."""
    args = tmain.parse_args(["--model-path", ckpt["fixture"], "--max-batch-size", "2", *argv])
    assert tmain.detect_model_type(ckpt["fixture"]) == "deepseek_v4"
    handle = tmain.build_engine(args, device="cpu")
    assert_streams_agree(handle, ckpt, "bf16" if argv else None)
