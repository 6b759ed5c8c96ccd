"""Checkpoints, model detection and the CLI's parts in the port, against the
safetensors package and the JAX package: the port's own safetensors reader
(``pegainfer_tpu_torch/utils/weights.py``) bit for bit against
``safetensors.torch.load_file``; a tiny HF Qwen3 checkpoint served through
the port's ``start_engine(path)`` against the JAX engine from the same
path, in bf16 and int8; ``probe_model`` / ``detect_model_type``,
``load_options`` and ``HFTokenizer`` against the JAX ones; the routes the
port refuses."""

import json

import numpy as np
import pytest
import torch

from pegainfer_tpu.engine import contract as jc
from pegainfer_tpu.models import dsv4_engine as jdsv4e
from pegainfer_tpu.models import qwen35_engine as jq35e
from pegainfer_tpu.models import qwen3_engine as jq3e
from pegainfer_tpu.server import main as jmain
from pegainfer_tpu.server import tokenizer as jtok
from pegainfer_tpu_torch.engine import contract as tc
from pegainfer_tpu_torch.models import dsv4_engine as tdsv4e
from pegainfer_tpu_torch.models import qwen35_engine as tq35e
from pegainfer_tpu_torch.models import qwen3_engine as tq3e
from pegainfer_tpu_torch.server import main as tmain
from pegainfer_tpu_torch.server import tokenizer as ttok
from pegainfer_tpu_torch.utils import weights

safetensors_torch = pytest.importorskip("safetensors.torch")
WAIT_S = 300

# ── the reader ──────────────────────────────────────────────────────────


def _tensor(dtype, shape, seed):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(shape, generator=g) > 0.5
    if dtype.is_floating_point:
        return (torch.randn(shape, generator=g) * 3).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(info.min, info.max, shape, generator=g, dtype=torch.int64).to(dtype)


def _same_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.numel():
        assert torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("name", sorted(weights.SAFETENSORS_DTYPES))
def test_reader_matches_safetensors_for_each_dtype(name, tmp_path):
    """Each dtype in a file of its own and beside a one-byte tensor (so
    later tensors start at odd offsets), with ``__metadata__``: every
    tensor bit for bit as the package reads it."""
    dtype = weights.SAFETENSORS_DTYPES[name]
    sd = {"odd": _tensor(torch.uint8, (1,), 0), "a": _tensor(dtype, (3, 5), 1),
          "b": _tensor(dtype, (7,), 2), "scalar": _tensor(dtype, (), 3),
          "empty": _tensor(dtype, (0, 4), 4)}
    path = str(tmp_path / "x.safetensors")
    safetensors_torch.save_file(sd, path, metadata={"format": "pt", "note": name})
    got, ref = weights.load_file(path), safetensors_torch.load_file(path)
    assert sorted(got) == sorted(ref) == sorted(sd)
    for k in sd:
        _same_bits(got[k], ref[k])
        _same_bits(got[k], sd[k])


def test_reader_takes_a_sharded_checkpoint_with_its_index(tmp_path):
    """Two shards named by ``model.safetensors.index.json`` (a stray file
    beside them is not read); ``load_state_dict`` equals the package's
    files merged."""
    shards = {"model-00001-of-00002.safetensors": {"w1": _tensor(torch.bfloat16, (64, 32), 5),
                                                   "n1": _tensor(torch.float32, (32,), 6)},
              "model-00002-of-00002.safetensors": {"w2": _tensor(torch.bfloat16, (32, 64), 7),
                                                   "i": _tensor(torch.int64, (9,), 8)}}
    weight_map = {}
    for f, sd in shards.items():
        safetensors_torch.save_file(sd, str(tmp_path / f), metadata={"format": "pt"})
        weight_map.update({k: f for k in sd})
    (tmp_path / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {"total_size": 0}, "weight_map": weight_map}))
    safetensors_torch.save_file({"stray": torch.zeros(2)}, str(tmp_path / "other.safetensors"))
    got = weights.load_state_dict(str(tmp_path))
    ref = {}
    for f in shards:
        ref.update(safetensors_torch.load_file(str(tmp_path / f)))
    assert sorted(got) == sorted(ref) == ["i", "n1", "w1", "w2"]
    for k in ref:
        _same_bits(got[k], ref[k])


def _corrupt(raw, how):
    n = int.from_bytes(raw[:8], "little")
    header = json.loads(raw[8:8 + n])
    if how == "truncated":
        return raw[:-3]
    if how == "short":
        return raw[:5]
    if how == "header_past_end":
        return (len(raw) * 2).to_bytes(8, "little") + raw[8:]
    if how == "not_json":
        return raw[:8] + b"{" * n + raw[8 + n:]
    if how == "offsets_outside":
        header["a"]["data_offsets"] = [0, len(raw)]
    elif how == "size_mismatch":
        header["a"]["shape"] = [4, 5]
    elif how == "unknown_dtype":
        header["a"]["dtype"] = "C64"
    body = json.dumps(header).encode()
    return len(body).to_bytes(8, "little") + body + raw[8 + n:]


@pytest.mark.parametrize("how", ["truncated", "short", "header_past_end", "not_json",
                                 "offsets_outside", "size_mismatch", "unknown_dtype"])
def test_reader_refuses_a_malformed_file(how, tmp_path):
    path = tmp_path / "x.safetensors"
    safetensors_torch.save_file({"a": torch.ones(3, 5), "b": torch.ones(2)}, str(path))
    path.write_bytes(_corrupt(path.read_bytes(), how))
    with pytest.raises(ValueError):
        weights.load_file(str(path))


# ── a tiny Qwen3 checkpoint through the engines ─────────────────────────


def _write_qwen3(path, tokenizer=False):
    """A tiny HF Qwen3ForCausalLM checkpoint (config.json,
    generation_config.json, model.safetensors), as
    tests/test_model_path_load.py writes one; with ``tokenizer`` also the
    WordLevel tokenizer of ``_save_tokenizer``."""
    transformers = pytest.importorskip("transformers")
    hf = transformers.Qwen3Config(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16, rms_norm_eps=1e-6,
        rope_theta=1e6, tie_word_embeddings=True, max_position_embeddings=512,
        eos_token_id=0, attn_implementation="eager")
    torch.manual_seed(0)
    model = transformers.Qwen3ForCausalLM(hf).eval()
    cfg = hf.to_dict()
    cfg["architectures"] = [type(model).__name__]
    (path / "config.json").write_text(json.dumps(cfg))
    (path / "generation_config.json").write_text(json.dumps({"eos_token_id": 0}))
    # tied: the head is the embedding, as HF saves it
    sd = {k: v.detach().contiguous() for k, v in model.state_dict().items()
          if k != "lm_head.weight"}
    safetensors_torch.save_file(sd, str(path / "model.safetensors"), metadata={"format": "pt"})
    if tokenizer:
        _save_tokenizer(path)
    return sd


def _stream(mod, handle, prompt, n):
    ch = mod.TokenChannel()
    handle.submit(mod.GenerateRequest(prompt_tokens=prompt, max_tokens=n, channel=ch,
                                      params=mod.SamplingParams(ignore_eos=True)))
    toks = []
    while True:
        ev = ch.get(timeout=WAIT_S)
        assert ev is not None, "engine produced no event in time"
        if isinstance(ev, mod.Token):
            toks.append(ev.id)
        elif mod.is_terminal(ev):
            assert isinstance(ev, mod.Finished), ev
            return toks


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_qwen3_checkpoint_serves_the_jax_engines_tokens(quantize, tmp_path):
    """``start_engine(path, device="cpu")`` (config and safetensors read by
    the port) streams the JAX engine's greedy tokens from the same path:
    two prompts, one long enough to prefill in pieces, in bf16 and in
    ``quantize="int8"``."""
    _write_qwen3(tmp_path)
    path = str(tmp_path)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, 256, 12).tolist(), rng.integers(2, 256, 150).tolist()]
    jh = jq3e.start_engine(path, jc.EngineLoadOptions(
        precompile=False, max_num_pages=64, prefill_chunk=64, quantize=quantize))
    try:
        ref = [_stream(jc, jh, p, 8) for p in prompts]
    finally:
        jh.shutdown()
    th = tq3e.start_engine(path, tc.EngineLoadOptions(
        max_num_pages=64, prefill_chunk=64, quantize=quantize), device="cpu")
    ex = th._scheduler.executor
    try:
        out = [_stream(tc, th, p, 8) for p in prompts]
    finally:
        th.shutdown()
    assert ex.params["embed"].dtype == torch.bfloat16 and ex.chunk_pieces == 3
    assert out == ref and all(len(t) == 8 for t in out)


def test_cli_parts_serve_a_checkpoint(tmp_path):
    """``build_engine`` / ``build_tokenizer`` on ``--model-path`` (the
    CLI's path, on the CPU): the model is detected, its tokenizer read, and
    the engine streams ``start_engine_from_params``'s tokens on the same
    state dict."""
    from pegainfer_tpu_torch.models import qwen3 as tq3

    sd = _write_qwen3(tmp_path, tokenizer=True)
    args = tmain.parse_args(["--model-path", str(tmp_path), "--max-num-pages", "64"])
    tok, name = tmain.build_tokenizer(args)
    assert name == tmp_path.name and tok.eos_token_id == 0
    prompt = tok.encode("the cat sat on the mat")
    assert len(prompt) == 6
    handle = tmain.build_engine(args, device="cpu")
    try:
        got = _stream(tc, handle, prompt, 6)
    finally:
        handle.shutdown()
    cfg = tq3.Qwen3Config.from_model_path(str(tmp_path))
    mem = tq3e.start_engine_from_params(cfg, tq3.params_from_state_dict(cfg, sd),
                                        tmain.load_options(args), device="cpu")
    try:
        assert _stream(tc, mem, prompt, 6) == got
    finally:
        mem.shutdown()


# ── detection ───────────────────────────────────────────────────────────

CONFIGS = {
    "qwen3": {"architectures": ["Qwen3ForCausalLM"]},
    "qwen35_next": {"architectures": ["Qwen3NextForCausalLM"]},
    "qwen35": {"architectures": ["Qwen3_5ForCausalLM"]},
    "dsv4": {"model_type": "deepseek_v4", "architectures": ["DeepseekV4ForCausalLM"]},
    "dsv4_by_arch": {"architectures": ["DeepseekV3ForCausalLM"]},
    "dsv2lite": {"model_type": "deepseek_v2", "architectures": ["DeepseekV2ForCausalLM"]},
    "llama": {"architectures": ["LlamaForCausalLM"]},
    "none": {},
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_detection_matches_jax(name, tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(CONFIGS[name]))
    path = str(tmp_path)
    for t, j in ((tq3e, jq3e), (tq35e, jq35e), (tdsv4e, jdsv4e)):
        assert t.probe_model(path) == j.probe_model(path)
        assert not t.probe_model(str(tmp_path / "missing"))
    try:
        want = jmain.detect_model_type(path)
    except ValueError:
        with pytest.raises(ValueError, match="unsupported architectures"):
            tmain.detect_model_type(path)
        assert name in ("llama", "none")
        return
    assert tmain.detect_model_type(path) == want


# ── options ─────────────────────────────────────────────────────────────


class _Captured(Exception):
    pass


def _jax_options(argv, monkeypatch):
    """The EngineLoadOptions the JAX CLI builds for ``argv`` (--sim): its
    ``main`` runs until it starts the sim engine, which is replaced by a
    function that records the options and stops it."""
    import pegainfer_tpu.sim
    import pegainfer_tpu.utils.compile_cache

    seen = []

    def start_engine(cfg, options):
        seen.append((cfg, options))
        raise _Captured()

    monkeypatch.setattr(pegainfer_tpu.sim, "start_engine", start_engine)
    monkeypatch.setattr(pegainfer_tpu.utils.compile_cache, "enable", lambda *a, **k: None)
    with pytest.raises(_Captured):
        jmain.main(argv)
    return seen[0]


@pytest.mark.parametrize("argv", [
    [], ["--delivery-profile"], ["--decode-block-max", "8"], ["--pipeline-depth", "3"],
    ["--delivery-profile", "--decode-block-max", "8"], ["--no-prefix-cache"],
    ["--quantize", "int8"], ["--no-precompile"],
    ["--seed", "7", "--max-num-pages", "99", "--max-batch-size", "5", "--prefill-chunk",
     "512", "--prefill-chunk-mixed", "128", "--sim-ttft", "0.5", "--sim-tpot", "0.25"]])
def test_load_options_match_the_jax_cli(argv, monkeypatch):
    argv = ["--sim", *argv]
    jcfg, jopts = _jax_options(argv, monkeypatch)
    args = tmain.parse_args(argv)
    opts = tmain.load_options(args)
    # every field, device_ordinals (the ranks' cards) too, which the CLI
    # leaves at its default
    fields = sorted(tc.EngineLoadOptions.__dataclass_fields__)
    assert set(jc.EngineLoadOptions.__dataclass_fields__) == set(fields)
    assert jopts.device_ordinals == jc.EngineLoadOptions().device_ordinals
    assert {f: getattr(opts, f) for f in fields} == {f: getattr(jopts, f) for f in fields}
    assert (args.sim_ttft, args.sim_tpot) == (jcfg.ttft_s, jcfg.tpot_s)


# ── refusals ────────────────────────────────────────────────────────────


@pytest.mark.parametrize("route", ["tp_size", "profile_dir", "multihost", "deepseek_v4",
                                   "dsv2lite", "quantize_bf16"])
def test_routes_the_port_lacks_raise(route, tmp_path, monkeypatch):
    if route in ("deepseek_v4", "dsv2lite"):
        (tmp_path / "config.json").write_text(json.dumps(CONFIGS[route.replace(
            "deepseek_v4", "dsv4")]))
    else:
        _write_qwen3(tmp_path)
    argv = ["--model-path", str(tmp_path), "--max-num-pages", "16"]
    # DSv2-Lite serves from a path on one card: its refusal is expert
    # parallelism; DSv4's model parallelism runs the eager step only, so
    # --tp-size without --no-precompile is refused
    argv += {"tp_size": ["--tp-size", "2"], "profile_dir": ["--profile-dir", str(tmp_path)],
             "quantize_bf16": ["--quantize", "bf16"],
             "deepseek_v4": ["--tp-size", "2"], "dsv2lite": ["--tp-size", "2"]}.get(route, [])
    if route == "multihost":
        monkeypatch.setenv("PEGAINFER_COORD", "localhost:1234")
    args = tmain.parse_args(argv)
    with pytest.raises(NotImplementedError):
        tmain.build_engine(args, device="cpu")
    if route in ("tp_size", "profile_dir", "multihost"):
        with pytest.raises(NotImplementedError):
            tmain.main(argv)


# ── the tokenizer ───────────────────────────────────────────────────────

CHAT_TEMPLATE = ("{% for m in messages %}<|{{ m['role'] }}|> {{ m['content'] }} {% endfor %}"
                 "{% if add_generation_prompt %}<|assistant|>{% endif %}")
WORDS = ["</s>", "<unk>", "<|user|>", "<|assistant|>", "<|system|>", "the", "cat", "sat", "on",
         "mat", "hello", "world"]


def _save_tokenizer(path):
    """A WordLevel tokenizer with a short Jinja chat template, saved as
    ``save_pretrained`` writes it (nothing downloaded)."""
    from tokenizers import Tokenizer, models, pre_tokenizers, decoders
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(WORDS)}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tok.decoder = decoders.WordPiece()  # joins words with spaces
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, eos_token="</s>", unk_token="<unk>")
    fast.chat_template = CHAT_TEMPLATE
    fast.save_pretrained(str(path))


def test_hf_tokenizer_matches_jax(tmp_path):
    pytest.importorskip("transformers")
    _save_tokenizer(tmp_path)
    t, j = ttok.HFTokenizer(str(tmp_path)), jtok.HFTokenizer(str(tmp_path))
    text = "hello world the cat sat on the mat dog"
    assert t.encode(text) == j.encode(text) and t.encode(text)[-1] == 1  # dog: <unk>
    ids = [10, 11, 5, 6, 0, 9]
    assert t.decode(ids) == j.decode(ids)
    msgs = [{"role": "system", "content": "the cat"}, {"role": "user", "content": "hello world"}]
    assert t.apply_chat_template(msgs) == j.apply_chat_template(msgs) == [4, 5, 6, 2, 10, 11, 3]
    assert t.eos_token_id == j.eos_token_id == 0
    # the Detokenizer streams the text the tokenizer decodes whole
    d = ttok.Detokenizer(t)
    assert "".join(d.push(i) for i in ids) + d.flush() == t.decode(ids)


def test_hf_tokenizer_without_transformers_raises(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        ttok.HFTokenizer(str(tmp_path))
    args = tmain.parse_args(["--model-path", str(tmp_path)])
    with pytest.raises(ImportError, match="transformers"):
        tmain.build_tokenizer(args)


def test_detokenizer_holds_back_an_incomplete_character():
    """A character split over two tokens comes out whole (the JAX
    Detokenizer's U+FFFD hold-back), in the JAX Detokenizer's deltas."""

    class Bytes:
        def decode(self, ids):
            return bytes(ids).decode("utf-8", errors="replace")

    ids = list("aé€b".encode())
    outs = []
    for mod in (ttok, jtok):
        d = mod.Detokenizer(Bytes())
        outs.append([d.push(i) for i in ids] + [d.flush()])
    assert outs[0] == outs[1] and "".join(outs[0]) == "aé€b"
    assert "" in outs[0][:-1]  # held back at least once
