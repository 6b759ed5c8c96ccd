"""The port's engine (TorchExecutor + its scheduler, on the CPU) against the
JAX engine (JaxExecutor with the XLA attention path) on the same tiny
weights, plus the port's import and device rules."""

import ast
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pegainfer_tpu.engine import contract as jc
from pegainfer_tpu.engine.jax_executor import JaxExecutor
from pegainfer_tpu.engine.scheduler import start_scheduler as j_start_scheduler
from pegainfer_tpu.models import qwen3 as jq3
from pegainfer_tpu_torch.engine import contract as tc
from pegainfer_tpu_torch.engine.torch_executor import TorchExecutor
from pegainfer_tpu_torch.models import qwen3 as tq3
from pegainfer_tpu_torch.models import qwen3_engine as tengine
from pegainfer_tpu_torch.utils.device import resolve_device

PORT = pathlib.Path(__file__).resolve().parents[1] / "pegainfer_tpu_torch"
EOS = 7
WAIT_S = 300


def _cfg_kw():
    return dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                vocab_size=128, rms_norm_eps=1e-6, rope_theta=1e6,
                tie_word_embeddings=False, eos_token_id=EOS, stop_token_ids=(EOS,),
                max_position_embeddings=256)


def _collect(mod, handle, prompts, max_tokens):
    """Submit all prompts at once, greedy; return each stream's token ids
    and terminal event."""
    chans = []
    for p in prompts:
        ch = mod.TokenChannel()
        handle.submit(mod.GenerateRequest(prompt_tokens=p, max_tokens=max_tokens,
                                          params=mod.SamplingParams(), channel=ch))
        chans.append(ch)
    out = []
    for ch in chans:
        toks, fin = [], None
        while fin is None:
            ev = ch.get(timeout=WAIT_S)
            assert ev is not None, "engine produced no event in time"
            if isinstance(ev, mod.Token):
                toks.append(ev.id)
            elif mod.is_terminal(ev):
                fin = ev
        out.append((toks, fin))
    return out


def _greedy_runs(**option):
    """Three greedy streams of 10 tokens through the JAX engine and the
    port's engine, both under ``option``: (JAX's, the port's, its
    executor)."""
    jcfg, tcfg = jq3.Qwen3Config(**_cfg_kw()), tq3.Qwen3Config(**_cfg_kw())
    jparams = jq3.init_random_params(jcfg, seed=11, dtype=jnp.float32, scale=0.2)
    tparams = tq3.params_from_jax(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(8, 128, n).tolist() for n in (6, 23, 13)]

    rt = jq3.make_runtime(jcfg, jparams, num_pages=128, page_size=4,
                          kv_dtype=jnp.float32, use_pallas=False)
    jhandle = j_start_scheduler(JaxExecutor(rt, jc.EngineLoadOptions(**option)))
    try:
        ref = _collect(jc, jhandle, prompts, max_tokens=10)
    finally:
        jhandle.shutdown()

    thandle = tengine.start_engine_from_params(
        tcfg, tparams, tc.EngineLoadOptions(max_num_pages=32, **option), device="cpu")
    try:
        out = _collect(tc, thandle, prompts, max_tokens=10)
    finally:
        thandle.shutdown()
    return ref, out, thandle._scheduler.executor


def _same_streams(ref, out):
    for (rt_toks, rfin), (ot_toks, ofin) in zip(ref, out):
        assert isinstance(rfin, jc.Finished) and isinstance(ofin, tc.Finished)
        assert ot_toks == rt_toks
        assert ofin.finish_reason.value == rfin.finish_reason.value
        assert ofin.completion_tokens == rfin.completion_tokens
    assert sum(len(t) for t, _ in out) > len(out)  # more than first tokens


def test_engine_greedy_streams_match_jax_engine():
    ref, out, ex = _greedy_runs()
    assert isinstance(ex, TorchExecutor) and ex.prefills == 3 and ex.decode_steps > 0
    _same_streams(ref, out)


def test_executor_sampling_and_logprobs_match_jax_executor():
    """Both executors driven step by step with the same plans: greedy,
    temperature, top-k and top-p rows with the same random_val draws give
    the same tokens, and requested logprobs agree (atol 1e-4)."""
    from pegainfer_tpu.engine import executor as jx
    from pegainfer_tpu_torch.engine import executor as tx

    jcfg, tcfg = jq3.Qwen3Config(**_cfg_kw()), tq3.Qwen3Config(**_cfg_kw())
    jparams = jq3.init_random_params(jcfg, seed=12, dtype=jnp.float32, scale=0.2)
    tparams = tq3.params_from_jax(jax.tree.map(np.asarray, jparams))
    rt = jq3.make_runtime(jcfg, jparams, num_pages=64, page_size=4,
                          kv_dtype=jnp.float32, use_pallas=False)
    jex = JaxExecutor(rt)
    tex = TorchExecutor(tcfg, tparams, tq3.make_kv_pages(tcfg, 16, 64, dtype=torch.float32))
    rng = np.random.default_rng(6)
    sampling = [dict(), dict(temperature=0.8), dict(temperature=1.0, top_k=5),
                dict(temperature=1.2, top_p=0.7)]
    logprobs = [0, 2, 0, 3]
    prompts = [rng.integers(8, 128, n).tolist() for n in (5, 9, 12, 7)]

    def prefill_items(mod, xmod, rands):
        return [xmod.PrefillStepItem(request_id=i, prompt_tokens=p,
                                     params=mod.SamplingParams(**sp), logprobs=lp,
                                     random_val=r)
                for i, (p, sp, lp, r) in enumerate(zip(prompts, sampling, logprobs, rands))]

    def compare(jres, tres):
        """Each side: [(token, TokenLogprob | None)] per request."""
        assert [t for t, _ in tres] == [t for t, _ in jres]
        for (_, jl), (_, tl) in zip(jres, tres):
            assert (jl is None) == (tl is None)
            if jl is not None:
                assert tl.logprob == pytest.approx(jl.logprob, abs=1e-4)
                assert [i for i, _ in tl.top_logprobs] == [i for i, _ in jl.top_logprobs]
                np.testing.assert_allclose([v for _, v in tl.top_logprobs],
                                           [v for _, v in jl.top_logprobs],
                                           rtol=0, atol=1e-4)

    rands = rng.uniform(size=4).tolist()
    jp = jex.execute_prefill(jx.PrefillPlan(prefill_items(jc, jx, rands))).requests
    tp = tex.execute_prefill(tx.PrefillPlan(prefill_items(tc, tx, rands))).requests
    compare([(r.first_token, r.first_token_logprob) for r in jp],
            [(r.first_token, r.first_token_logprob) for r in tp])
    toks = [r.first_token for r in jp]
    for _ in range(5):
        rands = rng.uniform(size=4).tolist()

        def decode_items(mod, xmod):
            return [xmod.DecodeStepItem(request_id=i, token_id=t,
                                        params=mod.SamplingParams(**sp), logprobs=lp,
                                        random_val=r)
                    for i, (t, sp, lp, r) in enumerate(zip(toks, sampling, logprobs, rands))]

        jd = jex.execute_decode(jx.DecodePlan(decode_items(jc, jx))).requests
        td = tex.execute_decode(tx.DecodePlan(decode_items(tc, tx))).requests
        compare([(r.token, r.logprob) for r in jd], [(r.token, r.logprob) for r in td])
        toks = [r.token for r in jd]
    assert tex.decode_steps == 5 and tex.prefills == 4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admission_matches_jax(seed):
    """The port's copy of the full-lifetime admission rule decides as the
    JAX package's does."""
    from types import SimpleNamespace as NS

    from pegainfer_tpu.engine import kv as jkv
    from pegainfer_tpu_torch.engine import kv as tkv

    rng = np.random.default_rng(seed)
    active = [NS(prompt_len=int(rng.integers(1, 300)), max_tokens=int(rng.integers(1, 200)),
                 generated_count=int(rng.integers(0, 50))) for _ in range(4)]
    deferred = [NS(prompt_len=int(rng.integers(1, 900)), max_tokens=int(rng.integers(1, 400)))
                for _ in range(12)]
    for avail in (0, 10, 40, 200):
        args = (deferred, active, 16, avail, 48)
        j, t = jkv.admit_deferred_requests(*args), tkv.admit_deferred_requests(*args)
        assert (t.pending, t.deferred, t.rejected) == (j.pending, j.deferred, j.rejected)


def test_engine_rejects_a_request_larger_than_the_pool():
    tcfg = tq3.Qwen3Config(**_cfg_kw())
    params = tq3.init_random_params(tcfg, seed=0, dtype=torch.float32)
    handle = tengine.start_engine_from_params(
        tcfg, params, tc.EngineLoadOptions(max_num_pages=3), device="cpu")
    try:
        (toks, fin), = _collect(tc, handle, [list(range(8, 140))], max_tokens=4)
    finally:
        handle.shutdown()
    assert toks == [] and isinstance(fin, tc.Rejected)


def test_echo_request_ends_in_error_not_silently():
    """An echo request with logprobs is served (no Error): its prompt comes
    back first as ``PromptTokens`` with each token's logprob (None for the
    first), then its tokens, the same greedy tokens as the same request
    without echo; the engine keeps serving the next request."""
    tcfg = tq3.Qwen3Config(**_cfg_kw())
    params = tq3.init_random_params(tcfg, seed=0, dtype=torch.float32)
    handle = tengine.start_engine_from_params(
        tcfg, params, tc.EngineLoadOptions(max_num_pages=16), device="cpu")
    try:
        ch = tc.TokenChannel()
        handle.submit(tc.GenerateRequest(prompt_tokens=[9, 10, 11], max_tokens=3,
                                         echo=True, logprobs=1, channel=ch))
        events = [ch.get(timeout=WAIT_S)]
        while events[-1] is not None and not tc.is_terminal(events[-1]):
            events.append(ch.get(timeout=WAIT_S))
        (toks, fin), = _collect(tc, handle, [[9, 10, 11]], max_tokens=3)
    finally:
        handle.shutdown()
    assert not any(isinstance(ev, tc.Error) for ev in events)
    pt = next(ev for ev in events if isinstance(ev, tc.PromptTokens))
    first_token = next(i for i, ev in enumerate(events) if isinstance(ev, tc.Token))
    assert events.index(pt) < first_token
    assert pt.ids == [9, 10, 11] and pt.logprobs[0] is None
    assert all(t.logprob <= 0 for t in pt.logprobs[1:]) and len(pt.logprobs) == 3
    assert [ev.id for ev in events if isinstance(ev, tc.Token)] == toks
    assert isinstance(events[-1], tc.Finished) and isinstance(fin, tc.Finished)
    assert len(toks) == 3


# what the card's machine lacks, or the port must not lean on: imported
# nowhere in the port; transformers only where HFTokenizer reads a
# checkpoint's tokenizer
REFUSED = ("jax", "jaxlib", "pegainfer_tpu", "aiohttp", "safetensors", "ml_dtypes")
TRANSFORMERS_AT = ("server/tokenizer.py", "HFTokenizer")


def _imports(path):
    """(imported module, the names of the classes and functions around the
    import) for each import in ``path``."""
    tree = ast.parse(path.read_text(), filename=str(path))

    def walk(node, scope):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Import):
                yield from ((a.name, scope) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.module and child.level == 0:
                yield child.module, scope
            inner = scope + (child.name,) if isinstance(
                child, (ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)) else scope
            yield from walk(child, inner)

    yield from walk(tree, ())


def test_port_imports_neither_jax_nor_the_jax_package():
    """Nor aiohttp, safetensors or ml_dtypes, anywhere; nor transformers
    outside ``server/tokenizer.py``'s ``HFTokenizer``."""
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 10
    seen_transformers = []
    for f in files:
        rel = f.relative_to(PORT).as_posix()
        for name, scope in _imports(f):
            root = name.split(".")[0]
            assert root not in REFUSED, f"{f}: imports {name}"
            if root == "transformers":
                assert (rel, scope[:1]) == (TRANSFORMERS_AT[0], TRANSFORMERS_AT[1:]), \
                    f"{f}: imports {name} in {scope}"
                seen_transformers.append(rel)
    assert seen_transformers == [TRANSFORMERS_AT[0]]


def _write_hf_qwen3(path):
    """A tiny HF Qwen3ForCausalLM checkpoint (config.json,
    generation_config.json, model.safetensors)."""
    transformers = pytest.importorskip("transformers")
    from safetensors.torch import save_file

    hf = transformers.Qwen3Config(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16, rms_norm_eps=1e-6,
        rope_theta=1e6, tie_word_embeddings=False, max_position_embeddings=256,
        eos_token_id=7, attn_implementation="eager")
    torch.manual_seed(2)
    model = transformers.Qwen3ForCausalLM(hf).eval()
    cfg = hf.to_dict()
    cfg["architectures"] = [type(model).__name__]
    (path / "config.json").write_text(json.dumps(cfg))
    (path / "generation_config.json").write_text(json.dumps({"eos_token_id": 7}))
    save_file({k: v.detach().contiguous() for k, v in model.state_dict().items()},
              str(path / "model.safetensors"))


# run in a fresh interpreter where the refused modules cannot be imported:
# the CLI serves one --sim request (stopped by SIGINT, as an operator stops
# it), then a Qwen3 checkpoint is loaded and served on the CPU
CARD_MACHINE_SCRIPT = r"""
import json, os, signal, socket, sys, threading, time, http.client
BLOCKED = json.loads(sys.argv[2])
for m in BLOCKED:
    sys.modules[m] = None
from pegainfer_tpu_torch.server.main import main
from pegainfer_tpu_torch.engine import contract as tc
from pegainfer_tpu_torch.models.qwen3_engine import start_engine

s = socket.socket()
s.bind(("127.0.0.1", 0))
port = s.getsockname()[1]
s.close()
out = {}

def client():
    try:
        for _ in range(600):
            try:
                c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
                c.request("GET", "/health")
                r = c.getresponse()
                r.read()
                if r.status == 200:
                    break
            except OSError:
                time.sleep(0.05)
        c.request("POST", "/v1/completions", body=json.dumps(
            {"prompt": [5, 6, 7], "max_tokens": 4}).encode())
        r = c.getresponse()
        out["completion"] = [r.status, json.loads(r.read())["usage"]]
    finally:
        os.kill(os.getpid(), signal.SIGINT)

t = threading.Thread(target=client)
t.start()
out["rc"] = main(["--sim", "--host", "127.0.0.1", "--port", str(port), "--sim-ttft", "0",
                  "--sim-tpot", "0"])
t.join(60)
h = start_engine(sys.argv[1], tc.EngineLoadOptions(max_num_pages=16), device="cpu")
ch = tc.TokenChannel()
h.submit(tc.GenerateRequest(prompt_tokens=[9, 10, 11, 12], max_tokens=5, channel=ch,
                            params=tc.SamplingParams(ignore_eos=True)))
out["tokens"] = [ev.id for ev in ch if isinstance(ev, tc.Token)]
h.shutdown()
out["loaded"] = sorted(m for m in BLOCKED if sys.modules.get(m) is not None)
print(json.dumps(out))
"""


def test_cli_and_checkpoint_run_without_the_refused_modules(tmp_path):
    """The card's machine, here: with jax, the JAX package, aiohttp,
    safetensors, ml_dtypes and transformers made unimportable, ``main``
    serves a --sim request and exits 0 on SIGINT, and a Qwen3 checkpoint
    loads and streams the tokens it streams in this process."""
    import subprocess
    import sys

    _write_hf_qwen3(tmp_path)
    blocked = [*REFUSED, "transformers"]
    proc = subprocess.run(
        [sys.executable, "-c", CARD_MACHINE_SCRIPT, str(tmp_path), json.dumps(blocked)],
        capture_output=True, text=True, timeout=240, cwd=str(PORT.parent))
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["rc"] == 0 and out["loaded"] == []
    assert out["completion"] == [200, {"prompt_tokens": 3, "completion_tokens": 4,
                                       "total_tokens": 7}]
    h = tengine.start_engine(str(tmp_path), tc.EngineLoadOptions(max_num_pages=16),
                             device="cpu")
    try:
        (toks, fin), = _collect(tc, h, [[9, 10, 11, 12]], max_tokens=5)
    finally:
        h.shutdown()
    assert isinstance(fin, tc.Finished) and out["tokens"] == toks and len(toks) == 5


def test_entry_points_refuse_to_run_without_a_card(monkeypatch):
    """Called without ``device`` on a machine without CUDA, an entry point
    raises rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = tq3.Qwen3Config(**_cfg_kw())
    params = tq3.init_random_params(tcfg, seed=0, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.start_engine_from_params(tcfg, params, tc.EngineLoadOptions(max_num_pages=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.start_engine("/nonexistent/model")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("option", [dict(quantize="int8-experts"), dict(quantize="bf16"),
                                    dict(decode_block=2), dict(decode_block=4)])
def test_unsupported_options_raise(option):
    """The quantize values Qwen3 does not serve raise, naming the family;
    ``decode_block``, refused before decode blocks were ported, serves: 2
    and 4 give the JAX engine's greedy streams under the same option."""
    if "decode_block" in option:
        ref, out, ex = _greedy_runs(**option)
        _same_streams(ref, out)
        assert ex.decode_block == option["decode_block"] and ex.decode_blocks < ex.decode_steps
        return
    tcfg = tq3.Qwen3Config(**_cfg_kw())
    params = tq3.init_random_params(tcfg, seed=0, dtype=torch.float32)
    kv = tq3.make_kv_pages(tcfg, 8, 4, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="Qwen3 engine"):
        TorchExecutor(tcfg, params, kv, tc.EngineLoadOptions(**option))


def test_prefix_cache_without_a_chunk_size_raises():
    """The cache continues a cached prefix through the chunked prefill, so
    it needs prefill_chunk; the error names both options. The default chunk
    is the JAX engine's 2,048, so the test turns it off explicitly."""
    tcfg = tq3.Qwen3Config(**_cfg_kw())
    params = tq3.init_random_params(tcfg, seed=0, dtype=torch.float32)
    kv = tq3.make_kv_pages(tcfg, 8, 4, dtype=torch.float32)
    with pytest.raises(ValueError, match="enable_prefix_cache.*prefill_chunk"):
        TorchExecutor(tcfg, params, kv, tc.EngineLoadOptions(enable_prefix_cache=True,
                                                             prefill_chunk=None))
