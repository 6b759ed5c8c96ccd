"""The port's OpenAI server (``pegainfer_tpu_torch/server``: ``OpenAIApp`` on
the standard-library ``httpd``) against the JAX package's (aiohttp), each
over its own package's sim engine: the requests of each of
tests/test_http_api.py's cases give the same status codes, JSON bodies and
SSE event sequences, ids and times aside. Then what only the port's
transport does: 404 / 405, a client that leaves mid-stream, and the server
over a tiny torch Qwen3 engine on the CPU."""

import asyncio
import http.client
import json
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from pegainfer_tpu import sim as jsim
from pegainfer_tpu.models import qwen3 as jq3
from pegainfer_tpu.server.api import OpenAIApp as JOpenAIApp
from pegainfer_tpu.server.tokenizer import SimTokenizer as JSimTokenizer
from pegainfer_tpu_torch import sim as tsim
from pegainfer_tpu_torch.engine import contract as tc
from pegainfer_tpu_torch.models import qwen3 as tq3
from pegainfer_tpu_torch.models import qwen3_engine as tengine
from pegainfer_tpu_torch.server import httpd
from pegainfer_tpu_torch.server.api import OpenAIApp
from pegainfer_tpu_torch.server.tokenizer import SimTokenizer

# fields that name a request or a time: they differ between two runs
VOLATILE = {"id", "created", "queue_ms", "started_unix_s", "uptime_s"}
WAIT_S = 60


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _parse(status, ctype, raw):
    """(status, body): JSON, the SSE events (JSON or "[DONE]"), or text."""
    if ctype.startswith("application/json"):
        return status, _strip(json.loads(raw))
    if ctype.startswith("text/event-stream"):
        events = []
        for block in raw.decode().split("\n\n"):
            if block:
                assert block.startswith("data: "), block
                data = block[len("data: "):]
                events.append(data if data == "[DONE]" else _strip(json.loads(data)))
        return status, events
    return status, raw.decode()


class JaxSide:
    """The JAX server over the JAX sim engine, through aiohttp's
    TestClient (as tests/test_http_api.py drives it)."""

    def __init__(self, **sim_kw):
        self.loop = asyncio.new_event_loop()
        self.engine = jsim.start_engine(jsim.SimulatedEngineConfig(**sim_kw))
        app = JOpenAIApp(self.engine, JSimTokenizer(), "sim-model").build()

        async def start():
            client = TestClient(TestServer(app))
            await client.start_server()
            return client

        self.client = self.loop.run_until_complete(start())

    def call(self, method, path, body=None):
        async def go():
            kw = {} if body is None else (
                {"data": body} if isinstance(body, bytes) else {"json": body})
            r = await self.client.request(method, path, **kw)
            return r.status, r.headers.get("Content-Type", ""), await r.read()

        return _parse(*self.loop.run_until_complete(go()))

    def close(self):
        self.loop.run_until_complete(self.client.close())
        self.loop.close()
        self.engine.shutdown()


class PortSide:
    """The port's server over the port's sim engine (or ``engine``),
    through ``httpd.serve`` on port 0, reached with http.client."""

    def __init__(self, engine=None, tokenizer=None, threads=8, **sim_kw):
        self.engine = engine or tsim.start_engine(tsim.SimulatedEngineConfig(**sim_kw))
        app = OpenAIApp(self.engine, tokenizer or SimTokenizer(), "sim-model").build()
        self.server = httpd.serve(app, "127.0.0.1", 0, threads=threads)
        self.conn = http.client.HTTPConnection("127.0.0.1", self.server.port, timeout=WAIT_S)

    def call(self, method, path, body=None):
        data = body if body is None or isinstance(body, bytes) else json.dumps(body).encode()
        self.conn.request(method, path, body=data,
                          headers={} if data is None else {"Content-Type": "application/json"})
        r = self.conn.getresponse()
        return _parse(r.status, r.getheader("Content-Type", ""), r.read())

    def close(self):
        self.conn.close()
        self.server.close()
        self.engine.shutdown()


# tests/test_http_api.py's cases: (sim engine options, the requests, each
# as a function of the responses before it)
def _stop_case(out):
    if not out:
        return "POST", "/v1/completions", {"prompt": [10, 20], "max_tokens": 6}
    stop_word = out[0][1]["choices"][0]["text"].split()[2]
    return "POST", "/v1/completions", {"prompt": [10, 20], "max_tokens": 6, "stop": stop_word}


CASES = {
    "health_and_models": ({}, [("GET", "/health", None), ("GET", "/v1/models", None)]),
    "completion_blocking": ({}, [
        ("POST", "/v1/completions", {"prompt": "hello world test", "max_tokens": 8})]),
    "token_prompt_and_determinism": ({}, [
        ("POST", "/v1/completions", {"prompt": [5, 6, 7], "max_tokens": 4})] * 2),
    "completion_streaming_sse": ({}, [
        ("POST", "/v1/completions", {"prompt": "streaming please", "max_tokens": 5,
                                     "stream": True,
                                     "stream_options": {"include_usage": True}})]),
    "chat_completion": ({}, [
        ("POST", "/v1/chat/completions", {"messages": [{"role": "user", "content": "hi there"}],
                                          "max_tokens": 6})]),
    "chat_streaming": ({}, [
        ("POST", "/v1/chat/completions", {"messages": [{"role": "user", "content": "stream me"}],
                                          "max_tokens": 4, "stream": True})]),
    "stop_string_cuts_generation": ({}, [_stop_case, _stop_case]),
    "bad_requests": ({}, [("POST", "/v1/completions", {"max_tokens": 4}),
                          ("POST", "/v1/chat/completions", {}),
                          ("POST", "/v1/completions", b"{not json")]),
    "rejected_too_long_maps_to_400": (dict(num_pages=4, page_size=4), [
        ("POST", "/v1/completions", {"prompt": list(range(100)), "max_tokens": 50})]),
    "completion_multi_prompt_batch": ({}, [
        ("POST", "/v1/completions", {"prompt": ["one two", "three four five"],
                                     "max_tokens": 4})]),
    "metrics_endpoint_counts": ({}, [
        ("POST", "/v1/completions", {"prompt": "a b", "max_tokens": 3}),
        ("GET", "/metrics", None)]),
}


def _run(side, requests):
    out = []
    for req in requests:
        method, path, body = req(out) if callable(req) else req
        out.append(side.call(method, path, body))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_http_parity_with_jax_server(case):
    sim_kw, requests = CASES[case]
    jside = JaxSide(**sim_kw)
    try:
        ref = _run(jside, requests)
    finally:
        jside.close()
    pside = PortSide(**sim_kw)
    try:
        out = _run(pside, requests)
    finally:
        pside.close()
    assert out == ref
    # the cases' own checks hold on both sides
    if case == "completion_streaming_sse":
        assert out[0][1][-1] == "[DONE]" and out[0][1][-2]["usage"]["completion_tokens"] == 5
    elif case == "stop_string_cuts_generation":
        assert out[1][1]["choices"][0]["finish_reason"] == "stop"
    elif case == "bad_requests":
        assert [s for s, _ in out] == [400, 400, 400]
    elif case == "rejected_too_long_maps_to_400":
        assert out[0][0] == 400 and "KV pages" in out[0][1]["error"]["message"]
    elif case == "metrics_endpoint_counts":
        assert out[1][1]["requests_total"] == 1 and out[1][1]["completion_tokens_total"] == 3


def test_unknown_path_and_wrong_method():
    """404 for an unknown path, 405 (naming the allowed method) for a known
    path asked with another, as aiohttp answers; the connection serves the
    next request."""
    side = PortSide()
    try:
        assert side.call("GET", "/v1/nothing") == (404, "404: Not Found")
        side.conn.request("GET", "/v1/completions")
        r = side.conn.getresponse()
        assert (r.status, r.getheader("Allow"), r.read()) == (
            405, "POST", b"405: Method Not Allowed")
        assert side.call("POST", "/health") == (405, "405: Method Not Allowed")
        assert side.call("GET", "/health?x=1") == (200, {"status": "ok"})
    finally:
        side.close()


def test_client_disconnect_mid_stream_frees_the_request():
    """A client that closes its socket mid-stream ends the handler, whose
    ``finally`` closes the channel: the scheduler retires the request and
    every page comes back to the sim engine's pool within a few seconds."""
    side = PortSide(tpot_s=0.002, num_pages=256, page_size=16)
    ex = side.engine._scheduler.executor
    free = ex.available_pages()  # all but the null page
    body = json.dumps({"prompt": [3, 4, 5], "max_tokens": 3000, "stream": True}).encode()
    sock = socket.create_connection(("127.0.0.1", side.server.port), timeout=WAIT_S)
    try:
        sock.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\nContent-Type: "
                     b"application/json\r\nContent-Length: %d\r\n\r\n%s" % (len(body), body))
        got = b""
        while got.count(b"data: ") < 5:
            got += sock.recv(4096)
        assert got.startswith(b"HTTP/1.1 200 OK")
        assert ex.available_pages() < free and len(side.engine._scheduler.active) == 1
    finally:
        sock.close()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and (ex.available_pages() < free
                                           or side.engine._scheduler.active):
        time.sleep(0.02)
    try:
        assert ex.available_pages() == free and not side.engine._scheduler.active
        # the server goes on serving
        assert side.call("GET", "/health") == (200, {"status": "ok"})
    finally:
        side.close()


def _tiny_qwen3():
    kw = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, head_dim=16, vocab_size=128,
              rms_norm_eps=1e-6, rope_theta=1e6, tie_word_embeddings=False, eos_token_id=7,
              stop_token_ids=(7,), max_position_embeddings=256)
    jcfg, tcfg = jq3.Qwen3Config(**kw), tq3.Qwen3Config(**kw)
    jparams = jq3.init_random_params(jcfg, seed=11, dtype=jnp.float32, scale=0.2)
    return tcfg, tq3.params_from_jax(jax.tree.map(np.asarray, jparams))


def _ids(text):
    return [int(w[3:]) for w in text.split()]


def test_server_over_a_torch_qwen3_engine():
    """The port's server in front of a tiny Qwen3 engine on the CPU (params
    from the JAX package's init): a token-list prompt's greedy ids, read
    back from the ``tok<id>`` text, equal the handle's for the same request;
    the streamed text joined equals the blocking text; echo and logprobs
    come back; /metrics counts the requests."""
    tcfg, params = _tiny_qwen3()
    engine = tengine.start_engine_from_params(
        tcfg, params, tc.EngineLoadOptions(max_num_pages=64), device="cpu")
    side = PortSide(engine=engine, tokenizer=SimTokenizer(vocab_size=tcfg.vocab_size))
    prompt = np.random.default_rng(3).integers(8, 128, 40).tolist()
    body = {"prompt": prompt, "max_tokens": 12, "ignore_eos": True}
    try:
        ch = tc.TokenChannel()
        engine.submit(tc.GenerateRequest(prompt_tokens=prompt, max_tokens=12, channel=ch,
                                         params=tc.SamplingParams(ignore_eos=True)))
        want = []
        for ev in ch:
            if isinstance(ev, tc.Token):
                want.append(ev.id)
        status, blocking = side.call("POST", "/v1/completions", {**body, "logprobs": 1})
        assert status == 200 and _ids(blocking["choices"][0]["text"]) == want
        lps = blocking["choices"][0]["logprobs"]
        assert lps["tokens"] == [f"tok{i}" for i in want] and len(lps["token_logprobs"]) == 12
        assert all(v <= 0 for v in lps["token_logprobs"])
        status, events = side.call("POST", "/v1/completions", {**body, "stream": True})
        assert status == 200 and events[-1] == "[DONE]"
        text = "".join(e["choices"][0]["text"] for e in events[:-1])
        assert text == blocking["choices"][0]["text"]
        assert events[-2]["choices"][0]["finish_reason"] == "length"
        status, echo = side.call("POST", "/v1/completions",
                                 {**body, "echo": True, "logprobs": 1})
        lps = echo["choices"][0]["logprobs"]
        # the echoed prompt's text is followed by the completion's, unjoined
        assert status == 200 and echo["choices"][0]["text"] == (
            " ".join(f"tok{i}" for i in prompt) + blocking["choices"][0]["text"])
        assert lps["tokens"] == [f"tok{i}" for i in prompt + want]
        assert lps["token_logprobs"][0] is None and len(lps["token_logprobs"]) == 52
        status, m = side.call("GET", "/metrics")
        # the JAX server counts the blocking requests' completion tokens only
        assert (m["requests_total"], m["completion_tokens_total"]) == (3, 24)
    finally:
        side.close()


def test_concurrent_streams_under_a_short_switch_interval():
    """24 clients stream at once (more than the cores and than the 16
    executor threads, so some wait for a thread) while the interpreter
    switches threads every 10 µs: every stream gets its tokens in order,
    each equal to its prompt's blocking text, and /metrics counts every
    request."""
    import sys
    import threading

    side = PortSide(threads=16, tpot_s=0.001)
    n, out = 24, {}

    def client(i):
        conn = http.client.HTTPConnection("127.0.0.1", side.server.port, timeout=WAIT_S)
        try:
            conn.request("POST", "/v1/completions", body=json.dumps(
                {"prompt": [i + 2, 3], "max_tokens": 20, "stream": True}).encode())
            r = conn.getresponse()
            out[i] = _parse(r.status, r.getheader("Content-Type", ""), r.read())
        finally:
            conn.close()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    try:
        assert sorted(out) == list(range(n))
        for i, (status, events) in out.items():
            assert status == 200 and events[-1] == "[DONE]"
            text = "".join(e["choices"][0]["text"] for e in events[:-1] if e.get("choices"))
            status, blocking = side.call("POST", "/v1/completions",
                                         {"prompt": [i + 2, 3], "max_tokens": 20})
            assert text == blocking["choices"][0]["text"] and len(text.split()) == 20
        assert side.call("GET", "/metrics")[1]["requests_total"] == 2 * n
    finally:
        side.close()
