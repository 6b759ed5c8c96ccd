"""OpenAI-compatible HTTP API over an in-process EngineHandle, counterpart
of ``pegainfer_tpu/server/api.py`` with the same routes, bodies, fields and
status codes; its handlers run on the port's standard-library transport
(``server/httpd.py``) in place of aiohttp.

Endpoints (parity with the reference's served surface via vllm-server:
/v1/completions, /v1/chat/completions, /v1/models, /health):

- POST /v1/completions — prompt as string, token list, or batch of either;
  stream (SSE), logprobs, echo, stop strings, temperature/top_k/top_p,
  max_tokens, seed-free determinism (sampling draws are scheduler-seeded,
  reference plan.rs:62).
- POST /v1/chat/completions — chat template applied by the tokenizer.
- GET /v1/models, GET /health.

TokenEvents map to OpenAI objects: Token → delta chunk, Finished →
finish_reason stop/length, Rejected/Error → HTTP 400/500 (or an error chunk
mid-stream). Scheduled events carry queue/schedule timestamps (reference
vllm-frontend/src/lib.rs:303-325) — exposed in the non-standard "pegainfer"
field for observability.
"""

from __future__ import annotations

import json
import time
import uuid
from typing import Any, Dict, List, Optional

from pegainfer_tpu_torch.engine.contract import (
    EngineHandle,
    Error,
    Finished,
    FinishReason,
    GenerateRequest,
    PromptTokens,
    Rejected,
    SamplingParams,
    Scheduled,
    Token,
)
from pegainfer_tpu_torch.server import httpd
from pegainfer_tpu_torch.server.tokenizer import Detokenizer, Tokenizer


def _sampling_from_body(body: Dict[str, Any]) -> SamplingParams:
    return SamplingParams(
        temperature=float(body.get("temperature", 0.0) or 0.0),
        top_k=int(body.get("top_k", -1) or -1),
        top_p=float(body.get("top_p", 1.0) or 1.0),
        ignore_eos=bool(body.get("ignore_eos", False)),
    )


def _error_response(status: int, message: str, etype: str = "invalid_request_error"):
    return httpd.json_response(
        {"error": {"message": message, "type": etype, "code": status}}, status=status
    )


class OpenAIApp:
    def __init__(self, engine: EngineHandle, tokenizer: Tokenizer, model_name: str):
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name
        # serving counters (reference analog: bench/KV telemetry snapshots,
        # deepseek-v4/src/direct/scheduler.rs:92-120)
        self.stats = {
            "requests_total": 0,
            "requests_rejected": 0,
            "requests_errored": 0,
            "prompt_tokens_total": 0,
            "completion_tokens_total": 0,
            "started_unix_s": time.time(),
        }

    # ── app wiring ───────────────────────────────────────────────────

    def build(self) -> httpd.App:
        app = httpd.App()
        app.add_post("/v1/completions", self.completions)
        app.add_post("/v1/chat/completions", self.chat_completions)
        app.add_get("/v1/models", self.models)
        app.add_get("/health", self.health)
        app.add_get("/metrics", self.metrics)
        return app

    async def health(self, request: httpd.Request) -> httpd.Response:
        return httpd.json_response({"status": "ok"})

    async def metrics(self, request: httpd.Request) -> httpd.Response:
        up = time.time() - self.stats["started_unix_s"]
        return httpd.json_response({**self.stats, "uptime_s": round(up, 1)})

    async def models(self, request: httpd.Request) -> httpd.Response:
        return httpd.json_response(
            {
                "object": "list",
                "data": [
                    {
                        "id": self.model_name,
                        "object": "model",
                        "created": int(time.time()),
                        "owned_by": "pegainfer-tpu",
                    }
                ],
            }
        )

    # ── shared generation plumbing ───────────────────────────────────

    def _submit(self, prompt_tokens: List[int], body: Dict[str, Any]) -> GenerateRequest:
        self.stats["requests_total"] += 1
        self.stats["prompt_tokens_total"] += len(prompt_tokens)
        req = GenerateRequest(
            prompt_tokens=prompt_tokens,
            max_tokens=int(body.get("max_tokens", 16)),
            params=_sampling_from_body(body),
            request_id=str(uuid.uuid4()),
            queued_at_unix_s=time.time(),
            logprobs=int(body.get("logprobs") or 0),
            echo=bool(body.get("echo", False)),
        )
        self.engine.submit(req)
        return req

    @staticmethod
    def _check_stop_strings(text: str, stops: List[str]) -> Optional[int]:
        """First index where any stop string starts, or None."""
        cut = None
        for s in stops:
            i = text.find(s)
            if i >= 0 and (cut is None or i < cut):
                cut = i
        return cut

    # ── /v1/completions ──────────────────────────────────────────────

    async def completions(self, request: httpd.Request) -> httpd.StreamResponse:
        try:
            body = request.json()
        except json.JSONDecodeError:
            return _error_response(400, "invalid JSON body")
        prompt = body.get("prompt")
        if prompt is None:
            return _error_response(400, "missing 'prompt'")
        prompts = prompt if isinstance(prompt, list) and prompt and isinstance(prompt[0], (str, list)) else [prompt]
        if isinstance(prompt, list) and prompt and isinstance(prompt[0], int):
            prompts = [prompt]  # single token-list prompt

        token_prompts: List[List[int]] = []
        for p in prompts:
            if isinstance(p, str):
                token_prompts.append(self.tokenizer.encode(p))
            elif isinstance(p, list):
                token_prompts.append([int(t) for t in p])
            else:
                return _error_response(400, "prompt must be string or token list")

        stream = bool(body.get("stream", False))
        if stream and len(token_prompts) > 1:
            return _error_response(400, "streaming supports a single prompt")

        if stream:
            return await self._stream_completion(request, token_prompts[0], body, chat=False)
        return await self._blocking_completion(token_prompts, body)

    def _logprobs_obj(self, out: "_Collected", want: int) -> Optional[Dict[str, Any]]:
        """OpenAI completions-style logprobs block (tokens as decoded strings)."""
        if want <= 0:
            return None
        ids = (out.prompt_token_ids + out.token_ids) if out.prompt_token_ids else out.token_ids
        lps = (out.prompt_logprobs + out.token_logprobs) if out.prompt_token_ids else out.token_logprobs
        tokens, token_logprobs, top_logprobs = [], [], []
        for tid, lp in zip(ids, lps):
            tokens.append(self.tokenizer.decode([tid]))
            token_logprobs.append(None if lp is None else lp.logprob)
            if lp is None or not lp.top_logprobs:
                top_logprobs.append(None)
            else:
                top_logprobs.append(
                    {self.tokenizer.decode([t]): v for t, v in lp.top_logprobs}
                )
        return {
            "tokens": tokens,
            "token_logprobs": token_logprobs,
            "top_logprobs": top_logprobs,
            "text_offset": [],
        }

    async def _blocking_completion(self, token_prompts, body) -> httpd.Response:
        stops = _stop_list(body)
        choices = []
        total_prompt = total_completion = 0
        for idx, toks in enumerate(token_prompts):
            req = self._submit(toks, body)
            out = await _collect_events(req)
            if isinstance(out, Rejected):
                self.stats["requests_rejected"] += 1
                return _error_response(400, out.message)
            if isinstance(out, _Failed):
                self.stats["requests_errored"] += 1
                return _error_response(500, out.message, "internal_error")
            text = self.tokenizer.decode(out.token_ids)
            finish = out.finish
            cut = self._check_stop_strings(text, stops)
            if cut is not None:
                text, finish = text[:cut], "stop"
            echo_text = self.tokenizer.decode(toks) if body.get("echo") else ""
            choices.append(
                {
                    "index": idx,
                    "text": echo_text + text,
                    "finish_reason": finish,
                    "logprobs": self._logprobs_obj(out, int(body.get("logprobs") or 0)),
                }
            )
            if out.queue_ms is not None:
                choices[-1]["pegainfer"] = {"queue_ms": out.queue_ms}
            total_prompt += len(toks)
            total_completion += len(out.token_ids)
        self.stats["completion_tokens_total"] += total_completion
        return httpd.json_response(
            {
                "id": f"cmpl-{uuid.uuid4().hex[:24]}",
                "object": "text_completion",
                "created": int(time.time()),
                "model": self.model_name,
                "choices": choices,
                "usage": {
                    "prompt_tokens": total_prompt,
                    "completion_tokens": total_completion,
                    "total_tokens": total_prompt + total_completion,
                },
            }
        )

    async def _stream_completion(
        self, request: httpd.Request, toks: List[int], body, chat: bool
    ) -> httpd.StreamResponse:
        resp = httpd.StreamResponse(
            headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
                "Connection": "keep-alive",
            }
        )
        await resp.prepare(request)
        req = self._submit(toks, body)
        detok = Detokenizer(self.tokenizer)
        stops = _stop_list(body)
        rid = f"{'chatcmpl' if chat else 'cmpl'}-{uuid.uuid4().hex[:24]}"
        created = int(time.time())
        n_completion = 0
        sent_role = False
        finish = None
        error_msg = None
        emitted = ""

        async def send(payload: Dict[str, Any]):
            await resp.write(f"data: {json.dumps(payload)}\n\n".encode())

        def chunk(delta_text: Optional[str], finish_reason: Optional[str]):
            if chat:
                delta: Dict[str, Any] = {}
                nonlocal sent_role
                if not sent_role:
                    delta["role"] = "assistant"
                    sent_role = True
                if delta_text:
                    delta["content"] = delta_text
                choice = {"index": 0, "delta": delta, "finish_reason": finish_reason}
                obj = "chat.completion.chunk"
            else:
                choice = {
                    "index": 0,
                    "text": delta_text or "",
                    "finish_reason": finish_reason,
                }
                obj = "text_completion"
            return {
                "id": rid,
                "object": obj,
                "created": created,
                "model": self.model_name,
                "choices": [choice],
            }

        try:
            async for ev in req.channel:
                if isinstance(ev, Token):
                    n_completion += 1
                    delta = detok.push(ev.id)
                    if delta:
                        cut = self._check_stop_strings(emitted + delta, stops)
                        if cut is not None:
                            head = (emitted + delta)[:cut][len(emitted):]
                            if head:
                                await send(chunk(head, None))
                            finish = "stop"
                            req.channel.close()
                            break
                        emitted += delta
                        await send(chunk(delta, None))
                elif isinstance(ev, Finished):
                    tail = detok.flush()
                    if tail:
                        stops_cut = self._check_stop_strings(emitted + tail, stops)
                        if stops_cut is not None:
                            tail = (emitted + tail)[:stops_cut][len(emitted):]
                        if tail:
                            await send(chunk(tail, None))
                    finish = ev.finish_reason.value
                elif isinstance(ev, (Error, Rejected)):
                    error_msg = ev.message
                    break
            if error_msg is not None:
                await send({"error": {"message": error_msg, "type": "internal_error"}})
            else:
                await send(chunk(None, finish or "stop"))
                if body.get("stream_options", {}).get("include_usage"):
                    usage_chunk = chunk(None, None)
                    usage_chunk["choices"] = []
                    usage_chunk["usage"] = {
                        "prompt_tokens": len(toks),
                        "completion_tokens": n_completion,
                        "total_tokens": len(toks) + n_completion,
                    }
                    await send(usage_chunk)
            await resp.write(b"data: [DONE]\n\n")
        finally:
            req.channel.close()
        await resp.write_eof()
        return resp

    # ── /v1/chat/completions ─────────────────────────────────────────

    async def chat_completions(self, request: httpd.Request) -> httpd.StreamResponse:
        try:
            body = request.json()
        except json.JSONDecodeError:
            return _error_response(400, "invalid JSON body")
        messages = body.get("messages")
        if not messages:
            return _error_response(400, "missing 'messages'")
        try:
            toks = self.tokenizer.apply_chat_template(messages)
        except Exception as e:  # noqa: BLE001
            return _error_response(400, f"chat template failed: {e}")
        body.setdefault("max_tokens", body.get("max_completion_tokens", 256))

        if body.get("stream", False):
            return await self._stream_completion(request, toks, body, chat=True)

        req = self._submit(toks, body)
        out = await _collect_events(req)
        if isinstance(out, Rejected):
            return _error_response(400, out.message)
        if isinstance(out, _Failed):
            return _error_response(500, out.message, "internal_error")
        text = self.tokenizer.decode(out.token_ids)
        finish = out.finish
        n_completion = len(out.token_ids)
        stops = _stop_list(body)
        cut = self._check_stop_strings(text, stops)
        if cut is not None:
            text, finish = text[:cut], "stop"
        return httpd.json_response(
            {
                "id": f"chatcmpl-{uuid.uuid4().hex[:24]}",
                "object": "chat.completion",
                "created": int(time.time()),
                "model": self.model_name,
                "choices": [
                    {
                        "index": 0,
                        "message": {"role": "assistant", "content": text},
                        "finish_reason": finish,
                    }
                ],
                "usage": {
                    "prompt_tokens": len(toks),
                    "completion_tokens": n_completion,
                    "total_tokens": len(toks) + n_completion,
                },
            }
        )


def _stop_list(body: Dict[str, Any]) -> List[str]:
    stop = body.get("stop")
    if stop is None:
        return []
    return [stop] if isinstance(stop, str) else [str(s) for s in stop]


class _Failed:
    def __init__(self, message: str):
        self.message = message


class _Collected:
    """Terminal summary of one request's event stream."""

    def __init__(self):
        self.token_ids: List[int] = []
        self.token_logprobs: List[Any] = []
        self.prompt_token_ids: List[int] = []
        self.prompt_logprobs: List[Any] = []
        self.finish = "stop"
        self.queue_ms: Any = None


async def _collect_events(req: GenerateRequest):
    """The request's events to its end. The channel is closed on the way
    out, so a handler cancelled by a client that left retires its request
    (and frees the executor thread that waits on the channel)."""
    out = _Collected()
    try:
        async for ev in req.channel:
            if isinstance(ev, Token):
                out.token_ids.append(ev.id)
                out.token_logprobs.append(ev.logprob)
            elif isinstance(ev, PromptTokens):
                out.prompt_token_ids = ev.ids
                out.prompt_logprobs = list(ev.logprobs)
            elif isinstance(ev, Finished):
                out.finish = ev.finish_reason.value
            elif isinstance(ev, Rejected):
                return ev
            elif isinstance(ev, Error):
                return _Failed(ev.message)
            elif isinstance(ev, Scheduled):
                out.queue_ms = round(
                    (ev.scheduled_at_unix_s - ev.queued_at_unix_s) * 1e3, 2
                )
    finally:
        req.channel.close()
    return out
