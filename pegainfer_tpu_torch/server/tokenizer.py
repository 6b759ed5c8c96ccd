"""Tokenizer seam and incremental detokenization for streaming,
counterpart of ``pegainfer_tpu/server/tokenizer.py``: ``HFTokenizer``
wraps ``transformers.AutoTokenizer`` (imported only when one is built),
``SimTokenizer`` keeps frontend tests model-free.
"""

from __future__ import annotations

from typing import List, Optional, Protocol


class Tokenizer(Protocol):
    def encode(self, text: str) -> List[int]: ...

    def decode(self, ids: List[int]) -> str: ...

    def apply_chat_template(self, messages: List[dict]) -> List[int]: ...

    @property
    def eos_token_id(self) -> Optional[int]: ...


class HFTokenizer:
    """transformers-backed tokenizer. Raises ImportError where transformers
    is missing; no other tokenizer is put in its place."""

    def __init__(self, model_path: str):
        try:
            from transformers import AutoTokenizer
        except ImportError as e:
            raise ImportError(
                f"HFTokenizer needs the transformers package to read {model_path!r}'s "
                "tokenizer; it is not installed") from e

        self._tok = AutoTokenizer.from_pretrained(model_path)

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text, add_special_tokens=False)

    def decode(self, ids: List[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=False)

    def apply_chat_template(self, messages: List[dict]) -> List[int]:
        return self._tok.apply_chat_template(messages, add_generation_prompt=True,
                                             tokenize=True)

    @property
    def eos_token_id(self) -> Optional[int]:
        return self._tok.eos_token_id


class SimTokenizer:
    """Deterministic toy tokenizer: one token per whitespace word (hashed into
    the vocab), decoded as ``tok<id>`` words. For sim-engine frontend tests,
    and for serving token-list prompts without a tokenizer: the ``tok<id>``
    text gives the ids back."""

    def __init__(self, vocab_size: int = 1000):
        self.vocab_size = vocab_size

    def encode(self, text: str) -> List[int]:
        return [hash(w) % (self.vocab_size - 2) + 2 for w in text.split()]

    def decode(self, ids: List[int]) -> str:
        return " ".join(f"tok{i}" for i in ids)

    def apply_chat_template(self, messages: List[dict]) -> List[int]:
        return self.encode(" ".join(m.get("content", "") for m in messages))

    @property
    def eos_token_id(self) -> Optional[int]:
        return 1


class Detokenizer:
    """Incremental detokenization: emits only complete UTF-8 text deltas.

    Decodes the full generated suffix each call and diffs against the last
    emitted prefix; holds back text while the decode ends in an incomplete
    codepoint (U+FFFD) so multi-token characters stream correctly.
    """

    REPLACEMENT = "�"

    def __init__(self, tokenizer: Tokenizer):
        self._tok = tokenizer
        self._ids: List[int] = []
        self._emitted = 0  # chars of the decoded string already sent

    def push(self, token_id: int) -> str:
        self._ids.append(token_id)
        text = self._tok.decode(self._ids)
        if text.endswith(self.REPLACEMENT):
            return ""
        delta = text[self._emitted:]
        self._emitted = len(text)
        return delta

    def flush(self) -> str:
        text = self._tok.decode(self._ids)
        delta = text[self._emitted:]
        self._emitted = len(text)
        return delta

    @property
    def text(self) -> str:
        return self._tok.decode(self._ids)
