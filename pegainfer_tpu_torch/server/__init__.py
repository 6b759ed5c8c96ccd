"""Serving stack of the port: the OpenAI-compatible HTTP frontend
(``api.py``) on a standard-library HTTP/1.1 transport (``httpd.py``), the
tokenizers (``tokenizer.py``) and the CLI (``main.py``). Counterpart of
``pegainfer_tpu/server``, whose frontend runs on aiohttp: the engine runs
in-process and the handlers talk straight to its ``EngineHandle``.
"""
