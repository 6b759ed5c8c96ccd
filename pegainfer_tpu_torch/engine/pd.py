"""Prefill/decode disaggregation (PD handoff); the port's copy of
``pegainfer_tpu/engine/pd.py``.

A prefill-side executor runs the prompt, then the request moves to a
decode-side executor with its own KV pool and state (in a deployment
another host). The payload lives on the host, in CPU tensors (numpy has
no bf16): the bytes that would cross the wire. It holds the request's KV
page contents, its state slot's rows (the Qwen3.5 hybrid's recurrent and
conv rows; DeepSeek-V4's window ring, compressed rows and compressor rings,
its whole payload) and the bookkeeping. The decode side allocates its own
pages, scatters the rows in, seeds a slot of its own and advances the
accounting; the request then decodes there as if it had prefilled there.

An executor supports the handoff through hooks of the same names in every
executor: ``export_pages(page_ids)`` / ``import_pages(rows, page_ids)``
where the model has paged KV (``TorchExecutor``, ``HybridExecutor``), and
``slot_export(slot)`` / ``slot_import(snap, slot)`` where it keeps state
rows a request (``HybridExecutor``, ``SlotExecutor``).

Scope: the executor-level seam. A disaggregated scheduler routes prefill
engine -> payload -> decode engine; that policy belongs to a deployment.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from pegainfer_tpu_torch.engine.executor import PrefillPlan, PrefillStepItem


@dataclass
class HandoffPayload:
    """Everything the decode side needs, on the host."""

    request_id: int
    prompt_len: int
    first_token: int
    kv_rows: Optional[torch.Tensor]  # the gathered pages; None for a page-less model
    state_snap: Optional[Any] = None  # the slot's rows, a tree of CPU tensors


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def prefill_and_export(ex, item: PrefillStepItem) -> HandoffPayload:
    """Prefill ``item`` on executor ``ex``, gather its pages and slot rows
    into a host payload, and release everything it held on ``ex``."""
    export_pages = getattr(ex, "export_pages", None)
    slot_export = getattr(ex, "slot_export", None)
    if export_pages is None and slot_export is None:
        raise ValueError("executor provides no export hooks (no PD support)")
    res = ex.execute_prefill(PrefillPlan(requests=[item], echo=item.echo))
    st = ex.acct.get(item.request_id)
    rows = export_pages(list(st.pages)).cpu() if export_pages is not None else None
    snap = _to_host(slot_export(ex._slot(item.request_id))) if slot_export is not None else None
    payload = HandoffPayload(request_id=item.request_id, prompt_len=st.length,
                             first_token=res.requests[0].first_token, kv_rows=rows,
                             state_snap=snap)
    ex.release_request(item.request_id)
    return payload


def import_request(ex, payload: HandoffPayload) -> None:
    """Materialize a handed-off request on executor ``ex``: allocate its
    pages, scatter the shipped rows, seed a slot and advance the
    accounting. Its first decode input is ``payload.first_token``."""
    if payload.kv_rows is not None and getattr(ex, "import_pages", None) is None:
        raise ValueError("payload has pages but the executor has no import_pages")
    if payload.state_snap is not None and getattr(ex, "slot_import", None) is None:
        raise ValueError("payload has state rows but the executor has no slot_import")
    st = ex.acct.state(payload.request_id)
    if st.length or st.pages:
        raise ValueError(f"request {payload.request_id} already present")
    st.ensure_capacity(ex.acct.pool, payload.prompt_len)
    if payload.kv_rows is not None:
        n_pages = -(-payload.prompt_len // ex.page_size())
        ex.import_pages(payload.kv_rows, st.pages[:n_pages])
    st.advance(payload.prompt_len)
    if payload.state_snap is not None:
        ex.slot_import(payload.state_snap, ex._slot(payload.request_id))
