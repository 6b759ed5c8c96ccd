"""Where the time of the split-KV paged-decode kernel K1 goes, on one card.

    python3 scripts/k1_split_study.py

Times K1 (``pegainfer_tpu_torch/csrc/paged_decode.cu``) at Qwen3-4B's head
shapes (32 query heads, 8 kv heads, hd 128, pages of 64) on
``chip_smoke.decode_case``'s inputs (the 36-layer pool, the last token in
flight), with CUDA events over back-to-back launches:

- the floor: one launch of a one-element add;
- B = 1 at a context of 1,152 and 8,192 under forced split plans (S splits
  of pps pages, through the kernel's C interface), the planner's own
  first; each row of the grid (1, 8, S); pages L2-hot (one layer) against
  cold (36 layers cycled, as a decode step finds them);
- SDPA on the same inputs (``chip_smoke.sdpa_decode_library``);
- one split (18 tiles in turn) at G = 1, 2, 4, 8 and hd 128, and G = 4 at
  hd 64: whether a tile's time follows the work or the bytes;
- the wrapper on a context of 1,152 in page tables wider than the row (18,
  64 and 256 pages): the planner splits the table width, so the live
  tokens fall into the first splits of a wide table.

Prints one line per measurement, the card line, and a JSON object.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def plan_launcher(lib, a, S, pps):
    """One K1 launch on ``a`` (pool form with the in-flight token, layer
    ``a["layer_id"]``) under the split plan (S, pps), through the kernel's
    C interface, with scratch allocated per call as the wrapper does."""
    q, pool, tables = a["q"], a["k_pages"], a["page_tables"]
    B, Hq, hd = q.shape
    Hkv, ps = pool.shape[1], pool.shape[4]
    G, P, esize = Hq // Hkv, tables.shape[1], pool.element_size()
    tickets = torch.zeros(B * Hkv, dtype=torch.int32, device=q.device)

    def launch():
        out = torch.empty_like(q)
        n = B * Hkv * S * G
        part = torch.empty(n * (hd + 2), dtype=torch.float32, device=q.device)
        k_ptr = pool.data_ptr() + a["layer_id"] * pool.stride(0) * esize
        err = lib.paged_decode_bf16(
            q.data_ptr(), k_ptr, k_ptr + pool.stride(3) * esize, a["cur_k"].data_ptr(),
            a["cur_v"].data_ptr(), tables.data_ptr(), a["seq_lens"].data_ptr(), out.data_ptr(),
            part.data_ptr(), part.data_ptr() + n * hd * 4, tickets.data_ptr(), B, Hkv, G, hd, P,
            ps, S, pps, pool.stride(1), pool.stride(2), float(a["scale"]), 1,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"paged_decode_bf16 returned {err} for plan ({S}, {pps})")
        return out
    return launch


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_split_study: no CUDA device", file=sys.stderr)
        return 2
    from pegainfer_tpu_torch.models import qwen3 as q3
    from pegainfer_tpu_torch.ops.cuda import build
    from pegainfer_tpu_torch.ops.cuda import paged_decode as pd

    lib = build.load("paged_decode")
    cfg = cs.qwen3_4b_config(q3)
    L = cfg.num_hidden_layers
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    result = {"card": cs.card_line(), "sm_count": sms}

    one = torch.zeros(1, device="cuda")
    result["floor_us"] = cs.time_ms(lambda i: one.add_(1), 360) * 1e3
    print(f"floor (one-element add): {result['floor_us']:.2f} us", flush=True)

    for ctx, plans in ((1152, [None, (9, 2), (6, 3), (3, 6), (1, 18)]),
                       (8192, [None, (64, 2), (128, 1), (16, 8), (8, 16)])):
        a = cs.decode_case(gen, cfg, [ctx], "pool_cur", layers=L)
        rows = []
        for plan in plans:
            S, pps = plan or pd.plan_splits(1, 8, a["page_tables"].shape[1], cs.PAGE, sms)
            launch = plan_launcher(lib, a, S, pps)

            def cold(i):
                a["layer_id"] = i % L
                return launch()

            def hot(i):
                a["layer_id"] = 0
                return launch()

            ref = pd.paged_attention_decode_plain(**{**a, "layer_id": 0})
            err = (hot(0).float() - ref.float()).abs().max().item()
            row = {"S": S, "pps": pps, "planner": plan is None, "max_abs_err": err,
                   "cold_us": cs.time_ms(cold, 360) * 1e3, "hot_us": cs.time_ms(hot, 360) * 1e3}
            rows.append(row)
            print(f"ctx {ctx} S={S} pps={pps}{' (planner)' if plan is None else ''}: cold "
                  f"{row['cold_us']:.2f} us, L2-hot {row['hot_us']:.2f} us, max_abs_err {err:.3e}",
                  flush=True)
        a["layer_id"] = 0
        lib_ms, lib_call = cs.sdpa_decode_library(a, L, pd.paged_attention_decode(**a))
        result[f"ctx{ctx}"] = {"plans": rows, "sdpa_us": lib_ms * 1e3 if lib_ms else None,
                               "sdpa_call": lib_call}
        del a
        torch.cuda.empty_cache()

    # one split (18 tiles in turn a block): does a tile's time follow the
    # work (G query heads a kv head, hd) or the bytes (hd only)?
    result["one_split"] = []
    for G, hd in ((1, 128), (2, 128), (4, 128), (8, 128), (4, 64)):
        shape = SimpleNamespace(num_attention_heads=8 * G, num_key_value_heads=8, head_dim=hd)
        a = cs.decode_case(gen, shape, [1152], "pool_cur", layers=L)
        launch = plan_launcher(lib, a, 1, 18)

        def cold(i):
            a["layer_id"] = i % L
            return launch()

        us = cs.time_ms(cold, 360) * 1e3
        result["one_split"].append({"G": G, "hd": hd, "us": us})
        print(f"ctx 1152 S=1 G={G} hd={hd}: {us:.2f} us", flush=True)
        del a

    # the wrapper on tables wider than the row: the plan follows the width
    a = cs.decode_case(gen, cfg, [1152], "pool_cur", layers=L)
    narrow = a["page_tables"]
    result["wide_tables"] = []
    for width in (narrow.shape[1], 64, 256):
        a["page_tables"] = torch.nn.functional.pad(narrow, (0, width - narrow.shape[1]))
        S, pps = pd.plan_splits(1, 8, width, cs.PAGE, sms)
        a["layer_id"] = 0
        ref = pd.paged_attention_decode_plain(**a)
        err = (pd.paged_attention_decode(**a).float() - ref.float()).abs().max().item()

        def cold(i):
            a["layer_id"] = i % L
            return pd.paged_attention_decode(**a)

        us = cs.time_ms(cold, 360) * 1e3
        result["wide_tables"].append({"P": width, "S": S, "pps": pps, "us": us,
                                      "max_abs_err": err})
        print(f"ctx 1152 in a table of {width} pages (S={S} pps={pps}): {us:.2f} us, "
              f"max_abs_err {err:.3e}", flush=True)
    print(result["card"])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
