"""CLI entry point of the port: model detection -> engine -> HTTP server.
Counterpart of ``pegainfer_tpu/server/main.py``, with its arguments. Run as

    python -m pegainfer_tpu_torch.server.main --model-path <checkpoint dir>
    python -m pegainfer_tpu_torch.server.main --sim

Qwen3, the Qwen3.5 hybrid, DeepSeek-V4 (an mp8 checkpoint; ``--quantize
bf16`` dequantizes it at load) and DeepSeek-V2-Lite (an HF checkpoint, bf16)
are served from a checkpoint through the port's engines on the card;
``--sim`` serves the simulated engine with the ``SimTokenizer`` (no card, no
model). ``--tp-size N --no-precompile`` serves a Qwen3 or a Qwen3.5 hybrid
checkpoint tensor-parallel, or a DeepSeek-V4 one split as its mp8 ranks
(N of 2, 4 or 8), one process a rank on the first N cards
(``models/qwen3_engine.py``, ``models/qwen35_engine.py``,
``models/dsv4_engine.py``). The server runs until SIGINT. What the port
lacks raises ``NotImplementedError``: ``--tp-size`` above 1 for
DeepSeek-V2-Lite (expert parallelism) or with the decode graphs (without
``--no-precompile``), a ``--quantize`` value the family does not serve,
``--profile-dir`` and the multi-host variables ``PEGAINFER_COORD`` /
``_NUM_PROCS`` / ``_PROC_ID``.
A checkpoint's tokenizer is read with transformers (``HFTokenizer``).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

from pegainfer_tpu_torch.engine.contract import EngineHandle, EngineLoadOptions

MULTIHOST_ENV = ("PEGAINFER_COORD", "PEGAINFER_NUM_PROCS", "PEGAINFER_PROC_ID")
TP_FAMILIES = ("qwen3", "qwen35", "deepseek_v4")  # the families served split over ranks

log = logging.getLogger("pegainfer_torch.server")


def detect_model_type(model_path: str) -> str:
    """The model family from config.json's ``model_type`` / architectures."""
    with open(os.path.join(model_path, "config.json")) as f:
        cfg = json.load(f)
    if cfg.get("model_type") == "deepseek_v4":
        return "deepseek_v4"
    if cfg.get("model_type") == "deepseek_v2":
        return "dsv2lite"
    archs = cfg.get("architectures") or []
    if "Qwen3ForCausalLM" in archs:
        return "qwen3"
    if any(a in ("Qwen3NextForCausalLM", "Qwen3_5ForCausalLM") for a in archs):
        return "qwen35"
    if any("Deepseek" in a for a in archs):
        return "deepseek_v4"
    raise ValueError(f"unsupported architectures: {archs}")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("pegainfer-tpu-torch serve")
    p.add_argument("--model-path", help="HF checkpoint dir (config.json + safetensors)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000, help="0: a free port (logged)")
    p.add_argument("--tp-size", type=int, default=0,
                   help="tensor-parallel world (0 or 1: one card, whatever the card "
                        "count; N > 1: Qwen3, Qwen3.5 or DeepSeek-V4 on N processes, "
                        "with --no-precompile)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--max-num-pages", type=int, default=None)
    p.add_argument("--max-batch-size", type=int, default=64)
    p.add_argument("--quantize", choices=["int8", "bf16"], default=None,
                   help="int8: weight-only int8 serving (Qwen families); bf16: "
                        "dequantize a quantized checkpoint at load (DSv4)")
    p.add_argument("--no-prefix-cache", action="store_true",
                   help="disable shared-prompt-prefix page caching")
    p.add_argument("--prefill-chunk", type=int, default=2048,
                   help="chunk size for long-prompt prefill (tokens)")
    p.add_argument("--prefill-chunk-mixed", type=int, default=256,
                   help="chunk size while other requests are decoding (bounds "
                        "decode stalls; set equal to --prefill-chunk to disable)")
    p.add_argument("--delivery-profile", action="store_true",
                   help="delivery-bounded decode: 4-token steady blocks and 4 "
                        "blocks in flight (default: 16-token blocks, 2 in flight)")
    p.add_argument("--decode-block-max", type=int, default=0,
                   help="steady-state decode block size override")
    p.add_argument("--pipeline-depth", type=int, default=0,
                   help="decode blocks in flight (default 2)")
    p.add_argument("--no-precompile", action="store_true",
                   help="no decode graphs: the eager decode step")
    p.add_argument("--profile-dir", default=None,
                   help="trace the serving process (not ported: raises)")
    p.add_argument("--sim", action="store_true", help="simulated engine (no card)")
    p.add_argument("--sim-ttft", type=float, default=0.02)
    p.add_argument("--sim-tpot", type=float, default=0.005)
    args = p.parse_args(argv)
    if not args.sim and not args.model_path:
        p.error("--model-path required (or use --sim)")
    return args


def load_options(args: argparse.Namespace) -> EngineLoadOptions:
    """The engine's options from the CLI's arguments (the JAX CLI's)."""
    okw = {}
    if args.delivery_profile:
        # delivery-bounded serving: small steady blocks and a deeper window;
        # an explicit --decode-block-max / --pipeline-depth wins
        okw = {"decode_block_max": 4, "decode_pipeline_depth": 4}
    if args.decode_block_max:
        okw["decode_block_max"] = args.decode_block_max
    if args.pipeline_depth:
        okw["decode_pipeline_depth"] = args.pipeline_depth
    return EngineLoadOptions(
        precompile=not args.no_precompile,
        seed=args.seed,
        max_num_pages=args.max_num_pages,
        max_batch_size=args.max_batch_size,
        quantize=args.quantize,
        enable_prefix_cache=not args.no_prefix_cache,
        prefill_chunk=args.prefill_chunk,
        prefill_chunk_mixed=args.prefill_chunk_mixed,
        **okw,
    )


def check_supported(args: argparse.Namespace) -> None:
    """Raise ``NotImplementedError`` for what the port's CLI lacks."""
    if args.profile_dir:
        raise NotImplementedError(
            "--profile-dir: the port has no tracing of the serving process yet")
    if args.sim:
        return
    set_vars = [v for v in MULTIHOST_ENV if os.environ.get(v)]
    if set_vars:
        raise NotImplementedError(
            f"{', '.join(set_vars)} set: the port has no multi-host serving")
    if args.tp_size > 1:
        family = detect_model_type(args.model_path)
        if family not in TP_FAMILIES:
            raise NotImplementedError(
                f"--tp-size {args.tp_size}: the port's tensor parallelism serves Qwen3, "
                f"Qwen3.5 and DeepSeek-V4, not {family}")
        if not args.no_precompile:
            raise NotImplementedError(
                f"--tp-size {args.tp_size}: tensor parallelism runs the eager decode step; "
                "pass --no-precompile")


def build_engine(args: argparse.Namespace, device=None) -> EngineHandle:
    """The engine the arguments ask for: the sim engine, or a checkpoint's
    through the port's engine of its family (on ``device``, ``cuda`` by
    default)."""
    check_supported(args)
    opts = load_options(args)
    if args.sim:
        from pegainfer_tpu_torch.sim import SimulatedEngineConfig, start_engine

        return start_engine(SimulatedEngineConfig(ttft_s=args.sim_ttft, tpot_s=args.sim_tpot),
                            opts)
    mtype = detect_model_type(args.model_path)
    if mtype == "qwen3":
        from pegainfer_tpu_torch.models import qwen3_engine

        return qwen3_engine.start_engine(args.model_path, opts, device=device,
                                         tp_size=args.tp_size)
    if mtype == "qwen35":
        from pegainfer_tpu_torch.models import qwen35_engine

        return qwen35_engine.start_engine(args.model_path, opts, device=device,
                                          tp_size=args.tp_size)
    if mtype == "deepseek_v4":
        from pegainfer_tpu_torch.models import dsv4_engine

        return dsv4_engine.start_engine(args.model_path, opts, device=device,
                                        tp_size=args.tp_size)
    from pegainfer_tpu_torch.models import dsv2lite

    return dsv2lite.start_engine(args.model_path, opts, device=device,
                                 ep_size=args.tp_size if args.tp_size > 0 else None)


def build_tokenizer(args: argparse.Namespace):
    """(tokenizer, model name): ``SimTokenizer`` for ``--sim``, else the
    checkpoint's through transformers."""
    if args.sim:
        from pegainfer_tpu_torch.server.tokenizer import SimTokenizer

        return SimTokenizer(), "pegainfer-sim"
    from pegainfer_tpu_torch.server.tokenizer import HFTokenizer

    return HFTokenizer(args.model_path), os.path.basename(os.path.normpath(args.model_path))


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(
        level=os.environ.get("PEGAINFER_LOG", "INFO"),
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    check_supported(args)
    # the tokenizer first: a missing transformers stops the start before
    # the weights are loaded
    tokenizer, model_name = build_tokenizer(args)
    engine = build_engine(args)
    from pegainfer_tpu_torch.server import httpd
    from pegainfer_tpu_torch.server.api import OpenAIApp

    try:
        app = OpenAIApp(engine, tokenizer, model_name).build()
        server = httpd.serve(app, args.host, args.port,
                             threads=max(64, args.max_batch_size))
    except BaseException:
        engine.shutdown()
        raise
    log.info("serving %s on http://%s:%d", model_name, server.host, server.port)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        log.info("interrupted: stopping")
    finally:
        server.close()
        engine.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
