"""The port's chunked-prefill piece plan and prefill stepper against the JAX
executor's (``JaxExecutor.prefill_stepper``), under random flips of
``decode_active`` between pieces, as ``tests/test_chunked_prefill.py``'s
``test_adaptive_piece_plan_fuzz`` walks the JAX one.

The piece ends must be page-aligned and strictly rising, equal to what the
JAX stepper yields for the same flips, and the first token must equal the
whole-prompt path's. Tiny config (2 layers, hidden 64, page 4, f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pegainfer_tpu.engine import contract as jc
from pegainfer_tpu.engine import executor as jx
from pegainfer_tpu.engine.jax_executor import JaxExecutor
from pegainfer_tpu.models import qwen3 as jq3
from pegainfer_tpu_torch.engine import contract as tc
from pegainfer_tpu_torch.engine import executor as tx
from pegainfer_tpu_torch.engine.torch_executor import (
    TorchExecutor,
    plan_piece,
    small_piece,
)
from pegainfer_tpu_torch.models import qwen3 as tq3

PS = 4
CHUNK, MIXED = 32, 16


def _cfg_kw():
    return dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                vocab_size=128, rms_norm_eps=1e-6, rope_theta=1e6,
                tie_word_embeddings=True, eos_token_id=1, stop_token_ids=(1,),
                max_position_embeddings=1024)


def _walk(T, start, chunk, mixed, small, flips):
    ends = []
    while start < T:
        start = plan_piece(T, start, chunk, mixed, small, next(flips))
        ends.append(start)
    return ends


@pytest.mark.parametrize("ps", [4, 16, 64])
def test_piece_plan_walk(ps):
    """Every schedule covers [start, T) in rising page-aligned steps, takes
    mixed pieces exactly while decode is active and leaves at most one
    ``small`` tail."""
    rng = np.random.default_rng(ps)
    for _ in range(300):
        chunk = ps * int(rng.integers(1, 48))
        mixed = min(chunk, ps * int(rng.integers(1, 12)))
        small = small_piece(chunk, ps)
        T = int(rng.integers(1, 6000))
        start = ps * int(rng.integers(0, (T - 1) // ps + 1))  # a cached prefix
        flips = [bool(b) for b in rng.integers(0, 2, 4096)]
        ends = _walk(T, start, chunk, mixed, small, iter(flips))
        assert ends[-1] == T
        assert all(b > a for a, b in zip([start] + ends, ends))
        assert all(e % ps == 0 for e in ends[:-1])
        for a, b, active in zip([start] + ends, ends, flips):
            if T - a <= small:
                assert b == T
            else:
                assert b == min(a + (mixed if active else chunk), T)
    assert small_piece(2048, 64) == 256 and small_piece(128, 64) == 128
    assert small_piece(2048, 96) == 2048  # 256 is not a page multiple


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jq3.Qwen3Config(**_cfg_kw()), tq3.Qwen3Config(**_cfg_kw())
    jparams = jq3.init_random_params(jcfg, seed=3, dtype=jnp.float32, scale=0.2)
    tparams = tq3.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, tcfg, tparams


def _drive(ex, item, flips):
    gen = ex.prefill_stepper(item)
    ends = []
    while True:
        ex.decode_active = next(flips)
        try:
            ends.append(next(gen))
        except StopIteration as done:
            return ends, done.value


@pytest.mark.parametrize("trial", range(3))
def test_stepper_matches_jax_stepper(models, trial):
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(100 + trial)
    T = int(rng.integers(40, 200))
    prompt = rng.integers(2, 127, T).tolist()
    flips = [bool(b) for b in rng.integers(0, 2, 64)]

    rt = jq3.make_runtime(jcfg, jparams, num_pages=128, page_size=PS,
                          kv_dtype=jnp.float32, use_pallas=False)
    jex = JaxExecutor(rt, jc.EngineLoadOptions(prefill_chunk=CHUNK, prefill_chunk_mixed=MIXED,
                                               enable_prefix_cache=False))
    jends, jres = _drive(jex, jx.PrefillStepItem(
        request_id=1, prompt_tokens=prompt, params=jc.SamplingParams()), iter(flips))

    def port(opts):
        return TorchExecutor(tcfg, tparams, tq3.make_kv_pages(tcfg, 128, PS,
                                                              dtype=torch.float32), opts)

    tex = port(tc.EngineLoadOptions(prefill_chunk=CHUNK, prefill_chunk_mixed=MIXED))
    item = tx.PrefillStepItem(request_id=1, prompt_tokens=prompt, params=tc.SamplingParams())
    tends, tres = _drive(tex, item, iter(flips))
    assert tends == jends, (T, tends, jends)
    assert all(e % PS == 0 and e < T for e in tends)
    assert tends == sorted(set(tends))
    assert tex.chunk_pieces == len(tends) + 1 and tex.prefills == 0
    # the whole-prompt path of the port (no chunks) and the JAX stepper
    whole = port(tc.EngineLoadOptions()).execute_prefill(tx.PrefillPlan([item])).requests[0]
    assert tres.first_token == whole.first_token == jres.first_token
