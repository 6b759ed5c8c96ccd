"""Decode block graphs (``DecodeGraphs.run_block``) against the same N
steps run eagerly (``decode_graphs.decode_block`` over the step), on the
card. Marked ``cuda``: run with ``python -m pytest -m cuda tests/`` on a
machine with an NVIDIA Hopper card; elsewhere each test skips.

A block graph replays the kernels its capture recorded with the same
arguments, and the sampling between its steps runs the same torch
operations, so its outputs (tokens, and with ``lp_k`` the chosen and top
logprobs and ids, all in one flat int32 tensor) must equal the eager
block's bit for bit, as must the pool past the null page and every live
slot's rows. The families and weights are tests/test_torch_kernels_cuda.py's
graph models: a tiny Qwen3 at hd 128 (K1; K6 at one expert in int8), a
tiny Qwen3.5 hybrid at hd 256 (K1, K6 in int8) and a tiny DeepSeek-V4 at
the widths where the chains take the rows (K3 / K4, K8, K9). A pipelined
pair dispatches block k + 1 on block k's tokens on the card before block
k is read, as the scheduler's pipeline does, and must equal two eager
blocks run one after the other.
"""

import importlib.util
import pathlib
from functools import partial

import numpy as np
import pytest
import torch

from pegainfer_tpu_torch.engine import decode_graphs as dg

# tests/test_torch_kernels_cuda.py's graph models and helpers, loaded by
# path (a card machine may have another package named ``tests``)
_spec = importlib.util.spec_from_file_location(
    "_kernels_cuda", pathlib.Path(__file__).with_name("test_torch_kernels_cuda.py"))
kc = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kc)
GRAPH_BUCKETS, GRAPH_PS, SLOT_GRAPH_SLOTS = kc.GRAPH_BUCKETS, kc.GRAPH_PS, kc.SLOT_GRAPH_SLOTS
graph_models, q35_graph_models, dsv4_graph_models = (
    kc.graph_models, kc.q35_graph_models, kc.dsv4_graph_models)

pytestmark = pytest.mark.cuda

V = 512  # the graph models' vocabulary
LP_K = 4


def _paged_rows(B, P, N, seed):
    """B live rows with room in a width-P table for N more tokens, each on
    its own pages: (tokens, positions, table, seq_lens)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(2, V, B).astype(np.int32)
    positions = np.zeros(B, np.int32)
    tables = np.zeros((B, P), np.int32)
    half = (P // 2) * GRAPH_PS
    for i in range(B):
        ctx = half + 1 + (37 * i) % (half - N - 1)
        positions[i] = ctx - 1
        n_pages = -(-(ctx + N) // GRAPH_PS)
        tables[i, :n_pages] = np.arange(1 + i * P, 1 + i * P + n_pages)
    return tokens, positions, tables, positions + 1


def _sampling(B, N, greedy, seed):
    """Row 0 greedy (temperature 0), the others sampled, or None."""
    if greedy:
        return None
    rng = np.random.default_rng(seed)
    temp = np.full(B, 0.8, np.float32)
    temp[0] = 0.0
    return (temp, np.full(B, 20, np.int32), np.full(B, 0.9, np.float32),
            rng.uniform(size=(N, B)).astype(np.float32))


class Case:
    """One family's step on an eager state and a graphed copy: ``eager``
    runs ``decode_block`` over the eager state, ``graphs`` the block graphs
    over the copy, ``same`` compares the live state."""

    def __init__(self, family, params, B, moe_chain=None):
        self.B = B
        if family == "qwen3":
            from pegainfer_tpu_torch.models import qwen3 as q3

            cfg = kc._graph_cfg()
            self.e = kc._graph_pool()
            self.g = self.e.clone()
            step = partial(q3.decode, cfg, params)
            self.fam = dg.QWEN3
            self.graphs = dg.DecodeGraphs(partial(step, self.g), torch.device("cuda"), GRAPH_BUCKETS,
                                          cfg.num_key_value_heads)
            self.step_e = partial(step, self.e)
            self.same = lambda: torch.equal(self.g[:, :, 1:], self.e[:, :, 1:])
        elif family == "qwen35":
            from pegainfer_tpu_torch.models import qwen35 as q35

            cfg = kc._q35_graph_cfg()
            self.e = kc._q35_graph_state()
            self.g = kc._clone_state(self.e)
            self.fam = dg.hybrid(SLOT_GRAPH_SLOTS)
            self.graphs = dg.DecodeGraphs(partial(q35.decode, cfg, params, self.g),
                                          torch.device("cuda"), GRAPH_BUCKETS,
                                          cfg.num_key_value_heads, self.fam)
            self.step_e = partial(q35.decode, cfg, params, self.e)
            self.same = lambda: kc._q35_state_equal(self.g, self.e)
        else:
            from pegainfer_tpu_torch.models import dsv4 as d4

            cfg = kc._dsv4_graph_cfg()
            self.e, self.g = kc._dsv4_graph_state(), kc._dsv4_graph_state()
            self.fam = dg.dsv4(2)
            self.graphs = dg.DecodeGraphs(partial(d4.decode, cfg, params, self.g,
                                                  moe_chain=moe_chain),
                                          torch.device("cuda"), (1, 2), 0, self.fam)
            self.step_e = partial(d4.decode, cfg, params, self.e, moe_chain=moe_chain)
            self.same = lambda: kc._dsv4_live_equal(self.g, self.e)

    def arrays(self, N, k=0, seed=0):
        """The block's inputs after k earlier blocks of N."""
        B = self.B
        if self.fam.table:
            tokens, positions, table, seq_lens = _paged_rows(B, 16, 2 * N, seed)
            rows = (tokens, positions + k * N, table, seq_lens + k * N)
            if self.fam is dg.QWEN3:
                return rows
            return (*rows, np.arange(B - 1, -1, -1, dtype=np.int32))
        tokens = (3 + 101 * np.arange(B) + seed).astype(np.int32)
        positions = (37 + 11 * np.arange(B) + k * N).astype(np.int32)
        return tokens, positions, np.array([1, 0][:B], np.int32)

    def eager(self, arrays, N, sampling, lp_k, tokens=None):
        args = {a: torch.from_numpy(x).cuda() for a, x in zip(self.fam.args, arrays)}
        if tokens is not None:
            args["tokens"] = tokens
        dev = None if sampling is None else [torch.from_numpy(x).cuda() for x in sampling]
        with torch.no_grad():
            return dg.decode_block(self.step_e, args, self.fam.args, N, dev, lp_k)


def _check_block(case, N, greedy, lp_k, seed=0):
    arrays = case.arrays(N, seed=seed)
    sampling = _sampling(case.B, N, greedy, seed)
    want = case.eager(arrays, N, sampling, lp_k)
    got = case.graphs.run_block(arrays, N, sampling, lp_k).clone()
    torch.cuda.synchronize()
    assert torch.equal(got, want), "the block graph's outputs differ from the eager block's"
    assert case.same(), "the block graph's state differs from the eager block's"
    toks, lp = dg.unpack_block(got.cpu().numpy(), N, case.B, lp_k)
    assert toks.shape == (N, case.B) and ((toks >= 0) & (toks < V)).all()
    if lp_k:
        assert np.isfinite(lp[0]).all() and (lp[0] <= 0).all()


QWEN3_CASES = [(mode, B) for mode in ("bf16", "int8") for B in (1, 2, 8)]


@pytest.mark.parametrize("N", [4, 16])
@pytest.mark.parametrize("mode,B", QWEN3_CASES, ids=[f"{m}-B{b}" for m, b in QWEN3_CASES])
def test_qwen3_block_graph_equals_n_eager_steps(graph_models, mode, B, N):
    """B 1 greedy without logprobs, B 2 and 8 with sampled rows and the top
    4 logprobs; the graph's launches are N steps'."""
    from pegainfer_tpu_torch.ops.cuda import paged_decode as pd

    case = Case("qwen3", graph_models[mode], B)
    greedy, lp_k = B == 1, 0 if B == 1 else LP_K
    _check_block(case, N, greedy, lp_k)
    _check_block(case, N, greedy, lp_k, seed=1)  # a replay
    k1 = pd.launches
    case.graphs.run_block(case.arrays(N, seed=2), N, _sampling(B, N, greedy, 2), lp_k)
    assert pd.launches - k1 == N * 2  # a replay counts two layers a step
    assert [n for _, _, n, _, _ in case.graphs.capture_log] == [N]


@pytest.mark.parametrize("N", [4, 16])
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_hybrid_block_graph_equals_n_eager_steps(q35_graph_models, mode, B, N):
    case = Case("qwen35", q35_graph_models[mode], B)
    _check_block(case, N, greedy=False, lp_k=LP_K)
    _check_block(case, N, greedy=False, lp_k=LP_K, seed=1)


DSV4_CASES = [(("fp4", False), "K3-K4"), (("fp4", True), "K9"), (("int8", None), "K8")]


@pytest.mark.parametrize("N", [4, 16])
@pytest.mark.parametrize("mode", [c for c, _ in DSV4_CASES], ids=[i for _, i in DSV4_CASES])
def test_dsv4_block_graph_equals_n_eager_steps(dsv4_graph_models, mode, N):
    experts, chain = mode
    case = Case("dsv4", dsv4_graph_models[experts], 2, chain)
    _check_block(case, N, greedy=False, lp_k=LP_K)
    _check_block(case, N, greedy=True, lp_k=0, seed=1)


PAIR_CASES = [("qwen3", "graph_models", "bf16"), ("qwen35", "q35_graph_models", "bf16"),
              ("dsv4", "dsv4_graph_models", "int8")]


@pytest.mark.parametrize("family,models,mode", PAIR_CASES, ids=[c[0] for c in PAIR_CASES])
def test_pipelined_pair_equals_two_blocks_in_turn(request, family, models, mode):
    """Block 2 of the same key dispatched on block 1's last row of tokens on
    the card (its host tokens stale) before block 1 is read: block 1's
    outputs, copied out between the replays, and block 2's equal two eager
    blocks, the second on the tokens the first sampled."""
    N, B = 4, 2
    case = Case(family, request.getfixturevalue(models)[mode], B)
    s1, s2 = _sampling(B, N, False, 1), _sampling(B, N, False, 2)
    a1 = case.arrays(N, 0)
    a2 = list(case.arrays(N, 1))
    a2[0] = np.zeros(B, np.int32)  # stale: the card's tokens are used
    out1 = case.graphs.run_block(a1, N, s1, LP_K)
    got1 = out1.clone()  # the copy between the replays
    got2 = case.graphs.run_block(a2, N, s2, LP_K, tokens=out1[:N * B].view(N, B)[-1]).clone()
    w1 = case.eager(a1, N, s1, LP_K)
    w2 = case.eager(a2, N, s2, LP_K, tokens=w1[:N * B].view(N, B)[-1].clone())
    torch.cuda.synchronize()
    assert torch.equal(got1, w1) and torch.equal(got2, w2)
    assert case.same()
    assert len(case.graphs.capture_log) == 1  # one graph, replayed twice
