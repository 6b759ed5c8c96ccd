"""tests/test_torch_decode_blocks.py's engine cases under the deep profile
(``decode_block_max=4, decode_pipeline_depth=4``: blocks of 4, four in
flight): the port's streams equal the JAX engine's under the same options,
an EOS inside the speculative window and a LENGTH boundary included."""

import pytest

from tests.test_torch_decode_blocks import CASES, _sides, weights  # noqa: F401


@pytest.fixture(scope="module")
def sides(weights):  # noqa: F811
    return "deep", _sides(weights, "deep")


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_deep_streams_match_the_jax_engine(sides, case):
    _, (jside, tside) = sides
    want = case(jside)
    got = case(tside)
    assert got == want
    assert tside.dispatches == jside.dispatches  # the same blocks
    assert tside.ex.decode_block_max == 4 and tside.ex.decode_pipeline_depth == 4
