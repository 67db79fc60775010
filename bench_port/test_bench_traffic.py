"""The traffic generator: the same seed gives the same requests, and every
seed offers the same sizes in another order."""
from collections import Counter

import numpy as np
import pytest

from bench_port import spec
from bench_port.traffic.generator import Stream, quantile_lengths

MIXES = ["code_long_prompt", "chat_decode"]


def _mix(name):
    return spec.read_json(spec.BENCH_DIR / "traffic" / f"{name}.json")


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_requests(mix):
    a = Stream(_mix(mix), 2 ** 31 + 5, 4, 50304)
    b = Stream(_mix(mix), 2 ** 31 + 5, 4, 50304)
    for _ in range(40):
        x, y = a.take(), b.take()
        assert x.rid == y.rid and x.max_new_tokens == y.max_new_tokens
        np.testing.assert_array_equal(x.prompt, y.prompt)


@pytest.mark.parametrize("mix", MIXES)
def test_seeds_share_sizes_not_order(mix):
    m = _mix(mix)
    n = m["block"]
    streams = [Stream(m, s, 0, 50304) for s in (1, 2 ** 33 + 1)]
    blocks = [[(len(r.prompt), r.max_new_tokens)
               for r in (s.request(i) for i in range(n))] for s in streams]
    for k in (0, 1):
        assert Counter(x[k] for x in blocks[0]) == \
            Counter(x[k] for x in blocks[1])
    assert blocks[0] != blocks[1]
    p0 = streams[0].request(3).prompt
    assert p0.min() >= 0 and p0.max() < 50304 and p0.dtype == np.int32


@pytest.mark.parametrize("mix", MIXES)
def test_lengths_follow_the_mix(mix):
    m = _mix(mix)
    for key in ("prompt", "output"):
        q = quantile_lengths(m[key], m["block"])
        assert q == sorted(q)
        assert m[key]["min"] <= q[0] and q[-1] <= m[key]["max"]
        assert abs(q[len(q) // 2] - m[key]["median"]) <= \
            0.05 * m[key]["median"] + 1


def test_ramp_requests_spread_their_outputs():
    m = _mix("chat_decode")
    s = Stream(m, 7, 32, 1000)
    outs = [s.take().max_new_tokens for _ in range(32)]
    assert outs[0] == 2 and outs == sorted(outs)
    assert outs[-1] < m["output"]["median"] + 2
    assert s.take().max_new_tokens >= m["output"]["min"]
