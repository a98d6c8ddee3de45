"""The plain reference against a naive per-request softmax at a tiny size:
D != Dv with V as K's prefix, nq = 2, shuffled pages."""

import math

import numpy as np
import pytest
import torch

from perfbench import traffic_gen
from perfbench.refs import mla_absorbed as ref


def _naive(q, rows, dv, scale):
    """float64 loops: token t of head h attends rows [0, n - nq + 1 + t)."""
    hq, nq, _ = q.shape
    n = rows.shape[0]
    out = torch.zeros((hq, nq, dv), dtype=torch.float64)
    for h in range(hq):
        for t in range(nq):
            seen = n - nq + 1 + t
            s = [float(q[h, t].double() @ rows[j].double()) * scale for j in range(seen)]
            m = max(s)
            w = [math.exp(x - m) for x in s]
            tot = sum(w)
            for j in range(seen):
                out[h, t] += (w[j] / tot) * rows[j, :dv].double()
    return out


@pytest.mark.parametrize("nq", [1, 2])
def test_reference_matches_naive_softmax(nq):
    page, d, dv, hq, scale = 8, 24, 16, 3, 0.3
    lens = np.array([5, 17, 9])
    table, pages = traffic_gen.page_table(lens, nq, page, seed=4)
    g = torch.Generator().manual_seed(0)
    pool = torch.randn((pages, 1, page, d), generator=g).to(torch.bfloat16)
    q = torch.randn((len(lens), hq, nq, d), generator=g).to(torch.bfloat16)
    table_t = torch.from_numpy(table)
    for b, n in enumerate(lens):
        rows = ref.gather_rows(pool, table_t[b], int(n) + nq)
        # the rows come back in the request's order, whatever pages hold them
        flat = torch.cat([pool[int(p), 0] for p in table[b, : -(-(int(n) + nq) // page)]])
        assert torch.equal(rows, flat[: int(n) + nq])
        got = ref.decode_request(q[b], rows, dv=dv, scale=scale)
        want = _naive(q[b].float(), rows.float(), dv, scale)
        assert got.dtype == torch.float32 and got.shape == (hq, nq, dv)
        torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)


def test_fp8_control_is_coarser():
    g = torch.Generator().manual_seed(1)
    q = torch.randn((4, 2, 64), generator=g)
    rows = torch.randn((50, 64), generator=g)
    exact = ref.decode_request(q, rows, dv=48, scale=0.2)
    low = ref.decode_request(q, rows, dv=48, scale=0.2, precision="fp8")
    assert (low - exact).abs().max() > 1e-2
    with pytest.raises(ValueError):
        ref.decode_request(q, rows, dv=48, scale=0.2, precision="fp4")
