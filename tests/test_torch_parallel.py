"""The port's ``parallel/`` against the JAX package, on the CPU.

Each world of 2 or 4 ranks is spawned once per module
(``parallel.dryrun.spawn_ranks``, gloo, a ``file://`` rendezvous under
``tmp_path``, one thread a rank, a 60 s process-group timeout and a bounded
join); its ranks (``_torch_parallel_ranks.py``, no JAX) run every sharded
op on the same numpy inputs and write what they get back. Each test holds
one op, forward and gradients of sum(out * dO), against the JAX package's
unsharded function (``reference_attention`` under ``jax.vjp``, or
``paged_decode_attention``) at the JAX suite's tolerances:

* ring, zigzag and Ulysses: 5e-2 absolute (``tests/_ring_check.py:31``);
* the halo window: 3e-2 relative for the output, 6e-2 for the gradients
  (``tests/test_parallel.py``);
* head-parallel attention: the ring's 5e-2 (``_ring_check.py``'s "tp
  heads" case); paged decode: 2e-2 (``tests/test_parallel.py``).

The zigzag layout, the halo bias, the param specs and the scaling
projection are held bit for bit against the JAX package in process, and
one case runs the JAX package's own ``ring_attention_sharded`` on 4 forced
host devices in a subprocess.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_parallel_ranks as ranks
from _torch_parity import jax_modules, np32, rel_err
from ffpa_attn_tpu_torch.parallel import (
    initialize_distributed,
    make_mesh,
    ring_scaling_projection,
    two_host_report,
)
from ffpa_attn_tpu_torch.parallel import analysis as tanalysis
from ffpa_attn_tpu_torch.parallel.dryrun import spawn_ranks
from ffpa_attn_tpu_torch.parallel.window import halo_bias
from ffpa_attn_tpu_torch.parallel.zigzag import (
    _chunk_order,
    zigzag_schedule,
    zigzag_shuffle,
    zigzag_unshuffle,
)

RING_TOL = 5e-2  # absolute, tests/_ring_check.py:31
WIN_TOL, WIN_GRAD_TOL = 3e-2, 6e-2  # relative, tests/test_parallel.py
PAGED_TOL = 2e-2
B, H, HKV, N, D = 1, 4, 2, 256, 320
WINDOWS = {2: [96], 4: [48, 100]}  # halo 1 at both widths, halo 2 at world 4
ULYSSES_WINDOW = 64
PAGE, LENS = 64, [200, 77]


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _inputs(world):
    rng = np.random.default_rng(0)
    r = lambda *s: _bf16(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    x = dict(q=r(B, H, N, D), k=r(B, HKV, N, D), v=r(B, HKV, N, D), do=r(B, H, N, D),
             k_mha=r(B, H, N, D), v_mha=r(B, H, N, D),
             sinks=np.asarray([0.3, 0.0, -0.2, 0.5], np.float32),
             slopes=np.asarray([0.01, 0.02, 0.03, 0.04], np.float32),
             windows=WINDOWS[world], ulysses_window=ULYSSES_WINDOW)
    pages = 1 + len(LENS) * 4
    table = (1 + np.arange(len(LENS) * 4, dtype=np.int32)).reshape(len(LENS), 4)
    x["paged"] = dict(q=r(len(LENS), 8, 1, D), k_pages=r(pages, 4, PAGE, D),
                      v_pages=r(pages, 4, PAGE, D), page_table=table,
                      lens=np.asarray(LENS, np.int32))
    return x


def _spawn(fn, world, args, tmp):
    spawn_ranks(fn, world, args, backend="gloo", rdzv_dir=str(tmp), timeout_s=240)


def _ops(world, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"ops{world}")
    x = _inputs(world)
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(x, f)
    _spawn(ranks.ops_rank, world, (str(tmp / "in.pkl"), str(tmp / "out.pkl")), tmp)
    with open(tmp / "out.pkl", "rb") as f:
        return x, pickle.load(f)


@pytest.fixture(scope="module")
def ops2(tmp_path_factory):
    return _ops(2, tmp_path_factory)


@pytest.fixture(scope="module")
def ops4(tmp_path_factory):
    return _ops(4, tmp_path_factory)


@pytest.fixture
def ops(request):
    return request.getfixturevalue(f"ops{request.param}")


def _jax_ref(q, k, v, do, extra=(), **kw):
    """JAX's unsharded reference_attention and its vjp w.r.t. (q, k, v,
    *extra), GQA by expand_kv_heads, on the bf16 inputs."""
    jax, jnp, jref = jax_modules("jax", "jax.numpy", "ffpa_attn_tpu.ops.reference")
    hq = q.shape[1]

    def f(q_, k_, v_, *ex):
        kw2 = dict(kw)
        if ex:
            kw2["sinks"] = ex[0]
        return jref.reference_attention(q_, jref.expand_kv_heads(k_, hq),
                                        jref.expand_kv_heads(v_, hq), **kw2)

    args = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)] + [jnp.asarray(e) for e in extra]
    out, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(do, jnp.bfloat16).astype(out.dtype))
    return [np32(out)] + [np32(g) for g in grads]


def _max_abs(a, b):
    return float(np.max(np.abs(np32(a) - np32(b))))


def _hold_abs(name, got, want, tol=RING_TOL):
    for label, g, w in zip(("out", "dq", "dk", "dv", "dsinks"), got, want):
        err = _max_abs(g, w)
        assert err < tol, (name, label, err)


@pytest.mark.parametrize("ops", [2, 4], indirect=True)
@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_jax(ops, causal):
    x, res = ops
    want = _jax_ref(x["q"], x["k"], x["v"], x["do"], is_causal=causal)
    _hold_abs("ring", res[f"ring_causal{int(causal)}"], want)


def test_ring_2d_tp_sp_matches_jax(ops4):
    x, res = ops4
    want = _jax_ref(x["q"], x["k_mha"], x["v_mha"], x["do"], is_causal=True)
    _hold_abs("ring tp x sp", res["ring_2d"], want)


@pytest.mark.parametrize("ops", [2, 4], indirect=True)
def test_zigzag_matches_jax(ops):
    x, res = ops
    want = _jax_ref(x["q"], x["k"], x["v"], x["do"], is_causal=True)
    _hold_abs("zigzag", res["zigzag"], want)


@pytest.mark.parametrize("ops,w", [(2, 96), (4, 48), (4, 100)], indirect=["ops"])
def test_window_matches_jax(ops, w):
    """Halo 1 (W below a shard) and halo 2 (W above one), with softcap and
    sinks; the sinks' gradient beside q, k and v's."""
    x, res = ops
    want = _jax_ref(x["q"], x["k"], x["v"], x["do"], extra=[x["sinks"]], is_causal=True,
                    window=(w, -1), softcap=25.0)
    got = res[f"window{w}"]
    assert rel_err(got[0], want[0]) < WIN_TOL
    for label, g, r in zip(("dq", "dk", "dv", "dsinks"), got[1:], want[1:]):
        assert rel_err(g, r) < WIN_GRAD_TOL, (w, label, rel_err(g, r))


@pytest.mark.parametrize("ops", [2, 4], indirect=True)
def test_ulysses_matches_jax(ops):
    """Causal, softcap, a window, ALiBi and sinks: each rank's heads take
    their slice of the slopes and sinks."""
    x, res = ops
    want = _jax_ref(x["q"], x["k_mha"], x["v_mha"], x["do"], extra=[x["sinks"]],
                    is_causal=True, softcap=25.0, window=(ULYSSES_WINDOW, -1),
                    alibi_slopes=x["slopes"])
    _hold_abs("ulysses", res["ulysses"], want)


@pytest.mark.parametrize("ops", [2, 4], indirect=True)
def test_head_parallel_matches_jax(ops):
    x, res = ops
    want = _jax_ref(x["q"], x["k_mha"], x["v_mha"], x["do"], is_causal=True)
    _hold_abs("head parallel", res["head_parallel"], want)


@pytest.mark.parametrize("ops", [2, 4], indirect=True)
def test_paged_head_parallel_matches_jax(ops):
    """Pools cut on Hkv (4 KV heads over 2 or 4 ranks, 8 Q heads), tables
    and lens replicated, against the JAX package's unsharded paged decode."""
    jnp, jpaged = jax_modules("jax.numpy", "ffpa_attn_tpu.ops.paged")
    x, res = ops
    p = x["paged"]
    cache = jpaged.PagedKVCache(
        jnp.asarray(p["k_pages"], jnp.bfloat16), jnp.asarray(p["v_pages"], jnp.bfloat16),
        jnp.asarray(p["page_table"]), jnp.asarray(p["lens"]))
    want = jpaged.paged_decode_attention(jnp.asarray(p["q"], jnp.bfloat16), cache)
    np.testing.assert_allclose(res["paged"][0], np32(want), atol=PAGED_TOL, rtol=PAGED_TOL)


_JAX_RING = r"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from ffpa_attn_tpu.parallel import make_mesh, ring_attention_sharded
with open(sys.argv[1], "rb") as f:
    x = pickle.load(f)
mesh = make_mesh((4,), ("sp",))
o = ring_attention_sharded(*(jnp.asarray(x[n], jnp.bfloat16) for n in ("q", "k", "v")),
                           mesh, seq_axis="sp", causal=True)
np.save(sys.argv[2], np.asarray(o, np.float32))
"""


def test_jax_sharded_ring_matches_port(ops4, tmp_path):
    """The JAX package's own causal ring_attention_sharded over 4 forced
    host devices against the port's over 4 ranks, same inputs."""
    jax_modules("jax")
    x, res = ops4
    with open(tmp_path / "in.pkl", "wb") as f:
        pickle.dump({n: x[n] for n in ("q", "k", "v")}, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", _JAX_RING, str(tmp_path / "in.pkl"),
                           str(tmp_path / "o.npy")], env=env, capture_output=True, text=True,
                          timeout=300, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert _max_abs(res["ring_causal1"][0], np.load(tmp_path / "o.npy")) < RING_TOL


@pytest.mark.parametrize("s", [1, 2, 3, 4, 8])
def test_zigzag_layout_matches_jax(s):
    jnp, jzz = jax_modules("jax.numpy", "ffpa_attn_tpu.parallel.zigzag")
    np.testing.assert_array_equal(_chunk_order(s), jzz._chunk_order(s))
    x = np.arange(2 * 3 * 16 * s * 2, dtype=np.float32).reshape(2, 3, 16 * s, 2)
    for axis in (2,):
        z = zigzag_shuffle(torch.from_numpy(x), s, axis)
        np.testing.assert_array_equal(z.numpy(), np.asarray(jzz.zigzag_shuffle(jnp.asarray(x),
                                                                               s, axis)))
        back = zigzag_unshuffle(z, s, axis)
        np.testing.assert_array_equal(back.numpy(), np.asarray(jzz.zigzag_unshuffle(
            jnp.asarray(z.numpy()), s, axis)))
        np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("s", [1, 2, 3, 4, 8])
def test_zigzag_schedule_is_balanced(s):
    """Every rank attends 2 diagonal and 2S - 1 full chunk pairs a layer,
    as the four-case rule gives pair by pair."""
    for rank in range(s):
        want = {"causal": 2, "full": 1}
        for r in range(1, s):
            src = (rank - r) % s
            want["full"] += 1 + (src < rank) + (src > rank)
        assert zigzag_schedule(s, rank) == want == {"causal": 2, "full": 2 * s - 1}


@pytest.mark.parametrize("nl,halo,idx", [(128, 1, 0), (128, 1, 1), (64, 2, 0), (64, 2, 1),
                                         (64, 2, 3), (96, 0, 2)])
def test_halo_bias_matches_jax(nl, halo, idx):
    """``window.py:95-104`` of the JAX package, with its mask constant."""
    jnp, jref = jax_modules("jax.numpy", "ffpa_attn_tpu.ops.reference")
    cols = jnp.arange((halo + 1) * nl, dtype=jnp.int32)
    valid = cols >= (halo - idx) * nl
    want = jnp.where(valid, 0.0, jref.DEFAULT_MASK_VALUE).astype(jnp.float32)[None, None, None]
    np.testing.assert_array_equal(halo_bias(nl, halo, idx).numpy(), np.asarray(want))


@pytest.mark.parametrize("sinks", [False, True])
def test_param_specs_match_jax(sinks):
    """Each leaf's torch spec is the JAX PartitionSpec with the
    projections' two dims swapped (nn.Linear keeps [out, in])."""
    from ffpa_attn_tpu_torch.models import ModelConfig, param_specs

    (jmodels,) = jax_modules("ffpa_attn_tpu.models.transformer")
    kw = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=2, n_kv_heads=1, head_dim=320,
              attn_sinks=sinks)
    got, want = param_specs(ModelConfig(**kw)), jmodels.param_specs(jmodels.ModelConfig(**kw))
    assert got["embed"] == tuple(want["embed"]) == ()
    assert got["final_norm"] == tuple(want["final_norm"]) == ()
    for g, w in zip(got["layers"], want["layers"]):
        assert set(g) == set(w)
        for name, spec in w.items():
            swapped = tuple(spec)[::-1] if name in ("wq", "wk", "wv", "wo", "w_up", "w_gate",
                                                    "w_down") else tuple(spec)
            assert g[name] == swapped, (name, g[name], spec)


def _patched_jax_constants(monkeypatch):
    (jan,) = jax_modules("ffpa_attn_tpu.parallel.analysis")
    monkeypatch.setattr(tanalysis, "NVLINK_BW_BYTES", jan.ICI_BW_BYTES)
    monkeypatch.setattr(tanalysis, "NETWORK_BW_BYTES", jan.DCN_BW_BYTES)
    monkeypatch.setattr(tanalysis, "STEP_LATENCY_S", jan.STEP_LATENCY_S)
    monkeypatch.setattr(tanalysis, "PEAK_BF16_FLOPS", jan.PEAK_BF16_FLOPS)
    return jan


@pytest.mark.parametrize("kw", [
    dict(b=1, h=32, n=16384, d=512, chips=4),
    dict(b=1, h=32, hkv=8, n=16384, d=512, chips=8, causal=True),
    dict(b=2, h=8, n=8192, d=320, dv=640, chips=2, itemsize=4),
    dict(b=1, h=32, n=16384, d=512, chips=8, hops=2),
    dict(b=1, h=32, n=16384, d=512, chips=8, rate=1.65e14, eff=0.5),
])
def test_scaling_projection_matches_jax(monkeypatch, kw):
    """With the JAX module's constants patched in, the port's projection
    is the JAX one bit for bit (the hop count over the network between
    hosts is its ``hops_over_dcn``, the measured rate its ``mxu_flops``)."""
    jan = _patched_jax_constants(monkeypatch)
    kw = dict(kw)
    hops, rate, eff = kw.pop("hops", 0), kw.pop("rate", None), kw.pop("eff", 0.85)
    got = ring_scaling_projection(**kw, inter_host_hops=hops, flops_rate=rate,
                                  tensor_core_efficiency=eff)
    want = jan.ring_scaling_projection(**kw, hops_over_dcn=hops, mxu_flops=rate,
                                       mxu_efficiency=eff)
    assert got == tanalysis.RingProjection(**vars(want))


@pytest.mark.parametrize("rate", [None, 1.65e14])
def test_two_host_report_matches_jax(monkeypatch, rate):
    jan = _patched_jax_constants(monkeypatch)
    got = two_host_report(flops_rate=rate)
    want = jan.two_host_report(mxu_flops=rate)
    assert [vars(p) for p in got] == [vars(p) for p in want]


def test_scaling_projection_h100_constants():
    """The spec constants: NVLink 450 GB/s one way, one NDR link 50 GB/s;
    a network hop throttles the ring, GQA rotates fewer bytes."""
    assert tanalysis.NVLINK_BW_BYTES == 450e9 and tanalysis.NETWORK_BW_BYTES == 50e9
    p8 = ring_scaling_projection(b=1, h=32, n=16384, d=512, chips=8)
    p8g = ring_scaling_projection(b=1, h=32, hkv=8, n=16384, d=512, chips=8)
    pnet = ring_scaling_projection(b=1, h=32, n=16384, d=512, chips=8, inter_host_hops=1)
    assert p8g.t_hop_ms == pytest.approx(p8.t_hop_ms / 4)
    assert pnet.t_hop_ms == pytest.approx(p8.t_hop_ms * 9)
    assert pnet.efficiency <= p8.efficiency


def test_initialize_distributed_without_torchrun_is_a_no_op(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    initialize_distributed()
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="mesh needs 2 devices"):
        make_mesh((2,), ("sp",), device="cpu")


def test_initialize_distributed_from_torchrun_variables(tmp_path):
    """RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT as torchrun sets them
    (one process, a localhost port): the group starts, a second call does
    nothing, and a one-rank mesh's axis is the whole group."""
    code = (
        "import torch.distributed as dist\n"
        "from ffpa_attn_tpu_torch.parallel import initialize_distributed, make_mesh\n"
        "from ffpa_attn_tpu_torch.parallel.mesh import axis_size, axis_rank\n"
        "initialize_distributed(backend='gloo')\n"
        "assert dist.is_initialized() and dist.get_backend() == 'gloo'\n"
        "initialize_distributed(backend='gloo')\n"
        "m = make_mesh((1,), ('sp',), device='cpu')\n"
        "assert axis_size(m, 'sp') == 1 and axis_rank(m, 'sp') == 0 and axis_size(m, 'tp') == 1\n"
        "dist.destroy_process_group()\n"
    )
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_spawn_ranks_runs_every_rank_and_reports_a_failure(tmp_path):
    _spawn(ranks.pid_rank, 3, (str(tmp_path),), tmp_path)
    rows = sorted(open(tmp_path / f"rank{r}").read().split()[:2] for r in range(3))
    assert rows == [[str(r), "3"] for r in range(3)]
    with pytest.raises(RuntimeError, match="a rank failed"):
        _spawn(ranks.pid_rank, 2, (str(tmp_path / "missing" / "dir"),), tmp_path)


def test_scaling_projection_leg_feeds_the_measured_rate(monkeypatch):
    """The e2e ``scaling_projection`` leg times the flagship forward with
    ``run_case`` (stubbed here: the CPU cannot run it at B1 H32 N8192) and
    feeds its rate to ``two_host_report``; the constants print as SPEC /
    MODEL CONSTANT."""
    from ffpa_attn_tpu_torch.cli import _bench, _e2e

    calls = []

    def fake_run_case(case, dtype, direction, **kw):
        calls.append((case.b, case.hq, case.nq, case.d, dtype, direction, kw["verify"]))
        return {"ffpa_tflops": 200.0}

    monkeypatch.setattr(_bench, "run_case", fake_run_case)
    out = _e2e.bench_scaling_projection(device="cpu")
    assert calls == [(1, 32, 8192, 512, torch.bfloat16, "fwd", False)]
    assert out["measured_tflops"] == 200.0
    assert out["nvlink_gbytes_per_s_SPEC"] == 450.0 and out["network_gbytes_per_s_SPEC"] == 50.0
    want = two_host_report(flops_rate=200e12)
    assert [p["chips"] for p in out["projections"]] == [p.chips for p in want]
    assert [p["efficiency_pct"] for p in out["projections"]] == [
        round(p.efficiency * 100, 1) for p in want]
